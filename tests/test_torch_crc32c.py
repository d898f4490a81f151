"""K1's plain version equals the JAX package's CRC32C formulations:
the XLA matmul the decode path calls and the Pallas kernel (interpret
mode). CRCs are integers, so the comparison is exact."""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from snappy_tpu.format.crc32c import crc32c
from snappy_tpu.format.tables import crc32c_table16
from snappy_tpu.ops import crc32c as jcrc
from snappy_tpu.ops.pallas.crc32c import crc32c_blocks_pallas
from snappy_tpu_torch.ops import crc32c as tcrc
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

def _rows(seed: int, b: int, s: int):
    """Zero-padded random rows with random lengths, including 0 and s."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, s + 1, b).astype(np.int32)
    lens[:2] = (0, s)
    rows = np.zeros((b, s), np.uint8)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    return rows, lens


def _port(fn, rows, lens):
    out = fn(torch.from_numpy(rows), torch.from_numpy(lens))
    assert out.dtype == torch.int64 and out.shape == (rows.shape[0],)
    return out.numpy().astype(np.uint32)


@pytest.mark.parametrize("s", [4, 1024, 65536])
def test_plain_masked_crc_matches_xla(s):
    rows, lens = _rows(5, 8 if s == 65536 else 16, s)
    want = np.asarray(jcrc.crc32c_masked_blocks(rows, lens))
    np.testing.assert_array_equal(_port(tcrc.crc32c_masked_blocks, rows, lens), want)
    want_u = np.asarray(jcrc.crc32c_blocks(rows, lens))
    np.testing.assert_array_equal(_port(tcrc.crc32c_blocks, rows, lens), want_u)


def test_plain_crc_matches_pallas_interpret():
    rows, lens = _rows(3, 8, 4096)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(crc32c_blocks_pallas(rows, lens))
    np.testing.assert_array_equal(_port(tcrc.crc32c_blocks, rows, lens), want)


def test_bytes_past_the_length_are_ignored():
    rows, lens = _rows(9, 12, 3000)  # not a power of two: the port needs none
    dirty = rows.copy()
    rng = np.random.default_rng(1)
    for i, n in enumerate(lens):
        dirty[i, n:] = rng.integers(1, 256, 3000 - n, dtype=np.uint8)
    want = np.array([crc32c(rows[i, :n].tobytes()) for i, n in enumerate(lens)], np.uint32)
    np.testing.assert_array_equal(_port(tcrc.crc32c_blocks, dirty, lens), want)


def test_shift_operators_match_jax_package():
    np.testing.assert_array_equal(
        tcrc.shift_operators(), np.asarray(jcrc.shift_operators()[:32], np.uint32)
    )


def test_wrapper_checks_its_inputs():
    rows = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        tcrc.crc32c_blocks(rows.to(torch.int32), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        tcrc.crc32c_blocks(rows, torch.zeros(3, dtype=torch.int32))
    assert tcrc.crc32c_blocks(rows[:0], torch.zeros(0, dtype=torch.int32)).shape == (0,)


# -- the kernel's arithmetic, length class by length class --------------------------
_LENGTH_CLASSES = (0, 1, 3, 4, 15, 16, 17)


def _class_rows(s: int, seed: int):
    """Rows of width ``s`` with every length class (0, 1, 3, 4, 15, 16, 17,
    ``s - 1``, ``s``; those above ``s`` dropped), zero past the length."""
    lens = np.array(sorted({n for n in (*_LENGTH_CLASSES, s - 1, s) if 0 <= n <= s}) * 2, np.int32)
    lens = np.concatenate([lens, np.zeros(-len(lens) % 8, np.int32)])  # Pallas takes rows by 8
    rng = np.random.default_rng(seed)
    rows = np.zeros((len(lens), s), np.uint8)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    return rows, lens


@pytest.mark.parametrize("s", [32, 2048, 65536])
def test_plain_matches_xla_on_every_length_class(s):
    rows, lens = _class_rows(s, 21)
    np.testing.assert_array_equal(
        _port(tcrc.crc32c_blocks, rows, lens), np.asarray(jcrc.crc32c_blocks(rows, lens)))
    np.testing.assert_array_equal(
        _port(tcrc.crc32c_masked_blocks, rows, lens),
        np.asarray(jcrc.crc32c_masked_blocks(rows, lens)))


def test_plain_matches_pallas_interpret_on_every_length_class():
    rows, lens = _class_rows(2048, 23)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(crc32c_blocks_pallas(rows, lens))
    np.testing.assert_array_equal(_port(tcrc.crc32c_blocks, rows, lens), want)


@pytest.mark.parametrize("s", [5, 17, 4001, 65537, 131077])
def test_widths_not_a_multiple_of_16(s):
    """Widths the JAX package does not take (not a power of two; past one
    chunk of THREADS * WORDS words), held to the reference CRC."""
    rows, lens = _class_rows(s, 25)
    want = np.array([crc32c(rows[i, :n].tobytes()) for i, n in enumerate(lens)], np.uint32)
    np.testing.assert_array_equal(_port(tcrc.crc32c_blocks, rows, lens), want)


@pytest.mark.parametrize("s", [16, 4001, 65536])
def test_dirty_bytes_past_every_length_class(s):
    rows, lens = _class_rows(s, 27)
    dirty = rows.copy()
    rng = np.random.default_rng(29)
    for i, n in enumerate(lens):
        dirty[i, n:] = rng.integers(1, 256, s - n, dtype=np.uint8)
    want = np.asarray(jcrc.crc32c_masked_blocks(rows, lens)) if s in (16, 65536) else None
    got = _port(tcrc.crc32c_masked_blocks, dirty, lens)
    np.testing.assert_array_equal(got, _port(tcrc.crc32c_masked_blocks, rows, lens))
    if want is not None:
        np.testing.assert_array_equal(got, want)


def test_fixed_operators_match_shift_operators():
    """Each fixed operator of the kernel (lane l's, warp w's, the chunk's),
    as eight nibble tables, advances a register past as many zero bytes as
    the column form (``shift_operators``, one M_{2^k} a set bit) and as
    that many byte steps of the CRC table, on random registers."""
    _, ops = tcrc.kernel_tables()
    threads, seg = tcrc.THREADS, 16 * tcrc.WORDS
    warps = threads // 32
    dists = ([(31 - lane) * seg for lane in range(32)]
             + [(warps - 1 - w) * 32 * seg for w in range(warps)] + [threads * seg])
    assert ops.shape == (32 + warps + 1, 8, 16)
    cols = tcrc.shift_operators()
    t0 = crc32c_table16()[0]
    rng = np.random.default_rng(31)
    for n, tab in zip(dists, ops):
        for v in map(int, rng.integers(0, 2**32, 3, dtype=np.uint64)):
            got = 0
            for q in range(8):
                got ^= int(tab[q][(v >> (4 * q)) & 15])
            want = v
            for k in range(n.bit_length()):
                if n >> k & 1:
                    want = tcrc._apply_int(cols[k], want)
            assert got == want, n
    for n, tab in zip(dists[::13], ops[::13]):  # a few, byte by byte
        v = int(rng.integers(0, 2**32, dtype=np.uint64))
        want = v
        for _ in range(n):
            want = int(t0[want & 0xFF]) ^ (want >> 8)
        assert want == int(np.bitwise_xor.reduce(
            [tab[q][(v >> (4 * q)) & 15] for q in range(8)])), n


def test_slicing_tables_advance_four_bytes():
    """One slicing-by-4 step (byte p of a word through table 3 - p, the
    register XORed into the word) equals 4 byte steps of the byte table."""
    t4, _ = tcrc.kernel_tables()
    t0 = crc32c_table16()[0]
    assert t4.shape == (4, 256)
    rng = np.random.default_rng(33)
    for _ in range(64):
        r = int(rng.integers(0, 2**32, dtype=np.uint64))
        word = rng.integers(0, 256, 4, dtype=np.uint8)
        want = r
        for byte in word:
            want = int(t0[(want ^ int(byte)) & 0xFF]) ^ (want >> 8)
        x = int.from_bytes(word.tobytes(), "little") ^ r
        got = int(t4[3][x & 0xFF] ^ t4[2][(x >> 8) & 0xFF] ^ t4[1][(x >> 16) & 0xFF]
                  ^ t4[0][x >> 24])
        assert got == want
