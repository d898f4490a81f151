"""The port's exact encoder equals the JAX package's, stage by stage.

The same numpy rows go through ``snappy_tpu.ops.encode`` (XLA on the CPU),
``snappy_tpu.ops.pallas.encode.compress_blocks_pallas`` (interpret mode,
on 4096- and 1024-byte rows as the JAX package's own tests run it) and
``snappy_tpu_torch.ops.encode`` (the plain version of K7, on CPU tensors):
the automaton's op planes, the serializer, the whole block encoder, and
each block against the reference encoder's raw stream. Outputs are bytes
and integers: tolerance 0. Contents stay at or below 16 KiB, since the
plain automaton takes one Python iteration per step.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import load_corpus
from snappy_tpu.ops import encode as jenc
from snappy_tpu.ops.pallas.encode import compress_blocks_pallas
from snappy_tpu_torch import native
from snappy_tpu_torch.format.varint import read_varu64
from snappy_tpu_torch.ops import encode as enc
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()


def _edge_rows():
    """The JAX package's edge rows (``tests/test_pallas.py:305-315``)."""
    rng = np.random.default_rng(3)
    return [
        b"hello world hello world hello world!",
        bytes(rng.integers(0, 4, 3000, dtype=np.uint8)),  # copy-heavy
        b"a" * 500,  # a run
        load_corpus("html")[:4096],
        bytes(rng.integers(0, 256, 1200, dtype=np.uint8)),  # incompressible
        b"xy",  # below MIN_NON_LITERAL_BLOCK_SIZE: one literal
        b"q" * 16,  # 16 < 17
        b"q" * 17,  # the smallest automaton input
        b"",
    ]


def _repetitive_rows(seed, count, max_len):
    """Seeded rows of a short random segment repeated (as the JAX
    package's quickcheck makes them)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(count):
        n = int(rng.integers(1, max_len))
        alphabet = int(rng.choice([2, 8, 64, 256]))
        seg = rng.integers(0, alphabet, max(n // 3, 1), dtype=np.uint8)
        rows.append(np.tile(seg, 4)[:n].tobytes())
    return rows


ROWS = _edge_rows() + _repetitive_rows(41, 4, 9000) + [
    load_corpus("alice29.txt")[:8192],
    b"abcdefgh" * 8192,  # a 64 KiB run of copies: long extensions, 64-byte peels
]


def _batch(datas, width=65536):
    rows = np.zeros((len(datas), width), np.uint8)
    lens = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        rows[i, : len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return rows, lens


def _oracle_body(data: bytes) -> bytes:
    """The reference encoder's raw stream without its varint preamble."""
    c = native.compress(data)
    return c[read_varu64(c)[1]:]


@pytest.fixture(scope="module")
def planes():
    rows, lens = _batch(ROWS)
    got = enc.find_ops_lockstep(torch.from_numpy(rows), torch.from_numpy(lens))
    want = jenc.find_ops(jnp.asarray(rows), jnp.asarray(lens))
    return rows, lens, got, [np.asarray(w) for w in want]


def test_find_ops_planes_match_jax_package(planes):
    _, _, got, want = planes
    for name, g, w in zip(("op_kind", "op_a", "op_b", "nops", "overflow"), got, want):
        assert g.dtype == (torch.bool if name == "overflow" else torch.int32), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert not got[4].any()


def test_find_ops_counts_the_kernels_steps(planes):
    """Extension steps of 128 bytes: one per started 128 bytes past the
    four that matched, for every copy op; the 64 KiB run's one copy is
    all extension."""
    _, lens, got, _ = planes
    op_kind, _, op_b, nops, _, scan_steps, extend_steps = got
    valid = torch.arange(enc.MAX_OPS)[None, :] < nops[:, None].long()
    copies = valid & (op_kind == 1)
    want = torch.where(copies, (op_b.long() - 4) // enc.QUANTUM + 1, 0).sum(1)
    assert torch.equal(extend_steps, want)
    assert int(copies[-1].sum()) == 1 and int(extend_steps[-1]) == (65536 - 8 - 4) // enc.QUANTUM + 1
    small = torch.from_numpy(lens) < 17
    assert not scan_steps[small].any() and (scan_steps[~small] > 0).all()


def test_serialize_ops_matches_jax_package(planes):
    """The serializer on the JAX package's own op planes."""
    rows, _, _, want = planes
    jout, jlen = jenc.serialize_ops(jnp.asarray(rows), *(jnp.asarray(w) for w in want[:4]))
    out, out_len = enc.serialize_ops(torch.from_numpy(rows), *(torch.tensor(w) for w in want[:4]))
    assert out.shape == (len(ROWS), enc.OUT_W) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))


def test_compress_blocks_matches_jax_package_and_the_reference(planes):
    rows, lens, _, _ = planes
    out, out_len = enc.compress_blocks(torch.from_numpy(rows), torch.from_numpy(lens))
    jout, jlen = jenc.compress_blocks(jnp.asarray(rows), jnp.asarray(lens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))
    for i, d in enumerate(ROWS):
        assert out[i, : out_len[i]].numpy().tobytes() == (_oracle_body(d) if d else b""), i
        assert not out[i, out_len[i]:].any()
    host_out, host_len = enc.compress_blocks_host(rows[:3], lens[:3], "cpu")
    np.testing.assert_array_equal(host_out, out[:3].numpy())
    np.testing.assert_array_equal(host_len, out_len[:3].numpy())


@pytest.mark.parametrize("width", [4096, 1024])
def test_compress_blocks_matches_pallas_interpret(width):
    datas = _edge_rows() if width == 4096 else _repetitive_rows(41, 6, 900)
    rows, lens = _batch(datas, width)
    jout, jlen = compress_blocks_pallas(jnp.asarray(rows), jnp.asarray(lens), interpret=True)
    out, out_len = enc.compress_blocks(torch.from_numpy(rows), torch.from_numpy(lens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))


def test_an_overflowed_lane_is_poisoned(monkeypatch):
    rows, lens = _batch([b"hello world hello world hello world!", b"abc" * 100], 1024)
    real = enc.find_ops

    def overflowed(blocks, lengths):
        *planes, overflow = real(blocks, lengths)
        return (*planes, torch.tensor([False, True]))

    monkeypatch.setattr(enc, "find_ops", overflowed)
    _, out_len = enc.compress_blocks(torch.from_numpy(rows), torch.from_numpy(lens))
    assert int(out_len[1]) == enc.OUT_W + 1 and int(out_len[0]) <= enc.OUT_W
    with pytest.raises(RuntimeError, match="op-count overflow"):
        enc.compress_blocks_host(rows, lens, "cpu")


def test_wrapper_checks_its_inputs():
    rows = torch.zeros((2, 1024), dtype=torch.uint8)
    lens = torch.tensor([3, 1024], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 128"):
        enc.compress_blocks(torch.zeros((2, 1000), dtype=torch.uint8), lens)
    with pytest.raises(ValueError, match="multiple of 128"):
        enc.compress_blocks(torch.zeros((1, 65536 + 128), dtype=torch.uint8), lens[:1])
    with pytest.raises(ValueError, match=r"lie in \[0, 1024\]"):
        enc.compress_blocks(rows, torch.tensor([3, 1025], dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        enc.compress_blocks(rows, lens.long())
    with pytest.raises(TypeError, match="uint8"):
        enc.compress_blocks(rows.to(torch.int32), lens)
    with pytest.raises(ValueError, match="unsupported device"):
        enc.compress_blocks(rows.to("meta"), lens.to("meta"))
