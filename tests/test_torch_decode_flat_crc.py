"""K2 with the frame checksum (``ops/decode_flat.py`` ``decode_flat_crc``,
``csrc/flat_gather.cu`` with its checksum on), on the CPU.

The kernel has no CPU mode. Here: the wrapper's CPU run against the JAX
package's reference decode and masked CRC32C (``snappy_tpu.format``), and
against K2's and K1's plain versions; the host-made tables the kernel folds
and combines with (M_4 and the tree's levels as 5-bit tables, the units'
shifts, the inverse operators that undo M_n); and the kernel's checksum
arithmetic followed in tensor ops (:func:`flat_crc_walk`, after
``csrc/flat_gather.cu``'s step 6) against the reference CRC and K1's plain
version. CRCs are integers: equality.
"""

import numpy as np
import pytest
import torch

from conftest import load_corpus
from snappy_tpu.format import reference as jref
from snappy_tpu.format.crc32c import crc32c_masked as jcrc32c_masked
from snappy_tpu.format.varint import write_varu64
from snappy_tpu_torch import native
from snappy_tpu_torch.config import configure
from snappy_tpu_torch.format.constants import CRC_MASK_DELTA
from snappy_tpu_torch.ops import api, crc32c, decode_flat, packing
from torch_vectors import (
    FLAT_CRC_SHAPES, flat_crc_rows, hold_jax_native, share_cores_with_workers,
)

share_cores_with_workers()
hold_jax_native()

GROUP = decode_flat.GROUP
TABLES = decode_flat.flat_crc_tables()
# Word offsets of the parts of flat_crc_tables (csrc/flat_gather.cu).
FIVE = decode_flat.FIVE
LEVEL_AT = FIVE
UNIT_AT = LEVEL_AT + decode_flat.LEVELS * FIVE
INV_AT = UNIT_AT + (decode_flat.MAX_CRC_UNITS - 1) * 128


_FF = 0xFFFFFFFF
RUN, LEVELS, TAIL_RADIX = decode_flat.RUN, decode_flat.LEVELS, decode_flat.TAIL_RADIX


def _lookup8(tabs: torch.Tensor, base, v: torch.Tensor) -> torch.Tensor:
    """Eight nibble lookups of ``v`` in the operator at word ``base`` of
    ``tabs`` (a number, or a tensor of them beside ``v``)."""
    r = torch.zeros_like(v)
    for q in range(8):
        r ^= tabs[base + 16 * q + ((v >> (4 * q)) & 15)]
    return r


def _five(tabs: torch.Tensor, base: int, v: torch.Tensor) -> torch.Tensor:
    """The operator held as 5-bit tables at word ``base`` of ``tabs`` on
    ``v``: seven lookups, as a warp's seven shuffles."""
    r = tabs[base + 192 + (v >> 30)]
    for c in range(6):
        r = r ^ tabs[base + 32 * c + ((v >> (5 * c)) & 31)]
    return r


def _tail_steps(tail: torch.Tensor) -> list[torch.Tensor]:
    """Indices into ``tail_counts`` of the (at most two) inverses that take
    back ``tail`` zeros, -1 for none."""
    lo, hi = tail % TAIL_RADIX, tail // TAIL_RADIX
    return [lo - 1, torch.where(hi > 0, hi + TAIL_RADIX - 2, -1)]


def flat_crc_walk(rows, declens):
    """The checksum instance's arithmetic in tensor ops, on K2's output:
    ``rows`` ``(B, d_pad)`` uint8, zeros past each ``declen`` as K2 writes
    them; returns the masked CRC32C of each row's first ``declen`` bytes
    (clamped to ``[0, d_pad]``), ``(B,)`` int64.

    Per 16 KiB unit: each thread's 128-byte run folded from 0 four bytes a
    step (``r = M_4(r ^ word)``; the initial value XORed into unit 0's
    first word), then the 128 runs joined in a tree whose level ``k``
    advances the earlier group by M_{128 2^k}. A live unit's share: a unit
    ``u`` before the row's last live one advanced by M_{16384 (last - u)},
    then the zeros past ``declen`` taken back by the inverse operators of
    their count's two base-128 digits. Per row: the live units' shares
    XORed."""
    b, d_pad = rows.shape
    tabs = torch.from_numpy(TABLES.astype(np.int64))
    n_units = max(1, -(-d_pad // GROUP))
    x = torch.zeros((b, n_units * GROUP), dtype=torch.int64)
    x[:, :d_pad] = rows.to(torch.int64)
    x = x.view(b, n_units, GROUP // RUN, RUN // 4, 4)
    words = x[..., 0] | x[..., 1] << 8 | x[..., 2] << 16 | x[..., 3] << 24
    words[:, 0, 0, 0] ^= _FF
    r = torch.zeros((b, n_units, GROUP // RUN), dtype=torch.int64)
    for i in range(RUN // 4):
        r = _five(tabs, 0, r ^ words[..., i])
    for k in range(LEVELS):
        r = _five(tabs, LEVEL_AT + FIVE * k, r[..., 0::2]) ^ r[..., 1::2]
    r = r[..., 0]
    length = declens.to(torch.int64).clamp(0, d_pad)
    last = (length + GROUP - 1) // GROUP - 1
    tail = GROUP * (last + 1) - length
    u = torch.arange(n_units)[None, :]
    share = torch.where(u < last[:, None],
                        _lookup8(tabs, UNIT_AT + 128 * (last[:, None] - u - 1).clamp(min=0), r), r)
    for step in _tail_steps(tail):
        share = torch.where(step[:, None] >= 0,
                            _lookup8(tabs, INV_AT + 128 * step[:, None].clamp(min=0), share), share)
    share = torch.where(u <= last[:, None], share, 0)
    v = torch.zeros(b, dtype=torch.int64)
    for k in range(n_units):
        v ^= share[:, k]
    crc = v ^ _FF
    crc = (((crc >> 15) | (crc << 17)) + CRC_MASK_DELTA) & _FF
    return torch.where(length == 0, CRC_MASK_DELTA, crc)


def _flatten(rows, d_pad, layout):
    srcs, lens = packing.batch_streams([b for b, _ in rows], None)
    declens = np.asarray([n for _, n in rows], np.int32)
    idx, tmeta, fallb, errs, _ = native.flatten_idx_batch(
        srcs, lens.astype(np.uint64), declens.astype(np.uint64), d_pad, layout=layout)
    assert not fallb.any() and not errs.any()
    return [torch.from_numpy(x) for x in (srcs, idx.view(np.int16), tmeta, declens)]


def _apply(tab: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Eight nibble lookups of the registers ``v`` in the ``(128,)`` table."""
    r = np.zeros_like(v)
    for q in range(8):
        r ^= tab[16 * q + ((v >> (4 * q)) & 15)]
    return r


def _apply5(tab: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Seven 5-bit lookups of the registers ``v`` in the ``(196,)`` table."""
    r = tab[192 + (v >> 30)]
    for c in range(6):
        r = r ^ tab[32 * c + ((v >> (5 * c)) & 31)]
    return r


@pytest.mark.parametrize("layout,d_pad", FLAT_CRC_SHAPES)
def test_decode_flat_crc_on_cpu_is_k2_and_k1(layout, d_pad):
    rows = flat_crc_rows(d_pad)
    a = _flatten(rows, d_pad, layout)
    out, crc = decode_flat.decode_flat_crc(*a, d_pad, layout)
    assert torch.equal(out, decode_flat.decode_flat_plain(*a, d_pad, layout))
    assert torch.equal(crc, crc32c.crc32c_masked_blocks(out, a[3]))
    host = out.numpy()
    for i, (body, n) in enumerate(rows):
        want = jref.decompress(write_varu64(n) + body)
        assert host[i, :n].tobytes() == want
        assert int(crc[i]) == jcrc32c_masked(want)
        assert not host[i, n:].any()


@pytest.mark.parametrize("layout,d_pad", [(0, 8192), (1, 32768)])
def test_decode_flat_crc_on_cpu_is_the_jax_frame_pair(layout, d_pad):
    """The JAX package's frame read on the same rows: its flat gather
    (``decode_flat_pallas`` or ``_v2``, interpret mode), then its masked
    CRC32C of the rows (``ops.crc32c.crc32c_masked_blocks``)."""
    import jax.numpy as jnp
    from snappy_tpu.ops import crc32c as jcrc
    from snappy_tpu.ops.pallas.decode import decode_flat_pallas, decode_flat_pallas_v2

    rows = flat_crc_rows(d_pad)
    a = _flatten(rows, d_pad, layout)
    out, crc = decode_flat.decode_flat_crc(*a, d_pad, layout)
    fn = decode_flat_pallas_v2 if layout else decode_flat_pallas
    want = np.asarray(fn(*(jnp.asarray(t.numpy()) for t in a), d_pad, interpret=True))
    assert np.array_equal(out.numpy(), want)
    assert np.array_equal(crc.numpy(), np.asarray(jcrc.crc32c_masked_blocks(want, a[3].numpy())))


def test_decode_flat_crc_counts_launches_only():
    """The CPU run launches nothing and counts nothing: ``crc_launches``
    never falls and rises only on the card (there with ``launches``);
    ``launch_counts`` reports it as ``flat_gather_crc`` and
    ``reset_launch_counts`` zeroes it."""
    from snappy_tpu_torch.ops import launch_counts, reset_launch_counts

    a = _flatten(flat_crc_rows(16384), 16384, 1)
    before = (decode_flat.crc_launches, decode_flat.launches, decode_flat.layout_launches[1])
    for _ in range(2):
        decode_flat.decode_flat_crc(*a, 16384, 1)
    assert (decode_flat.crc_launches, decode_flat.launches,
            decode_flat.layout_launches[1]) == before
    assert launch_counts()["flat_gather_crc"] == decode_flat.crc_launches
    reset_launch_counts()
    assert decode_flat.crc_launches == 0 and launch_counts()["flat_gather_crc"] == 0


def test_decode_flat_crc_checks_its_arguments():
    rows = flat_crc_rows(16384)
    a = _flatten(rows, 16384, 1)
    with pytest.raises(ValueError):
        decode_flat.decode_flat_crc(*a, 16384 + 1024, 1)
    with pytest.raises(TypeError):
        decode_flat.decode_flat_crc(a[0], a[1].to(torch.int32), *a[2:], 16384, 1)


@pytest.mark.parametrize("first", range(0, 254, 16))
def test_inverse_operators_undo_their_shift(first):
    """The kernel's tables of M_n^-1, n = lo and 128 hi for lo, hi in
    1..127, take back n zero bytes: applied after M_n (the host's columns)
    they give every register back, and before it too."""
    counts = decode_flat.tail_counts()
    assert counts == sorted(set(counts)) and max(counts) < GROUP and len(counts) == 254
    v = np.random.default_rng(3).integers(0, 1 << 32, 1024, dtype=np.uint64)
    v[:3] = (0, 1, 0xFFFFFFFF)
    for k in range(first, min(first + 16, len(counts))):
        n = counts[k]
        inv = TABLES[INV_AT + 128 * k: INV_AT + 128 * (k + 1)].astype(np.uint64)
        fwd = crc32c.nibble_tables(n).reshape(-1).astype(np.uint64)
        assert (_apply(inv, _apply(fwd, v)) == v).all(), n
        assert (_apply(fwd, _apply(inv, v)) == v).all(), n


@pytest.mark.parametrize("part", ["step", "levels", "units"])
def test_shift_tables_match_the_operators(part):
    """The step's table is M_4, level k's M_{128 2^k} (5-bit tables), the
    units' M_{16384 k} (nibble tables): each against the host's columns on
    random registers, 0, 1 and all ones among them."""
    v = np.random.default_rng(5).integers(0, 1 << 32, 512, dtype=np.uint64)
    v[:3] = (0, 1, 0xFFFFFFFF)
    if part == "step":
        tabs, dists, fn = [TABLES[:FIVE]], [4], _apply5
    elif part == "levels":
        tabs = [TABLES[LEVEL_AT + FIVE * k: LEVEL_AT + FIVE * (k + 1)]
                for k in range(decode_flat.LEVELS)]
        dists, fn = [128 << k for k in range(decode_flat.LEVELS)], _apply5
    else:
        tabs = [TABLES[UNIT_AT + 128 * (k - 1): UNIT_AT + 128 * k] for k in range(1, 8)]
        dists, fn = [GROUP * k for k in range(1, 8)], _apply
    for tab, n in zip(tabs, dists):
        want = crc32c._apply_np(crc32c.shift_columns(n), v)
        assert (fn(tab.astype(np.uint64), v) == want).all(), n


@pytest.mark.parametrize("d_pad", [1024, 8192, 16384, 20480, 32768, 49152, 65536, 131072])
def test_unit_combine_walk_matches_k1_plain(d_pad):
    """The kernel's checksum arithmetic, unit by unit and combined, against
    K1's plain version and the JAX package's masked CRC32C on random rows (zeros past declen, as K2 writes
    them) with lengths on and beside every unit's edges, 0, past d_pad and
    below 0."""
    rng = np.random.default_rng(d_pad)
    edges = [e + o for e in range(0, d_pad + 1, GROUP) for o in (-1, 0, 1)]
    lens = np.asarray([n for n in edges if 0 <= n <= d_pad] + [1, 3, 4, 15, 16, d_pad, d_pad + 9, -5]
                      + list(rng.integers(0, d_pad + 1, 8)), np.int32)
    rows = torch.from_numpy(rng.integers(0, 256, (len(lens), d_pad), dtype=np.uint8))
    lens_t = torch.from_numpy(lens)
    live = torch.arange(d_pad)[None, :] < lens_t.clamp(0, d_pad)[:, None].long()
    rows = torch.where(live, rows, 0).to(torch.uint8)
    got = flat_crc_walk(rows, lens_t)
    assert torch.equal(got, crc32c.crc32c_plain(rows, lens_t, masked=True))
    host = rows.numpy()
    assert [int(c) for c in got] == [jcrc32c_masked(host[i, :max(0, min(n, d_pad))].tobytes())
                                     for i, n in enumerate(lens)]


def test_frame_read_on_cpu_takes_the_flat_route_with_its_crcs():
    """decompress_frame on the CPU: every launch group on the flat route,
    the stream back, and a flipped stored checksum raises."""
    data = (load_corpus("html") * 3 + load_corpus("alice29.txt"))[:300000]
    stream = native.frame_compress(data)
    api.routes = []
    try:
        with configure(device="cpu"):
            assert api.decompress_frame(stream) == data
        assert {r[2] for r in api.routes} == {"flat"}
    finally:
        api.routes = None
    bad = bytearray(stream)
    bad[14] ^= 1  # the first chunk's stored CRC (stream identifier 10 bytes, header 4)
    with configure(device="cpu"), pytest.raises(Exception):
        api.decompress_frame(bytes(bad))
