"""What the flat-gather kernel (K2, K11; ``csrc/flat_gather.cu``) reads and
where it writes, on the CPU.

The kernel has no CPU mode, so its arithmetic is followed here in numpy,
CTA by CTA (a row's 16 KiB unit of output): each chunk of 8 indices, its
tile's clamped base, the bounds that decide whether a byte reads its
source position (the row, the window, ``declen``), the byte's place in the
swizzled output tile and the tile's way out. Every tile byte must be
written once and read back once, and the result must equal the plain
version, on: the host flatten's indices of corpus chunks (both
layouts, with a row of declen 0), K11's buckets (the flatten's and
hand-made), a raw stream whose body passes 64 KiB, rows of the 81,920-byte
width, the chain-resolution route's planes (``ops/resolve.py``
``idx_to_v2_inputs``) and bases past either end of the row. Bytes:
equality.
"""

import numpy as np
import pytest
import torch

from conftest import load_corpus
from snappy_tpu_torch import native
from snappy_tpu_torch.ops import decode_flat, packing, resolve
from torch_vectors import (
    hold_jax_native, literal, raw_body, resolve_cases, scan_batch, share_cores_with_workers,
    wide_stream,
)

share_cores_with_workers()
hold_jax_native()

GROUP = decode_flat.GROUP
CHUNKS = [
    load_corpus("html")[:65536],
    load_corpus("plrabn12.txt")[:65536],
    load_corpus("fireworks.jpeg")[:40000],
    load_corpus("paper-100k.pdf")[:65536],
    b"ab" * 20000,
    bytes(65536),
    load_corpus("kppkn.gtb")[:61234],
    b"",
]


def _swz(q):
    return q ^ ((q >> 6) & 7)


def kernel_model(srcs, idx, tmeta, declens, d_pad, layout, gbuck=None, variant=4):
    """The kernel's output, computed with its own arithmetic."""
    b, s = srcs.shape
    u16 = idx.view(np.uint16).astype(np.int64)
    step, k = (128 if layout else 1), np.arange(8)
    widths = decode_flat.window_rows(s // 128)
    out = np.zeros((b, d_pad), np.uint8)
    for row in range(b):
        for unit in range(-(-d_pad // GROUP)):
            g0 = unit * GROUP
            n_chunks = min(GROUP, d_pad - g0) // 8
            lim = int(declens[row]) - g0
            live, wlim = lim > 0, 1 << 16
            if gbuck is not None:
                gb = int(gbuck[row, unit])
                live = live and (0 <= gb <= 2 if variant == 3 else gb >= 0)
                wlim = widths[min(max(gb, 0), 2)] * 128
            if not live:
                continue
            c = np.arange(n_chunks)
            r = u16[row, g0 : g0 + 8 * n_chunks].reshape(n_chunks, 8)
            m = tmeta[row, g0 // 1024 + (c & 15 if layout else c >> 7), 0].astype(np.int64)
            base = np.clip(m, -513, s // 128 + 1)[:, None] * 128
            t, col = c & 15, c >> 4
            d0 = t * 1024 + col if layout else c * 8
            a0 = (t * 1024 + (((col >> 4) ^ (t & 7)) << 4) + (col & 15) if layout
                  else (_swz(c >> 1) << 4) + (c & 1) * 8)
            rlo = np.maximum(0, -base)
            rn = np.maximum(0, np.minimum(s - base, wlim) - rlo)
            dlim = min(lim, n_chunks * 8) - d0[:, None]
            ok = (r - rlo >= 0) & (r - rlo < rn) & (k * step < dlim)
            x = np.where(ok, srcs[row, np.clip(base + r, 0, s - 1)], 0)
            addr = a0[:, None] + k * step
            assert len(np.unique(addr)) == addr.size
            tile = np.full(8 * n_chunks, -1)
            tile[addr] = x
            back = tile.reshape(-1, 16)[_swz(np.arange(n_chunks // 2))].ravel()
            assert (back >= 0).all()
            out[row, g0 : g0 + back.size] = back
    return out


def _flattened(rows, d_pad, layout, width=None):
    srcs, lens = packing.batch_streams([body for body, _ in rows], width)
    declens = np.asarray([n for _, n in rows], np.int32)
    idx, tmeta, fallb, errs, _ = native.flatten_idx_batch(
        srcs, lens.astype(np.uint64), declens.astype(np.uint64), d_pad, layout=layout)
    assert not fallb.any() and not errs.any()
    return srcs, idx, tmeta, declens


def _check(srcs, idx, tmeta, declens, d_pad, layout, gbuck=None, variant=4):
    t = [torch.from_numpy(x) for x in (srcs, idx.view(np.int16), tmeta, declens)]
    if gbuck is None:
        want = decode_flat.decode_flat_plain(*t, d_pad, layout)
    else:
        want = decode_flat.decode_flat_grouped_plain(
            *t[:3], torch.from_numpy(gbuck), t[3], d_pad, variant)
    got = kernel_model(srcs, idx, tmeta, declens, d_pad, layout, gbuck, variant)
    np.testing.assert_array_equal(got, want.numpy())


def _noise(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("layout", [0, 1])
def test_corpus_chunks(layout):
    datas = CHUNKS if layout else [c[:7000] for c in CHUNKS]
    d_pad = 65536 if layout else 7168
    _check(*_flattened([raw_body(d) for d in datas], d_pad, layout), d_pad, layout)


def test_grouped_buckets():
    """K11 under the flatten's buckets and hand-made ones (a dead group, a
    3, the wider groups cut to the narrow window)."""
    srcs, idx, tmeta, declens = _flattened([raw_body(d) for d in CHUNKS], 65536, 1)
    gb = decode_flat.group_buckets(torch.from_numpy(tmeta), torch.from_numpy(declens), 65536)
    hand = gb.clone()
    hand[gb > 0] = 0
    hand[0, 0], hand[1, 1] = -1, 3
    for g in (gb, hand):
        for variant in (3, 4):
            _check(srcs, idx, tmeta, declens, 65536, 1, g.numpy(), variant)


@pytest.mark.parametrize("layout", [0, 1])
def test_wide_stream(layout):
    """Two blocks of the wide stream, and in layout 0 a 1000-byte literal
    more, so that ``d_pad`` is not whole 16 KiB."""
    body, declen = wide_stream(2)
    if not layout:
        body, declen = body + literal(bytes(range(200)) * 5), declen + 1000
    d_pad = -(-declen // 1024) * 1024
    assert len(body) > 65536 and (d_pad % 16384 == 0) == bool(layout)
    _check(*_flattened([(body, declen)], d_pad, layout), d_pad, layout)


@pytest.mark.parametrize("layout", [0, 1])
def test_rows_of_81920_bytes(layout):
    noise = _noise(65536)
    rows = [raw_body(noise), raw_body(noise[::-1]), raw_body(CHUNKS[0]), (b"", 0)]
    assert len(rows[0][0]) > 65536
    d_pad = 65536 if layout else 66560
    _check(*_flattened(rows, d_pad, layout, 81920), d_pad, layout)


def test_resolve_route_planes():
    """The chain-resolution route's planes at ``d_pad`` 65536, with a block
    of the wide stream."""
    rows = [raw_body(c) for c in resolve_cases()] + [wide_stream(1)]
    srcs, lens, declens, recs, nops, errs = scan_batch(rows)
    assert not errs.any()
    a = resolve.resolve_reference(resolve.records_to_pointers(
        *(torch.from_numpy(x) for x in (recs, nops, declens)), 65536))
    idx, tmeta, fallback = resolve.idx_to_v2_inputs(
        a, torch.from_numpy(declens), 65536, srcs.shape[1] // 128)
    assert not fallback.any()
    _check(srcs, idx.numpy(), tmeta.numpy(), declens, 65536, 1)


@pytest.mark.parametrize("layout", [0, 1])
def test_bases_past_the_row(layout):
    """Random indices under bases below 0 and past the row's end: the
    kernel's clamped bases read exactly the plain version's positions."""
    rng = np.random.default_rng(17)
    b, s, d_pad = 3, 4096, 32768 if layout else 19456
    srcs = rng.integers(0, 256, (b, s), dtype=np.uint8)
    idx = rng.integers(0, 1 << 16, (b, d_pad), dtype=np.uint16)
    idx[:, ::7] = rng.integers(0, 600, (b, len(range(0, d_pad, 7))))
    tmeta = np.zeros((b, d_pad // 1024, 2), np.int32)
    tmeta[:, :, 0] = rng.choice([-100000, -600, -513, -512, -3, 0, 5, 31, 32, 33, 900, 1 << 20],
                                (b, d_pad // 1024))
    declens = np.asarray([d_pad, d_pad - 5000, 1], np.int32)
    _check(srcs, idx, tmeta, declens, d_pad, layout)
