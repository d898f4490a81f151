"""Emission of the flat encoder from its breakpoint plan: kernel K5 and
its split form K6 (``csrc/emit.cu``).

The plan (:func:`snappy_tpu_torch.ops.encode_flat._breakpoints`) makes the
source index of every output byte a step function::

    idx(d) = d + base[g] + sum(dlt[j] * (d >= bp[j]))   over the window
             rows [lo_row[g], lo_row[g] + rows_g[g]) of 128 steps each,
             g = d >> 10

and the compressed row is ``out[d] = src[idx(d)]`` for ``d < out_len``,
zero after, over ``(B, 81920)``; ``src`` is the row's ``[block bytes |
header plane]``. A source index outside ``src`` reads 0 (no output byte
below ``out_len`` has one).

- :func:`fused_emit` (K5) goes from the plan to the bytes in one launch;
- :func:`shift_idx` and :func:`emit_bytes` (K6) are the same two halves in
  two launches: ``idx`` for the groups below ``out_len`` (0 elsewhere), in
  output order, then the gather.

On CUDA tensors the wrappers launch the kernels (or raise); on CPU tensors
they run the plain versions, which take the windowed sum without assuming
any order of the window. The kernels binary-search the window, which relies
on the breakpoints being sorted (the plan's construction), so comparing the
two on the card checks that too; :func:`fused_emit_walk` follows K5's walk
step for step in numpy, so that the CPU tests hold that order too.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import numpy as np
import torch

from . import _build

LANES = 128
GROUP = 1024
N_GROUPS = 80  # output groups of 1024 bytes; 81920 >= the 76800-byte OUT_W
OUT_ROWS_PAD = N_GROUPS * GROUP // LANES  # 640
#: Breakpoint window rows per 1024-byte output group. Wire-format worst
#: case: every record emits >= 2 bytes and <= 3 breakpoints, so a group
#: meets <= 514 records -> <= 1542 breakpoints + 127 of row alignment
#: = 1669 < 14 * 128. No input can overflow this window.
BP_WIN_ROWS = 14

#: K5's walk (csrc/emit.cu): threads a CTA, groups a step, plan rows held.
WALK_THREADS = 256
STEP_GROUPS = WALK_THREADS // 64
RING_ROWS = 32
RUN_GROUPS = 8  # groups a CTA walks

#: Kernel launches per entry since the counts were last reset.
entry_launches = {"fused_emit": 0, "shift_idx": 0, "emit_bytes": 0}


def shift_idx_plain(lo_row, base, rows_g, out_len, bp_rows, dlt_rows):
    """The windowed step sum in PyTorch ops, on any device; ``(B, 81920)``
    int32.

    Every step of a group's window adds its delta at the first output
    position of the group that it reaches (position 0 if it lies below
    the group, none if above), and a prefix sum over the group's 1024
    positions gives each ``d`` the sum of the deltas with ``d >= bp``:
    the literal sum, with no order of the window assumed."""
    b, nrows, _ = bp_rows.shape
    dev = bp_rows.device
    g0 = torch.arange(N_GROUPS, dtype=torch.int32, device=dev)[None, :, None] * GROUP
    rows = rows_g.clamp(0, BP_WIN_ROWS)
    hist = torch.zeros((b, N_GROUPS, GROUP + 1), dtype=torch.int32, device=dev)
    for j in range(BP_WIN_ROWS):
        r = lo_row + j
        ok = (j < rows) & (r < nrows)
        ix = r.clamp(0, nrows - 1).to(torch.int64)[..., None].expand(-1, -1, LANES)
        at = (bp_rows.gather(1, ix) - g0).clamp(0, GROUP).to(torch.int64)
        hist.scatter_add_(2, at, torch.where(ok[..., None], dlt_rows.gather(1, ix), 0))
    d = torch.arange(N_GROUPS * GROUP, dtype=torch.int32, device=dev).view(1, N_GROUPS, GROUP)
    idx = torch.cumsum(hist[..., :GROUP], 2, dtype=torch.int32) + base[..., None] + d
    live = g0[..., 0] < out_len[:, None]
    return torch.where(live[..., None], idx, 0).view(b, N_GROUPS * GROUP)


def fused_emit_walk(lo_row, base, rows_g, out_len, bp_rows, dlt_rows):
    """K5's walk in numpy, step for step: ``(B, 81920)`` int32 source
    indices of the live groups (0 in the rest), as :func:`shift_idx_plain`
    gives them when every window is sorted.

    A row is walked in runs of ``RUN_GROUPS`` groups, each run on its own
    and ``STEP_GROUPS`` groups a step, fewer where the step's
    windows would span more than ``RING_ROWS`` plan rows. The rows the step
    covers are held in a ring (row ``r`` in slot ``r % RING_ROWS``); rows
    it shares with the last step are kept, the rest loaded, their deltas
    taken into an exclusive prefix (uint32) that runs from the last time
    the ring started afresh. Each thread of 16 bytes ``d0 .. d0 + 15``
    binary-searches its group's window for the first steps above ``d0``
    (``k0``) and above ``d0 + 15`` (``k1``, at most ``k0 + 255``), counts
    the steps between at their bytes and sums the counts up, so byte ``i``
    reads the prefix at ``k0`` plus its count (past 254 steps, a search for
    every byte). Every live byte's index is computed, also past
    ``out_len``."""
    lo_row, base, rows_g, out_len = (
        np.asarray(x.cpu(), np.int64) for x in (lo_row, base, rows_g, out_len))
    bsz, nrows, _ = bp_rows.shape
    bp = np.asarray(bp_rows.cpu(), np.int64).reshape(bsz, -1)
    dl = np.asarray(dlt_rows.cpu(), np.int64).reshape(bsz, -1)
    idx = np.zeros((bsz, N_GROUPS * GROUP), np.int64)
    ring_bp = np.zeros(RING_ROWS * LANES, np.int64)
    ring_ex = np.zeros(RING_ROWS * LANES, np.int64)
    mask = (1 << 32) - 1

    def slot(x):
        return (x >> 7) % RING_ROWS * LANES + (x & 127)

    for b, run in itertools.product(range(bsz), range(0, N_GROUPS, RUN_GROUPS)):
        olen = int(out_len[b])
        live = max(min(-(-olen // GROUP), run + RUN_GROUPS, N_GROUPS), run) if olen > 0 else run
        lo = np.clip(lo_row[b, :live], 0, nrows)
        end = np.minimum(lo + np.clip(rows_g[b, :live], 0, BP_WIN_ROWS), nrows)
        r0 = r1 = carry = 0
        g = run
        while g < live:
            n = min(STEP_GROUPS, live - g)
            while True:
                u0, u1 = int(lo[g : g + n].min()), int(end[g : g + n].max())
                if u1 - u0 <= RING_ROWS or n == 1:
                    break
                n -= 1
            if u0 < r0 or u0 > r1:  # no overlap: the ring starts afresh
                r1, carry = u0, 0
            r0 = u0
            if u1 > r1:
                at = np.arange(r1 * LANES, u1 * LANES)
                d = dl[b, at]
                ring_bp[slot(at)] = bp[b, at]
                ring_ex[slot(at)] = (carry + np.cumsum(d) - d) & mask
                carry = (carry + int(d.sum())) & mask
                r1 = u1
            lim = r1 * LANES

            def ex_at(x):
                return int(ring_ex[slot(x)]) if x < lim else carry

            def first_above(lo, hi, d):  # the kernel's binary search
                while lo < hi:
                    mid = (lo + hi) >> 1
                    if ring_bp[slot(mid)] <= d:
                        lo = mid + 1
                    else:
                        hi = mid
                return lo

            for gq in range(g, g + n):
                s, e = int(lo[gq]) * LANES, int(end[gq]) * LANES
                off = int(base[b, gq]) - ex_at(s)
                for d0 in range(gq * GROUP, (gq + 1) * GROUP, 16):
                    k0 = first_above(s, e, d0)
                    k1 = first_above(k0, min(e, k0 + 255), d0 + 15)
                    if k1 < k0 + 255:  # the steps counted at their bytes, summed up
                        count = np.zeros(16, np.int64)
                        for j in range(k0, k1):  # at is 1..15 in a sorted window
                            at = int(ring_bp[slot(j)]) - d0
                            count[(at & 7) + (8 if at >= 8 else 0)] += 1
                        ks = k0 + np.cumsum(count)
                    else:
                        ks = [first_above(s, e, d) for d in range(d0, d0 + 16)]
                    o = np.array([ex_at(int(k)) for k in ks], np.int64)
                    idx[b, d0 : d0 + 16] = (np.arange(d0, d0 + 16) + off + o) & mask
            g += n
    return torch.from_numpy(idx.astype(np.uint32).view(np.int32))


def emit_bytes_plain(src, idx, out_len):
    """``src[idx]`` below ``out_len``, 0 after, in PyTorch ops."""
    d = torch.arange(idx.shape[1], device=idx.device)
    ok = (d[None, :] < out_len[:, None]) & (idx >= 0) & (idx < src.shape[1])
    val = src.gather(1, idx.clamp(0, src.shape[1] - 1).to(torch.int64))
    return torch.where(ok, val, 0).to(torch.uint8)


#: Edge lengths of K6's gather: none, one byte, around a 16-byte store,
#: around a 1,024-byte group, and the whole 81,920-byte row.
EDGE_LENS = (0, 1, 15, 16, 17, 1023, 1025, 81920)


def edge_batch(out_lens, device, seed: int = 3, src_w: int = 70001):
    """Inputs of :func:`emit_bytes` on edge rows: ``(src (B, src_w) uint8,
    idx (B, 81920) int32, out_len (B,) int32)`` with the given ``out_lens``,
    made on ``device`` from ``seed``. Indices are drawn from ``[-2, src_w +
    2)``, so some fall outside the row, and every row has -1, ``src_w`` and
    ``src_w - 1`` at its first three bytes and last two. The width is odd,
    so rows start at every alignment."""
    b = len(out_lens)
    g = torch.Generator(device=device).manual_seed(seed)
    src = torch.randint(0, 256, (b, src_w), generator=g, device=device, dtype=torch.uint8)
    idx = torch.randint(-2, src_w + 2, (b, N_GROUPS * GROUP), generator=g, device=device,
                        dtype=torch.int32)
    idx[:, :3] = torch.tensor([-1, src_w, src_w - 1], dtype=torch.int32)
    idx[:, -2:] = torch.tensor([src_w, src_w - 1], dtype=torch.int32)
    out_len = torch.tensor(list(out_lens), dtype=torch.int32, device=device)
    return src, idx, out_len


def fused_emit_plain(lo_row, base, rows_g, out_len, bp_rows, dlt_rows, src):
    """K5's function as K6's two plain halves."""
    idx = shift_idx_plain(lo_row, base, rows_g, out_len, bp_rows, dlt_rows)
    return emit_bytes_plain(src, idx, out_len)


@functools.cache
def _kernel(name: str):
    fn = getattr(_build.kernel_lib("emit"), f"stpu_cuda_{name}")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = {
        "fused_emit": [p, p, p, p, p, p, i64, p, i64, i64, p, p],
        "shift_idx": [p, p, p, p, p, p, i64, i64, p, p],
        "emit_bytes": [p, p, p, i64, i64, p, p],
    }[name]
    fn.restype = ctypes.c_int
    return fn


def _check(tensors: dict, dtypes: dict, shapes: dict):
    for name, t in tensors.items():
        if t.dtype != dtypes[name]:
            raise TypeError(f"{name} must be {dtypes[name]}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must have shape {shapes[name]}, got {tuple(t.shape)}")
    dev = next(iter(tensors.values())).device
    if any(t.device != dev for t in tensors.values()):
        raise ValueError("all inputs must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not all(t.is_contiguous() for t in tensors.values()):
            raise ValueError("inputs must be contiguous")
        if "idx" in tensors and tensors["idx"].data_ptr() % 16:
            raise ValueError("idx must be 16-byte aligned (the kernel reads it as int4)")
        if next(iter(tensors.values())).shape[0] > 65535:
            raise ValueError("more rows than one launch's grid")
    return dev


def _plan_specs(lo_row, bp_rows):
    b, nrows = lo_row.shape[0], bp_rows.shape[1]
    i32 = torch.int32
    dtypes = dict.fromkeys(("lo_row", "base", "rows_g", "out_len", "bp_rows", "dlt_rows"), i32)
    shapes = {
        "lo_row": (b, N_GROUPS), "base": (b, N_GROUPS), "rows_g": (b, N_GROUPS),
        "out_len": (b,), "bp_rows": (b, nrows, LANES), "dlt_rows": (b, nrows, LANES),
    }
    return dtypes, shapes


def _count(name: str) -> None:
    _build.count(entry_launches, name)


def fused_emit(lo_row, base, rows_g, out_len, bp_rows, dlt_rows, src):
    """K5: ``(B, 81920)`` uint8 compressed rows from the plan.

    ``lo_row``, ``base``, ``rows_g``: ``(B, 80)`` int32 per-group window;
    ``out_len``: ``(B,)`` int32; ``bp_rows``, ``dlt_rows``: ``(B, R, 128)``
    int32 steps; ``src``: ``(B, W)`` uint8 ``[block | header plane]``.
    """
    plan = dict(lo_row=lo_row, base=base, rows_g=rows_g, out_len=out_len,
                bp_rows=bp_rows, dlt_rows=dlt_rows)
    dtypes, shapes = _plan_specs(lo_row, bp_rows)
    dev = _check({**plan, "src": src}, {**dtypes, "src": torch.uint8},
                 {**shapes, "src": (lo_row.shape[0], src.shape[1])})
    if dev.type == "cpu":
        return fused_emit_plain(lo_row, base, rows_g, out_len, bp_rows, dlt_rows, src)
    b = lo_row.shape[0]
    out = torch.empty((b, N_GROUPS * GROUP), dtype=torch.uint8, device=dev)
    if b == 0:
        return out
    _count("fused_emit")
    _build.launch(
        dev, "fused_emit", _kernel("fused_emit"),
        lo_row.data_ptr(), base.data_ptr(), rows_g.data_ptr(), out_len.data_ptr(),
        bp_rows.data_ptr(), dlt_rows.data_ptr(), bp_rows.shape[1] * LANES,
        src.data_ptr(), src.shape[1], b, out.data_ptr(),
    )
    return out


def shift_idx(lo_row, base, rows_g, out_len, bp_rows, dlt_rows):
    """K6, first half: ``(B, 81920)`` int32 source indices, in output order,
    for the groups below ``out_len`` and 0 in the rest."""
    plan = dict(lo_row=lo_row, base=base, rows_g=rows_g, out_len=out_len,
                bp_rows=bp_rows, dlt_rows=dlt_rows)
    dev = _check(plan, *_plan_specs(lo_row, bp_rows))
    if dev.type == "cpu":
        return shift_idx_plain(lo_row, base, rows_g, out_len, bp_rows, dlt_rows)
    b = lo_row.shape[0]
    idx = torch.empty((b, N_GROUPS * GROUP), dtype=torch.int32, device=dev)
    if b == 0:
        return idx
    _count("shift_idx")
    _build.launch(
        dev, "shift_idx", _kernel("shift_idx"),
        lo_row.data_ptr(), base.data_ptr(), rows_g.data_ptr(), out_len.data_ptr(),
        bp_rows.data_ptr(), dlt_rows.data_ptr(), bp_rows.shape[1] * LANES,
        b, idx.data_ptr(),
    )
    return idx


def emit_bytes(src, idx, out_len):
    """K6, second half: ``(B, 81920)`` uint8, ``src[idx]`` below ``out_len``."""
    b = idx.shape[0]
    dev = _check(
        {"src": src, "idx": idx, "out_len": out_len},
        {"src": torch.uint8, "idx": torch.int32, "out_len": torch.int32},
        {"src": (b, src.shape[1]), "idx": (b, N_GROUPS * GROUP), "out_len": (b,)},
    )
    if dev.type == "cpu":
        return emit_bytes_plain(src, idx, out_len)
    out = torch.empty((b, N_GROUPS * GROUP), dtype=torch.uint8, device=dev)
    if b == 0:
        return out
    _count("emit_bytes")
    _build.launch(
        dev, "emit_bytes", _kernel("emit_bytes"),
        idx.data_ptr(), out_len.data_ptr(), src.data_ptr(), src.shape[1], b, out.data_ptr(),
    )
    return out
