"""Segment parse of the flat encoder: kernel K4 (``csrc/parse.cu``).

With pure-greedy acceptance the parse decision at a position depends only
on precomputed positional data (the jump words of
:func:`snappy_tpu_torch.ops.encode_flat.prepass`), never on the parser's
history. So each 512-byte segment of a 64 KiB block is walked on its own:
scan the jump word at ``p``; a candidate starts its match extension in
the same step, a non-candidate hops to the next candidate; an extension
compares four bytes at ``(p + lp, p + lp - off)`` per step and records
the copy ``(p - seg_base) | len << 10, offset`` when it stops.

``parse_blocks(lens, jw, blocks)`` returns ``(rec0, rec1, cnt)``:
``(B, 128, MAX_REC)`` int32 records, zero in unused slots, and ``(B, 128,
8)`` int32 with the per-segment record count in column 0 and the
overflow flag ``count >= MAX_REC`` in column 1, exactly as the JAX
package's ``parse_blocks_pallas`` does.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs :func:`parse_blocks_plain`, the Pallas body's lockstep
loop over ``(B, 128)`` lane state in PyTorch ops.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

S = 65536
SEG = 512
NSEG = S // SEG  # 128 segments per block
LANES = 128

#: Copy records per segment. A copy is at least 4 bytes, so a 512-byte
#: segment holds at most 128; a segment that fills all 144 slots is
#: flagged all the same.
MAX_REC = 144

#: Jump-word layout (one int32 per position, segment layout):
#:   candidate:      bit 27 = 1, bits [0,16) = offset,
#:                   bits [16,26) = capped length estimate
#:   non-candidate:  bits [0,10) = next-candidate column within segment
#:                   (SEG when none: the walk parks at the segment end)
JW_CAND = 1 << 27

#: Kernel launches since the count was last reset (main-path evidence).
launches = 0


def _tz_bytes(x):
    """Whole zero bytes at the bottom of ``x`` (4 when ``x == 0``)."""
    return torch.where(
        x & 0xFF != 0, 0,
        torch.where(x & 0xFFFF != 0, 1,
                    torch.where(x & 0xFFFFFF != 0, 2, torch.where(x != 0, 3, 4))),
    ).to(torch.int32)


def parse_lockstep(lens, jw, blocks):
    """The Pallas body's lockstep walk in PyTorch ops, on any device.

    Returns ``(rec0, rec1, cnt, lane_steps, seg_steps)``: the records as
    :func:`parse_blocks` returns them, the number of (segment, iteration)
    pairs in which a walk was live (the work the kernel does), and each
    segment's own steps, ``(B, 128)`` int64 (its walk's length: a block's
    longest walk bounds its thread block).
    """
    b = lens.shape[0]
    dev = jw.device
    n = lens.to(torch.int32)
    lo = (torch.arange(NSEG, device=dev, dtype=torch.int32) * SEG).expand(b, NSEG)
    hi = torch.minimum(lo + SEG, n[:, None])
    wide = torch.cat(
        [blocks.to(torch.int64), torch.zeros((b, 4), dtype=torch.int64, device=dev)], dim=1
    )

    def u32_at(pos):
        pos = pos.to(torch.int64)
        return (
            wide.gather(1, pos) | wide.gather(1, pos + 1) << 8
            | wide.gather(1, pos + 2) << 16 | wide.gather(1, pos + 3) << 24
        )

    zero = torch.zeros((b, NSEG), dtype=torch.int32, device=dev)
    p, mode, lp, k = lo.clone(), zero, zero, zero
    offc = torch.ones_like(zero)
    rec0 = torch.zeros((b, NSEG, MAX_REC), dtype=torch.int32, device=dev)
    rec1 = torch.zeros_like(rec0)
    seg_steps = torch.zeros((b, NSEG), dtype=torch.int64, device=dev)
    while True:
        alive = p < hi
        if not bool(alive.any()):
            break
        seg_steps += alive
        scan_m = alive & (mode == 0)

        # scan: the jump word at p (column clipped as the Pallas read is)
        col = (p - lo).clamp(0, SEG - 1).to(torch.int64)
        jwv = jw.gather(2, col[..., None])[..., 0]
        cand = (jwv & JW_CAND) != 0
        start_ext = scan_m & cand
        lp = torch.where(start_ext, (jwv >> 16) & 0x3FF, lp)
        offc = torch.where(start_ext, jwv & 0xFFFF, offc)
        ext_m = alive & ((mode == 1) | start_ext)

        # extension: four bytes at (p + lp, q = p + lp - off); the q read
        # clips its row to the block as the byte-plane routing does
        a_p = p + lp
        u32p = u32_at(lo + (a_p - lo).clamp(0, SEG - 1))
        a = (a_p - offc).clamp(min=0)
        u32q = u32_at((a >> 7).clamp(0, 511) * LANES + (a & 127))
        adv = torch.minimum(_tz_bytes(u32p ^ u32q), (hi - a_p).clamp(min=0))
        new_lp = lp + torch.where(ext_m, adv, 0)
        ext_done = ext_m & ((adv < 4) | (p + new_lp >= hi))

        # record the finished copy in column k
        rec_ok = ext_done & (k < MAX_REC)
        kk = k.clamp(0, MAX_REC - 1).to(torch.int64)[..., None]
        v0 = (p - lo) | (new_lp << 10)
        rec0.scatter_(2, kk, torch.where(rec_ok, v0, rec0.gather(2, kk)[..., 0])[..., None])
        rec1.scatter_(2, kk, torch.where(rec_ok, offc, rec1.gather(2, kk)[..., 0])[..., None])

        hop = scan_m & ~cand
        p2 = torch.where(ext_done, p + new_lp, torch.where(hop, lo + (jwv & 0x3FF), p))
        p = torch.where(ext_done & (k >= MAX_REC), hi, p2)  # a full segment parks
        mode = torch.where(ext_done, 0, torch.where(start_ext, 1, mode))
        lp = torch.where(ext_done, 0, new_lp)
        k = k + rec_ok.to(torch.int32)
    cnt = torch.zeros((b, NSEG, 8), dtype=torch.int32, device=dev)
    cnt[..., 0] = k
    cnt[..., 1] = (k >= MAX_REC).to(torch.int32)
    return rec0, rec1, cnt, int(seg_steps.sum()), seg_steps


def parse_blocks_plain(lens, jw, blocks):
    """:func:`parse_lockstep` without the step counts."""
    return parse_lockstep(lens, jw, blocks)[:3]


@functools.cache
def _kernel():
    fn = _build.kernel_lib("parse").stpu_cuda_parse
    p = ctypes.c_void_p
    fn.argtypes = [p, p, p, ctypes.c_int64, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def parse_blocks(lens, jw, blocks):
    """Walk every segment of ``(B, 65536)`` uint8 ``blocks``.

    ``lens``: ``(B,)`` int32 block lengths; ``jw``: ``(B, 128, 512)``
    int32 jump words from the prepass. A CUDA input launches the kernel
    (or raises); a CPU input runs :func:`parse_blocks_plain`.
    """
    b = lens.shape[0]
    if lens.dtype != torch.int32 or jw.dtype != torch.int32 or blocks.dtype != torch.uint8:
        raise TypeError("lens and jw must be int32 and blocks uint8")
    if lens.shape != (b,) or jw.shape != (b, NSEG, SEG) or blocks.shape != (b, S):
        raise ValueError(
            f"expected lens (B,), jw (B, {NSEG}, {SEG}) and blocks (B, {S}); got "
            f"{tuple(lens.shape)}, {tuple(jw.shape)}, {tuple(blocks.shape)}"
        )
    tensors = (lens, jw, blocks)
    if any(t.device != blocks.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if blocks.device.type == "cpu":
        return parse_blocks_plain(lens, jw, blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"unsupported device {blocks.device}")
    if not all(t.is_contiguous() for t in tensors) or blocks.data_ptr() % 16:
        raise ValueError("inputs must be contiguous and blocks 16-byte aligned")
    rec0 = torch.empty((b, NSEG, MAX_REC), dtype=torch.int32, device=blocks.device)
    rec1 = torch.empty_like(rec0)
    cnt = torch.empty((b, NSEG, 8), dtype=torch.int32, device=blocks.device)
    if b == 0:
        return rec0, rec1, cnt
    if b > 2**31 - 1:
        raise ValueError(f"{b} rows exceed one launch's grid")
    _build.count(globals(), "launches")
    _build.launch(
        blocks.device, "parse", _kernel(),
        lens.data_ptr(), jw.data_ptr(), blocks.data_ptr(), b,
        rec0.data_ptr(), rec1.data_ptr(), cnt.data_ptr(),
    )
    return rec0, rec1, cnt
