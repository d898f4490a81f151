"""Fast parallel compression in tensor ops (valid Snappy, not the
reference's bytes).

The port of the JAX package's ``ops/encode_fast.py``; it has no Pallas
kernel. It is ``compress(profile="fast")``'s codec under
``Config.flat_encode=False``, the frame encoder's ``fast=True`` codec and
the flat encoder's route for a block it flags. Per 64 KiB block:

1. **Previous-occurrence candidates**: every position's nearest previous
   occurrence of its 4-gram, for all positions at once, from one sort of
   ``gram << 16 | position`` (``encode_flat._prev_two_sorts``).
2. **Match lengths**: each position extends against its candidate four
   bytes per round, up to a 256-byte cap, while any lane in the batch is
   still matching.
3. **Greedy parse by pointer doubling**: ``next[p] = p + (L(p) if
   eligible else 1)``; the op boundaries are the orbit of 0; single-byte
   literal positions merge into runs and ops compact by a prefix sum.

The ops go through the exact encoder's serializer
(:func:`.encode.serialize_ops`). The output equals the JAX package's
``compress_blocks_fast`` byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch

from ..format.constants import MIN_NON_LITERAL_BLOCK_SIZE
from ..trace import span
from .encode import MAX_OPS, S, serialize_ops, u32_plane
from .encode_flat import _prev_two_sorts, _rev_cummin
from .parse import _tz_bytes

_MAX_COPY = 256  # per-op match cap; the serializer peels 64-byte copy tags
_NCHUNK = _MAX_COPY // 4

I32 = torch.int32
I64 = torch.int64


def _match_lengths(u32, prev, n):
    """Match length (0, or 4.._MAX_COPY) of each position against its
    candidate; the rounds stop as soon as no lane in the batch matches."""
    p = torch.arange(S, dtype=I64, device=u32.device).expand(prev.shape)
    q = prev.clamp(min=0).to(I64)
    top = u32.shape[1] - 1
    length = torch.zeros(prev.shape, dtype=I32, device=u32.device)
    alive = prev >= 0
    for i in range(_NCHUNK):
        if not bool(alive.any()):
            break
        x = u32.gather(1, (p + 4 * i).clamp(max=top)) ^ u32.gather(1, (q + 4 * i).clamp(max=top))
        eq = x == 0
        length = length + torch.where(alive, torch.where(eq, 4, _tz_bytes(x)), 0).to(I32)
        alive = alive & eq
    length = torch.minimum(length, n[:, None] - p[:1].to(I32))
    return torch.where((prev >= 0) & (length >= 4), length, 0)


def _orbit(next_, n_rounds):
    """Mark the orbit of position 0 under ``next_`` (``(B, S + 1)``)."""
    jump = next_.to(I64)
    mark = torch.zeros(next_.shape, dtype=I32, device=next_.device)
    mark[:, 0] = 1
    for _ in range(n_rounds):
        mark = mark.scatter_reduce(1, jump, mark, "amax")
        jump2 = jump.gather(1, jump)
        converged = bool(torch.equal(jump2, jump))
        jump = jump2
        if converged:
            break
    return mark == 1


def compress_blocks_fast(blocks, lengths):
    """Fast-parse compress of a ``(B, 65536)`` uint8 block batch on its
    device.

    Returns ``(out (B, OUT_W) uint8, out_len (B,) int32)``: valid raw
    Snappy per block, byte for byte the JAX package's
    ``compress_blocks_fast``."""
    bsz = blocks.shape[0]
    dev = blocks.device
    n = lengths.to(I32)
    p = torch.arange(S, dtype=I32, device=dev)[None, :]

    u32 = u32_plane(blocks, _MAX_COPY + 8)
    prev = _prev_two_sorts(u32[:, :S], n)
    length = _match_lengths(u32, prev, n)
    del u32

    # Tiny blocks are a single literal.
    tiny = n < MIN_NON_LITERAL_BLOCK_SIZE
    length = torch.where(tiny[:, None], 0, length)

    # One-step lazy matching, and no isolated 4-byte copy2 inside a run.
    zero1 = torch.zeros((bsz, 1), dtype=I32, device=dev)
    nxt_len = torch.cat([length[:, 1:], zero1], 1)
    offs = p - prev.clamp(min=0)
    len_p4 = torch.cat([length[:, 4:], zero1.expand(bsz, 4)], 1)
    isolated = (length == 4) & (offs > 2047) & (len_p4 < 4)
    eligible = (length >= 4) & ~isolated & ~(nxt_len > length)
    live = p < n[:, None]
    step = torch.where(eligible, length, 1)
    nxt = torch.where(live, torch.minimum(p + step, torch.tensor(S, dtype=I32, device=dev)), p)
    nxt = torch.cat([nxt, torch.full((bsz, 1), S, dtype=I32, device=dev)], 1)

    mark = _orbit(nxt, max(1, (S - 1).bit_length()))[:, :S] & live

    is_copy = mark & eligible
    is_lit = mark & ~eligible
    prev_lit = torch.cat([torch.zeros((bsz, 1), dtype=torch.bool, device=dev), is_lit[:, :-1]], 1)
    lit_start = is_lit & ~prev_lit

    # A literal run ends at the next copy start at or after p (else n).
    copy_pos = torch.where(is_copy, p, S)
    run_end = torch.minimum(_rev_cummin(copy_pos), n[:, None])

    record = is_copy | lit_start
    rec = record.to(I32)
    opnum = torch.cumsum(rec, 1, dtype=I32) - rec
    nops = rec.sum(1, dtype=I32)

    kind_v = is_copy.to(I32)
    a_v = torch.where(is_copy, p - prev, p)
    b_v = torch.where(is_copy, length, run_end)
    tgt = torch.where(record, opnum.clamp(max=MAX_OPS - 1), MAX_OPS).to(I64)

    def scat_ops(vals):
        buf = torch.zeros((bsz, MAX_OPS + 1), dtype=I32, device=dev)
        return buf.scatter_(1, tgt, vals)[:, :MAX_OPS]

    return serialize_ops(blocks, scat_ops(kind_v), scat_ops(a_v), scat_ops(b_v), nops)


def compress_blocks_fast_host(blocks: np.ndarray, lengths: np.ndarray, device):
    """Host-facing wrapper (the JAX package's ``compress_blocks_fast_host``):
    numpy blocks and lengths in, numpy ``(out, out_len)`` out, computed on
    ``device``."""
    dev = torch.device(device)
    with span("h2d"):
        blocks_t = torch.from_numpy(np.ascontiguousarray(blocks, np.uint8)).to(dev)
        lens_t = torch.from_numpy(np.asarray(lengths, np.int32)).to(dev)
    with span("tensor", dev):
        out, out_len = compress_blocks_fast(blocks_t, lens_t)
    with span("d2h"):
        return out.cpu().numpy(), out_len.cpu().numpy()
