"""Record-replay decode of raw op streams: kernel K10 (``csrc/records.cu``).

``decode_records(srcs, recs, nops, declens, d_pad)`` replays the op records
of ``native.scan_records_batch`` (``w0 = len | literal << 30``; ``w1`` the
content index of a literal or the offset of a copy) into ``(B, d_pad)``
uint8 rows, as the JAX package's ``decode_records_pallas`` does: the bytes
of the first ``nops`` records, zeros from there to ``d_pad``. The scan has
validated every op, and its error codes go with the rows: a corrupt row
keeps its valid prefix.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs :func:`decode_records_plain`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: Kernel launches since the count was last reset (main-path evidence).
launches = 0


def _first_hops(srcs, recs, nops, declens, d_pad: int):
    """Each output byte's first hop, ``(val, lit, live)``: a literal byte's
    source index, a copied byte's earlier position ``start - off + (j mod
    off)``; whether it is a literal byte; whether it is written at all."""
    b = srcs.shape[0]
    cap = recs.shape[1]
    dev = srcs.device
    w0 = recs[:, :, 0].to(torch.int64)
    w1 = recs[:, :, 1].to(torch.int64)
    valid = torch.arange(cap, device=dev)[None, :] < nops.to(torch.int64)[:, None]
    ln = torch.where(valid, w0 & 0x3FFFFFFF, 0)
    islit = ((w0 >> 30) & 1) == 1
    ends = torch.cumsum(ln, dim=1)
    total = ends[:, -1:] if cap else torch.zeros((b, 1), dtype=torch.int64, device=dev)
    starts = torch.where(valid, ends - ln, total)  # past nops: never cover a live byte
    d = torch.arange(d_pad, device=dev).expand(b, d_pad)
    lim = torch.minimum(declens.to(torch.int64)[:, None], total)
    live = d < lim
    r = torch.searchsorted(starts.contiguous(), d.contiguous(), right=True) - 1
    r = r.clamp(0, max(cap - 1, 0))
    if cap:
        start, off, lit = starts.gather(1, r), w1.gather(1, r), islit.gather(1, r)
    else:
        start = off = torch.zeros_like(d)
        lit = torch.zeros_like(d, dtype=torch.bool)
    j = d - start
    return torch.where(lit, off + j, start - off + j % off.clamp(min=1)), lit, live


def decode_records_plain(srcs, recs, nops, declens, d_pad: int):
    """K10's plain version, in tensor ops with no loop over ops: each byte's
    covering record by ``searchsorted`` over the record starts; its first
    hop, a source index for a literal or an earlier position
    ``start - off + (j mod off)`` for a copy; pointer doubling to the
    literal origin (int64 planes and a resolved mask, so rows up to
    ``max_dpad`` fit); a gather from ``srcs``; zeros at and past
    ``min(declen, the records' total length)``."""
    s = srcs.shape[1]
    val, lit, live = _first_hops(srcs, recs, nops, declens, d_pad)
    done = lit | ~live
    for _ in range(max(1, d_pad.bit_length()) + 1):
        if bool(done.all()):
            break
        tgt = torch.where(done, 0, val).clamp(0, d_pad - 1)
        val = torch.where(done, val, val.gather(1, tgt))
        done = done | done.gather(1, tgt)
    out = srcs.gather(1, torch.where(live, val, 0).clamp(0, max(s - 1, 0)))
    return torch.where(live, out, 0).to(torch.uint8)


def window_rounds(srcs, recs, nops, declens, d_pad: int, window: int = 4096):
    """K10's doubling as its CTA path takes it, window by window in order:
    a hop that leaves the window reads its origin there at once, and
    doubling rounds settle the chains inside the window. Returns each
    row's rounds summed over its windows, ``(B,)`` int64, taking every
    round all at once (the kernel doubles in place, which can only end
    sooner)."""
    val, lit, live = _first_hops(srcs, recs, nops, declens, d_pad)
    pos = torch.arange(d_pad, device=srcs.device).expand_as(val)
    hop = torch.where(lit | ~live, pos, val)
    rounds = torch.zeros(srcs.shape[0], dtype=torch.int64, device=srcs.device)
    for base in range(0, d_pad, window):
        h = hop[:, base : base + window]
        h = torch.where(h < base, hop.gather(1, h.clamp(0, d_pad - 1)), h)
        hop[:, base : base + window] = h  # the kernel stores these before doubling
        p = pos[:, base : base + window]
        open_ = (h >= base) & (h != p)
        while bool(open_.any()):
            rounds += open_.any(1).to(torch.int64)
            h2 = hop.gather(1, h)
            root = h2 == h
            h = torch.where(open_ & ~root, h2, h)
            open_ = open_ & ~root & (h >= base)
            hop[:, base : base + window] = h
        hop[:, base : base + window] = h
    return rounds


@functools.cache
def _kernel():
    fn = _build.kernel_lib("records").stpu_cuda_records
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, i64, i64, p, i64, p, p, i64, p, p]
    fn.restype = ctypes.c_int
    return fn


def decode_records(srcs, recs, nops, declens, d_pad: int):
    """Replay ``(B, R, 2)`` int32 records into ``(B, d_pad)`` uint8 rows.

    ``srcs``: ``(B, S)`` uint8 bodies (the literals' source);
    ``nops``, ``declens``: ``(B,)`` int32, every ``nops <= R`` (the caller
    routes a group whose scan overflowed its record cap away) and every
    ``declens <= d_pad``.
    """
    b, s = srcs.shape
    if srcs.dtype != torch.uint8:
        raise TypeError(f"srcs must be uint8, got {srcs.dtype}")
    if recs.dtype != torch.int32 or nops.dtype != torch.int32 or declens.dtype != torch.int32:
        raise TypeError("recs, nops and declens must be int32")
    if recs.dim() != 3 or recs.shape[0] != b or recs.shape[2] != 2:
        raise ValueError(f"recs must be (B, R, 2), got {tuple(recs.shape)}")
    if nops.shape != (b,) or declens.shape != (b,):
        raise ValueError("nops and declens must have one entry per row")
    tensors = (srcs, recs, nops, declens)
    if any(t.device != srcs.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if d_pad <= 0 or d_pad % 16:
        raise ValueError(f"d_pad {d_pad} must be a positive multiple of 16")
    if srcs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {srcs.device}")
    if b and (int(nops.max()) > recs.shape[1] or int(declens.max()) > d_pad):
        raise ValueError("a row's op count exceeds R or its declen exceeds d_pad")
    if srcs.device.type == "cpu":
        return decode_records_plain(srcs, recs, nops, declens, d_pad)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    dst = torch.empty((b, d_pad), dtype=torch.uint8, device=srcs.device)
    if b == 0:
        return dst
    _build.count(globals(), "launches")
    _build.launch(
        srcs.device, "records", _kernel(),
        srcs.data_ptr(), b, s, recs.data_ptr(), recs.shape[1], nops.data_ptr(),
        declens.data_ptr(), d_pad, dst.data_ptr(),
    )
    return dst
