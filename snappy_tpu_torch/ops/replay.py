"""Self-contained replay decode of raw op streams: kernel K3
(``csrc/replay.cu``).

``decode_replay(srcs, src_lens, declens, d_pad)`` decodes each row's op
stream, validates every op, and returns ``(dst (B, d_pad) uint8, err (B,)
int32)`` bit for bit as the JAX package's ``decode_batch_pallas`` does: the
valid prefix, zeros after it, and the first bad op's device code (below).
It serves every group under ``configure(decode_flat=False)``, the groups
the other routes leave, and raw streams up to ``replay_max_body``.

On a CUDA tensor the wrapper launches the kernel (or raises): rows of
``d_pad <= 65536`` take one CTA a row that finds the op starts and the
copies' origins by pointer doubling (:func:`replay_windows` follows it in
tensor ops), wider rows a CTA walk in shared memory. On a CPU tensor it
runs :func:`decode_replay_plain`, the walk in Python on the host.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build
from .records import decode_records_plain

#: Device error codes (``snappy_tpu/ops/decode.py:44-49``).
OK = 0
E_LITERAL = 1
E_COPYREAD = 2
E_OFFSET = 3
E_COPYWRITE = 4
E_HEADER_MISMATCH = 5

_CAP = 1 << 30  # clamp for lengths that provably overrun

#: Kernel launches since the count was last reset (main-path evidence).
launches = 0


def _replay_row(src: bytes, n: int, declen: int, out: bytearray) -> int:
    """Decode one row into ``out``; returns the device error code."""

    def at(p):
        return src[p] if p < n else 0

    def read4(p):
        return at(p) | at(p + 1) << 8 | at(p + 2) << 16 | at(p + 3) << 24

    s = d = 0
    while s < n:
        tag = src[s]
        kind = tag & 3
        lenm1 = tag >> 2
        if kind == 0:
            long_lit = lenm1 >= 60
            bc = min(max(lenm1 - 59, 1), 4)
            raw = read4(s + 1) & (0xFFFFFFFF >> (8 * (4 - bc)))
            ll = (min(raw, _CAP) if long_lit else lenm1) + 1
            content = s + 1 + (bc if long_lit else 0)
            if (long_lit and s + 5 > n) or n - content < ll or declen - d < ll:
                return E_LITERAL
            out[d : d + ll] = src[content : content + ll]
            s, d = content + ll, d + ll
        else:
            ntb = 1 if kind == 1 else (2 if kind == 2 else 4)
            length = 4 + (lenm1 & 7) if kind == 1 else lenm1 + 1
            if kind == 1:
                off = (tag >> 5) << 8 | at(s + 1)
            else:
                off = read4(s + 1) & (0xFFFFFFFF >> (8 * (4 - ntb)))
            if s + 1 + ntb > n:
                return E_COPYREAD
            if off == 0 or d < off:
                return E_OFFSET
            if d + length > declen:
                return E_COPYWRITE
            period = out[d - off : d]
            out[d : d + length] = (period * -(-length // off))[:length]
            s, d = s + 1 + ntb, d + length
    return E_HEADER_MISMATCH if d != declen else OK


def decode_replay_plain(srcs, src_lens, declens, d_pad: int):
    """The replay walk, row by row on the host; results on the input device."""
    rows = srcs.cpu().numpy()
    dst = np.zeros((rows.shape[0], d_pad), np.uint8)
    errs = np.zeros(rows.shape[0], np.int32)
    for i, (n, dl) in enumerate(zip(src_lens.tolist(), declens.tolist())):
        out = bytearray(d_pad)
        errs[i] = _replay_row(rows[i].tobytes(), n, dl, out)
        dst[i] = np.frombuffer(out, np.uint8)
    return torch.from_numpy(dst).to(srcs.device), torch.from_numpy(errs).to(srcs.device)


def _parse_positions(row, n: int):
    """The op that would start at every position of one row's ``(S,)``
    uint8 tensor (bytes at and past ``n`` read as 0), as int64 planes:
    ``consumed`` (source bytes), ``produced`` (output bytes), ``lit``,
    ``w1`` (a literal's content index, a copy's offset) and ``src_err``
    (the check code that needs no output position: :data:`E_LITERAL` for a
    literal whose bytes pass ``n``, :data:`E_COPYREAD` for a copy whose
    offset bytes do)."""
    s = row.shape[0]
    b = torch.zeros(s + 5, dtype=torch.int64, device=row.device)
    b[: min(n, s)] = row[: min(n, s)].to(torch.int64)
    tag, i = b[:s], torch.arange(s, device=row.device)
    trail = b[1 : s + 1] | b[2 : s + 2] << 8 | b[3 : s + 3] << 16 | b[4 : s + 4] << 24
    kind, lenm1 = tag & 3, tag >> 2
    lit = kind == 0
    long_lit = lenm1 >= 60
    bc = (lenm1 - 59).clamp(1, 4)
    ll = torch.where(long_lit, (trail & (0xFFFFFFFF >> (8 * (4 - bc)))).clamp(max=_CAP), lenm1) + 1
    content = i + 1 + torch.where(long_lit, bc, 0)
    lit_err = (long_lit & (i + 5 > n)) | (n - content < ll)
    ntb = torch.where(kind == 1, 1, torch.where(kind == 2, 2, 4))
    off = torch.where(kind == 1, (tag >> 5) << 8 | (trail & 0xFF),
                      trail & (0xFFFFFFFF >> (8 * (4 - ntb))))
    return {
        "consumed": torch.where(lit, content - i + ll, 1 + ntb),
        "produced": torch.where(lit, ll, torch.where(kind == 1, 4 + (lenm1 & 7), lenm1 + 1)),
        "lit": lit,
        "w1": torch.where(lit, content, off),
        "src_err": torch.where(lit, torch.where(lit_err, E_LITERAL, OK),
                               torch.where(i + 1 + ntb > n, E_COPYREAD, OK)),
    }


def replay_windows(srcs, src_lens, declens, d_pad: int, window: int = 4096):
    """K3's algorithm for rows of ``d_pad <= 65536``, step by step in tensor
    ops (a model of the kernel, not its plain version): each row's source a
    window of ``window`` positions at a time, each window starting at the
    op start the window before found; every position's op parsed; the op
    starts marked as the orbit of the window's first position under
    ``next = i + consumed`` by marks pushed along doubling jumps until the
    first position's jump leaves the window; each op's output start by a
    prefix sum; the checks; the first bad op; the valid ops as K10's
    records, whose bytes :func:`records.decode_records_plain` gives.

    Returns ``(dst, errs, detail)``: ``dst`` ``(B, d_pad)`` uint8 and
    ``errs`` ``(B,)`` int32, which equal :func:`decode_replay_plain`'s, and
    ``detail`` a dict of ``op_mask`` ``(B, S)`` bool (the op starts the
    windows marked, up to and including the first bad op), ``dst_start``
    ``(B, S)`` int64 (each marked op's output start, else 0), ``first``
    ``(B,)`` int64 (the first bad op's position, or ``S``), ``windows`` and
    ``rounds`` ``(B,)`` int64 (windows taken, doubling rounds summed over
    them)."""
    b, s = srcs.shape
    dev = srcs.device
    op_mask = torch.zeros((b, s), dtype=torch.bool, device=dev)
    dst_start = torch.zeros((b, s), dtype=torch.int64, device=dev)
    first = torch.full((b,), s, dtype=torch.int64, device=dev)
    windows = torch.zeros(b, dtype=torch.int64, device=dev)
    rounds = torch.zeros(b, dtype=torch.int64, device=dev)
    errs = torch.zeros(b, dtype=torch.int32, device=dev)
    rows_recs, q = [], torch.arange(window, device=dev)
    for r, (n, declen) in enumerate(zip(src_lens.tolist(), declens.tolist())):
        f = _parse_positions(srcs[r], n)
        recs = []
        s0 = carry = 0
        err = OK
        while s0 < n and err == OK:
            windows[r] += 1
            pos = s0 + q
            live = pos < n
            at = pos.clamp(max=s - 1)
            jump = torch.where(live, (q + f["consumed"][at]).clamp(max=window), window)
            jump = torch.cat([jump, jump.new_full((1,), window)])
            mark = torch.zeros(window + 1, dtype=torch.bool, device=dev)
            mark[0] = True
            while int(jump[0]) < window:
                mark = mark.index_fill(0, jump[mark], True)
                jump = jump[jump]
                rounds[r] += 1
            is_op = mark[:window] & live
            prod = torch.where(is_op, f["produced"][at], 0)
            d = carry + torch.cumsum(prod, 0) - prod
            lit, w1 = f["lit"][at], f["w1"][at]
            code = torch.where(
                lit, torch.where((f["src_err"][at] != OK) | (declen - d < prod), E_LITERAL, OK),
                torch.where(f["src_err"][at] != OK, E_COPYREAD,
                            torch.where((w1 == 0) | (d < w1), E_OFFSET,
                                        torch.where(d + prod > declen, E_COPYWRITE, OK))))
            bad = (is_op & (code != OK)).nonzero()
            fb = int(bad[0, 0]) if len(bad) else window
            seen = is_op & (q <= fb)
            op_mask[r, pos[seen]] = True
            dst_start[r, pos[seen]] = d[seen]
            valid = is_op & (q < fb)
            recs.append(torch.stack([prod[valid] | lit[valid].to(torch.int64) << 30, w1[valid]], 1))
            if fb < window:
                err, carry = int(code[fb]), int(d[fb])
                first[r] = s0 + fb
            else:
                carry = int(d[-1] + prod[-1])
                last = int(valid.nonzero()[-1, 0])
                s0 = min(s0 + last + int(f["consumed"][at[last]]), n)
        errs[r] = E_HEADER_MISMATCH if err == OK and carry != declen else err
        rows_recs.append(torch.cat(recs) if recs else torch.zeros((0, 2), dtype=torch.int64, device=dev))
    nops = torch.tensor([len(x) for x in rows_recs], dtype=torch.int32, device=dev)
    recs = torch.zeros((b, max([1, *nops.tolist()]), 2), dtype=torch.int32, device=dev)
    for r, x in enumerate(rows_recs):
        recs[r, : len(x)] = x.to(torch.int32)
    dst = decode_records_plain(srcs, recs, nops, declens, d_pad)
    return dst, errs, {"op_mask": op_mask, "dst_start": dst_start, "first": first,
                       "windows": windows, "rounds": rounds}


@functools.cache
def _kernel():
    fn = _build.kernel_lib("replay").stpu_cuda_replay
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, i64, i64, p, p, i64, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def decode_replay(srcs, src_lens, declens, d_pad: int):
    """Decode ``(B, S)`` uint8 bodies; ``src_lens``/``declens`` ``(B,)``
    int32 with ``src_lens <= S`` and ``declens <= d_pad``."""
    b, s = srcs.shape
    if srcs.dtype != torch.uint8:
        raise TypeError(f"srcs must be uint8, got {srcs.dtype}")
    if src_lens.dtype != torch.int32 or declens.dtype != torch.int32:
        raise TypeError("src_lens and declens must be int32")
    if src_lens.shape != (b,) or declens.shape != (b,):
        raise ValueError("src_lens and declens must have one entry per row")
    tensors = (srcs, src_lens, declens)
    if any(t.device != srcs.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    # The walk reads src_lens bytes of each row and writes declens bytes.
    if b and (int(src_lens.max()) > s or int(declens.max()) > d_pad):
        raise ValueError(f"a row's length exceeds its width ({s}) or d_pad ({d_pad})")
    if srcs.device.type == "cpu":
        return decode_replay_plain(srcs, src_lens, declens, d_pad)
    if srcs.device.type != "cuda":
        raise ValueError(f"unsupported device {srcs.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    dst = torch.empty((b, d_pad), dtype=torch.uint8, device=srcs.device)
    errs = torch.empty(b, dtype=torch.int32, device=srcs.device)
    if b == 0:
        return dst, errs
    _build.count(globals(), "launches")
    _build.launch(
        srcs.device, "replay", _kernel(),
        srcs.data_ptr(), b, s, src_lens.data_ptr(), declens.data_ptr(),
        d_pad, dst.data_ptr(), errs.data_ptr(),
    )
    return dst, errs
