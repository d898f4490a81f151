"""Self-contained replay decode of raw op streams: kernel K3
(``csrc/replay.cu``).

``decode_replay(srcs, src_lens, declens, d_pad)`` walks each row's tags
in order, validates every op, and returns ``(dst (B, d_pad) uint8,
err (B,) int32)`` bit for bit as the JAX package's ``decode_batch_pallas``
does: the valid prefix, zeros after it, and the first bad op's device
code (below). It serves the rows that the host flatten cannot window.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs :func:`decode_replay_plain`, the same walk in Python on
the host.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

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


@functools.cache
def _kernel():
    fn = _build.kernel_lib("replay").stpu_cuda_replay
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, i64, i64, p, p, i64, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def decode_replay(srcs, src_lens, declens, d_pad: int):
    """Decode ``(B, S)`` uint8 bodies; ``src_lens``/``declens`` ``(B,)``
    int32 with ``src_lens <= S`` and ``declens <= d_pad``. On the card a
    row that fits one block's shared memory is staged there."""
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
    stream = torch.cuda.current_stream(srcs.device).cuda_stream
    global launches
    launches += 1
    _build.check(
        _kernel()(
            srcs.data_ptr(), b, s, src_lens.data_ptr(), declens.data_ptr(),
            d_pad, dst.data_ptr(), errs.data_ptr(), stream,
        ),
        "replay",
    )
    return dst, errs
