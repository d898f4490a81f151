"""Flat-gather decode over host-flattened indices: kernel K2
(``csrc/flat_gather.cu``).

The host flatten (``native.flatten_idx_batch``) turns every copy chain
into the index of the literal byte it reads, relative to its 1024-byte
tile's window base row. Decode is then one gather::

    out[b, d] = src[b, tile_meta[b, d >> 10, 0] * 128 + idx[b, phys(d)]]

for ``d < declens[b]``, and 0 up to ``d_pad``. ``layout=0`` keeps ``idx``
in output order (``phys(d) = d``); ``layout=1`` is the transposed block
order the flatten writes for widths that are whole 16 KiB groups
(:func:`phys_index`). The bucket column of ``tile_meta`` only sized the
TPU kernels' matrix-unit windows and is ignored.

``idx`` travels as ``int16`` (torch's ``uint16`` support is thin); the
kernel reads it as ``uint16`` and the plain version masks with 0xFFFF.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: Kernel launches since the count was last reset, in all and per layout.
launches = 0
layout_launches = [0, 0]


def phys_index(d, layout: int):
    """Position of output byte ``d``'s index in the ``layout`` order
    (``core.cpp`` ``stpu_flatten_idx``); ints, arrays or tensors."""
    if layout == 0:
        return d
    return (d >> 14 << 14) | ((d & 127) << 7) | (((d >> 10) & 15) << 3) | ((d >> 7) & 7)


def decode_flat_plain(srcs, idx, tile_meta, declens, d_pad: int, layout: int):
    """The gather in PyTorch ops, on any device."""
    b, s = srcs.shape
    d = torch.arange(d_pad, device=srcs.device)
    rel = idx.to(torch.int64)[:, phys_index(d, layout)] & 0xFFFF
    base = tile_meta[:, :, 0].to(torch.int64).repeat_interleave(1024, dim=1) * 128
    pos = base + rel
    val = srcs.gather(1, pos.clamp(max=s - 1))
    live = (pos < s) & (d[None, :] < declens.to(torch.int64)[:, None])
    return torch.where(live, val, 0).to(torch.uint8)


@functools.cache
def _kernel():
    fn = _build.kernel_lib("flat_gather").stpu_cuda_flat_gather
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, i64, i64, p, p, p, i64, ctypes.c_int, p, p]
    fn.restype = ctypes.c_int
    return fn


def decode_flat(srcs, idx, tile_meta, declens, d_pad: int, layout: int):
    """Decode ``(B, S)`` uint8 bodies to ``(B, d_pad)`` uint8 bytes.

    ``idx``: ``(B, d_pad)`` int16; ``tile_meta``: ``(B, d_pad // 1024, 2)``
    int32; ``declens``: ``(B,)`` int32. A CUDA input launches the kernel
    (or raises); a CPU input runs :func:`decode_flat_plain`.
    """
    b, s = srcs.shape
    if srcs.dtype != torch.uint8 or idx.dtype != torch.int16:
        raise TypeError(f"srcs must be uint8 and idx int16, got {srcs.dtype}, {idx.dtype}")
    if tile_meta.dtype != torch.int32 or declens.dtype != torch.int32:
        raise TypeError("tile_meta and declens must be int32")
    if d_pad % 1024 or (layout == 1 and d_pad % 16384) or layout not in (0, 1):
        raise ValueError(f"layout {layout} with d_pad {d_pad}")
    if (
        idx.shape != (b, d_pad)
        or tile_meta.shape != (b, d_pad // 1024, 2)
        or declens.shape != (b,)
    ):
        raise ValueError("idx, tile_meta and declens do not match srcs and d_pad")
    tensors = (srcs, idx, tile_meta, declens)
    if any(t.device != srcs.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if srcs.device.type == "cpu":
        return decode_flat_plain(srcs, idx, tile_meta, declens, d_pad, layout)
    if srcs.device.type != "cuda":
        raise ValueError(f"unsupported device {srcs.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if b > 65535:
        raise ValueError(f"{b} rows exceed one launch's grid")
    out = torch.empty((b, d_pad), dtype=torch.uint8, device=srcs.device)
    if b == 0 or d_pad == 0:
        return out
    stream = torch.cuda.current_stream(srcs.device).cuda_stream
    global launches
    launches += 1
    layout_launches[layout] += 1
    _build.check(
        _kernel()(
            srcs.data_ptr(), b, s, idx.data_ptr(), tile_meta.data_ptr(),
            declens.data_ptr(), d_pad, layout, out.data_ptr(), stream,
        ),
        "flat_gather",
    )
    return out
