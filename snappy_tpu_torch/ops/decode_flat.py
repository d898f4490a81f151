"""Flat-gather decode over host-flattened indices: kernels K2 and K11,
one CUDA kernel with two entry points (``csrc/flat_gather.cu``).

The host flatten (``native.flatten_idx_batch``) turns every copy chain
into the index of the literal byte it reads, relative to its 1024-byte
tile's window base row. Decode is then one gather::

    out[b, d] = src[b, tile_meta[b, d >> 10, 0] * 128 + idx[b, phys(d)]]

for ``d < declens[b]`` and a position inside the row, and 0 up to
``d_pad``. ``layout=0`` keeps ``idx`` in output order (``phys(d) = d``);
``layout=1`` is the transposed block order the flatten writes for widths
that are whole 16 KiB groups (:func:`phys_index`). The bucket column of
``tile_meta`` only sized the TPU kernels' matrix-unit windows and K2
ignores it.

K11, :func:`decode_flat_grouped`, is the JAX package's v3/v4 entry
(``decode_flat_pallas_v3``/``_v4``): ``layout=1`` with one window bucket
per 16 KiB group (``gbuck``, from :func:`group_buckets`). It keeps what
the windows do to the bytes: a dead group is zeros, and a byte whose
window-relative row lies past its group's window, or past the source
row, is 0.

``idx`` travels as ``int16`` (torch's ``uint16`` support is thin); the
kernel reads it as ``uint16`` and the plain version masks with 0xFFFF.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

#: Kernel launches since the count was last reset: K2 in all and per
#: layout, K11 per variant.
launches = 0
layout_launches = [0, 0]
grouped_launches = {3: 0, 4: 0}

GROUP = 16384  # output bytes per bucket group (16 tiles of 1024)
NOMINAL_WINDOWS = (128, 256, 512)  # window rows of buckets 0, 1, 2


def phys_index(d, layout: int):
    """Position of output byte ``d``'s index in the ``layout`` order
    (``core.cpp`` ``stpu_flatten_idx``); ints, arrays or tensors."""
    if layout == 0:
        return d
    return (d >> 14 << 14) | ((d & 127) << 7) | (((d >> 10) & 15) << 3) | ((d >> 7) & 7)


def _reads(s: int, idx, tile_meta, declens, d_pad: int, layout: int, window=None):
    """``(p, ok)``, both ``(B, d_pad)``: the source position each output
    byte reads, and whether it reads it (``d < declen``, ``0 <= p < s`` and,
    given a per-byte ``window`` of rows, ``idx >> 7 < window``)."""
    d = torch.arange(d_pad, device=idx.device)
    rel = idx.to(torch.int64)[:, phys_index(d, layout)] & 0xFFFF
    p = tile_meta[:, :, 0].to(torch.int64).repeat_interleave(1024, dim=1) * 128 + rel
    ok = (p >= 0) & (p < s) & (d[None, :] < declens.to(torch.int64)[:, None])
    if window is not None:
        ok &= (rel >> 7) < window
    return p, ok


def decode_flat_plain(srcs, idx, tile_meta, declens, d_pad: int, layout: int):
    """The gather in PyTorch ops, on any device."""
    s = srcs.shape[1]
    p, ok = _reads(s, idx, tile_meta, declens, d_pad, layout)
    val = srcs.gather(1, p.clamp(0, s - 1))
    return torch.where(ok, val, 0).to(torch.uint8)


def _cuda_checks(tensors, b: int, s: int) -> None:
    """What the kernel takes beyond the shapes: ``tensors`` (``srcs`` and
    ``idx`` first) on the card and contiguous, ``idx`` 16-byte aligned (it
    is read 16 bytes at a time), rows below 1 GiB (32-bit positions)."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"unsupported device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if tensors[1].data_ptr() % 16 or s >= 1 << 30:
        raise ValueError(f"idx must be 16-byte aligned and rows below 1 GiB, got {s} bytes")
    if b > 65535:
        raise ValueError(f"{b} rows exceed one launch's grid")


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
    _cuda_checks(tensors, b, s)
    out = torch.empty((b, d_pad), dtype=torch.uint8, device=srcs.device)
    if b == 0 or d_pad == 0:
        return out
    _build.count(globals(), "launches")
    _build.count(layout_launches, layout)
    _build.launch(
        srcs.device, "flat_gather", _kernel(),
        srcs.data_ptr(), b, s, idx.data_ptr(), tile_meta.data_ptr(),
        declens.data_ptr(), d_pad, layout, out.data_ptr(),
    )
    return out


def group_buckets(tile_meta, declens, d_pad: int):
    """Each 16 KiB group's window bucket: the widest of its 16 tiles'
    (``tile_meta[..., 1]``), or -1 for a group wholly past ``declen``.

    ``tile_meta``: ``(B, d_pad // 1024, 2)`` int32; ``declens``: ``(B,)``.
    Returns ``(B, d_pad // 16384)`` int32 on their device (the JAX
    package's ``group_buckets``, ``ops/pallas/decode.py:1228``)."""
    b, t, _ = tile_meta.shape
    if d_pad % GROUP or t != d_pad // 1024:
        raise ValueError(f"tile_meta of {t} tiles with d_pad {d_pad}")
    g = t // 16
    gb = tile_meta[:, :, 1].reshape(b, g, 16).amax(dim=2)
    n_active = (declens.to(torch.int64) + GROUP - 1) // GROUP
    dead = torch.arange(g, device=tile_meta.device)[None, :] >= n_active[:, None]
    return torch.where(dead, -1, gb).to(torch.int32)


def window_rows(s_rows: int) -> list[int]:
    """Window rows of buckets 0, 1, 2 for source rows of ``s_rows`` lines
    of 128 bytes: the nominal width, at most ``s_rows``, rounded up to 128
    (``_make_flat_v3_kernel``, ``_make_flat_v4_kernel``)."""
    return [-(-min(w, s_rows) // 128) * 128 for w in NOMINAL_WINDOWS]


def _group_window(gbuck, s_rows: int, variant: int):
    """Window rows of every output byte under K11's buckets, ``(B, d_pad)``:
    0 in a dead group."""
    gb = gbuck.to(torch.int64)
    live = (gb >= 0) & (gb <= 2) if variant == 3 else gb >= 0
    widths = torch.tensor(window_rows(s_rows), device=gbuck.device)
    return torch.where(live, widths[gb.clamp(0, 2)], 0).repeat_interleave(GROUP, dim=1)


def decode_flat_grouped_plain(srcs, idx, tile_meta, gbuck, declens, d_pad: int, variant: int):
    """K11's gather in PyTorch ops, on any device."""
    s = srcs.shape[1]
    window = _group_window(gbuck, s // 128, variant)
    p, ok = _reads(s, idx, tile_meta, declens, d_pad, 1, window)
    val = srcs.gather(1, p.clamp(0, s - 1))
    return torch.where(ok, val, 0).to(torch.uint8)


@functools.cache
def _grouped_kernel():
    fn = _build.kernel_lib("flat_gather").stpu_cuda_flat_grouped
    p, i64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [p, i64, i64, p, p, p, p, i64, cint, cint, cint, cint, p, p]
    fn.restype = ctypes.c_int
    return fn


def decode_flat_grouped(srcs, idx, tile_meta, gbuck, declens, d_pad: int, variant: int):
    """Decode ``(B, S)`` uint8 bodies to ``(B, d_pad)`` uint8 bytes with a
    window bucket per 16 KiB group: K11, the JAX package's
    ``decode_flat_pallas_v3`` (``variant=3``) or ``_v4`` (``variant=4``).

    ``idx``: ``(B, d_pad)`` int16 in the ``layout=1`` order;
    ``tile_meta``: ``(B, d_pad // 1024, 2)`` int32; ``gbuck``:
    ``(B, d_pad // 16384)`` int32; ``declens``: ``(B,)`` int32. ``S`` is
    whole 128-byte lines and ``d_pad`` whole 16 KiB groups. A CUDA input
    launches the kernel (or raises); a CPU input runs
    :func:`decode_flat_grouped_plain`.
    """
    b, s = srcs.shape
    if variant not in (3, 4):
        raise ValueError(f"variant {variant} is not 3 or 4")
    if srcs.dtype != torch.uint8 or idx.dtype != torch.int16:
        raise TypeError(f"srcs must be uint8 and idx int16, got {srcs.dtype}, {idx.dtype}")
    if any(t.dtype != torch.int32 for t in (tile_meta, gbuck, declens)):
        raise TypeError("tile_meta, gbuck and declens must be int32")
    if d_pad % GROUP or s % 128:
        raise ValueError(f"d_pad {d_pad} or row width {s} is not tiled")
    if (
        idx.shape != (b, d_pad)
        or tile_meta.shape != (b, d_pad // 1024, 2)
        or gbuck.shape != (b, d_pad // GROUP)
        or declens.shape != (b,)
    ):
        raise ValueError("idx, tile_meta, gbuck and declens do not match srcs and d_pad")
    tensors = (srcs, idx, tile_meta, gbuck, declens)
    if any(t.device != srcs.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if srcs.device.type == "cpu":
        return decode_flat_grouped_plain(srcs, idx, tile_meta, gbuck, declens, d_pad, variant)
    _cuda_checks(tensors, b, s)
    out = torch.empty((b, d_pad), dtype=torch.uint8, device=srcs.device)
    if b == 0 or d_pad == 0:
        return out
    _build.count(grouped_launches, variant)
    _build.launch(
        srcs.device, "flat_grouped", _grouped_kernel(),
        srcs.data_ptr(), b, s, idx.data_ptr(), tile_meta.data_ptr(), gbuck.data_ptr(),
        declens.data_ptr(), d_pad, variant, *window_rows(s // 128), out.data_ptr(),
    )
    return out
