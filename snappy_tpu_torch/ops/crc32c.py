"""Batched CRC32C over device rows: kernel K1 (``csrc/crc32c.cu``).

``crc32c_blocks`` and ``crc32c_masked_blocks`` take ``(B, S)`` uint8
rows and ``(B,)`` int32 lengths and return ``(B,)`` int64 CRCs (values in
``[0, 2**32)``; torch has no usable uint32). Bytes past a row's length
are ignored, whatever they hold; lengths are clamped to ``[0, S]``.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain PyTorch version, which repeats the kernel's
arithmetic: a table CRC per 1/256 segment of each row, then the segment
registers combined with the GF(2) shift operators ``M_{2^k}``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..format.constants import CASTAGNOLI_POLY, CRC_MASK_DELTA
from ..format.tables import crc32c_table
from . import _build

#: Kernel launches since the count was last reset (main-path evidence).
launches = 0

THREADS = 256  # segments per row; csrc/crc32c.cu kThreads
_FF = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# GF(2) operator algebra (host-side precompute), as in the JAX package's
# ops/crc32c.py.
# ---------------------------------------------------------------------------


def _byte_step_cols() -> list[int]:
    """Columns of M_1: the register map for one zero byte."""
    cols = []
    for j in range(32):
        r = 1 << j
        for _ in range(8):
            r = (r >> 1) ^ (CASTAGNOLI_POLY if (r & 1) else 0)
        cols.append(r)
    return cols


def _apply_int(cols, v: int) -> int:
    acc = 0
    for j in range(32):
        if (v >> j) & 1:
            acc ^= cols[j]
    return acc


def _compose(a, b):
    """Columns of a∘b (apply b, then a)."""
    return [_apply_int(a, bj) for bj in b]


@functools.cache
def shift_operators() -> np.ndarray:
    """``ops[k]`` = columns of M_{2^k}: advance a CRC past 2^k zero
    bytes. ``(32, 32)`` uint32."""
    ops = [_byte_step_cols()]
    for _ in range(31):
        ops.append(_compose(ops[-1], ops[-1]))
    return np.asarray(ops, dtype=np.uint32)


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _apply(cols: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(v)
    for j in range(32):
        acc ^= torch.where((v >> j) & 1 == 1, cols[j], 0)
    return acc


def _shift_zeros(ops: torch.Tensor, r: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Advance raw registers ``r`` past ``n`` zero bytes (elementwise)."""
    for k in range((int(n.max()) if n.numel() else 0).bit_length()):
        r = torch.where((n >> k) & 1 == 1, _apply(ops[k], r), r)
    return r


def crc32c_plain(rows: torch.Tensor, lengths: torch.Tensor, masked: bool) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops, on any device."""
    b, s = rows.shape
    dev = rows.device
    table = torch.from_numpy(crc32c_table().astype(np.int64)).to(dev)
    ops = torch.from_numpy(shift_operators().astype(np.int64)).to(dev)
    lens = lengths.to(torch.int64).clamp(0, s)[:, None]  # (B, 1)
    seg = ((lens + THREADS - 1) // THREADS + 15) // 16 * 16
    t = torch.arange(THREADS, device=dev, dtype=torch.int64)[None, :]
    lo = torch.minimum(t * seg, lens)
    hi = torch.minimum(lo + seg, lens)
    r = torch.zeros((b, THREADS), dtype=torch.int64, device=dev)
    data = rows.to(torch.int64)
    for k in range(int(seg.max()) if b else 0):
        pos = lo + k
        byte = data.gather(1, pos.clamp(max=s - 1))
        stepped = table[(r ^ byte) & 0xFF] ^ (r >> 8)
        r = torch.where(pos < hi, stepped, r)
    r = _shift_zeros(ops, r, lens - hi)
    while r.shape[1] > 1:
        half = r.shape[1] // 2
        r = r[:, :half] ^ r[:, half:]
    init = _shift_zeros(ops, torch.full_like(lens, _FF), lens)
    crc = (r ^ init ^ _FF)[:, 0]
    if masked:
        crc = (((crc >> 15) | (crc << 17)) + CRC_MASK_DELTA) & _FF
    return crc


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


@functools.cache
def _kernel():
    fn = _build.kernel_lib("crc32c").stpu_cuda_crc32c_rows
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [p, i64, i64, p, p, p, ctypes.c_int, p, p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _device_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The byte table and shift operators as int32 bit patterns on ``device``."""
    table = torch.from_numpy(crc32c_table().view(np.int32).copy()).to(device)
    ops = torch.from_numpy(shift_operators().view(np.int32).reshape(-1).copy()).to(device)
    return table, ops


def _crc(rows: torch.Tensor, lengths: torch.Tensor, masked: bool) -> torch.Tensor:
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise TypeError(f"rows must be a 2-D uint8 tensor, got {rows.dtype} {tuple(rows.shape)}")
    if lengths.dtype != torch.int32 or lengths.shape != rows.shape[:1]:
        raise TypeError(f"lengths must be int32 of shape ({rows.shape[0]},)")
    if lengths.device != rows.device:
        raise ValueError("rows and lengths must be on one device")
    if rows.device.type == "cpu":
        return crc32c_plain(rows, lengths, masked)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if not (rows.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("rows and lengths must be contiguous")
    out = torch.empty(rows.shape[0], dtype=torch.int64, device=rows.device)
    if rows.shape[0] == 0:
        return out
    table, ops = _device_tables(rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    global launches
    launches += 1
    _build.check(
        _kernel()(
            rows.data_ptr(), rows.shape[0], rows.shape[1], lengths.data_ptr(),
            table.data_ptr(), ops.data_ptr(), int(masked), out.data_ptr(), stream,
        ),
        "crc32c",
    )
    return out


def crc32c_blocks(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Unmasked CRC32C of each row up to its length, ``(B,)`` int64."""
    return _crc(rows, lengths, masked=False)


def crc32c_masked_blocks(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Masked CRC32C per row, as stored in frame chunk headers."""
    return _crc(rows, lengths, masked=True)
