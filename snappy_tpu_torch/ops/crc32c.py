"""Batched CRC32C over device rows: kernel K1 (``csrc/crc32c.cu``).

``crc32c_blocks`` and ``crc32c_masked_blocks`` take ``(B, S)`` uint8
rows and ``(B,)`` int32 lengths and return ``(B,)`` int64 CRCs (values in
``[0, 2**32)``; torch has no usable uint32). Bytes past a row's length
are ignored, whatever they hold; lengths are clamped to ``[0, S]``.

On a CUDA tensor the wrapper launches the kernel (or raises); on a CPU
tensor it runs the plain PyTorch version, which repeats the kernel's
arithmetic: each row's whole 16-byte words right-aligned into chunks of
``THREADS * WORDS`` words with leading zero words, the row's initial
``0xFFFFFFFF`` XORed into its first word, slicing by 4 over each
thread's ``WORDS`` words from a register of 0, the segment registers
advanced by the fixed operators of their lane and warp (M_n advances past
``n`` zero bytes; eight nibble lookups each) and XORed together, the
chunks joined in order, and the ``len % 16`` tail in byte steps.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..format.constants import CASTAGNOLI_POLY, CRC_MASK_DELTA
from ..format.tables import crc32c_table16
from . import _build

#: Kernel launches since the count was last reset (main-path evidence).
launches = 0

THREADS = 1024  # segments per chunk; csrc/crc32c.cu kThreads
WORDS = 4  # 16-byte words a segment; kWords
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


def _squares(first) -> np.ndarray:
    """``first`` and its 31 repeated squares, ``(32, 32)`` uint32 columns."""
    ops = [first]
    for _ in range(31):
        ops.append(_compose(ops[-1], ops[-1]))
    return np.asarray(ops, dtype=np.uint32)


@functools.cache
def shift_operators() -> np.ndarray:
    """``ops[k]`` = columns of M_{2^k}: advance a CRC past 2^k zero
    bytes. ``(32, 32)`` uint32."""
    return _squares(_byte_step_cols())


def _apply_np(cols, v: np.ndarray) -> np.ndarray:
    """The operator with columns ``cols`` on every register of ``v``."""
    bits = (v.astype(np.uint64)[..., None] >> np.arange(32, dtype=np.uint64)) & 1
    return np.bitwise_xor.reduce(np.where(bits == 1, np.asarray(cols, np.uint64), 0), axis=-1)


def _power(ops: np.ndarray, n: int) -> np.ndarray:
    """Columns of the product of ``ops[k]`` over ``n``'s set bits (powers
    of one operator: they commute)."""
    cols = np.uint64(1) << np.arange(32, dtype=np.uint64)  # the identity
    for k in range(n.bit_length()):
        if n >> k & 1:
            cols = _apply_np(ops[k], cols)
    return cols.astype(np.uint32)


@functools.cache
def shift_columns(n: int) -> np.ndarray:
    """Columns of M_n, the advance past ``n`` zero bytes: the product of
    the ``shift_operators`` of ``n``'s set bits."""
    return _power(shift_operators(), n)


def _nibbles(cols) -> np.ndarray:
    """The operator with columns ``cols`` as eight nibble tables."""
    v = np.arange(16, dtype=np.uint64)[None, :] << (4 * np.arange(8, dtype=np.uint64))[:, None]
    return _apply_np(cols, v).astype(np.uint32)


def nibble_tables(n: int) -> np.ndarray:
    """M_n as eight nibble tables, ``(8, 16)`` uint32: ``tab[q, v] =
    M_n(v << 4q)``, so that ``M_n(x)`` is the XOR of ``tab[q, (x >> 4q) &
    15]`` over ``q``."""
    return _nibbles(shift_columns(n))


def five_bit_tables(n: int) -> np.ndarray:
    """M_n as seven tables of 5-bit chunks, 196 uint32 words: word ``32 c +
    j`` is ``M_n(j << 5c)`` for ``c < 6``, word ``192 + j`` is ``M_n(j <<
    30)`` for ``j < 4``; ``M_n(x)`` is the XOR over ``c`` of chunk ``c``'s
    entry for the bits of ``x`` from ``5c`` up (K2's checksum, whose warps
    hold them in seven registers)."""
    j = np.arange(32, dtype=np.uint64)
    v = np.concatenate([j << np.uint64(5 * c) for c in range(6)] + [j[:4] << np.uint64(30)])
    return _apply_np(shift_columns(n), v).astype(np.uint32)


def _invert(cols) -> np.ndarray:
    """Columns of the inverse of the invertible GF(2) operator with columns
    ``cols``: Gauss-Jordan, each row beside the identity's."""
    cols = [int(c) for c in cols]
    rows = [sum(((cols[j] >> i) & 1) << j for j in range(32)) | 1 << (32 + i) for i in range(32)]
    for j in range(32):
        p = next(i for i in range(j, 32) if rows[i] >> j & 1)
        rows[j], rows[p] = rows[p], rows[j]
        for i in range(32):
            if i != j and rows[i] >> j & 1:
                rows[i] ^= rows[j]
    return np.asarray([sum(((rows[i] >> (32 + k)) & 1) << i for i in range(32))
                       for k in range(32)], dtype=np.uint32)


@functools.cache
def inverse_operators() -> np.ndarray:
    """``inv[k]`` = columns of M_{2^k}'s inverse, which takes back 2^k zero
    bytes: M_n is invertible because CRC32C's polynomial has a constant
    term. ``(32, 32)`` uint32."""
    return _squares(_invert(shift_operators()[0]))


@functools.cache
def inverse_columns(n: int) -> np.ndarray:
    """Columns of M_n's inverse: the product of the
    :func:`inverse_operators` of ``n``'s set bits."""
    return _power(inverse_operators(), n)


def inverse_nibble_tables(n: int) -> np.ndarray:
    """M_n's inverse as eight nibble tables, as :func:`nibble_tables`."""
    return _nibbles(inverse_columns(n))


@functools.cache
def kernel_tables() -> tuple[np.ndarray, np.ndarray]:
    """The kernel's two table arguments: the ``(4, 256)`` slicing-by-4
    tables (byte ``p`` of a 4-byte word through table ``3 - p``), and the
    fixed operators as :func:`nibble_tables`, ``(32 + THREADS / 32 + 1, 8,
    16)``: lane ``l``'s M_{(31 - l) seg}, warp ``w``'s M_{(THREADS / 32 - 1
    - w) 32 seg}, and the chunk's M_{THREADS seg}, seg = 16 * WORDS bytes
    (a thread's segment)."""
    seg, warps = 16 * WORDS, THREADS // 32
    dists = ([(31 - lane) * seg for lane in range(32)]
             + [(warps - 1 - w) * 32 * seg for w in range(warps)] + [THREADS * seg])
    return crc32c_table16()[:4].copy(), np.stack([nibble_tables(d) for d in dists])


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _lookup8(tab: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Eight nibble lookups, ``tab`` ``(8, 16)``, on registers ``v``."""
    r = torch.zeros_like(v)
    for q in range(8):
        r ^= tab[q][(v >> (4 * q)) & 15]
    return r


def crc32c_plain(rows: torch.Tensor, lengths: torch.Tensor, masked: bool) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops, on any device. Every row
    takes the batch's largest chunk count: a leading chunk of zero words
    leaves the register at 0, as the kernel's fewer chunks do."""
    b, s = rows.shape
    dev = rows.device
    if b == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    t4_np, ops_np = kernel_tables()
    t4 = torch.from_numpy(t4_np.astype(np.int64)).to(dev)
    ops = torch.from_numpy(ops_np.astype(np.int64)).to(dev)
    lens = lengths.to(torch.int64).clamp(0, s)
    if s < 16:  # room for the gathers below; no byte past a length is read
        rows = torch.cat([rows, rows.new_zeros((b, 16 - s))], 1)
    whole = lens >> 4
    chunk_words = THREADS * WORDS
    n_chunks = max(1, -(-int(whole.max()) // chunk_words))
    n_words = n_chunks * chunk_words
    # Right-aligned whole words; a negative index is a leading zero word.
    wi = torch.arange(n_words, device=dev)[None, :] - (n_words - whole)[:, None]
    at = (wi.clamp(min=0) * 16)[..., None] + torch.arange(16, device=dev)
    words = rows.gather(1, at.view(b, -1)).view(b, n_words, 16).to(torch.int64)
    words = torch.where((wi >= 0)[..., None], words, 0)
    words[..., :4] ^= torch.where(wi == 0, 0xFF, 0)[..., None]  # the initial value
    words = words.view(b, n_chunks, THREADS, WORDS, 16)
    # Slicing by 4 over each segment's words, 4 bytes a step.
    r = torch.zeros((b, n_chunks, THREADS), dtype=torch.int64, device=dev)
    for i in range(WORDS):
        for lane in range(4):
            x = words[..., i, 4 * lane : 4 * lane + 4]
            x = (x[..., 0] | x[..., 1] << 8 | x[..., 2] << 16 | x[..., 3] << 24) ^ r
            r = t4[3][x & 0xFF] ^ t4[2][(x >> 8) & 0xFF] ^ t4[1][(x >> 16) & 0xFF] ^ t4[0][x >> 24]
    # The fixed operators: each lane's, the XOR of the warp, each warp's,
    # the XOR of the warps; then the chunks in order.
    warps = THREADS // 32
    for first, count in ((0, 32), (32, warps)):
        r = r.view(b, n_chunks, -1, count)
        own = torch.arange(count, device=dev) * 16
        moved = torch.zeros_like(r)
        for q in range(8):
            moved ^= ops[first : first + count, q].reshape(-1)[own + ((r >> (4 * q)) & 15)]
        while moved.shape[-1] > 1:
            half = moved.shape[-1] // 2
            moved = moved[..., :half] ^ moved[..., half:]
        r = moved[..., 0]
    r = r.view(b, n_chunks)
    acc = torch.zeros(b, dtype=torch.int64, device=dev)
    for c in range(n_chunks):
        acc = _lookup8(ops[-1], acc) ^ r[:, c]
    acc = torch.where(whole == 0, _FF, acc)
    # The tail's len % 16 bytes in byte steps.
    for i in range(15):
        byte = rows.gather(1, (whole * 16 + i).clamp(max=rows.shape[1] - 1)[:, None])[:, 0]
        stepped = t4[0][(acc ^ byte) & 0xFF] ^ (acc >> 8)
        acc = torch.where(i < (lens & 15), stepped, acc)
    crc = acc ^ _FF
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


_tables_lock = threading.Lock()


@functools.cache
def _tables_on(index: int) -> tuple[int, int, tuple[torch.Tensor, ...]]:
    dev = torch.device("cuda", index)
    keep = tuple(torch.from_numpy(np.ascontiguousarray(x).view(np.int32).reshape(-1)).to(dev)
                 for x in kernel_tables())
    torch.cuda.synchronize(dev)  # copied in before any stream of any thread reads them
    return keep[0].data_ptr(), keep[1].data_ptr(), keep


def _device_tables(index: int) -> tuple[int, int, tuple[torch.Tensor, ...]]:
    """The kernel's tables as int32 bit patterns on card ``index``: their
    two pointers, and the tensors that keep them alive for the process.

    Built once a card under a lock: the shards of a sharded entry reach
    here from one thread each, and two of them may share a card."""
    with _tables_lock:
        return _tables_on(index)


def _crc(rows: torch.Tensor, lengths: torch.Tensor, masked: bool) -> torch.Tensor:
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise TypeError(f"rows must be a 2-D uint8 tensor, got {rows.dtype} {tuple(rows.shape)}")
    b, s = rows.shape
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise TypeError(f"lengths must be int32 of shape ({b},)")
    dev = rows.device
    if lengths.device != dev:
        raise ValueError("rows and lengths must be on one device")
    if dev.type != "cuda":
        if dev.type == "cpu":
            return crc32c_plain(rows, lengths, masked)
        raise ValueError(f"unsupported device {dev}")
    if not (rows.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("rows and lengths must be contiguous")
    out = torch.empty(b, dtype=torch.int64, device=dev)
    if b == 0:
        return out
    table, ops, _ = _device_tables(dev.index)
    _build.count(globals(), "launches")
    _build.launch(dev, "crc32c", _kernel(),
                  rows.data_ptr(), b, s, lengths.data_ptr(), table, ops, masked, out.data_ptr())
    return out


def crc32c_blocks(blocks: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Unmasked CRC32C of each row of ``blocks`` up to its length, ``(B,)``
    int64."""
    return _crc(blocks, lengths, masked=False)


def crc32c_masked_blocks(blocks: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Masked CRC32C per row of ``blocks``, as stored in frame chunk headers."""
    return _crc(blocks, lengths, masked=True)
