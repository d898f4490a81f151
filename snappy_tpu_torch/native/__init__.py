"""ctypes bindings for the port's copy of the native C++ host runtime.

``core.cpp`` is a verbatim copy of the JAX package's host runtime. It is
built with ``g++`` into ``build/snappy_tpu_torch/`` at first use (see
``ops/_build.py``), never next to this file, so the port cannot pick up
the JAX package's prebuilt library. A failed build raises: the port's
decode path needs the host flatten.

Exposed: the host halves of the device decode (``flatten_idx_batch``,
``scan_records_batch``, and the op-start bitmaps of the hosted tensor
decode, ``scan_ops`` and ``scan_ops_batch``), the sequential host engine
the API falls back to and the tests compare with (``decompress``,
``decompress_len``, ``decompress_batch``, ``crc32c_masked``,
``frame_decompress``), the encoders of the host engine, which also make
test and smoke-run streams
(``frame_compress``, ``compress``), the into-buffer calls of the
streaming adapters (``compress_into``, ``decompress_into``,
``frame_decompress_len``, ``frame_decompress_into``), the host codec's
batch calls (``compress_batch_into``, ``decompress_batch_into``,
``compress_batch``) and unmasked ``crc32c``, and :func:`available`, which
says whether the runtime loads.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from .. import error as err_mod
from ..config import get_config
from ..format.constants import MAX_INPUT_SIZE, max_compress_len

_SRC = Path(__file__).resolve().parent / "core.cpp"
_lock = threading.Lock()
_lib = None


class _Error(ctypes.Structure):
    _fields_ = [
        ("code", ctypes.c_int32),
        ("a", ctypes.c_uint64),
        ("b", ctypes.c_uint64),
        ("c", ctypes.c_uint64),
    ]


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        from ..ops._build import host_lib

        lib = host_lib(_SRC)
        ptr, u64, i64, cint = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int
        errp = ctypes.POINTER(_Error)
        # srcs, src_stride, lens, dsts, dst_stride, out_lens, errs, n, threads
        batch = (None, [ptr, u64, ptr, ptr, u64, ptr, ptr, u64, cint])
        sigs = {
            "stpu_crc32c": (ctypes.c_uint32, [ctypes.c_char_p, ctypes.c_size_t]),
            "stpu_crc32c_masked": (ctypes.c_uint32, [ctypes.c_char_p, ctypes.c_size_t]),
            "stpu_max_compress_len": (u64, [u64]),
            "stpu_compress": (i64, [ctypes.c_char_p, u64, ptr, u64, errp]),
            "stpu_decompress_len": (i64, [ctypes.c_char_p, u64, errp]),
            "stpu_decompress": (i64, [ctypes.c_char_p, u64, ptr, u64, errp]),
            "stpu_compress_batch": batch,
            "stpu_decompress_batch": batch,
            "stpu_frame_compress": (i64, [ctypes.c_char_p, u64, ptr, u64, cint, errp]),
            "stpu_frame_decompress_len": (i64, [ctypes.c_char_p, u64, errp]),
            "stpu_frame_decompress": (
                i64, [ctypes.c_char_p, u64, ptr, u64, cint, errp]
            ),
            "stpu_scan_ops": (i64, [ctypes.c_char_p, u64, ptr]),
            # srcs, src_stride, lens, bits, bits_stride, n, threads
            "stpu_scan_ops_batch": (None, [ptr, u64, ptr, ptr, u64, u64, cint]),
            # srcs, src_stride, lens, declens, recs, rec_cap, nops, errs,
            # dtotals, n, threads
            "stpu_scan_records_batch": (
                None, [ptr, u64, ptr, ptr, ptr, i64, ptr, ptr, ptr, u64, cint]
            ),
            # srcs, src_stride, lens, declens, s_rows, idx_rel, d_pad,
            # tile_meta, fallbacks, errs, dtotals, n, threads, layout
            "stpu_flatten_idx_batch": (
                None,
                [ptr, u64, ptr, ptr, i64, ptr, u64, ptr, ptr, ptr, ptr, u64, cint, cint],
            ),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def available() -> bool:
    """Whether the host runtime builds and loads here; never raises."""
    try:
        _load()
    except (OSError, RuntimeError, AttributeError):  # no g++, a failed build, a stale library
        return False
    return True


def _raise(e: _Error):
    code = int(e.code)
    if code == 8:  # E_EMPTY
        raise err_mod.Empty()
    if code == 9:  # E_BUFFER_TOO_SMALL
        raise err_mod.BufferTooSmall(given=int(e.a), min=int(e.b))
    exc = err_mod.error_from_code(code, int(e.a), int(e.b), int(e.c))
    if exc is None:
        raise RuntimeError(f"native codec returned unknown error code {code}")
    raise exc  # includes EOFError for truncated frames


def _threads(threads: int) -> int:
    """0 means "all": ``Config.threads`` when set, else the C++ side
    uses hardware concurrency."""
    if threads == 0 and get_config().threads:
        return max(1, get_config().threads)
    return threads


def _in_rows(arr, dtype):
    """The C side indexes ``base + i * shape[-1]``: check the dtype and
    make sliced (non-contiguous) views contiguous."""
    if arr.dtype != dtype:
        raise TypeError(f"expected {np.dtype(dtype).name} array, got {arr.dtype}")
    return np.ascontiguousarray(arr)


def _out_rows(arr, dtype):
    """A written-to argument: a contiguous copy would drop the results."""
    if arr.dtype != dtype:
        raise TypeError(f"expected {np.dtype(dtype).name} array, got {arr.dtype}")
    if not arr.flags.c_contiguous:
        raise ValueError("output arrays must be C-contiguous")
    return arr


def _raise_first(errs: np.ndarray) -> None:
    """Raise the exception of the first failing ``[code, a, b, c]`` row."""
    bad = np.nonzero(errs[:, 0])[0]
    if bad.size:
        e = _Error()
        e.code, e.a, e.b, e.c = (int(v) for v in errs[int(bad[0])])
        _raise(e)


def _batch(entry: str, srcs, lens, dsts, out_lens, errs, threads: int) -> None:
    srcs = _in_rows(srcs, np.uint8)
    lens = _in_rows(lens, np.uint64)
    dsts = _out_rows(dsts, np.uint8)
    out_lens = _out_rows(out_lens, np.uint64)
    errs = _out_rows(errs, np.uint64)
    getattr(_load(), entry)(
        srcs.ctypes.data, srcs.shape[-1], lens.ctypes.data, dsts.ctypes.data, dsts.shape[-1],
        out_lens.ctypes.data, errs.ctypes.data, lens.shape[0], _threads(threads),
    )


def compress_batch_into(srcs, lens, dsts, out_lens, errs, threads: int = 0) -> None:
    """Compress ``n`` raw streams chunk-parallel across host cores.

    ``srcs``: ``(n, src_stride)`` uint8, row ``i`` holding ``lens[i]``
    (uint64) input bytes; ``dsts``: ``(n, dst_stride)`` uint8 with
    ``dst_stride >= max_compress_len(lens.max())``; ``out_lens``: ``(n,)``
    uint64; ``errs``: ``(n, 4)`` uint64, each row ``[code, a, b, c]`` (0:
    the row compressed). Rows fail on their own; nothing raises. ``threads``
    0 means all: ``Config.threads`` when set, else every core."""
    _batch("stpu_compress_batch", srcs, lens, dsts, out_lens, errs, threads)


def decompress_batch_into(srcs, lens, dsts, out_lens, errs, threads: int = 0) -> None:
    """Decompress ``n`` raw streams (varint header included) into the rows of
    ``dsts``; arguments and ``errs`` as for :func:`compress_batch_into`."""
    _batch("stpu_decompress_batch", srcs, lens, dsts, out_lens, errs, threads)


def compress_batch(blocks: list[bytes], threads: int = 0) -> list[bytes]:
    """Compress byte strings chunk-parallel; raises the first failing row's
    exception in input order (an oversized row's ``TooBig`` before any
    work), as compressing them one by one would."""
    if not blocks:
        return []
    for b in blocks:
        if max_compress_len(len(b)) == 0:
            raise err_mod.TooBig(given=len(b), max=MAX_INPUT_SIZE)
    n, width = len(blocks), max(len(b) for b in blocks)
    srcs = np.zeros((n, max(width, 1)), np.uint8)
    lens = np.empty(n, np.uint64)
    for i, b in enumerate(blocks):
        srcs[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    dsts = np.empty((n, max_compress_len(width)), np.uint8)
    out_lens = np.empty(n, np.uint64)
    errs = np.zeros((n, 4), np.uint64)
    compress_batch_into(srcs, lens, dsts, out_lens, errs, threads)
    _raise_first(errs)
    return [dsts[i, : int(out_lens[i])].tobytes() for i in range(n)]


def compress(data: bytes) -> bytes:
    """The reference encoder's raw stream of ``data`` (sequential host
    codec; the size yardstick of the device encoder)."""
    lib = _load()
    cap = int(lib.stpu_max_compress_len(len(data)))
    out = np.empty(max(cap, 1), dtype=np.uint8)
    e = _Error()
    n = lib.stpu_compress(data, len(data), out.ctypes.data, cap, ctypes.byref(e))
    if n < 0:
        _raise(e)
    return out[:n].tobytes()


def compress_into(data: bytes, out: np.ndarray) -> int:
    """Compress into the caller's uint8 ndarray; returns bytes written.
    The size checks run in C++, with the same errors."""
    if max_compress_len(len(data)) == 0:
        raise err_mod.TooBig(given=len(data), max=MAX_INPUT_SIZE)
    e = _Error()
    n = _load().stpu_compress(data, len(data), out.ctypes.data, out.shape[0], ctypes.byref(e))
    if n < 0:
        _raise(e)
    return n


def decompress_into(data: bytes, out: np.ndarray) -> int:
    """Decompress into the caller's uint8 ndarray; returns bytes written.
    Empty input, header, TooBig and BufferTooSmall are checked in one C++
    call, in the reference's order and with its errors."""
    e = _Error()
    n = _load().stpu_decompress(data, len(data), out.ctypes.data, out.shape[0], ctypes.byref(e))
    if n < 0:
        _raise(e)
    return n


def decompress_len(data: bytes) -> int:
    e = _Error()
    n = _load().stpu_decompress_len(data, len(data), ctypes.byref(e))
    if n < 0:
        _raise(e)
    return n


def decompress(data: bytes) -> bytes:
    """Sequential host decode of one raw stream, with the exact errors."""
    if len(data) == 0:
        raise err_mod.Empty()
    declen = decompress_len(data)
    out = np.empty(max(declen, 1), dtype=np.uint8)
    e = _Error()
    n = _load().stpu_decompress(data, len(data), out.ctypes.data, declen, ctypes.byref(e))
    if n < 0:
        _raise(e)
    return out[:n].tobytes()


def decompress_batch(blocks: list[bytes], threads: int = 0) -> list[bytes]:
    """Decompress raw streams chunk-parallel; raises the first failing
    row's exact exception (input order). Rows whose declared length
    exceeds what their body could produce decode one by one, so a
    crafted header cannot inflate the batch's output stride."""
    if not blocks:
        return []
    n = len(blocks)
    d_cap = 1
    seq = [False] * n
    for i, b in enumerate(blocks):
        try:
            dl = decompress_len(b)
        except err_mod.SnappyError:
            continue
        if dl > (64 * len(b)) // 3 + 64:
            seq[i] = True
        else:
            d_cap = max(d_cap, dl)
    srcs = np.zeros((n, max(max(len(b) for b in blocks), 1)), np.uint8)
    lens = np.empty(n, np.uint64)
    for i, b in enumerate(blocks):
        srcs[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    dsts = np.empty((n, d_cap), np.uint8)
    out_lens = np.empty(n, np.uint64)
    errs = np.zeros((n, 4), np.uint64)
    decompress_batch_into(srcs, lens, dsts, out_lens, errs, threads)
    outs = []
    for i, b in enumerate(blocks):
        if seq[i]:
            outs.append(decompress(b))
            continue
        _raise_first(errs[i : i + 1])
        outs.append(dsts[i, : int(out_lens[i])].tobytes())
    return outs


def scan_ops(body: bytes, bits_out: np.ndarray | None = None) -> np.ndarray:
    """Op-start bitmap of one raw op stream (no varint header): the tag
    walk of ``stpu_scan_ops``, which reads zeros past the body, clamps
    lengths at 2^30 and does not stop at a malformed op, as the tensor
    decode's speculative parse does. Returns a ``(ceil(len / 8),)`` uint8
    little-endian bitmap, or fills ``bits_out`` (which may be wider; its
    tail is left as it is)."""
    nbits = (len(body) + 7) // 8
    if bits_out is None:
        bits_out = np.zeros(max(nbits, 1), np.uint8)
    if bits_out.dtype != np.uint8 or bits_out.shape[0] < nbits or not bits_out.flags.c_contiguous:
        raise ValueError(f"bits_out must be contiguous uint8 of at least {nbits} bytes")
    _load().stpu_scan_ops(body, len(body), bits_out.ctypes.data)
    return bits_out


def scan_ops_batch(srcs, lens, bits, threads: int = 0) -> None:
    """Op-start bitmaps of ``n`` rows at once, chunk-parallel: row ``i``
    of ``bits`` (``(n, stride)`` uint8, zeroed by the caller) takes the
    bitmap of ``srcs[i, :lens[i]]``."""
    srcs = _in_rows(srcs, np.uint8)
    lens = _in_rows(lens, np.uint64)
    if bits.dtype != np.uint8 or not bits.flags.c_contiguous or bits.shape[0] != lens.shape[0]:
        raise ValueError("bits must be contiguous uint8 with one row per stream")
    if bits.shape[1] * 8 < int(lens.max(initial=0)):
        raise ValueError(f"bits rows of {bits.shape[1]} bytes are too short")
    _load().stpu_scan_ops_batch(
        srcs.ctypes.data, srcs.shape[1], lens.ctypes.data, bits.ctypes.data,
        bits.shape[1], lens.shape[0], _threads(threads),
    )


def scan_records_batch(srcs, lens, declens, rec_cap: int, threads: int = 0):
    """Validated op records for ``n`` rows (``stpu_scan_records``): a
    lockstep mirror of the replay kernel's validation. Returns
    ``(recs (n, rec_cap, 2) int32, nops (n,) int64, errs (n,) int32,
    dtotals (n,) int64)``; ``errs`` carries the device error codes."""
    srcs = _in_rows(srcs, np.uint8)
    lens = _in_rows(lens, np.uint64)
    declens = _in_rows(declens, np.uint64)
    n = lens.shape[0]
    recs = np.zeros((n, rec_cap, 2), np.int32)
    nops = np.zeros(n, np.int64)
    errs = np.zeros(n, np.int32)
    dtotals = np.zeros(n, np.int64)
    _load().stpu_scan_records_batch(
        srcs.ctypes.data, srcs.shape[1], lens.ctypes.data, declens.ctypes.data,
        recs.ctypes.data, rec_cap, nops.ctypes.data, errs.ctypes.data,
        dtotals.ctypes.data, n, _threads(threads),
    )
    return recs, nops, errs, dtotals


def flatten_idx_batch(srcs, lens, declens, d_pad: int, threads: int = 0,
                      layout: int = 0):
    """Flatten every copy chain to per-byte literal-source indices.

    The host half of the flat-gather decode (``stpu_flatten_idx``).
    Returns ``(idx_rel (n, d_pad) uint16, tile_meta (n, d_pad//1024, 2)
    int32 [window base row, bucket], fallbacks (n,) int64, errs (n,)
    int32, dtotals (n,) int64)``. ``idx_rel`` is relative to its tile's
    base row (``base*128``); ``fallbacks[i] != 0`` flags a tile whose
    source spread exceeds the widest window (only bodies over 64 KiB),
    and the caller sends the row to the replay kernel. ``layout=1``
    writes ``idx_rel`` in the transposed block order of
    :func:`snappy_tpu_torch.ops.decode_flat.phys_index` and needs
    ``d_pad % 16384 == 0``.
    """
    srcs = _in_rows(srcs, np.uint8)
    lens = _in_rows(lens, np.uint64)
    declens = _in_rows(declens, np.uint64)
    n = lens.shape[0]
    if d_pad % 1024 or srcs.shape[1] % 128:
        raise ValueError(f"d_pad {d_pad} / row width {srcs.shape[1]} not tiled")
    if layout not in (0, 1) or (layout == 1 and d_pad % 16384):
        raise ValueError(f"layout {layout} with d_pad {d_pad}")
    idx_rel = np.zeros((n, d_pad), np.uint16)
    tile_meta = np.zeros((n, d_pad // 1024, 2), np.int32)
    fallbacks = np.zeros(n, np.int64)
    errs = np.zeros(n, np.int32)
    dtotals = np.zeros(n, np.int64)
    _load().stpu_flatten_idx_batch(
        srcs.ctypes.data, srcs.shape[1], lens.ctypes.data, declens.ctypes.data,
        srcs.shape[1] // 128, idx_rel.ctypes.data, d_pad, tile_meta.ctypes.data,
        fallbacks.ctypes.data, errs.ctypes.data, dtotals.ctypes.data, n,
        _threads(threads), layout,
    )
    return idx_rel, tile_meta, fallbacks, errs, dtotals


def frame_compress(data: bytes, threads: int = 0) -> bytes:
    """Frame-encode ``data`` (multithreaded over 64 KiB chunks); chunks
    that compression does not shrink by 1/8 are stored uncompressed."""
    nchunks = -(-len(data) // 65536)
    cap = 10 + nchunks * (8 + 76490)
    out = np.empty(max(cap, 1), dtype=np.uint8)
    e = _Error()
    m = _load().stpu_frame_compress(
        data, len(data), out.ctypes.data, cap, _threads(threads), ctypes.byref(e)
    )
    if m < 0:
        _raise(e)
    return out[:m].tobytes()


def frame_decompress_len(data, n: int | None = None) -> int:
    """Total decompressed size of a whole frame stream (the walk only).

    ``data`` may be bytes or a ctypes char-array view over a mutable
    buffer; ``n`` bounds the walk when the view is longer than the
    stream."""
    e = _Error()
    total = _load().stpu_frame_decompress_len(
        data, len(data) if n is None else n, ctypes.byref(e)
    )
    if total < 0:
        _raise(e)
    return int(total)


def frame_decompress_into(data, out: np.ndarray, threads: int = 0, n: int | None = None) -> int:
    """Decode a whole frame stream into the caller's uint8 ndarray;
    returns bytes written. ``data`` and ``n`` as for
    :func:`frame_decompress_len`: the streaming reader decodes straight
    out of its accumulation buffer into a reused scratch."""
    e = _Error()
    m = _load().stpu_frame_decompress(
        data, len(data) if n is None else n, out.ctypes.data, out.shape[0],
        _threads(threads), ctypes.byref(e),
    )
    if m < 0:
        _raise(e)
    return int(m)


def frame_decompress(data: bytes, threads: int = 0) -> bytes:
    """Decode a whole frame stream on the host, with the streaming
    reader's error semantics (first failing chunk in stream order wins;
    decode errors precede that chunk's checksum check)."""
    out = np.empty(max(frame_decompress_len(data), 1), dtype=np.uint8)
    return out[: frame_decompress_into(data, out, threads)].tobytes()


def crc32c(data: bytes) -> int:
    """Unmasked CRC32C (Castagnoli) of ``data``."""
    return int(_load().stpu_crc32c(data, len(data)))


def crc32c_masked(data: bytes) -> int:
    """Masked CRC32C (hardware CRC instructions where the CPU has them)."""
    return int(_load().stpu_crc32c_masked(data, len(data)))
