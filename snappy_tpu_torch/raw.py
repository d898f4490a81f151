"""Raw Snappy block format: ``Encoder``, ``Decoder``, size helpers.

The port of the JAX package's ``raw.py`` (reference ``src/raw.rs``,
``src/compress.rs:78-169``, ``src/decompress.rs:30-111``): the
into-buffer calls check sizes with the same errors; the ``*_vec`` calls
allocate (returning ``bytes``). Inputs may be ``bytes``, ``bytearray``,
``memoryview`` or 1-D ``uint8`` NumPy arrays. The batched device path is
``snappy_tpu_torch.compress`` / ``decompress``; the ``device`` engines
reach it per call.
"""

from __future__ import annotations

import numpy as np

from . import error as err
from . import native as _native
from .engine import get_engine
from .format.constants import MAX_INPUT_SIZE, max_compress_len
from .format.reference import decompress_len as _ref_decompress_len

__all__ = ["Encoder", "Decoder", "max_compress_len", "decompress_len"]


def _as_bytes(data) -> bytes:
    if isinstance(data, bytes):
        return data
    if isinstance(data, (bytearray, memoryview)):
        return bytes(data)
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8 or data.ndim != 1:
            raise TypeError("numpy inputs must be 1-D uint8 arrays")
        return data.tobytes()
    raise TypeError(f"unsupported input type: {type(data).__name__}")


def _is_native_out(output) -> bool:
    """A writable, contiguous 1-D uint8 ndarray the C++ side can fill."""
    return (
        type(output) is np.ndarray
        and output.dtype == np.uint8
        and output.ndim == 1
        and output.flags.c_contiguous
        and output.flags.writeable
    )


def decompress_len(data) -> int:
    """Decompressed size (in bytes) of the compressed bytes given."""
    return _ref_decompress_len(_as_bytes(data))


class Encoder:
    """Raw-format encoder, reusable across calls.

    ``engine`` picks the execution engine (``auto``, ``native``,
    ``reference``, ``device``, ``device-fast``); all but ``device-fast``
    give the reference's bytes.
    """

    def __init__(self, engine: str = "auto"):
        self._engine = get_engine(engine)

    def compress(self, input, output) -> int:
        """Compress ``input`` into the caller's buffer; returns bytes written.

        ``output`` is a writable buffer (bytearray, uint8 ndarray,
        memoryview) of at least ``max_compress_len(len(input))`` bytes.
        """
        native = self._engine.name == "native"
        if native and type(input) is bytes and _is_native_out(output):
            # One ctypes call into the caller's array, no copy.
            min_len = max_compress_len(len(input))
            if min_len == 0:
                raise err.TooBig(given=len(input), max=MAX_INPUT_SIZE)
            if output.shape[0] < min_len:
                raise err.BufferTooSmall(given=output.shape[0], min=min_len)
            return _native.compress_into(input, output)
        data = _as_bytes(input)
        min_len = max_compress_len(len(data))
        if min_len == 0:
            raise err.TooBig(given=len(data), max=MAX_INPUT_SIZE)
        out_view = memoryview(output).cast("B")
        if len(out_view) < min_len:
            raise err.BufferTooSmall(given=len(out_view), min=min_len)
        if native and not out_view.readonly:
            # Read-only buffers take the slice assignment below, which
            # raises the usual TypeError.
            return _native.compress_into(data, np.frombuffer(out_view, np.uint8))
        result = self._engine.compress(data)
        out_view[: len(result)] = result
        return len(result)

    def compress_vec(self, input) -> bytes:
        """Compress ``input`` into freshly allocated bytes."""
        data = _as_bytes(input)
        if max_compress_len(len(data)) == 0:
            raise err.TooBig(given=len(data), max=MAX_INPUT_SIZE)
        return self._engine.compress(data)


class Decoder:
    """Raw-format decoder, reusable across calls."""

    def __init__(self, engine: str = "auto"):
        self._engine = get_engine(engine)

    def decompress(self, input, output) -> int:
        """Decompress ``input`` into the caller's buffer; returns bytes written."""
        native = self._engine.name == "native"
        if native and type(input) is bytes and _is_native_out(output):
            # Empty input, header, TooBig and BufferTooSmall are checked
            # in C++, in the order of the path below, with its errors.
            return _native.decompress_into(input, output)
        data = _as_bytes(input)
        if len(data) == 0:
            raise err.Empty()
        declen = self._engine.decompress_len(data)
        out_view = memoryview(output).cast("B")
        if declen > len(out_view):
            raise err.BufferTooSmall(given=len(out_view), min=declen)
        if native and not out_view.readonly:
            return _native.decompress_into(data, np.frombuffer(out_view, np.uint8))
        result = self._engine.decompress(data)
        out_view[: len(result)] = result
        return len(result)

    def decompress_vec(self, input) -> bytes:
        """Decompress ``input`` into freshly allocated bytes."""
        data = _as_bytes(input)
        if len(data) == 0:
            raise err.Empty()
        return self._engine.decompress(data)
