"""ctypes binding to the system C++ libsnappy — the independent oracle.

The reference's strongest correctness weapon is differential testing against
Google's C++ snappy via an FFI shim (reference ``snappy-cpp/src/lib.rs:13-64``,
used by ``test/tests.rs:90-160`` and the 10,000-case quickcheck pair at
``test/tests.rs:547-573``).  This module, a copy of the JAX package's
``utils/cpp_oracle.py``, fills the same role for the PyTorch port: a thin binding to ``libsnappy.so.1``'s C API (``snappy-c.h``) that the test
suite uses to cross-check every engine against an implementation written by
a different team.

The binding is optional: :func:`available` returns False (and the tests that
need it skip, deciding in a fixture) when the shared library is absent.  Nothing in the codec itself
depends on it.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

# snappy_status values from snappy-c.h.
_OK = 0
_INVALID_INPUT = 1
_BUFFER_TOO_SMALL = 2

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_CANDIDATES = (
    "libsnappy.so.1",
    "libsnappy.so",
    "/lib/x86_64-linux-gnu/libsnappy.so.1",
)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    names = list(_CANDIDATES)
    found = ctypes.util.find_library("snappy")
    if found:
        names.insert(0, found)
    for name in names:
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        try:
            lib.snappy_compress.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.snappy_compress.restype = ctypes.c_int
            lib.snappy_uncompress.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.snappy_uncompress.restype = ctypes.c_int
            lib.snappy_max_compressed_length.argtypes = [ctypes.c_size_t]
            lib.snappy_max_compressed_length.restype = ctypes.c_size_t
            lib.snappy_uncompressed_length.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.snappy_uncompressed_length.restype = ctypes.c_int
        except AttributeError:
            continue
        _LIB = lib
        break
    return _LIB


def available() -> bool:
    """True when the system libsnappy was found and bound."""
    return _load() is not None


def max_compressed_length(n: int) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("libsnappy not available")
    return int(lib.snappy_max_compressed_length(n))


def compress(data: bytes) -> bytes:
    """Compress via C++ snappy (reference ``snappy-cpp/src/lib.rs:13-38``)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libsnappy not available")
    out_len = ctypes.c_size_t(lib.snappy_max_compressed_length(len(data)))
    out = ctypes.create_string_buffer(out_len.value)
    status = lib.snappy_compress(data, len(data), out, ctypes.byref(out_len))
    if status != _OK:
        raise RuntimeError(f"snappy_compress failed with status {status}")
    return out.raw[: out_len.value]


def uncompressed_length(data: bytes) -> int:
    """Parse the varint preamble via C++ snappy; raises on invalid input."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libsnappy not available")
    n = ctypes.c_size_t(0)
    status = lib.snappy_uncompressed_length(data, len(data), ctypes.byref(n))
    if status != _OK:
        raise ValueError(f"snappy_uncompressed_length status {status}")
    return int(n.value)


def decompress(data: bytes) -> bytes:
    """Decompress via C++ snappy (reference ``snappy-cpp/src/lib.rs:40-64``).

    Raises ValueError on invalid input, mirroring the Rust shim's panic on
    non-Ok status.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("libsnappy not available")
    n = ctypes.c_size_t(uncompressed_length(data))
    out = ctypes.create_string_buffer(max(1, n.value))
    status = lib.snappy_uncompress(data, len(data), out, ctypes.byref(n))
    if status != _OK:
        raise ValueError(f"snappy_uncompress status {status}")
    return out.raw[: n.value]
