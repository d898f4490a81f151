"""Derived format tables, computed at import time.

The reference generates these at build time (``build.rs:28-124``); here they
are small vectorized NumPy computations. Both the NumPy reference codec and
the CUDA kernels' wrappers consume them.
"""

from __future__ import annotations

import functools

import numpy as np

from .constants import CASTAGNOLI_POLY


@functools.cache
def tag_lookup_table() -> np.ndarray:
    """256-entry u16 table mapping a tag byte to its decoded attributes.

    Bit layout ``xxaa abbb xxcc cccc`` (reference ``src/decompress.rs:377-398``):

    - ``a`` (bits 11-13): number of bytes following the tag byte that encode
      the rest of the op header (copy offset trailer, or literal length
      trailer for long literals);
    - ``b`` (bits 8-10): the three high offset bits baked into a copy-1 tag,
      pre-positioned so they OR directly with the 8-bit trailer;
    - ``c`` (bits 0-7): the copy length (or literal length when <= 60).

    Semantics match reference ``build.rs:40-67``.
    """
    b = np.arange(256, dtype=np.uint32)
    kind = b & 0b11

    lit_len = (b >> 2) + 1
    lit_entry = np.where(lit_len <= 60, lit_len, (lit_len - 60) << 11)

    copy1_len = 4 + ((b >> 2) & 0b111)
    copy1_off_hi = (b >> 5) & 0b111
    copy1_entry = (1 << 11) | (copy1_off_hi << 8) | copy1_len

    copy2_entry = (2 << 11) | (1 + (b >> 2))
    copy4_entry = (4 << 11) | (1 + (b >> 2))

    entry = np.select(
        [kind == 0, kind == 1, kind == 2],
        [lit_entry, copy1_entry, copy2_entry],
        default=copy4_entry,
    )
    return entry.astype(np.uint16)


@functools.cache
def crc32c_table() -> np.ndarray:
    """Standard reflected CRC32C byte table, shape (256,) u32."""
    crc = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        crc = np.where(crc & 1, (crc >> 1) ^ np.uint32(CASTAGNOLI_POLY), crc >> 1)
    return crc


@functools.cache
def crc32c_table16() -> np.ndarray:
    """Slicing-by-16 tables, shape (16, 256) u32.

    ``table16[j][i]`` advances a CRC whose byte ``i`` sits ``j`` positions
    before the end of a 16-byte window (reference ``build.rs:97-108``).
    """
    t0 = crc32c_table()
    tab = np.zeros((16, 256), dtype=np.uint32)
    tab[0] = t0
    for j in range(1, 16):
        prev = tab[j - 1]
        tab[j] = (prev >> 8) ^ t0[(prev & 0xFF).astype(np.int64)]
    return tab


#: WORD_MASK[k] masks the low k bytes of a little-endian u32 read
#: (reference ``src/decompress.rs:17``).
WORD_MASK = np.array([0, 0xFF, 0xFFFF, 0xFFFFFF, 0xFFFFFFFF], dtype=np.uint64)
