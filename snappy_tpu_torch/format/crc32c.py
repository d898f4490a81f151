"""Host reference CRC32C (Castagnoli), with Snappy's masking.

Slicing-by-16 formulation (reference ``src/crc32.rs:85-111``). This is the
correctness oracle; the native C++ runtime (hardware CRC instructions) and
the CUDA kernel (``ops/crc32c.py``) are the fast paths.
"""

from __future__ import annotations


from .constants import mask_crc
from .tables import crc32c_table, crc32c_table16


def crc32c(data: bytes) -> int:
    """Plain (unmasked) CRC32C of ``data``."""
    t16 = crc32c_table16()
    t = crc32c_table()
    # Work in Python ints; ~n/16 iterations of 16 table lookups.
    tl = [row.tolist() for row in t16]
    t0 = t.tolist()
    crc = 0xFFFFFFFF
    n = len(data)
    i = 0
    if n >= 16:
        mv = memoryview(data)
        while i + 16 <= n:
            b = mv[i : i + 16]
            crc ^= b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24)
            crc = (
                tl[0][b[15]]
                ^ tl[1][b[14]]
                ^ tl[2][b[13]]
                ^ tl[3][b[12]]
                ^ tl[4][b[11]]
                ^ tl[5][b[10]]
                ^ tl[6][b[9]]
                ^ tl[7][b[8]]
                ^ tl[8][b[7]]
                ^ tl[9][b[6]]
                ^ tl[10][b[5]]
                ^ tl[11][b[4]]
                ^ tl[12][(crc >> 24) & 0xFF]
                ^ tl[13][(crc >> 16) & 0xFF]
                ^ tl[14][(crc >> 8) & 0xFF]
                ^ tl[15][crc & 0xFF]
            )
            i += 16
    for b in data[i:]:
        crc = t0[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c_masked(data: bytes) -> int:
    """Snappy's masked CRC32C, as stored in frame chunk headers."""
    return mask_crc(crc32c(data))
