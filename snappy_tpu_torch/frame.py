"""Frame-format core: chunk taxonomy and single-chunk construction.

The port of the JAX package's ``frame.py`` (reference ``src/frame.rs``):
each chunk carries the masked CRC32C of its uncompressed payload, and a
chunk is stored uncompressed when compression saves less than 1/8.
"""

from __future__ import annotations

import enum

from .engine import HostEngine
from .format.constants import (
    CHUNK_HEADER_AND_CRC_SIZE,
    CHUNK_TYPE_COMPRESSED,
    CHUNK_TYPE_PADDING,
    CHUNK_TYPE_STREAM,
    CHUNK_TYPE_UNCOMPRESSED,
    MAX_BLOCK_SIZE,
    MAX_COMPRESS_BLOCK_SIZE,
    STREAM_BODY,
    STREAM_IDENTIFIER,
)
from .format.varint import read_varu64

__all__ = [
    "ChunkType",
    "compress_frame",
    "scan_stream_prefix",
    "STREAM_IDENTIFIER",
    "STREAM_BODY",
    "CHUNK_HEADER_AND_CRC_SIZE",
    "MAX_COMPRESS_BLOCK_SIZE",
]


class ChunkType(enum.IntEnum):
    Stream = CHUNK_TYPE_STREAM
    Compressed = CHUNK_TYPE_COMPRESSED
    Uncompressed = CHUNK_TYPE_UNCOMPRESSED
    Padding = CHUNK_TYPE_PADDING

    @staticmethod
    def from_u8(b: int):
        """A ChunkType, or the raw byte for reserved types."""
        try:
            return ChunkType(b)
        except ValueError:
            return b


def scan_stream_prefix(data: bytes) -> tuple[int, int]:
    """Longest valid chunk-aligned prefix of a frame stream.

    Returns ``(stream_bytes, source_bytes)``: how many bytes of ``data``
    form structurally complete chunks, and how many uncompressed bytes
    those chunks cover. Streams restart at chunk granularity and stream
    identifiers may recur, so a stream cut at ``stream_bytes`` followed by
    a fresh stream of the remaining source encodes the whole input.
    Declared lengths are trusted; decompression still checks the CRCs.
    """
    pos = 0
    source = 0
    n = len(data)
    seen_ident = False
    while True:
        if pos + 4 > n:
            return pos, source
        ty = data[pos]
        length = data[pos + 1] | (data[pos + 2] << 8) | (data[pos + 3] << 16)
        if not seen_ident and ty != CHUNK_TYPE_STREAM:
            return pos, source
        if length > MAX_COMPRESS_BLOCK_SIZE or pos + 4 + length > n:
            return pos, source
        body = data[pos + 4 : pos + 4 + length]
        if ty == CHUNK_TYPE_STREAM:
            if body != STREAM_BODY:
                return pos, source
            seen_ident = True
        elif ty == CHUNK_TYPE_UNCOMPRESSED:
            if length < 4:
                return pos, source
            source += length - 4
        elif ty == CHUNK_TYPE_COMPRESSED:
            if length < 4:
                return pos, source
            declen, hdr = read_varu64(body[4:])
            if hdr == 0 or declen > MAX_BLOCK_SIZE:
                return pos, source
            source += declen
        elif 0x02 <= ty <= 0x7F:
            return pos, source  # reserved-unskippable: not ours
        # padding and reserved-skippable chunks carry no source bytes
        pos += 4 + length


def compress_frame(engine: HostEngine, src: bytes) -> tuple[bytes, bytes]:
    """One frame chunk for ``src`` (at most ``MAX_BLOCK_SIZE`` bytes).

    Returns ``(chunk_header, payload)``: the 8-byte {type, u24 length, u32
    masked CRC} prefix, and the compressed bytes, or ``src`` itself when
    compression saved less than 1/8.
    """
    if len(src) > MAX_BLOCK_SIZE:
        raise ValueError(f"a frame chunk holds at most {MAX_BLOCK_SIZE} bytes, got {len(src)}")
    checksum = engine.crc32c_masked(src)
    compressed = engine.compress(src)
    if len(compressed) >= len(src) - (len(src) // 8):
        chunk_type, payload = ChunkType.Uncompressed, src
    else:
        chunk_type, payload = ChunkType.Compressed, compressed
    chunk_len = 4 + len(payload)
    header = bytes(
        (
            int(chunk_type),
            chunk_len & 0xFF,
            (chunk_len >> 8) & 0xFF,
            (chunk_len >> 16) & 0xFF,
            checksum & 0xFF,
            (checksum >> 8) & 0xFF,
            (checksum >> 16) & 0xFF,
            (checksum >> 24) & 0xFF,
        )
    )
    return header, payload
