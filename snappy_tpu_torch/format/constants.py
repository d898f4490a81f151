"""Frozen Snappy format constants.

These mirror the format contract of the reference implementation
(BurntSushi/rust-snappy):

- ``MAX_INPUT_SIZE`` / ``MAX_BLOCK_SIZE``: reference ``src/lib.rs:93-97``.
- Tag encodings: reference ``src/compress.rs:27-36``.
- Frame constants: reference ``src/frame.rs:12-35``.
- CRC32C (Castagnoli) polynomial and mask delta: reference ``build.rs:6``
  and ``src/crc32.rs:35-38``.

Everything in this module is part of the wire format and must never change.
Execution-tuning knobs (batch sizes, mesh shapes) live in
``snappy_tpu_torch.config`` instead.
"""

# ---------------------------------------------------------------------------
# Raw block format
# ---------------------------------------------------------------------------

#: Maximum number of bytes a single raw Snappy stream may decompress to.
MAX_INPUT_SIZE = 2**32 - 1

#: The unit at which the compressor scans for candidates. Match offsets never
#: cross a block boundary, which is what makes blocks independently
#: (de)compressible and therefore independently decodable.
MAX_BLOCK_SIZE = 1 << 16

#: 2-bit tag discriminators (low two bits of every op's first byte).
TAG_LITERAL = 0b00
TAG_COPY1 = 0b01
TAG_COPY2 = 0b10
TAG_COPY4 = 0b11  # Never emitted by the encoder; must be decoded.

#: Number of bytes at the end of a block the reference encoder leaves
#: unconsidered for matches (wiggle room for wide copies).
INPUT_MARGIN = 16 - 1

#: Blocks smaller than this are emitted as a single literal.
MIN_NON_LITERAL_BLOCK_SIZE = 1 + 1 + INPUT_MARGIN

#: LZ77 hash table sizing (reference ``src/compress.rs:11-15``).
MAX_TABLE_SIZE = 1 << 14
SMALL_TABLE_SIZE = 1 << 10

#: Multiplier of the 4-byte-sequence hash (reference ``src/compress.rs:522-525``).
HASH_MULTIPLIER = 0x1E35A7BD


def max_compress_len(input_len: int) -> int:
    """Maximum possible compressed size for ``input_len`` input bytes.

    Returns 0 if the input (or its bound) exceeds ``MAX_INPUT_SIZE``.
    Mirrors reference ``src/compress.rs:42-53``.
    """
    if input_len > MAX_INPUT_SIZE:
        return 0
    max_len = 32 + input_len + input_len // 6
    return 0 if max_len > MAX_INPUT_SIZE else max_len


# ---------------------------------------------------------------------------
# Frame (streaming) format
# ---------------------------------------------------------------------------

#: ``max_compress_len(MAX_BLOCK_SIZE)`` — the largest chunk payload a frame
#: stream may carry (reference ``src/frame.rs:12``).
MAX_COMPRESS_BLOCK_SIZE = 76490
assert MAX_COMPRESS_BLOCK_SIZE == max_compress_len(MAX_BLOCK_SIZE)

#: Magic chunk that starts every frame stream. It may legally recur
#: mid-stream (file concatenation). Reference ``src/frame.rs:18``.
STREAM_IDENTIFIER = b"\xFF\x06\x00\x00sNaPpY"
STREAM_BODY = b"sNaPpY"

#: Chunk type byte (1) + 3-byte little-endian length + 4-byte CRC.
CHUNK_HEADER_AND_CRC_SIZE = 8

#: Defined chunk types (reference ``src/frame.rs:30-35``). Types
#: 0x02-0x7F are reserved-unskippable (decode error); 0x80-0xFD are
#: reserved-skippable.
CHUNK_TYPE_STREAM = 0xFF
CHUNK_TYPE_COMPRESSED = 0x00
CHUNK_TYPE_UNCOMPRESSED = 0x01
CHUNK_TYPE_PADDING = 0xFE

# ---------------------------------------------------------------------------
# CRC32C
# ---------------------------------------------------------------------------

#: Castagnoli polynomial (reflected form).
CASTAGNOLI_POLY = 0x82F63B78

#: Snappy's checksum masking delta (reference ``src/crc32.rs:35-38``).
CRC_MASK_DELTA = 0xA282EAD8


def mask_crc(crc: int) -> int:
    """Apply Snappy's CRC masking: rotate right 15 then add the delta."""
    crc &= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + CRC_MASK_DELTA) & 0xFFFFFFFF


def unmask_crc(masked: int) -> int:
    """Inverse of :func:`mask_crc` (handy for tests)."""
    masked &= 0xFFFFFFFF
    rot = (masked - CRC_MASK_DELTA) & 0xFFFFFFFF
    return ((rot << 15) | (rot >> 17)) & 0xFFFFFFFF
