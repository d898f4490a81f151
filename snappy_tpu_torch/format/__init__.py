"""The Snappy format, executed: constants, varints, tables, reference codec."""

from . import constants, reference, tables, varint
from .constants import (
    MAX_BLOCK_SIZE,
    MAX_COMPRESS_BLOCK_SIZE,
    MAX_INPUT_SIZE,
    STREAM_IDENTIFIER,
    mask_crc,
    max_compress_len,
)

__all__ = [
    "constants",
    "reference",
    "tables",
    "varint",
    "MAX_BLOCK_SIZE",
    "MAX_COMPRESS_BLOCK_SIZE",
    "MAX_INPUT_SIZE",
    "STREAM_IDENTIFIER",
    "mask_crc",
    "max_compress_len",
]
