"""Host<->device marshalling: bytes to fixed-shape batches and back.

The device codecs operate on fixed-shape ``uint8`` batches (``(B, S)``)
plus per-row length vectors. Variable-length data is handled with
zero-padding + length bookkeeping, never dynamic shapes (a bounded set of
widths keeps the kernels' launch shapes few).

Padding is always with zero bytes: the decode kernels read
the padded rows and the CRC kernel ignores bytes past each length.
"""

from __future__ import annotations

import numpy as np

from ..format.constants import MAX_BLOCK_SIZE


def pad_to_bucket(n: int, minimum: int = 1024) -> int:
    """Round ``n`` up to a power-of-two bucket (>= ``minimum``).

    Bucketing bounds the number of distinct row widths the host API
    can launch with.
    """
    b = minimum
    while b < n:
        b *= 2
    return b


def blocks_of(data: bytes, block_size: int = MAX_BLOCK_SIZE) -> tuple[np.ndarray, np.ndarray]:
    """Split ``data`` into zero-padded fixed-size blocks.

    Returns ``(blocks, lengths)`` where ``blocks`` is ``(B, block_size)``
    uint8 (zero-padded) and ``lengths`` is ``(B,)`` int32. Reference
    analogue: the per-64KiB outer loop, ``src/compress.rs:129-152``.
    """
    n = len(data)
    nblocks = max(1, -(-n // block_size))
    blocks = np.zeros((nblocks, block_size), dtype=np.uint8)
    lengths = np.zeros(nblocks, dtype=np.int32)
    arr = np.frombuffer(data, dtype=np.uint8)
    for i in range(nblocks):
        chunk = arr[i * block_size : (i + 1) * block_size]
        blocks[i, : len(chunk)] = chunk
        lengths[i] = len(chunk)
    return blocks, lengths


def batch_streams(
    streams: list[bytes], width: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Pack a list of byte strings into one zero-padded ``(B, width)`` batch."""
    maxlen = max((len(s) for s in streams), default=0)
    if width is None:
        width = pad_to_bucket(max(maxlen, 1))
    if maxlen > width:
        raise ValueError(f"stream of {maxlen} bytes exceeds batch width {width}")
    out = np.zeros((len(streams), width), dtype=np.uint8)
    lengths = np.zeros(len(streams), dtype=np.int32)
    for i, s in enumerate(streams):
        out[i, : len(s)] = np.frombuffer(s, dtype=np.uint8)
        lengths[i] = len(s)
    return out, lengths


def unbatch_streams(batch: np.ndarray, lengths: np.ndarray) -> list[bytes]:
    """Inverse of :func:`batch_streams` (trims each row to its length)."""
    batch = np.asarray(batch, dtype=np.uint8)
    lengths = np.asarray(lengths)
    return [batch[i, : int(lengths[i])].tobytes() for i in range(batch.shape[0])]


def concat_rows(batch: np.ndarray, lengths: np.ndarray) -> bytes:
    """Ordered concatenation of the valid prefix of every row.

    This is the stream-assembly step: per-row compressed lengths are the
    only cross-block information the format needs (SURVEY.md §2 checklist,
    item 1 — gather compressed chunks in stream order).
    """
    return b"".join(unbatch_streams(batch, lengths))
