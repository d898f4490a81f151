"""Parquet data pages compressed with Snappy, as parquet-mr writes them:
the benchmark's plain reference for page reads.

parquet-format's ``Compression.md`` defines SNAPPY as the raw block
format: one raw stream a page (its length preamble, then its ops), no
framing and no checksum; the page header gives ``uncompressed_page_size``.
A GPU reader decodes every page of a row group in one batched call.

- :func:`row_group` lays out one row group: columns filled in turn, one
  page a column a round, each page ``page_chunks`` whole chunks of its
  column (cycled), until the next page would pass ``group_bytes`` of
  compressed pages; that page is cut to the whole chunks that still fit,
  and the row group ends there.
- A page's raw stream is its chunks' op streams after one preamble: the
  reference encoder compresses every 64 KiB fragment on its own, so that
  is what it makes of a page of whole chunks.
- :func:`decode_pages` decodes each page with ``snappy.decompress`` and
  turns an error into that page's code, so that a bad page leaves the
  others of its row group as they are.
- :func:`break_copy` makes a page invalid whatever its bytes: one copy's
  offset set past the bytes decoded before it.

Plain Python and NumPy; it imports nothing of the port (nor JAX).
"""

from __future__ import annotations

from . import snappy as ref

#: A page's code in :func:`decode_pages`: decoded, or not a valid stream.
OK = 0
BAD = 1


def stream_bytes(raw_len: int, op_bytes: int) -> int:
    """Compressed bytes of a page: its preamble and its ops."""
    return len(ref.varint(raw_len)) + op_bytes


def row_group(columns: list[list[int]], op_len: list[int], chunk_bytes: int, page_chunks: int,
              group_bytes: int) -> list[list[int]]:
    """The pages of one row group, each the list of its chunk ids.

    ``columns[c]`` lists column ``c``'s chunks in turn (cycled when a
    column runs out); ``op_len[i]`` is chunk ``i``'s op stream length, and
    every chunk holds ``chunk_bytes``. The pages come in the order they
    are written: round by round, column by column."""
    if not columns or not all(columns):
        raise ValueError("every column needs at least one chunk")
    at = [0] * len(columns)
    pages: list[list[int]] = []
    total = 0
    while True:
        for c, col in enumerate(columns):
            ids = [col[(at[c] + k) % len(col)] for k in range(page_chunks)]
            for k in range(page_chunks, 0, -1):
                size = stream_bytes(k * chunk_bytes, sum(op_len[i] for i in ids[:k]))
                if total + size <= group_bytes:
                    break
            else:
                return pages
            pages.append(ids[:k])
            total += size
            at[c] += k
            if k < page_chunks:
                return pages


def decode_pages(bodies: list[bytes], declens: list[int]) -> tuple[list[bytes], list[int]]:
    """Each page's bytes and code: ``bodies`` are the pages' op streams
    (no preamble), ``declens`` their ``uncompressed_page_size``. A page
    that is not a valid stream of its declared length gets :data:`BAD`
    and no bytes."""
    outs, codes = [], []
    for body, n in zip(bodies, declens):
        try:
            outs.append(ref.decompress(ref.varint(n) + body))
            codes.append(OK)
        except ValueError:
            outs.append(b"")
            codes.append(BAD)
    return outs, codes


def _ops(body: bytes):
    """``(tag position, kind, output position)`` of each op of an op stream
    (no preamble), in order."""
    pos = out = 0
    while pos < len(body):
        tag = body[pos]
        kind = tag & 3
        yield pos, kind, out
        if kind == 0:
            n = (tag >> 2) + 1
            extra = n - 60 if n > 60 else 0
            if extra:
                n = int.from_bytes(body[pos + 1 : pos + 1 + extra], "little") + 1
            pos += 1 + extra + n
            out += n
        elif kind == 1:
            pos += 2
            out += ((tag >> 2) & 7) + 4
        else:
            pos += 3 if kind == 2 else 5
            out += (tag >> 2) + 1


#: The largest offset each copy kind holds: 11, 16 and 32 bits.
_MAX_OFFSET = {1: (1 << 11) - 1, 2: (1 << 16) - 1, 3: (1 << 32) - 1}


def break_copy(body: bytes, draw: int) -> bytes:
    """``body`` with one copy's offset set past the bytes decoded before
    it, so that no decoder may accept the stream: among the copies whose
    offset field can hold such a value, the ``draw``-th (modulo their
    count), its offset one past the output before it plus ``draw`` within
    the field."""
    can = []
    for pos, kind, out in _ops(body):
        if out >= _MAX_OFFSET[2]:
            break
        if kind and out < _MAX_OFFSET[kind]:
            can.append((pos, kind, out))
    if not can:
        raise ValueError("the page has no copy whose offset can pass its output")
    pos, kind, out = can[draw % len(can)]
    off = out + 1 + draw % (_MAX_OFFSET[kind] - out)
    b = bytearray(body)
    if kind == 1:
        b[pos] = (b[pos] & 0x1F) | ((off >> 8) << 5)
        b[pos + 1] = off & 0xFF
    else:
        k = 2 if kind == 2 else 4
        b[pos + 1 : pos + 1 + k] = off.to_bytes(k, "little")
    return bytes(b)
