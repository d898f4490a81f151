"""Slow, obviously-correct host codec: the executable format spec.

This NumPy/Python implementation is the correctness oracle for the native
runtime and the CUDA kernels. It reproduces the reference
encoder's emission choices byte-for-byte (greedy matcher, skip schedule,
hash-table sizing, copy splitting — reference ``src/compress.rs``) and the
reference decoder's exact error taxonomy (``src/decompress.rs``), so its
output is bit-identical to both rust-snappy and C++ snappy.

It is *not* a performance path; the native C++ runtime and the CUDA kernels
are.
"""

from __future__ import annotations

import numpy as np

from .. import error as err
from .constants import (
    HASH_MULTIPLIER,
    INPUT_MARGIN,
    MAX_BLOCK_SIZE,
    MAX_INPUT_SIZE,
    MAX_TABLE_SIZE,
    MIN_NON_LITERAL_BLOCK_SIZE,
    TAG_COPY1,
    TAG_COPY2,
    TAG_LITERAL,
    max_compress_len,
)
from .tables import tag_lookup_table
from .varint import read_varu64, write_varu64

_U32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------


def compress(data: bytes) -> bytes:
    """Compress ``data`` into a raw Snappy block stream (varint preamble +
    ops). Bit-identical to the reference encoder."""
    n = len(data)
    if max_compress_len(n) == 0:
        raise err.TooBig(given=n, max=MAX_INPUT_SIZE)
    if n == 0:
        return b"\x00"
    out = bytearray(write_varu64(n))
    for start in range(0, n, MAX_BLOCK_SIZE):
        _compress_block(data[start : start + MAX_BLOCK_SIZE], out)
    return bytes(out)


def _emit_literal(src: bytes, lit_start: int, lit_end: int, out: bytearray) -> None:
    """Emit a literal op for ``src[lit_start:lit_end]`` (length >= 1)."""
    n = (lit_end - lit_start) - 1
    if n <= 59:
        out.append((n << 2) | TAG_LITERAL)
    elif n < 256:
        out.append((60 << 2) | TAG_LITERAL)
        out.append(n)
    else:
        out.append((61 << 2) | TAG_LITERAL)
        out.append(n & 0xFF)
        out.append((n >> 8) & 0xFF)
    out += src[lit_start:lit_end]


def _emit_copy(offset: int, length: int, out: bytearray) -> None:
    """Emit copy ops totalling ``length`` bytes at ``offset``.

    Splitting mirrors reference ``src/compress.rs:323-357``: lengths >= 68
    peel 64-byte copy-2 ops; a 65..67 remainder peels a 60-byte copy-2 so the
    tail stays >= 4 and copy-1 eligible.
    """
    while length >= 68:
        _emit_copy2(offset, 64, out)
        length -= 64
    if length > 64:
        _emit_copy2(offset, 60, out)
        length -= 60
    if length <= 11 and offset <= 2047:
        out.append(((offset >> 8) << 5) | ((length - 4) << 2) | TAG_COPY1)
        out.append(offset & 0xFF)
    else:
        _emit_copy2(offset, length, out)


def _emit_copy2(offset: int, length: int, out: bytearray) -> None:
    out.append(((length - 1) << 2) | TAG_COPY2)
    out.append(offset & 0xFF)
    out.append((offset >> 8) & 0xFF)


def _block_table_params(block_size: int) -> tuple[int, int]:
    """(shift, table_size) per reference ``src/compress.rs:491-518``."""
    shift = 32 - 8
    table_size = 256
    while table_size < MAX_TABLE_SIZE and table_size < block_size:
        shift -= 1
        table_size *= 2
    return shift, table_size


def _compress_block(src: bytes, out: bytearray) -> None:
    """Greedy LZ77 over one block of at most MAX_BLOCK_SIZE bytes.

    This is the exact automaton of reference ``src/compress.rs:195-317``:
    one hash probe per iteration with an accelerating skip, match extension
    to the first mismatching byte, and the double-hash-update after each
    copy. Any deviation changes emitted bytes and breaks golden-data tests.
    """
    n = len(src)
    if n < MIN_NON_LITERAL_BLOCK_SIZE:
        _emit_literal(src, 0, n, out)
        return

    shift, table_size = _block_table_params(n)
    table = [0] * table_size

    a = np.frombuffer(src, dtype=np.uint8)
    # Little-endian u32 at every position 0..n-4, precomputed for speed.
    u32 = (
        a[: n - 3].astype(np.uint32)
        | (a[1 : n - 2].astype(np.uint32) << 8)
        | (a[2 : n - 1].astype(np.uint32) << 16)
        | (a[3:n].astype(np.uint32) << 24)
    ).tolist()

    def hash_(x: int) -> int:
        return ((x * HASH_MULTIPLIER) & _U32) >> shift

    s = 1
    s_limit = n - INPUT_MARGIN
    next_emit = 0
    next_hash = hash_(u32[s])

    def done() -> None:
        if next_emit < n:
            _emit_literal(src, next_emit, n, out)

    while True:
        # Candidate scan with the accelerating skip heuristic.
        skip = 32
        s_next = s
        while True:
            s = s_next
            bytes_between = skip >> 5
            s_next = s + bytes_between
            skip += bytes_between
            if s_next > s_limit:
                return done()
            candidate = table[next_hash]
            table[next_hash] = s
            next_hash = hash_(u32[s_next])
            if u32[s] == u32[candidate]:
                break

        _emit_literal(src, next_emit, s, out)

        while True:
            base = s
            s += 4
            # Extend the match: advance past the common prefix of
            # src[s:] and src[candidate+4:].
            cand = candidate + 4
            limit = n - s
            neq = a[s:n] != a[cand : cand + limit]
            mismatch = int(np.argmax(neq)) if neq.any() else limit
            s += mismatch

            _emit_copy(base - candidate, s - base, out)
            next_emit = s
            if s >= s_limit:
                return done()

            # One 8-byte load in the reference updates two table slots and
            # yields the next probe value.
            table[hash_(u32[s - 1])] = s - 1
            cur = u32[s]
            cur_hash = hash_(cur)
            candidate = table[cur_hash]
            table[cur_hash] = s
            if cur != u32[candidate]:
                next_hash = hash_(u32[s + 1])
                s += 1
                break


# ---------------------------------------------------------------------------
# Decompression
# ---------------------------------------------------------------------------


def decompress_len(data: bytes) -> int:
    """Decompressed size promised by the stream header."""
    if len(data) == 0:
        return 0
    return _read_header(data)[0]


def _read_header(data: bytes) -> tuple[int, int]:
    """Returns (decompress_len, header_len) or raises."""
    declen, hdr_len = read_varu64(data)
    if hdr_len == 0:
        raise err.Header()
    if declen > MAX_INPUT_SIZE:
        raise err.TooBig(given=declen, max=MAX_INPUT_SIZE)
    return declen, hdr_len


def decompress(data: bytes) -> bytes:
    """Decompress a raw Snappy stream, with the reference's exact errors."""
    if len(data) == 0:
        raise err.Empty()
    declen, hdr_len = _read_header(data)
    src = data[hdr_len:]
    dst = bytearray(declen)
    d = _decompress_ops(src, dst)
    if d != declen:
        raise err.HeaderMismatch(expected_len=declen, got_len=d)
    return bytes(dst)


def _decompress_ops(src: bytes, dst: bytearray) -> int:
    """Run the tag-dispatch loop; returns bytes written."""
    tag_table = tag_lookup_table()
    src_len = len(src)
    dst_len = len(dst)
    s = 0
    d = 0
    while s < src_len:
        byte = src[s]
        s += 1
        if byte & 0b11 == TAG_LITERAL:
            length = (byte >> 2) + 1
            if length >= 61:
                # Long literal: 1-4 trailing length bytes. The reference
                # demands 4 readable bytes here regardless of byte_count.
                if s + 4 > src_len:
                    raise err.Literal(len=4, src_len=src_len - s, dst_len=dst_len - d)
                byte_count = length - 60
                length = (
                    int.from_bytes(src[s : s + 4], "little")
                    & int(0xFFFFFFFF >> (8 * (4 - byte_count)))
                ) + 1
                s += byte_count
            if src_len - s < length or dst_len - d < length:
                raise err.Literal(len=length, src_len=src_len - s, dst_len=dst_len - d)
            dst[d : d + length] = src[s : s + length]
            s += length
            d += length
        else:
            entry = int(tag_table[byte])
            num_tag_bytes = entry >> 11
            length = entry & 0xFF
            # Offset trailer read, mirroring TagEntry::offset.
            if s + 4 <= src_len:
                trailer = int.from_bytes(src[s : s + 4], "little") & int(
                    (1 << (8 * num_tag_bytes)) - 1
                )
            elif num_tag_bytes == 1:
                if s >= src_len:
                    raise err.CopyRead(len=1, src_len=src_len - s)
                trailer = src[s]
            elif num_tag_bytes == 2:
                if s + 1 >= src_len:
                    raise err.CopyRead(len=2, src_len=src_len - s)
                trailer = src[s] | (src[s + 1] << 8)
            else:
                raise err.CopyRead(len=num_tag_bytes, src_len=src_len - s)
            offset = (entry & 0b0000_0111_0000_0000) | trailer
            s += num_tag_bytes

            if offset == 0 or d < offset:
                raise err.Offset(offset=offset, dst_pos=d)
            end = d + length
            if end > dst_len:
                raise err.CopyWrite(len=length, dst_len=dst_len - d)
            if offset >= length:
                dst[d:end] = dst[d - offset : d - offset + length]
            else:
                # Overlapping copy: repeat the preceding `offset` bytes.
                pattern = dst[d - offset : d]
                reps = -(-length // offset)
                dst[d:end] = (bytes(pattern) * reps)[:length]
            d = end
    return d
