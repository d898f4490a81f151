"""Plain Snappy codec in Python and NumPy: the benchmark's reference.

It works out what the port must produce from the same inputs the
benchmark hands the port, and imports nothing of the port (nor JAX).

- :func:`compress_block` is google/snappy's greedy automaton for one
  block of at most 64 KiB (hash table sized to the block up to 2**14
  entries, one probe per step with the skip that grows every 32 misses,
  match extension, the two table updates after each copy, and copies
  split as the reference splits them), so its bytes are the reference
  encoder's. A frozen copy of the algorithm, written out here so that no
  change to the program can move it.
- :func:`decompress` is the plain tag walk of the raw format.
- :func:`crc32c_masked` is the Castagnoli CRC with Snappy's mask, over
  many buffers at once in NumPy.
- :func:`frame_chunk` frames one chunk as the framing format asks
  (google/snappy ``framing_format.txt``): a compressed chunk where it
  saves at least an eighth, else a stored one.
"""

from __future__ import annotations

import numpy as np

BLOCK = 1 << 16
STREAM_IDENTIFIER = b"\xff\x06\x00\x00sNaPpY"
CHUNK_COMPRESSED = 0x00
CHUNK_STORED = 0x01

_HASH_MUL = 0x1E35A7BD
_INPUT_MARGIN = 15
_MIN_NON_LITERAL = 1 + 1 + _INPUT_MARGIN
_MAX_TABLE = 1 << 14
_U32 = 0xFFFFFFFF
_POLY = 0x82F63B78
_MASK_DELTA = 0xA282EAD8


def varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def read_varint(data: bytes) -> tuple[int, int]:
    """``(value, bytes read)`` of the varint at the start of ``data``."""
    n = shift = 0
    for i, b in enumerate(data[:10]):
        n |= (b & 0x7F) << shift
        if b < 0x80:
            return n, i + 1
        shift += 7
    raise ValueError("bad varint")


def _literal(src: bytes, start: int, end: int, out: bytearray) -> None:
    n = end - start - 1
    if n < 60:
        out.append(n << 2)
    elif n < 256:
        out += bytes((60 << 2, n))
    else:
        out += bytes((61 << 2, n & 0xFF, n >> 8))
    out += src[start:end]


def _copy2(offset: int, length: int, out: bytearray) -> None:
    out += bytes((((length - 1) << 2) | 2, offset & 0xFF, offset >> 8))


def _copy(offset: int, length: int, out: bytearray) -> None:
    while length >= 68:
        _copy2(offset, 64, out)
        length -= 64
    if length > 64:
        _copy2(offset, 60, out)
        length -= 60
    if length <= 11 and offset < 2048:
        out += bytes((((offset >> 8) << 5) | ((length - 4) << 2) | 1, offset & 0xFF))
    else:
        _copy2(offset, length, out)


def compress_block(src: bytes) -> bytes:
    """The raw op stream (no length preamble) of one block of at most
    64 KiB, byte for byte the reference encoder's."""
    n = len(src)
    if n > BLOCK:
        raise ValueError(f"a block holds at most {BLOCK} bytes, not {n}")
    out = bytearray()
    if n < _MIN_NON_LITERAL:
        if n:
            _literal(src, 0, n, out)
        return bytes(out)
    shift, size = 24, 256
    while size < _MAX_TABLE and size < n:
        shift -= 1
        size *= 2
    table = [0] * size
    a = np.frombuffer(src, np.uint8)
    w = a.astype(np.uint32)
    u32 = (w[: n - 3] | (w[1 : n - 2] << 8) | (w[2 : n - 1] << 16) | (w[3:] << 24)).tolist()

    def h(x: int) -> int:
        return ((x * _HASH_MUL) & _U32) >> shift

    s, limit, emit = 1, n - _INPUT_MARGIN, 0
    next_hash = h(u32[s])
    while True:
        skip, s_next = 32, s
        while True:
            s = s_next
            step = skip >> 5
            s_next = s + step
            skip += step
            if s_next > limit:
                _literal(src, emit, n, out)
                return bytes(out)
            cand = table[next_hash]
            table[next_hash] = s
            next_hash = h(u32[s_next])
            if u32[s] == u32[cand]:
                break
        _literal(src, emit, s, out)
        while True:
            base = s
            s += 4
            c = cand + 4
            neq = a[s:n] != a[c : c + n - s]
            s += int(np.argmax(neq)) if neq.any() else n - s
            _copy(base - cand, s - base, out)
            emit = s
            if s >= limit:
                if emit < n:
                    _literal(src, emit, n, out)
                return bytes(out)
            table[h(u32[s - 1])] = s - 1
            cur = u32[s]
            ch = h(cur)
            cand = table[ch]
            table[ch] = s
            if cur != u32[cand]:
                next_hash = h(u32[s + 1])
                s += 1
                break


def compress(data: bytes) -> bytes:
    """A raw Snappy stream: the length preamble, then every 64 KiB block."""
    return varint(len(data)) + b"".join(
        compress_block(data[i : i + BLOCK]) for i in range(0, len(data), BLOCK))


def decompress(stream: bytes) -> bytes:
    """Decode a raw Snappy stream (preamble and ops); raises ``ValueError``
    on any stream that is not well formed."""
    n, pos = read_varint(stream)
    dst = bytearray()
    while pos < len(stream):
        tag = stream[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            ln = (tag >> 2) + 1
            if ln > 60:
                k = ln - 60
                ln = int.from_bytes(stream[pos : pos + k], "little") + 1
                pos += k
            if pos + ln > len(stream):
                raise ValueError("literal runs past the stream")
            dst += stream[pos : pos + ln]
            pos += ln
            continue
        if kind == 1:
            ln = ((tag >> 2) & 7) + 4
            off = ((tag >> 5) << 8) | stream[pos]
            pos += 1
        else:
            ln = (tag >> 2) + 1
            k = 2 if kind == 2 else 4
            off = int.from_bytes(stream[pos : pos + k], "little")
            pos += k
        if off == 0 or off > len(dst):
            raise ValueError(f"copy offset {off} at output byte {len(dst)}")
        start = len(dst) - off
        if off >= ln:
            dst += dst[start : start + ln]
        else:  # an overlapping copy repeats the last ``off`` bytes
            dst += (dst[start:] * (ln // off + 1))[:ln]
    if len(dst) != n or pos != len(stream):
        raise ValueError(f"stream decodes to {len(dst)} bytes, its preamble says {n}")
    return bytes(dst)


def _crc_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1)
    return t


def crc32c_masked(bufs: list[bytes]) -> list[int]:
    """Snappy's masked CRC32C of each buffer: the byte-at-a-time table
    walk, every buffer at once (one NumPy step per byte position)."""
    if not bufs:
        return []
    t = _crc_table()
    lens = np.array([len(b) for b in bufs])
    rows = np.zeros((len(bufs), int(lens.max(initial=0))), np.uint8)
    for i, b in enumerate(bufs):
        rows[i, : len(b)] = np.frombuffer(b, np.uint8)
    crc = np.full(len(bufs), _U32, np.uint32)
    for j in range(rows.shape[1]):
        live = lens > j
        nxt = t[(crc ^ rows[:, j]) & 0xFF] ^ (crc >> 8)
        crc = np.where(live, nxt, crc)
    out = []
    for c in (crc ^ np.uint32(_U32)).tolist():
        out.append((((c >> 15) | (c << 17)) + _MASK_DELTA) & _U32)
    return out


def frame_chunk(raw: bytes, compressed: bytes, crc: int) -> bytes:
    """One frame chunk of ``raw``: compressed (``compressed`` is its raw
    Snappy stream, preamble included) where that saves at least an eighth
    of ``raw``, else stored; each carries ``crc``, the masked CRC32C of
    ``raw``."""
    n = len(raw)
    if len(compressed) < n - n // 8:
        kind, body = CHUNK_COMPRESSED, compressed
    else:
        kind, body = CHUNK_STORED, raw
    size = len(body) + 4
    return bytes((kind, size & 0xFF, (size >> 8) & 0xFF, size >> 16)) + crc.to_bytes(4, "little") + body


def frame_walk(stream: bytes) -> list[tuple[int, int, int]]:
    """``(chunk type, offset of its body, body length)`` of every chunk
    of a frame stream."""
    out, pos = [], 0
    while pos < len(stream):
        if pos + 4 > len(stream):
            raise ValueError("a chunk header runs past the stream")
        size = int.from_bytes(stream[pos + 1 : pos + 4], "little")
        out.append((stream[pos], pos + 4, size))
        pos += 4 + size
    if pos != len(stream):
        raise ValueError("the last chunk runs past the stream")
    return out


def frame_decode(stream: bytes, verify: bool = True) -> bytes:
    """The data of a frame stream; with ``verify`` every data chunk's
    masked CRC32C is checked (``ValueError`` where one differs)."""
    raws, crcs = [], []
    for kind, at, size in frame_walk(stream):
        body = stream[at : at + size]
        if kind == 0xFF:
            if body != STREAM_IDENTIFIER[4:]:
                raise ValueError("bad stream identifier")
            continue
        if kind not in (CHUNK_COMPRESSED, CHUNK_STORED):
            if kind < 0x80:
                raise ValueError(f"unskippable chunk type {kind:#x}")
            continue
        crcs.append(int.from_bytes(body[:4], "little"))
        raws.append(decompress(body[4:]) if kind == CHUNK_COMPRESSED else body[4:])
    if verify and crc32c_masked(raws) != crcs:
        raise ValueError("a chunk's checksum differs")
    return b"".join(raws)
