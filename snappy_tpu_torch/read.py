"""Streaming readers: ``FrameDecoder`` and ``FrameEncoder``.

The port of the JAX package's ``read.py``: file-object adapters over the
Snappy frame format, mirroring reference ``src/read.rs``:

- ``FrameDecoder`` wraps a readable binary stream of frame-format data and
  reads as *decompressed* bytes;
- ``FrameEncoder`` wraps a readable binary stream of plain data and reads
  as *compressed* frame-format bytes (one underlying ``read`` per frame).

Corrupt input raises :class:`snappy_tpu_torch.error.SnappyError` subclasses; a
stream truncated mid-chunk raises ``EOFError`` (the analog of the
reference's ``io::ErrorKind::UnexpectedEof``). On the ``device`` engines
``FrameDecoder.read()`` of a whole stream decodes it on the card in one
batch (``snappy_tpu_torch.decompress_frame``: K2, K3 and K1).
"""

from __future__ import annotations

import io

from . import error as err
from .engine import get_engine
from .format.varint import read_varu64
from .format.constants import (
    CHUNK_HEADER_AND_CRC_SIZE,
    MAX_BLOCK_SIZE,
    MAX_COMPRESS_BLOCK_SIZE,
    STREAM_BODY,
    STREAM_IDENTIFIER,
)
from .frame import ChunkType, compress_frame

__all__ = ["FrameDecoder", "FrameEncoder"]

#: Largest single frame the reading encoder can emit: stream identifier +
#: chunk header + maximally-expanded block (reference ``src/read.rs:33-35``).
MAX_READ_FRAME_ENCODER_BLOCK_SIZE = (
    len(STREAM_IDENTIFIER) + CHUNK_HEADER_AND_CRC_SIZE + MAX_COMPRESS_BLOCK_SIZE
)


def _read_exact(r, n: int) -> bytes:
    """Read exactly n bytes or raise EOFError (unexpected EOF)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = r.read(n - len(buf))
        if not chunk:
            raise EOFError("snappy: unexpected EOF while reading frame chunk")
        buf += chunk
    return bytes(buf)


def _read_exact_eof(r, n: int) -> bytes | None:
    """Like _read_exact, but returns None on a clean EOF at the first byte."""
    first = r.read(n)
    if not first:
        return None
    if len(first) == n:
        return first
    return first + _read_exact(r, n - len(first))


class _ChainedReader:
    """Serves buffered bytes first, then delegates to the wrapped reader
    (used to hand un-decoded wire back when the segmented fill drops to
    sequential mode; the permanent mode latch means this wraps at most
    once per decoder)."""

    def __init__(self, prefix: bytes, reader):
        self._buf = memoryview(prefix)
        self._r = reader

    def read(self, n: int = -1) -> bytes:
        if self._buf:
            if n is None or n < 0:
                out = bytes(self._buf) + (self._r.read(-1) or b"")
                self._buf = memoryview(b"")
                return out
            out = bytes(self._buf[:n])
            self._buf = self._buf[n:]
            return out
        return self._r.read(n)


class FrameDecoder(io.RawIOBase):
    """Reads a Snappy frame stream as decompressed bytes.

    Chunk handling follows the framing spec exactly (reference
    ``src/read.rs:105-238``): the stream identifier must come first and may
    recur (concatenated files), reserved chunk types 0x02-0x7F are errors,
    0x80-0xFD and padding are skipped, and every data chunk's masked CRC32C
    is verified against the decompressed payload.
    """

    #: Wire bytes decoded per segment on the native engine: large enough
    #: to feed every core, small enough to keep streaming memory bounded.
    _SEGMENT_WIRE = 8 << 20
    #: Declared-output cap per segment (bounds the decode scratch).
    _SEGMENT_OUT = 32 << 20

    def __init__(self, reader, engine: str = "auto"):
        super().__init__()
        self._r = reader
        self._engine = get_engine(engine)
        self._dst = b""
        self._dsts = 0
        self._read_stream_ident = False
        # Segmented-fill state: buffered wire bytes not yet decoded, a
        # reused decode scratch (fresh multi-MB allocations page-fault
        # on every fill), and the sequential-mode latch (set on the
        # first error; see _enter_seq_mode).
        self._wire = bytearray()
        self._seg_scratch = None
        self._seq_mode = False
        # Set when the scan saw a decidable-bad chunk header beyond a
        # good prefix: the next fill must surface it from the buffered
        # bytes without blocking for more input.
        self._head_bad = False

    def get_ref(self):
        return self._r

    def into_inner(self):
        return self._r

    def __repr__(self) -> str:
        # Deliberately redacts the internal buffer, like the reference's
        # hand-written Debug impls (src/read.rs:241-254).
        return (
            f"FrameDecoder(r={self._r!r}, dst=[...], dsts={self._dsts}, "
            f"dste={len(self._dst)}, read_stream_ident={self._read_stream_ident})"
        )

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        data = self.read(len(memoryview(b)))
        n = len(data)
        memoryview(b)[:n] = data
        return n

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            # Device and native engines slurp and decode the whole
            # remaining stream chunk-parallel (one batched launch / a
            # multithreaded native call) when nothing has been consumed.
            if (
                self._engine.name in ("native", "device", "device-fast")
                and not self._read_stream_ident
                and not self._dst
            ):
                from .ops import api

                return api._as_call("read.FrameDecoder", self._read_rest)
            out = bytearray()
            while True:
                chunk = self.read(io.DEFAULT_BUFFER_SIZE)
                if not chunk:
                    return bytes(out)
                out += chunk
        while True:
            if self._dsts < len(self._dst):
                n = min(len(self._dst) - self._dsts, size)
                out = self._dst[self._dsts : self._dsts + n]
                self._dsts += n
                # The segmented fill buffers a memoryview over its reused
                # scratch; materialize the consumer's slice.
                return out if type(out) is bytes else bytes(out)
            if not self._fill():
                return b""

    def _fill(self) -> bool:
        """Decode chunks until data is buffered; False on clean EOF.

        On the native engine this decodes a bounded *segment* of wire
        bytes per call, chunk-parallel across host cores, while keeping
        the sequential reader's exact error order (see ``_fill_segment``).
        Each fill is one call of ``ops.api``'s recorder.
        """
        from .ops import api

        return api._as_call("read.FrameDecoder", self._fill_chunks)

    def _fill_chunks(self) -> bool:
        while True:
            if self._engine.name == "native" and not self._seq_mode:
                r = self._fill_segment()
                if r is None:  # no data yet (padding, or need more wire)
                    continue
                return r
            return self._fill_one()

    def _read_rest(self) -> bytes:
        """The whole remaining stream, read and decoded at once."""
        rest = bytearray()
        while True:
            piece = self._r.read(1 << 20)
            if not piece:
                break
            rest += piece
        self._read_stream_ident = True
        if self._engine.name == "native":
            from . import native

            return native.frame_decompress(bytes(rest))
        from .ops import api

        return api.decompress_frame(bytes(rest))

    def _push_back_wire(self) -> None:
        if self._wire:
            self._r = _ChainedReader(bytes(self._wire), self._r)
            self._wire = bytearray()

    def _enter_seq_mode(self) -> bool:
        """Hand the buffered wire back and continue chunk-at-a-time.

        Entered when a segment contains any error (or truncates): the
        sequential walk re-reads the same bytes, delivers every good
        chunk's data, and raises the exact error at the exact position a
        chunk-at-a-time reader produces. Stays sequential afterwards, so
        post-error resume semantics match too.
        """
        self._push_back_wire()
        self._seq_mode = True
        return self._fill_one()

    def _fill_segment(self) -> bool:
        """Segmented fill: top up a bounded wire buffer, cut it at the
        last complete chunk boundary (header arithmetic only), and hand
        the whole prefix to the multithreaded native frame codec —
        decode, CRC verification, and output assembly all happen
        chunk-parallel in C++ into a reused scratch buffer. Any error
        drops to ``_enter_seq_mode`` for exact sequential semantics.
        """
        from . import native

        if self._head_bad:
            # The bad header is already buffered; raise it (after the
            # previously delivered prefix) without reading more input.
            return self._enter_seq_mode()
        wire = self._wire
        eof = False
        while len(wire) < self._SEGMENT_WIRE:
            piece = self._r.read(1 << 20)
            if not piece:
                eof = True
                break
            wire += piece
            if len(piece) < (1 << 20):
                # Short read: the source delivered what it had (pipe /
                # socket burst). Decode it now rather than blocking for
                # a full segment — an interactive consumer sees each
                # burst's data promptly, like the sequential reader.
                break
        # Longest prefix of complete chunks, bounded by declared output.
        # An oversized length field stops the scan so the sequential walk
        # raises on that header without waiting for payload a blocking
        # pipe may never deliver; the declared-output cap keeps scratch
        # memory bounded even for hyper-compressible (or crafted) chunks
        # that each declare 64 KiB from a handful of wire bytes.
        pos = 0
        bad = False
        n = len(wire)
        out_total = 0
        while pos + 4 <= n and out_total <= self._SEGMENT_OUT:
            ty = wire[pos]
            length = wire[pos + 1] | (wire[pos + 2] << 8) | (wire[pos + 3] << 16)
            if length > MAX_COMPRESS_BLOCK_SIZE:
                bad = True
                break
            if pos + 4 + length > n:
                break
            if ty == 0x00 and length >= 4:  # Compressed: declared length
                declen, nb = read_varu64(wire[pos + 8 : pos + 18])
                if nb == 0 or declen > MAX_BLOCK_SIZE:
                    # Malformed or oversized declaration: the sequential
                    # walk raises the exact error without allocating.
                    bad = True
                    break
                out_total += declen
            elif ty == 0x01 and length >= 4:  # Uncompressed
                out_total += length - 4
            pos += 4 + length
        if pos:
            # Zero-copy decode straight out of the accumulation buffer:
            # a ctypes view over the complete-chunk prefix (copying the
            # prefix out costs more than the decode itself). After the
            # first segment the stream identifier is maintained in-place
            # at the buffer head (the slice-assign below), so every
            # segment is a well-formed frame stream.
            import ctypes

            view = (ctypes.c_char * pos).from_buffer(wire)
            try:
                total = native.frame_decompress_len(view, pos)
                scratch = self._seg_scratch
                if scratch is None or scratch.shape[0] < total:
                    import numpy as np

                    scratch = self._seg_scratch = np.empty(
                        max(total, self._SEGMENT_WIRE), np.uint8
                    )
                total = native.frame_decompress_into(view, scratch, 0, pos)
            except (err.SnappyError, EOFError):
                return self._enter_seq_mode()
            finally:
                del view  # release the buffer export before mutating wire
            self._read_stream_ident = True
            self._head_bad = bad
            if total == 0 and eof:
                # Ident/padding-only tail and the source is done: the
                # sequential walk finishes (clean EOF, or the exact
                # truncation error for a partial trailing chunk).
                return self._enter_seq_mode()
            # Consume the prefix, keeping a stream identifier at the head
            # so the next segment decodes as a well-formed stream.
            wire[:pos] = STREAM_IDENTIFIER
            if total == 0:
                return None  # padding/ident-only segment; read more
            self._dst = memoryview(scratch)[:total]
            self._dsts = 0
            return True
        if bad or (eof and wire):
            # Error chunk up front, or a trailing partial chunk at EOF:
            # the sequential walk over the same bytes produces the exact
            # outcome (error, or EOFError mid-chunk).
            return self._enter_seq_mode()
        if eof:
            return False
        # Less than one complete chunk so far and the source is live:
        # signal the caller to loop (the next top-up blocks in read()
        # exactly where a chunk-at-a-time reader would block).
        return None

    def _fill_one(self) -> bool:
        """Decode chunks until one yields data; False on clean EOF."""
        while True:
            header = _read_exact_eof(self._r, 4)
            if header is None:
                return False
            ty = ChunkType.from_u8(header[0])
            if not self._read_stream_ident:
                if ty is not ChunkType.Stream:
                    raise err.StreamHeader(byte=header[0])
                self._read_stream_ident = True
            length = header[1] | (header[2] << 8) | (header[3] << 16)
            if length > MAX_COMPRESS_BLOCK_SIZE:
                raise err.UnsupportedChunkLength(len=length, header=False)

            if not isinstance(ty, ChunkType):  # reserved chunk type
                if 0x02 <= ty <= 0x7F:
                    raise err.UnsupportedChunkType(byte=ty)
                # 0x80-0xFD: reserved but skippable.
                _read_exact(self._r, length)
                continue
            if ty is ChunkType.Padding:
                _read_exact(self._r, length)
                continue
            if ty is ChunkType.Stream:
                if length != len(STREAM_BODY):
                    raise err.UnsupportedChunkLength(len=length, header=True)
                body = _read_exact(self._r, length)
                if body != STREAM_BODY:
                    raise err.StreamHeaderMismatch(bytes=body)
                continue
            if ty is ChunkType.Uncompressed:
                if length < 4:
                    raise err.UnsupportedChunkLength(len=length, header=False)
                payload = _read_exact(self._r, length)
                expected_sum = int.from_bytes(payload[:4], "little")
                data = payload[4:]
                if len(data) > MAX_BLOCK_SIZE:
                    raise err.UnsupportedChunkLength(len=len(data), header=False)
                got_sum = self._engine.crc32c_masked(data)
                if expected_sum != got_sum:
                    raise err.Checksum(expected=expected_sum, got=got_sum)
                self._dst = data
                self._dsts = 0
                return True
            # Compressed chunk.
            if length < 4:
                raise err.UnsupportedChunkLength(len=length, header=False)
            payload = _read_exact(self._r, length)
            expected_sum = int.from_bytes(payload[:4], "little")
            comp = payload[4:]
            declen = self._engine.decompress_len(comp)
            if declen > MAX_BLOCK_SIZE:
                raise err.UnsupportedChunkLength(len=declen, header=False)
            data = self._engine.decompress(comp)
            got_sum = self._engine.crc32c_masked(data)
            if expected_sum != got_sum:
                raise err.Checksum(expected=expected_sum, got=got_sum)
            self._dst = data
            self._dsts = 0
            return True


class FrameEncoder(io.RawIOBase):
    """Reads plain data from ``reader`` as compressed frame-format bytes.

    Makes exactly one underlying ``read`` per emitted frame (reference
    ``src/read.rs:365-409``), so short reads from the source produce
    smaller (still valid) frames.
    """

    def __init__(self, reader, engine: str = "auto"):
        super().__init__()
        self._r = reader
        self._engine = get_engine(engine)
        self._dst = b""
        self._dsts = 0
        self._wrote_stream_ident = False

    def get_ref(self):
        return self._r

    def __repr__(self) -> str:
        # Buffer-redacting repr (reference src/read.rs:412-434).
        return (
            f"FrameEncoder(inner=Inner(r={self._r!r}, dst=[...], "
            f"wrote_stream_ident={self._wrote_stream_ident}), "
            f"dsts={self._dsts}, dste={len(self._dst)})"
        )

    def readable(self) -> bool:
        return True

    def read(self, size: int = -1) -> bytes:
        if size is None or size < 0:
            out = bytearray()
            while True:
                chunk = self.read(io.DEFAULT_BUFFER_SIZE)
                if not chunk:
                    return bytes(out)
                out += chunk
        while True:
            if self._dsts < len(self._dst):
                n = min(len(self._dst) - self._dsts, size)
                out = self._dst[self._dsts : self._dsts + n]
                self._dsts += n
                return out
            frame = self._read_frame()
            if frame is None:
                return b""
            self._dst = frame
            self._dsts = 0

    def readinto(self, b) -> int:
        view = memoryview(b)
        if (
            self._dsts >= len(self._dst)
            and len(view) >= MAX_READ_FRAME_ENCODER_BLOCK_SIZE
        ):
            # Large caller buffers skip the intermediate frame buffer:
            # the next frame's parts land directly in the caller's
            # memory (reference zero-copy, ``src/read.rs:33-35`` +
            # ``:350-354``). Output bytes are identical to the buffered
            # path (tested), only the copy is saved.
            parts = self._read_frame_parts()
            if parts is None:
                return 0
            n = 0
            for p in parts:
                view[n : n + len(p)] = p
                n += len(p)
            return n
        data = self.read(len(view))
        n = len(data)
        view[:n] = data
        return n

    def _read_frame_parts(self) -> list | None:
        src = self._r.read(MAX_BLOCK_SIZE)
        if not src:
            return None
        parts = []
        if not self._wrote_stream_ident:
            parts.append(STREAM_IDENTIFIER)
            self._wrote_stream_ident = True
        header, payload = compress_frame(self._engine, src)
        parts.append(header)
        parts.append(payload)
        return parts

    def _read_frame(self) -> bytes | None:
        parts = self._read_frame_parts()
        return None if parts is None else b"".join(parts)
