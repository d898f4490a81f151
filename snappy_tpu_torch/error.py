"""Error taxonomy for Snappy (de)compression.

Structurally mirrors the 13-variant enum of the reference
(``src/error.rs:72-180``), surfaced as a Python exception hierarchy. Every
exception carries the same fields the reference variant does, compares by
value, and formats the same human-readable message. Device kernels reduce
validity flags to an error code; :func:`error_from_code` rehydrates the
exception host-side (kernels cannot raise).
"""

from __future__ import annotations


class SnappyError(Exception):
    """Base class for all Snappy errors.

    Subclasses declare ``_fields``; equality/hash/repr derive from them so
    tests can assert exact error values like the reference suite does.
    """

    _fields: tuple[str, ...] = ()

    def __init__(self, **kwargs):
        for name in self._fields:
            setattr(self, name, kwargs.pop(name))
        if kwargs:
            raise TypeError(f"unexpected fields: {sorted(kwargs)}")
        super().__init__(str(self))

    def _values(self):
        return tuple(getattr(self, name) for name in self._fields)

    def __eq__(self, other):
        return type(self) is type(other) and self._values() == other._values()

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash((type(self).__name__, self._values()))

    def __repr__(self):
        args = ", ".join(f"{k}={v!r}" for k, v in zip(self._fields, self._values()))
        return f"{type(self).__name__}({args})"


class TooBig(SnappyError):
    """Input larger than the format allows (compress or decompress)."""

    _fields = ("given", "max")

    def __str__(self):
        return (
            f"snappy: input buffer (size = {self.given}) is larger than "
            f"allowed (size = {self.max})"
        )


class BufferTooSmall(SnappyError):
    """Caller-provided output buffer is too small."""

    _fields = ("given", "min")

    def __str__(self):
        return (
            f"snappy: output buffer (size = {self.given}) is smaller than "
            f"required (size = {self.min})"
        )


class Empty(SnappyError):
    """Tried to decompress an empty buffer."""

    def __str__(self):
        return "snappy: corrupt input (empty)"


class Header(SnappyError):
    """Invalid varint header."""

    def __str__(self):
        return "snappy: corrupt input (invalid header)"


class HeaderMismatch(SnappyError):
    """Fewer decompressed bytes produced than the header promised."""

    _fields = ("expected_len", "got_len")

    def __str__(self):
        return (
            "snappy: corrupt input (header mismatch; expected "
            f"{self.expected_len} decompressed bytes but got {self.got_len})"
        )


class Literal(SnappyError):
    """Literal run over-reads the source or over-writes the destination."""

    _fields = ("len", "src_len", "dst_len")

    def __str__(self):
        return (
            "snappy: corrupt input (expected literal read of length "
            f"{self.len}; remaining src: {self.src_len}; remaining dst: "
            f"{self.dst_len})"
        )


class CopyRead(SnappyError):
    """Copy offset trailer extends past the end of the source."""

    _fields = ("len", "src_len")

    def __str__(self):
        return (
            "snappy: corrupt input (expected copy read of length "
            f"{self.len}; remaining src: {self.src_len})"
        )


class CopyWrite(SnappyError):
    """Copy writes past the end of the destination."""

    _fields = ("len", "dst_len")

    def __str__(self):
        return (
            "snappy: corrupt input (expected copy write of length "
            f"{self.len}; remaining dst: {self.dst_len})"
        )


class Offset(SnappyError):
    """Copy offset is zero or reaches before the start of the output."""

    _fields = ("offset", "dst_pos")

    def __str__(self):
        return (
            "snappy: corrupt input (expected valid offset but got offset "
            f"{self.offset}; dst position: {self.dst_pos})"
        )


class StreamHeader(SnappyError):
    """Frame stream did not begin with the stream identifier chunk."""

    _fields = ("byte",)

    def __str__(self):
        return (
            "snappy: corrupt input (expected stream header but got "
            f"unexpected chunk type byte {self.byte})"
        )


class StreamHeaderMismatch(SnappyError):
    """Stream identifier chunk body was not ``sNaPpY``."""

    _fields = ("bytes",)

    def __str__(self):
        escaped = "".join(
            chr(b) if 0x20 <= b < 0x7F and b not in (0x22, 0x27, 0x5C) else f"\\x{b:02x}"
            for b in self.bytes
        )
        return (
            f"snappy: corrupt input (expected sNaPpY stream header but got {escaped})"
        )


class UnsupportedChunkType(SnappyError):
    """Reserved-unskippable chunk type (0x02-0x7F) encountered."""

    _fields = ("byte",)

    def __str__(self):
        return f"snappy: corrupt input (unsupported chunk type: {self.byte})"


class UnsupportedChunkLength(SnappyError):
    """Chunk length is invalid for its chunk type."""

    _fields = ("len", "header")

    def __str__(self):
        if self.header:
            return f"snappy: corrupt input (invalid stream header length: {self.len})"
        return f"snappy: corrupt input (unsupported chunk length: {self.len})"


class Checksum(SnappyError):
    """Frame chunk CRC32C verification failed."""

    _fields = ("expected", "got")

    def __str__(self):
        return (
            "snappy: corrupt input (bad checksum; expected: "
            f"{self.expected}, got: {self.got})"
        )


class IntoInnerError(SnappyError):
    """Flushing during ``FrameEncoder.into_inner`` failed.

    Carries both the writer (for recovery) and the underlying error,
    mirroring reference ``src/error.rs:15-60``.
    """

    def __init__(self, writer, error):
        self.writer = writer
        self.err = error
        Exception.__init__(self, str(error))

    def error(self):
        return self.err

    def into_error(self):
        return self.err

    def into_inner(self):
        return self.writer

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)


# ---------------------------------------------------------------------------
# Device error codes
# ---------------------------------------------------------------------------
# Kernels cannot raise; they reduce per-block validity flags to one i32 code
# plus two u64 payload values, which the host turns back into exceptions.

OK = 0
E_HEADER = 1
E_TOO_BIG = 2
E_HEADER_MISMATCH = 3
E_LITERAL = 4
E_COPY_READ = 5
E_COPY_WRITE = 6
E_OFFSET = 7
E_STREAM_HEADER = 10
E_STREAM_HEADER_MISMATCH = 11
E_UNSUPPORTED_CHUNK_TYPE = 12
E_UNSUPPORTED_CHUNK_LENGTH = 13
E_CHECKSUM = 14
E_EOF = 15


def _unpack_bytes(packed: int, length: int) -> bytes:
    return bytes((packed >> (8 * i)) & 0xFF for i in range(length))


_DEVICE_ERRORS = {
    E_HEADER: lambda a, b, c: Header(),
    E_TOO_BIG: lambda a, b, c: TooBig(given=a, max=b),
    E_HEADER_MISMATCH: lambda a, b, c: HeaderMismatch(expected_len=a, got_len=b),
    E_LITERAL: lambda a, b, c: Literal(len=a, src_len=b, dst_len=c),
    E_COPY_READ: lambda a, b, c: CopyRead(len=a, src_len=b),
    E_COPY_WRITE: lambda a, b, c: CopyWrite(len=a, dst_len=b),
    E_OFFSET: lambda a, b, c: Offset(offset=a, dst_pos=b),
    E_STREAM_HEADER: lambda a, b, c: StreamHeader(byte=a),
    E_STREAM_HEADER_MISMATCH: lambda a, b, c: StreamHeaderMismatch(
        bytes=_unpack_bytes(a, b)
    ),
    E_UNSUPPORTED_CHUNK_TYPE: lambda a, b, c: UnsupportedChunkType(byte=a),
    E_UNSUPPORTED_CHUNK_LENGTH: lambda a, b, c: UnsupportedChunkLength(
        len=a, header=bool(b)
    ),
    E_CHECKSUM: lambda a, b, c: Checksum(expected=a, got=b),
    E_EOF: lambda a, b, c: EOFError(
        "snappy: unexpected EOF while reading frame chunk"
    ),
}


def error_from_code(code: int, a: int = 0, b: int = 0, c: int = 0):
    """Rehydrate a device-side error code into its exception (or None)."""
    code = int(code)
    if code == OK:
        return None
    return _DEVICE_ERRORS[code](int(a), int(b), int(c))
