"""Protobuf-style unsigned varint encode/decode.

Mirrors the semantics of reference ``src/bytes.rs:61-90``: decoding returns
``(0, 0)`` on a truncated varint or on u64 overflow — the caller converts
that sentinel into a header error.
"""

from __future__ import annotations

_U64_MAX = 2**64 - 1


def write_varu64(n: int) -> bytes:
    """Encode ``n`` (0 <= n <= 2^64-1) as a protobuf varint."""
    if not 0 <= n <= _U64_MAX:
        raise ValueError(f"varint out of range: {n}")
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def read_varu64(data) -> tuple[int, int]:
    """Decode a varint from the start of ``data``.

    Returns ``(value, nbytes)``. On a truncated varint, or when a
    continuation would shift past 64 bits (u64 overflow in the reference),
    returns ``(0, 0)``.
    """
    n = 0
    shift = 0
    for i, b in enumerate(data):
        if b < 0x80:
            # Reference uses checked_shl, which fails only when the shift
            # amount is >= 64; bits shifted past the top are discarded
            # (u64 wrapping semantics).
            if shift >= 64:
                return (0, 0)
            return ((n | (b << shift)) & _U64_MAX, i + 1)
        if shift >= 64:
            return (0, 0)
        n |= ((b & 0x7F) << shift) & _U64_MAX
        shift += 7
    return (0, 0)
