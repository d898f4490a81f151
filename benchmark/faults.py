"""Faults planted under the timed path, for the tests that show the check
catches them. A run of the benchmark never plants one.

Each fault replaces one function of the port, by name, for the life of the
process (a run is a process of its own):

- ``alter``: one byte of what the program produces is flipped (the first
  decoded chunk of a launch group);
- ``half``: half of the work is left out (every second decoded chunk
  comes back empty).
"""

from __future__ import annotations

import contextlib

FAULTS = ("alter", "half")


def _flip(b: bytes) -> bytes:
    if not b:
        return b"\x01"
    i = len(b) // 2
    return b[:i] + bytes((b[i] ^ 0x01,)) + b[i + 1:]


@contextlib.contextmanager
def planted(fault: str | None):
    """The port with ``fault`` planted for the ``with`` body."""
    if fault is None:
        yield
        return
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; one of {FAULTS}")
    from snappy_tpu_torch.ops import api

    decode = api.decompress_streams
    api.decompress_streams = _faulty(fault, decode)
    try:
        yield
    finally:
        api.decompress_streams = decode


def _faulty(fault: str, decode):
    def decode_faulty(*a, **k):
        outs, errs, crcs = decode(*a, **k)
        if fault == "alter":
            outs[0] = _flip(outs[0])
        else:
            outs = [o if i % 2 == 0 else b"" for i, o in enumerate(outs)]
        return outs, errs, crcs

    return decode_faulty
