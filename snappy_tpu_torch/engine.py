"""Execution engines of the streaming adapters.

The port of the JAX package's ``engine.py``. The format is fixed
(``snappy_tpu_torch.format``); engines are interchangeable executors of
it, named as in the JAX package:

- ``reference``: the NumPy/Python oracle (slow, always there);
- ``native``: the port's copy of the C++ host runtime (ctypes);
- ``auto``: ``native``, else ``reference`` when the runtime cannot build;
- ``device``: decode on the card (``snappy_tpu_torch.decompress``); exact
  per-call compression stays on the host codec, which gives the same
  bytes: the JAX package routes it there on purpose, because the
  automaton is serial per block and a single call is a poor fit for the
  card. The streaming writer sends whole launches of frame chunks to the
  card (``ops/frame.py``, K1 and K7);
- ``device-fast``: as ``device``, but per-call compression takes the flat
  encoder on the card (``compress(profile="fast")``): valid Snappy, not
  the reference's bytes.

``device`` engines run on ``Config.device`` (``"cuda"`` unless the caller
configures ``"cpu"``) and raise without a card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

__all__ = ["HostEngine", "get_engine"]


@dataclass(frozen=True)
class HostEngine:
    name: str
    compress: Callable[[bytes], bytes]
    decompress: Callable[[bytes], bytes]
    decompress_len: Callable[[bytes], int]
    crc32c_masked: Callable[[bytes], int]


_ENGINES: dict[str, HostEngine] = {}


def _reference_engine() -> HostEngine:
    from .format import crc32c as crc_ref
    from .format import reference as ref

    return HostEngine(
        name="reference",
        compress=ref.compress,
        decompress=ref.decompress,
        decompress_len=ref.decompress_len,
        crc32c_masked=crc_ref.crc32c_masked,
    )


def _native_engine() -> HostEngine | None:
    from . import native

    if not native.available():  # no compiler, or the build failed
        return None
    return HostEngine(
        name="native",
        compress=native.compress,
        decompress=native.decompress,
        decompress_len=native.decompress_len,
        crc32c_masked=native.crc32c_masked,
    )


def _device_engine(profile: str) -> HostEngine:
    # The per-call scalar helpers (decompress_len, the CRC of one chunk)
    # stay on the host fast path.
    from .ops import api

    host = _native_engine() or _reference_engine()
    if profile == "fast":
        compress = lambda data: api.compress(data, profile="fast")  # noqa: E731
    else:
        compress = host.compress
    return HostEngine(
        name="device-fast" if profile == "fast" else "device",
        compress=compress,
        decompress=api.decompress,
        decompress_len=host.decompress_len,
        crc32c_masked=host.crc32c_masked,
    )


def get_engine(name: str = "auto") -> HostEngine:
    """Resolve an engine by name.

    ``auto``, ``native``, ``reference`` and ``device`` give the reference's
    bytes; ``device-fast`` compresses with the flat encoder. ``auto`` (or
    an empty name) means ``Config.engine``; an explicit name wins over it.
    """
    if not name or name == "auto":
        from .config import get_config

        name = get_config().engine or "auto"
    if name in _ENGINES:
        return _ENGINES[name]
    if name == "reference":
        eng = _reference_engine()
    elif name == "native":
        eng = _native_engine()
        if eng is None:
            raise RuntimeError("native engine unavailable (build failed?)")
    elif name == "auto":
        eng = _native_engine() or _reference_engine()
    elif name == "device":
        eng = _device_engine("exact")
    elif name == "device-fast":
        eng = _device_engine("fast")
    else:
        raise ValueError(f"unknown engine {name!r}")
    _ENGINES[name] = eng
    return eng
