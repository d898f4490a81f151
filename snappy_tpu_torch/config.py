"""Runtime configuration of the PyTorch/CUDA port.

The JAX package's ``Config`` is frozen and its fields are named after the
TPU (``pallas_max_dpad``, ``pallas_fastpath``...), so the port keeps its
own. Library code reads :func:`get_config` at each decision point.
Precedence, highest first:

1. the JAX package's ``SNAPPY_TPU_*`` environment variables (deployment
   overrides; :data:`_ENV_KNOBS`), read at every call, so one setting
   steers both packages;
2. temporary overrides via :func:`configure` (a ContextVar overlay, safe
   under threads and asyncio);
3. the process-wide base set by :func:`set_config`;
4. the dataclass defaults below.

:func:`configure` and :func:`set_config` also take the JAX package's field
names (:data:`_REFERENCE_FIELDS`: ``configure(pallas_resolve=True)`` is
``configure(decode_resolve=True)``), so code written for the JAX package
runs unchanged; its three TPU-only knobs are accepted and ignored
(:data:`_IGNORED_FIELDS`).

Example::

    import snappy_tpu_torch
    from snappy_tpu_torch.config import configure

    with configure(device="cpu"):   # run the kernels' plain versions
        snappy_tpu_torch.decompress(buf)
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass, fields, replace

__all__ = [
    "Config",
    "get_config",
    "set_config",
    "configure",
    "config_from_reference",
]


@dataclass(frozen=True)
class Config:
    """Every runtime knob of the port, in one place.

    - ``device``: where the entry points run, ``"cuda"`` (or
      ``"cuda:N"``) or ``"cpu"``. On ``"cpu"`` each kernel's wrapper
      takes its plain PyTorch version; that is what the CPU tests do.
      With ``"cuda"`` and no card the entry points raise.
    - ``blocks_per_launch``: 64 KiB blocks per compress launch; a
      launch's rows pad to the next power of two.
    - ``flat_encode``: the encoder of ``compress(profile="fast")`` (and so
      of the ``device-fast`` engine and ``szip --engine device-fast``).
      ``True`` takes the flat encoder (K4, K5); ``False`` the fast profile
      in tensor ops (``ops/encode_fast.py``, the JAX package's
      ``compress_blocks_fast_host``); ``None`` (the default) the flat
      encoder, as the JAX package's ``None`` does on its TPU: the port's
      card plays the TPU's part. Carried from the JAX package's
      ``flat_encode``.
    - ``decode_rows_per_launch``: the most rows a batched-decode launch
      group packs. It bounds a packed group, not a launch: the flat
      route's groups of a call share one launch of K2, while their card
      bytes stay within one group of this many rows at ``max_dpad``.
    - ``decode_kernels``: decode launch groups with the kernel routes
      (flat, replay, and the record-scan routes below). ``None`` (the
      default) means on unless ``pure_device``; ``False`` pins the tensor
      routes of ``ops/decode.py``: the hosted one (the host's op-start
      bitmap, ``native.scan_ops_batch``), or under ``pure_device`` the
      all-device one (op discovery by pointer doubling). Carried from the
      JAX package's ``pallas_decode``.
    - ``decode_flat``: within the kernel routes, the flat route (host
      flatten, K2); ``False`` sends groups to the replay kernel (K3), or
      past ``replay_max_body`` to a tensor route. From ``pallas_flat``.
    - ``pure_device``: no host scan of any kind: the record-scan, flat and
      hosted routes are off, the kernels too unless ``decode_kernels`` is
      ``True`` (then K3 takes the groups up to ``replay_max_body``), and
      every other group, an oversized one included, takes the all-device
      tensor route on the card. From ``pure_device``.
    - ``decode_records``: decode launch groups by record replay (K10):
      the host scans each row's ops into 8-byte records
      (``native.scan_records_batch``) and the card replays them. A group
      whose op count overflows the scan's record cap takes the replay
      kernel (K3). Takes precedence over ``decode_resolve``. Off by
      default, as the JAX package's ``pallas_records``.
    - ``decode_resolve``: decode launch groups by chain resolution on the
      card (``ops/resolve.py``: K8, then the flat gather K2): the host
      only scans ops into records, and the card builds every byte's
      literal origin itself. It takes groups of outputs in whole 16 KiB
      up to 64 KiB and rows up to 64 KiB; a group it cannot finish (a
      record-cap overflow, a source spread past the widest window, a
      chain left unresolved) takes the flat route. Off by default, as
      the JAX package's ``pallas_resolve``.
    - ``max_device_stream``: single raw streams past this decode on host.
    - ``max_device_output``: declared outputs past this decode on host.
    - ``max_dpad``: padded output width per launch group; wider groups
      decode on the host (frame chunks never get there). A group's
      ``d_pad`` is its widest output rounded up to a power of two, so a
      batch of raw streams just past 1 MiB (a Parquet page written a
      little past its 1 MiB target) already turns down at the default.
    - ``replay_max_body``: the widest rows (compressed bytes) the replay
      kernel (K3) takes; a group the other kernel routes leave that is
      wider takes a tensor route (hosted, or all-device under
      ``pure_device``).
    - ``threads``: host C++ codec thread cap; 0 = hardware concurrency.
    - ``debug``: cross-check every device decode against the NumPy
      oracle and fail loudly on divergence.
    - ``engine``: the engine the streaming adapters (``raw``, ``read``,
      ``write``) take when they are given ``"auto"``: ``auto`` (the
      native C++ codec, else the NumPy reference), ``native``,
      ``reference``, ``device`` or ``device-fast`` (see
      :mod:`snappy_tpu_torch.engine`).
    """

    device: str = "cuda"
    blocks_per_launch: int = 2048
    flat_encode: bool | None = None
    decode_rows_per_launch: int = 512
    decode_kernels: bool | None = None
    decode_flat: bool = True
    pure_device: bool = False
    decode_records: bool = False
    decode_resolve: bool = False
    max_device_stream: int = 1 << 26
    max_device_output: int = 1 << 27
    max_dpad: int = 1 << 20
    replay_max_body: int = 1 << 17
    threads: int = 0
    debug: bool = False
    engine: str = "auto"


#: JAX ``Config`` field -> port field, for the knobs both packages share.
_REFERENCE_FIELDS = {
    "engine": "engine",
    "blocks_per_launch": "blocks_per_launch",
    "flat_encode": "flat_encode",
    "decode_rows_per_launch": "decode_rows_per_launch",
    "pallas_decode": "decode_kernels",
    "pallas_flat": "decode_flat",
    "pure_device": "pure_device",
    "pallas_records": "decode_records",
    "pallas_resolve": "decode_resolve",
    "max_device_stream": "max_device_stream",
    "max_device_output": "max_device_output",
    "pallas_max_dpad": "max_dpad",
    "replay_max_body": "replay_max_body",
    "threads": "threads",
    "debug": "debug",
}


def config_from_reference(fields: dict) -> Config:
    """The port's ``Config`` under the JAX package's routing caps.

    ``fields`` is ``dataclasses.asdict`` of a ``snappy_tpu.config.Config``
    (a plain dict, so this module imports nothing of the JAX package).
    Shared knobs carry over, the route selectors among them (``pallas_decode``,
    ``pallas_flat``, ``pure_device``, ``pallas_records``, ``pallas_resolve``,
    ``flat_encode``); TPU-only ones (the compose machinery, the choice of
    exact encoder) have no counterpart and are ignored; ``device`` keeps its
    default.
    """
    return Config(
        **{ours: fields[theirs] for theirs, ours in _REFERENCE_FIELDS.items()}
    )


_base_default = Config()
_base_var: contextvars.ContextVar[Config | None] = contextvars.ContextVar(
    "snappy_tpu_torch_config_base", default=None
)


def _onoff(v: str) -> bool:
    """'' and '0' are off; anything else is on (the JAX package's knob
    semantics, where setting the variable at all usually means on)."""
    return v not in ("", "0")


def _truthy(v: str) -> bool:
    return bool(v)


def _int_or_none(v: str):
    try:
        return int(v)
    except ValueError:
        return None  # ignore malformed values, keep the base setting


#: The JAX package's environment variables: name -> (JAX ``Config`` field,
#: parser), as in ``snappy_tpu/config.py``. Each sets the port's field
#: that :data:`_REFERENCE_FIELDS` pairs with the JAX field. A parser
#: returning None leaves the base value in place.
_ENV_KNOBS = {
    "SNAPPY_TPU_ENGINE": ("engine", lambda v: v or None),
    "SNAPPY_TPU_PALLAS_DECODE": ("pallas_decode", _onoff),
    "SNAPPY_TPU_PALLAS_FLAT": ("pallas_flat", _onoff),
    "SNAPPY_TPU_PALLAS_RECORDS": ("pallas_records", lambda v: v == "1"),
    "SNAPPY_TPU_PALLAS_RESOLVE": ("pallas_resolve", lambda v: v == "1"),
    "SNAPPY_TPU_FLAT_ENCODE": ("flat_encode", _onoff),
    "SNAPPY_TPU_PURE_DEVICE": ("pure_device", _truthy),
    "SNAPPY_TPU_DEBUG": ("debug", _truthy),
    "SNAPPY_TPU_THREADS": ("threads", _int_or_none),
}

#: The JAX package's variables that the port reads and ignores: they select
#: TPU move machinery (``pallas_fastpath``, ``pallas_compose``) or the
#: choice between the Pallas and the XLA exact encoder (``pallas_encode``),
#: none of which changes a byte and none of which the port has.
_IGNORED_ENV = (
    "SNAPPY_TPU_PALLAS_ENCODE",
    "SNAPPY_TPU_PALLAS_FASTPATH",
    "SNAPPY_TPU_PALLAS_COMPOSE",
)

#: The JAX ``Config`` fields of those variables, which :func:`configure` and
#: :func:`set_config` accept and ignore for the same reason.
_IGNORED_FIELDS = ("pallas_encode", "pallas_fastpath", "pallas_compose")


def _port_fields(overrides: dict) -> dict:
    """``overrides`` with each JAX field name (:data:`_REFERENCE_FIELDS`) as
    the port field it pairs with, and the TPU-only ones dropped. A JAX name
    given with its port name, or a name neither package has, raises
    ``TypeError``."""
    out, given_as = {}, {}
    for name, value in overrides.items():
        if name in _IGNORED_FIELDS:
            continue
        ours = _REFERENCE_FIELDS.get(name, name)
        if ours in out:
            raise TypeError(f"{given_as[ours]!r} and {name!r} both set the config field {ours!r}")
        out[ours], given_as[ours] = value, name
    unknown = set(out) - {f.name for f in fields(Config)}
    if unknown:
        raise TypeError(f"unknown config fields: {sorted(unknown)}")
    return out


def _current_base() -> Config:
    ctx = _base_var.get()
    return ctx if ctx is not None else _base_default


def get_config() -> Config:
    """The effective configuration: the environment's overrides applied to
    the base."""
    updates = {}
    for var, (theirs, parse) in _ENV_KNOBS.items():
        raw = os.environ.get(var)
        if raw is None:
            continue
        val = parse(raw)
        if val is not None:
            updates[_REFERENCE_FIELDS[theirs]] = val
    cfg = _current_base()
    return replace(cfg, **updates) if updates else cfg


def set_config(cfg: Config | None = None, **overrides) -> Config:
    """Set the process-wide base configuration (below the environment's
    overrides).

    Pass a full :class:`Config`, or field overrides applied to the
    current base, by the port's or the JAX package's names. Returns the new
    base.
    """
    global _base_default
    if cfg is not None and overrides:
        raise TypeError("pass a Config or field overrides, not both")
    _base_default = cfg if cfg is not None else replace(_base_default, **_port_fields(overrides))
    return _base_default


@contextlib.contextmanager
def configure(**overrides):
    """Temporarily override base configuration fields (context manager);
    the environment's overrides still win.

    Re-entrant and safe under threads/async: overrides live in a
    ContextVar, so concurrent callers see their own values and
    out-of-order unwinds restore exactly the state each caller saw. Fields
    go by the port's or the JAX package's names.
    """
    token = _base_var.set(replace(_current_base(), **_port_fields(overrides)))
    try:
        yield _base_var.get()
    finally:
        _base_var.reset(token)
