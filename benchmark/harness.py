"""What the drivers share: a run's context and outcome, the clocks, the
closed loop of one caller, the sample of calls that are checked, and the
look at the card.

A driver takes a :class:`Context` and returns an :class:`Outcome`; the
metric readers (``metrics/<name>.py``) read the outcome and nothing else.
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

#: Top-level module names that no run may have loaded once its window has
#: closed: JAX, its libraries, and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "snappy_tpu")


@dataclass
class Context:
    name: str
    seed: int
    seconds: float
    trace: bool
    cell: dict
    config: dict
    #: ``cuda`` on the card; the CPU tests pass ``cpu``, which runs the
    #: kernels' plain versions and skips the look for a card.
    device: str = "cuda"
    #: A fault planted under the timed path (the tests only): see ``faults.py``.
    fault: str | None = None
    #: Run the cell's control in the program's place (``correct`` must come out false).
    control: bool = False
    cache_dir: Path | None = None
    #: Seconds of the process spent on the reference's cache before the
    #: window: subtracted from ``setup_s``, which counts the program's set-up.
    reference_s: float = 0.0

    @property
    def traffic(self) -> dict:
        return self.cell["traffic"]

    @property
    def params(self) -> dict:
        return self.cell["params"]


@dataclass
class Outcome:
    """What a run measured. Window fields are from the measured window,
    which every run has; ``layer`` fields from the traced stretch, which
    only ``--trace 1`` adds."""

    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    latencies_s: list[float] = field(default_factory=list)
    bytes_done: int = 0  # uncompressed bytes of the calls completed in the window
    cpu_s: float = 0.0
    kernel_s: float = 0.0  # device seconds of the window's kernels (profiler)
    setup_s: float = 0.0
    device: dict = field(default_factory=dict)
    #: name -> (value, limit): each number compared, correct while value <= limit.
    checks: dict[str, tuple[float, float]] = field(default_factory=dict)
    #: The traced run's readings: ``spans`` (one dict of ``api.spans``
    #: seconds a call), ``trace`` (``trace.reduce_events``), ``need_bytes``
    #: (the codec's bytes in and out over the profiled calls).
    layer: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for v, lim in self.checks.values())


def clock() -> float:
    """Seconds since boot (``CLOCK_BOOTTIME``), the clock of the process's
    start time in ``/proc``."""
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """When this process started, on :func:`clock`: ``/proc``'s start
    time in clock ticks since boot."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def log(what: str) -> None:
    """A line on stderr: ``what`` and the seconds since the process began."""
    print(f"[bench {clock() - process_start():8.3f} s] {what}", file=sys.stderr, flush=True)


def cpu_seconds() -> float:
    """User plus system CPU seconds of every thread of this process."""
    return time.process_time()


def host_state() -> dict[str, float]:
    """The process's user and system CPU seconds so far (``getrusage``),
    for the log beside a window: system time is the kernel's work for
    the process, page faults and mappings among it."""
    import resource

    r = resource.getrusage(resource.RUSAGE_SELF)
    return {"user_s": r.ru_utime, "sys_s": r.ru_stime}


def closed_loop(call, items: list, seconds: float, keep: set[int] | None = None):
    """One caller: ``call(item)`` on ``items`` round-robin, the next as soon
    as the last returns, until a call ends past ``seconds`` after the
    first began; that call counts, so the window is all the work and all
    of its time. Returns ``(window_s, latencies_s, done, kept, failed,
    cpu_s, started)``: ``done`` lists the item index of each call that
    returned, ``kept`` maps each call index in ``keep`` (and the last) to
    ``(item index, result)``; ``started`` is the first call's start on
    :func:`clock`."""
    keep = keep or set()
    lat, kept, failed, done = [], {}, 0, []
    cpu0 = cpu_seconds()
    t0 = clock()
    end = t0 + seconds
    i = 0
    while True:
        j = i % len(items)
        a = clock()
        try:
            out = call(items[j])
        except Exception as e:  # noqa: BLE001 - a failed call is counted, and fails the run
            print(f"call {i} failed: {type(e).__name__}: {e}", file=sys.stderr)
            out, failed = None, failed + 1
        else:
            done.append(j)
        b = clock()
        lat.append(b - a)
        if i in keep:
            kept[i] = (j, out)
        i += 1
        if b >= end:
            kept[i - 1] = (j, out)
            break
    return b - t0, lat, done, kept, failed, cpu_seconds() - cpu0, t0


def sample(seed: int, est_calls: int, want: int) -> set[int]:
    """About ``want`` call indices of ``est_calls``, drawn from the seed:
    every ``m``-th call from an offset the seed draws."""
    m = max(1, est_calls // max(want, 1))
    r = int(np.random.default_rng(abs(int(seed)) % 2**63).integers(m))
    return set(range(r, 4 * est_calls + m, m))


def mismatched(got, want: bytes) -> int:
    """Bytes of ``got`` that differ from ``want``, its missing or extra
    bytes included; a call that gave nothing misses every byte."""
    if got is None:
        return len(want)
    got = bytes(got)
    if got == want:
        return 0
    n = min(len(got), len(want))
    a, b = np.frombuffer(got, np.uint8, n), np.frombuffer(want, np.uint8, n)
    return int((a != b).sum()) + abs(len(got) - len(want))


def forbidden_loaded() -> list[str]:
    """The forbidden top-level names among ``sys.modules``, each compared
    whole: ``snappy_tpu_torch`` is not ``snappy_tpu``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card(device: str) -> dict:
    """The ``device`` object of the result for one card (the peak set by
    the caller once the window closes)."""
    import torch

    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def configure_port(device: str, settings: dict | None = None) -> None:
    """Run the port as the configuration states: its default ``Config``
    with the configuration's ``port`` settings; on the CPU (the tests), the
    kernels' plain versions."""
    import snappy_tpu_torch

    snappy_tpu_torch.set_config(snappy_tpu_torch.Config(device=device, **(settings or {})))
