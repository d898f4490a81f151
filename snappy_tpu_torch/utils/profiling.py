"""Profiling helpers: wall-clock timing and ``torch.profiler`` traces.

The port of ``snappy_tpu/utils/profiling.py``. Steady-state wall-clock
timing around work that ends on the card needs a synchronize before each
clock read (``timed`` does it, as the JAX version asks its callers for a
``block_until_ready``); a device trace shows each kernel's device time and
the host's gaps between launches.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field

import torch


@dataclass
class Timer:
    """Accumulates named wall-clock spans; ``report()`` pretty-prints."""

    spans: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        width = max((len(k) for k in self.spans), default=0)
        return "\n".join(f"{k:<{width}} {v * 1e3:9.2f} ms" for k, v in self.spans.items())


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(label: str, nbytes: int | None = None, out=None):
    """Time a block, the card's queued work included; prints GB/s when
    ``nbytes`` is given."""
    out = out or sys.stderr
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    if nbytes is not None and dt > 0:
        print(f"{label}: {dt * 1e3:.2f} ms  {nbytes / dt / 1e9:.2f} GB/s", file=out)
    else:
        print(f"{label}: {dt * 1e3:.2f} ms", file=out)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block into ``logdir`` as a
    Chrome trace, ``trace.<pid>.<ns>.json`` (open it with Perfetto or
    ``chrome://tracing``).

    Host activity is always traced, the card's whenever one is present; the
    block's queued device work is synchronized before the trace stops.
    Yields the profiler (``key_averages()`` sums the events by name).
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, f"trace.{os.getpid()}.{time.time_ns()}.json"))
