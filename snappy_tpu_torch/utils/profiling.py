"""Profiling helpers: wall-clock timing and ``torch.profiler`` traces.

The port of ``snappy_tpu/utils/profiling.py``. Steady-state wall-clock
timing around work that ends on the card needs a synchronize before each
clock read (``timed`` does it, as the JAX version asks its callers for a
``block_until_ready``); a device trace shows each kernel's device time and
the host's gaps between launches.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import torch


def _sync() -> None:
    """Wait for every card: a sharded entry's shards run on several."""
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


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


def event_ms(fn, reps: int, warm: int = 2, turns: int = 1, check=None) -> list[float]:
    """Milliseconds per call of ``fn`` on the card, one reading per turn:
    each turn is ``reps`` calls on resident inputs between two CUDA events,
    the host's dispatch included, after ``warm`` untimed calls.
    ``check(out)`` then sees the output of the last timed call."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out, last = [], None
    for _ in range(turns):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            last = fn()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    if check is not None:
        check(last)
    return out


def graph_ms(fn, reps: int, turns: int = 1, check=None) -> list[float]:
    """Milliseconds per call of ``fn`` with the host out of the window, one
    reading per turn: ``reps`` calls captured once in a CUDA graph on the
    side stream that ran the warm-up (the wrappers launch on the current
    stream, the capture's, and make their scratch there first), each turn
    one replay between two CUDA events. ``fn`` must read nothing back.
    ``check(out)`` then sees the last captured call's output as the last
    replay left it, so the timed work is the checked work."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            last = fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(turns):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / reps)
    if check is not None:
        check(last)
    del graph
    return out


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block into ``logdir`` as a
    Chrome trace, ``trace.<pid>.<ns>.json`` (open it with Perfetto or
    ``chrome://tracing``).

    Host activity is always traced, the cards' whenever one is present; the
    block's queued work on every card is synchronized before the trace
    stops.
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


def device_events(path: str) -> list[dict]:
    """The device events of a Chrome trace written by :func:`device_trace`:
    kernels, copies and sets, each ``{"name", "cat", "device", "ts",
    "dur"}`` (times in microseconds; ``cat`` is ``kernel``, ``gpu_memcpy``
    or ``gpu_memset``; ``device`` the card's index)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [{"name": e["name"], "cat": e["cat"], "device": e.get("args", {}).get("device"),
             "ts": e["ts"], "dur": e["dur"]}
            for e in events if e.get("ph") == "X" and "dur" in e
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def device_to_device_copies(events: list[dict]) -> list[dict]:
    """The copies among ``events`` from device memory to device memory: on
    one card (``DtoD``) or from card to card (``PtoP``)."""
    return [e for e in events if e["cat"] == "gpu_memcpy"
            and ("DtoD" in e["name"] or "PtoP" in e["name"])]


def cross_device_overlap_us(events: list[dict], cat: str = "kernel") -> float:
    """Microseconds during which events of ``cat`` run on two or more cards
    at once."""
    edges = sorted((t, step, e["device"]) for e in events if e["cat"] == cat
                   for t, step in ((e["ts"], 1), (e["ts"] + e["dur"], -1)))
    running: dict = {}
    overlap, last = 0.0, None
    for t, step, dev in edges:
        if last is not None and sum(1 for n in running.values() if n > 0) >= 2:
            overlap += t - last
        running[dev] = running.get(dev, 0) + step
        last = t
    return overlap
