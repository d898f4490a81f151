"""The profiler's readings of a run and their reduction.

:func:`window_kernels` runs the measured window of every run under the
profiler, the card's activity only, and sums the device time of the
kernels that the window's calls ran: the end-to-end ``device_trace``
reading, which the host's clock does not enter.

:func:`profile` runs the traced stretch of a ``--trace 1`` run: calls
under ``torch.profiler`` (host and CUDA activity) inside one labelled
range, :data:`WINDOW`, each call in a range :data:`CALL`, and the card's
queued work synchronised before the range closes. The port labels its ``api`` spans as ranges of the same trace
while no ``api.spans`` dict is set, so the trace names what the host was
doing during each idle gap of the card. :func:`reduce_events` turns the
trace's events into the numbers the per-layer readers take: the window,
the card's busy time (the union of its kernels, copies and sets), kernel
time, device time by operation and idle time by host range.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

WINDOW = "bench.window"
CALL = "bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: The name of idle time during which the host was in no labelled range.
OUTSIDE = "harness"


def _profiled(body, acts) -> tuple[object, list[dict]]:
    """``body()`` under the profiler with activities ``acts``; returns its
    result and the trace's events. The trace is written to a directory of
    its own under ``TMPDIR`` and removed once read."""
    import torch

    with torch.profiler.profile(activities=acts) as prof:
        got = body()
    tmp = tempfile.mkdtemp(prefix="bench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return got, events


def window_kernels(body, cuda: bool = True) -> tuple[object, float]:
    """``body()`` (the measured window, which ends with every call's bytes
    in host memory) under the profiler, the card's activity only, where
    ``cuda``; returns its result and :func:`kernel_seconds` of the trace
    (0 without a card)."""
    if not cuda:
        return body(), 0.0
    import torch
    from torch.profiler import ProfilerActivity

    def synced():
        got = body()
        torch.cuda.synchronize()
        return got

    got, events = _profiled(synced, [ProfilerActivity.CUDA])
    return got, kernel_seconds(events)


def kernel_seconds(events: list[dict]) -> float:
    """The summed device time, in seconds, of every kernel in a Chrome
    trace's events (times in microseconds)."""
    return sum(float(e["dur"]) for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel" and "dur" in e) / 1e6


def profile(fn, n: int, cuda: bool = True) -> tuple[list, dict]:
    """``[fn(i) for i in range(n)]`` under the profiler, the card's
    activity too where ``cuda``; returns the results and
    :func:`reduce_events` of the trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    def body():
        out = []
        with record_function(WINDOW):
            for i in range(n):
                with record_function(CALL):
                    out.append(fn(i))
            if cuda:
                torch.cuda.synchronize()
        return out

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out, events = _profiled(body, acts)
    return out, reduce_events(events)


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _innermost(host: list[tuple[float, float, str]], t: float) -> str:
    best, width = OUTSIDE, float("inf")
    for a, b, name in host:
        if a <= t < b and b - a < width:
            best, width = name, b - a
    return best


def reduce_events(events: list[dict]) -> dict:
    """Reduce a Chrome trace's events (times in microseconds) to seconds:

    ``window_s``, the :data:`WINDOW` range's length; ``cards``, for each
    card that ran anything in it, ``busy_s`` (the union of its device
    events) and ``kernel_s`` (the sum of its kernels); ``busy_s``, the
    mean over those cards; ``kernel_s``, the sum over them;
    ``device_ops``, device seconds by operation name; ``idle``, the
    cards' idle seconds by the innermost host range open at the time
    (:data:`OUTSIDE` where none but the window was)."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"] != WINDOW]
    per_card: dict = {}
    ops: dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a, b = max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        card = per_card.setdefault((e.get("args") or {}).get("device", e.get("pid")),
                                   {"spans": [], "kernel_us": 0.0})
        card["spans"].append((a, b))
        if e["cat"] == "kernel":
            card["kernel_us"] += b - a
        ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a) / 1e6
    idle: dict[str, float] = {}
    cards = {}
    for dev, card in per_card.items():
        busy = _merge(card["spans"])
        edges = [w0] + [t for ab in busy for t in ab] + [w1]
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            cuts = sorted({a, b} | {t for h in host for t in h[:2] if a < t < b})
            for x, y in zip(cuts, cuts[1:]):
                name = _innermost(host, (x + y) / 2)
                idle[name] = idle.get(name, 0.0) + (y - x) / 1e6
        cards[str(dev)] = {"busy_s": sum(b - a for a, b in busy) / 1e6,
                           "kernel_s": card["kernel_us"] / 1e6}
    return {
        "window_s": (w1 - w0) / 1e6,
        "cards": cards,
        "busy_s": sum(c["busy_s"] for c in cards.values()) / len(cards) if cards else 0.0,
        "kernel_s": sum(c["kernel_s"] for c in cards.values()),
        "device_ops": ops,
        "idle": idle,
    }


def top(d: dict[str, float], n: int = 10) -> list[list]:
    """The ``n`` largest entries of ``d`` as ``[[name, seconds], ...]``."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
