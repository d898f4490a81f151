"""The share of the card's idle time in the profiled reads during which the
program had no part of the call open but its root, %: the idle that the
trace names after a public entry's range (``decompress_frame``), over the
idle under any of the program's ranges (every range but the benchmark's
own). It reads the call's host work that no part names; the ranges' own
boundaries take about 4 us each of it. ``None`` where the program labels
no entry's range."""

from benchmark import trace

#: The port's public entries: each call's root range is named after one.
ENTRIES = ("decompress_frame", "decompress_streams", "decompress", "compress",
           "read.FrameDecoder", "write.FrameEncoder")


def read(o):
    idle = (o.layer.get("trace") or {}).get("idle") or {}
    if not any(k in idle for k in ENTRIES):
        return None
    inside = {k: v for k, v in idle.items() if k not in (trace.OUTSIDE, trace.CALL)}
    return 100.0 * sum(inside.get(k, 0.0) for k in ENTRIES) / sum(inside.values())
