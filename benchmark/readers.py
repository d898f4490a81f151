"""What the metric readers share: a run's span, trace and counter readings
reduced to one number each, or ``None`` where the run holds nothing to
read (the metric is then left out of the result line)."""

from __future__ import annotations

import json
import statistics
from pathlib import Path

from . import stats

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())["cards"]


def span_ms(o, names: tuple[str, ...]) -> float | None:
    """The mean over the traced calls of the ``api.spans`` seconds under
    ``names``, summed, in milliseconds."""
    calls = o.layer.get("spans") or []
    if not any(n in s for s in calls for n in names):
        return None
    return 1e3 * statistics.fmean(sum(s.get(n, 0.0) for n in names) for s in calls)


def roofline_pct(o) -> float | None:
    """The least time the card's memory could take for the codec's bytes
    in and out of the profiled calls, at the published peak, as a share
    of the kernels' summed device time in the profiler's window."""
    tr, need = o.layer.get("trace") or {}, o.layer.get("need_bytes") or 0
    peak = PEAKS.get(o.device.get("kind"), {}).get("hbm_bytes_per_s")
    if not tr.get("kernel_s") or not need or not peak:
        return None
    return 100.0 * (need / peak) / tr["kernel_s"]


def idle_pct(o) -> float | None:
    """The share of the profiler's window with no kernel, copy or set on
    the card, the mean over cards."""
    tr = o.layer.get("trace") or {}
    if not tr.get("cards") or not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def rate_gbps(o) -> float | None:
    return stats.rate_gbps(o.bytes_done, o.window_s)
