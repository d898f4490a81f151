"""The 95th percentile of every call of the window, from its start to its
last output byte in host memory, in ms (per layer: the host's clock)."""

from benchmark import stats


def read(o):
    v = stats.p95(o.latencies_s)
    return None if v is None else 1e3 * v
