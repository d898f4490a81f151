"""The arithmetic of the end-to-end metrics, on plain numbers.

Every rate is all the work of the window over all of its time; every
tail is over every call of the window. Nothing here reads a clock.
"""

from __future__ import annotations

import statistics


def rate_gbps(nbytes: int, window_s: float) -> float | None:
    """GB/s (10**9 bytes a second) of ``nbytes`` completed in ``window_s``."""
    return nbytes / window_s / 1e9 if window_s > 0 and nbytes > 0 else None


def p95(values: list[float]) -> float | None:
    """The 95th percentile of every value, interpolated between the two
    nearest ranks (``statistics.quantiles``' inclusive method)."""
    if not values:
        return None
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def cpu_s_per_gb(cpu_s: float, nbytes: int) -> float | None:
    """CPU seconds per GB (10**9 bytes) of data completed."""
    return cpu_s / (nbytes / 1e9) if nbytes > 0 and cpu_s > 0 else None

