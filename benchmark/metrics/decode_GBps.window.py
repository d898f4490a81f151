"""Uncompressed bytes the calls of the window delivered to host memory, over
the window's seconds on the host's clock, in GB/s (per layer: the host
stands still at times, so the rate swings from run to run)."""

from benchmark.readers import rate_gbps as read  # noqa: F401
