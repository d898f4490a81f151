"""The share of the profiled window of reads in which the card ran no
kernel, copy or set, %."""

from benchmark.readers import idle_pct as read  # noqa: F401
