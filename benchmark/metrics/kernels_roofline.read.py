"""The read's kernels against the card's memory roofline, %: compressed
bytes in plus uncompressed bytes out of the profiled calls at the
published peak, over the summed device time of every kernel they ran."""

from benchmark.readers import roofline_pct as read  # noqa: F401
