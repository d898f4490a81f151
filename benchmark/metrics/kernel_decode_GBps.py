"""Uncompressed bytes the calls of the window delivered, over the device
seconds of every kernel those calls ran on the card (the profiler's trace
of the whole window), in GB/s: the card's decode rate, which the host's
clock does not enter."""

from benchmark import stats


def read(o):
    return stats.rate_gbps(o.bytes_done, o.kernel_s)
