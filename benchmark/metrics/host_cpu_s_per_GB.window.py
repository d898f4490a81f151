"""CPU seconds, user and system, of every thread of the process over the
window, per GB of uncompressed data completed (per layer: the host's
clock)."""

from benchmark import stats


def read(o):
    return stats.cpu_s_per_gb(o.cpu_s, o.bytes_done)
