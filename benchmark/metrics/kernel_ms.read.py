"""The kernels of a read, ms a call: api.spans kernels (CUDA events around
the launches: K2 and K1 on the flat route)."""

from benchmark.readers import span_ms


def read(o):
    return span_ms(o, ("kernels",))
