"""Copies of a read, ms a call: api.spans h2d and d2h."""

from benchmark.readers import span_ms


def read(o):
    return span_ms(o, ("h2d", "d2h"))
