"""The host flatten of a read, ms a call: api.spans flatten
(native stpu_flatten_idx, every host core)."""

from benchmark.readers import span_ms


def read(o):
    return span_ms(o, ("flatten",))
