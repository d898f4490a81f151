"""Host bytes handling of a read, ms a call: api.spans walk, pack, unpack,
join and stored_crc (the chunk walk, grouping and packing, rows to bytes,
the join, the stored chunks' checksums)."""

from benchmark.readers import span_ms


def read(o):
    return span_ms(o, ("walk", "pack", "unpack", "join", "stored_crc"))
