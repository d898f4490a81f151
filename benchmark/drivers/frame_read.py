"""Framed reads: one caller decoding frame streams in a closed loop.

Each call is ``snappy_tpu_torch.decompress_frame(stream)`` on the next
stream of the pool (``traffic.frame_pool``): the chunk walk, the
grouping, the host flatten, the copies, K2 and K1 on the card, the stored
chunks' checksums and the join. A call ends with every byte in host
memory. Each sampled call's bytes are held to the stream's data, which the
reference decoded from the same chunks when it compressed them.

The configuration guarantees that every chunk's checksum is checked on
read: after the calls, one stream with one compressed chunk's checksum
flipped and one with one stored chunk's flipped, chunks drawn from the
seed, must each raise. The control is the reference decoder in the
port's place with its checksum check off.
"""

from __future__ import annotations

import numpy as np

from .. import faults, harness, single, traffic
from ..reference import snappy as ref


def _probes(stream: bytes, seed: int) -> list[bytes]:
    """``stream`` with one chunk's checksum flipped: a compressed chunk,
    then a stored one (where the stream has one), drawn from the seed."""
    rng = np.random.default_rng(abs(int(seed)) % 2**63 + 1)
    chunks = ref.frame_walk(stream)
    out = []
    for kind in (ref.CHUNK_COMPRESSED, ref.CHUNK_STORED):
        at = [a for k, a, _ in chunks if k == kind]
        if at:
            pos = at[int(rng.integers(len(at)))]
            out.append(stream[:pos] + bytes((stream[pos] ^ 0x01,)) + stream[pos + 1:])
    return out


def run(ctx: harness.Context) -> harness.Outcome:
    with faults.planted(ctx.fault):
        return _run(ctx)


def _run(ctx: harness.Context) -> harness.Outcome:
    import snappy_tpu_torch

    harness.log("imports done")
    harness.configure_port(ctx.device, ctx.config.get("port"))
    corpus = traffic.load_corpus(ctx.config, ctx.cache_dir)
    ctx.reference_s = corpus.reference_s
    pool = traffic.frame_pool(corpus, ctx.traffic, ctx.seed)
    if ctx.control:
        def decode(data):
            return ref.frame_decode(data, verify=False)
    else:
        decode = snappy_tpu_torch.decompress_frame

    out = single.run(ctx, pool, lambda item: decode(item.data),
                        expect=lambda item: traffic.expected_frame_output(corpus, item),
                        need=lambda item, got: item.in_bytes + len(got))
    accepted = 0
    for bad in _probes(pool[0].data, ctx.seed):
        try:
            decode(bad)
        except (snappy_tpu_torch.SnappyError, ValueError):
            continue
        accepted += 1
    out.checks["crc_unchecked"] = (accepted, 0)
    return out
