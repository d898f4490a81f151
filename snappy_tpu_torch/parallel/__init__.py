"""Multi-GPU scale-out: device meshes and the sharded batch codecs.

The port of ``snappy_tpu/parallel/``. Snappy's unit of parallelism is
the independent 64 KiB block / frame chunk: no shared dictionary, no
cross-block offsets, so the data path needs no collective. Sharding the
block axis over a 1-D mesh is the whole story, and the only information
ranks exchange is the per-block compressed length vector used for ordered
stream assembly (``multihost.compress_segments``: one ``all_gather`` of a
few KB). A sharded entry runs every shard at once, one host thread a
mesh entry, and returns a ``Sharded``: each shard's output left on its own
device.
"""

from .mesh import Mesh, ParallelConfig, auto_mesh, make_mesh  # noqa: F401
from .sharded import (  # noqa: F401
    Sharded,
    map_shards,
    sharded_compress_blocks,
    sharded_decode_streams,
    sharded_encode_frame_chunks,
)
