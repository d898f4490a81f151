"""The port's sharded tensor, hosted and replay decodes and its sharded
frame-chunk encoder on CPU meshes of 1, 2 and 4 devices give the JAX
package's sharded entries' bytes and error codes on its 8-device virtual
CPU mesh, and the one unsharded port call's. The batch holds corpus
blocks' bodies and the reference's corrupt vectors. Equality throughout."""

import jax
import numpy as np
import pytest
import torch

from snappy_tpu.parallel import make_mesh as jax_mesh
from snappy_tpu.parallel import sharded as jsharded
from snappy_tpu_torch.ops.decode import decode_batch, decode_batch_hosted
from snappy_tpu_torch.ops.frame import encode_frame_chunks
from snappy_tpu_torch.ops.replay import decode_replay
from snappy_tpu_torch.parallel import sharded
from torch_vectors import (
    cpu_mesh, hold_jax_native, jax_entry_outputs, share_cores_with_workers, shard_blocks,
    shard_decode_batch,
)

share_cores_with_workers()
hold_jax_native()

MESHES = [1, 2, 4]
BLOCKS, LENS = shard_blocks()
D_PAD = 16384
SRCS, SRC_LENS, DECLENS, BITS = shard_decode_batch(BLOCKS, LENS)


def t(x):
    return torch.from_numpy(x)


ENTRIES = {
    "streams": (
        lambda m: jax_entry_outputs(jsharded.sharded_decode_streams, m, SRCS, SRC_LENS, DECLENS, D_PAD),
        lambda m: sharded.sharded_decode_streams(m, SRCS, SRC_LENS, DECLENS, D_PAD),
        lambda: decode_batch(t(SRCS), t(SRC_LENS), t(DECLENS), D_PAD),
    ),
    "hosted": (
        lambda m: jax_entry_outputs(jsharded.sharded_decode_streams_hosted, m, SRCS, SRC_LENS, DECLENS, BITS, D_PAD),
        lambda m: sharded.sharded_decode_streams_hosted(m, SRCS, SRC_LENS, DECLENS, BITS, D_PAD),
        lambda: decode_batch_hosted(t(SRCS), t(SRC_LENS), t(DECLENS), t(BITS), D_PAD),
    ),
    "replay": (
        lambda m: jax_entry_outputs(jsharded.sharded_decode_streams_pallas, m, SRCS, SRC_LENS, DECLENS, D_PAD),
        lambda m: sharded.sharded_decode_streams_replay(m, SRCS, SRC_LENS, DECLENS, D_PAD),
        lambda: decode_replay(t(SRCS), t(SRC_LENS), t(DECLENS), D_PAD),
    ),
    "frame_chunks": (
        lambda m: jax_entry_outputs(jsharded.sharded_encode_frame_chunks, m, BLOCKS, LENS),
        lambda m: sharded.sharded_encode_frame_chunks(m, BLOCKS, LENS),
        lambda: encode_frame_chunks(t(BLOCKS), t(LENS)),
    ),
}


@pytest.fixture(scope="module")
def wanted():
    """Each entry's JAX outputs on the 8-device mesh and the unsharded port
    call's, computed once."""
    jmesh = jax_mesh(jax.devices()[:8])
    return {name: (theirs(jmesh), [x.numpy() for x in whole()])
            for name, (theirs, _, whole) in ENTRIES.items()}


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_sharded_entry_matches_jax_package_and_unsharded_call(wanted, entry, n):
    want, whole = wanted[entry]
    got = [x.numpy() for x in ENTRIES[entry][1](cpu_mesh(n))]
    assert len(got) == len(want) == len(whole)
    for g, w, u in zip(got, want, whole):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, u)
    if entry != "frame_chunks":
        dst, err = got[0], got[1]
        assert not err[:8].any() and err[8:].all()
        for i, m in enumerate(LENS):
            assert dst[i, :m].tobytes() == BLOCKS[i, :m].tobytes()
