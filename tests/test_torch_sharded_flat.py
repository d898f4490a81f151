"""The port's sharded flat-encoder compress (K4, K5; their plain versions
on the CPU) on CPU meshes of 1, 2 and 4 devices gives the JAX package's
``sharded_compress_blocks_flat`` bytes, lengths and overflow flags on its
8-device virtual CPU mesh (its Pallas kernels in interpret mode), and the
one unsharded port call's. Equality throughout."""

import jax
import numpy as np
import pytest
import torch

from snappy_tpu.parallel import make_mesh as jax_mesh
from snappy_tpu.parallel import sharded as jsharded
from snappy_tpu_torch import native
from snappy_tpu_torch.format.varint import write_varu64
from snappy_tpu_torch.ops.encode_flat import compress_blocks_flat_fast
from snappy_tpu_torch.parallel import sharded
from torch_vectors import (
    cpu_mesh, hold_jax_native, jax_entry_outputs, share_cores_with_workers, shard_blocks,
)

share_cores_with_workers()
hold_jax_native()

BLOCKS, LENS = shard_blocks()


@pytest.fixture(scope="module")
def wanted():
    jmesh = jax_mesh(jax.devices()[:8])
    want = jax_entry_outputs(jsharded.sharded_compress_blocks_flat, jmesh, BLOCKS, LENS)
    whole = [x.numpy() for x in compress_blocks_flat_fast(torch.from_numpy(BLOCKS),
                                                          torch.from_numpy(LENS))]
    return want, whole


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_flat_compress(wanted, n):
    want, whole = wanted
    mesh = cpu_mesh(n)
    got = [x.numpy() for x in sharded.sharded_compress_blocks_flat(mesh, BLOCKS, LENS)]
    assert len(got) == len(want) == 3
    for g, w, u in zip(got, want, whole):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, u)
    out, out_len, ovf = got
    assert not ovf.any()
    for i, m in enumerate(LENS):
        stream = write_varu64(int(m)) + out[i, : out_len[i]].tobytes()
        assert native.decompress(stream) == BLOCKS[i, :m].tobytes()
