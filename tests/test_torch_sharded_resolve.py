"""The port's sharded chain-resolution decode (``sharded_decode_resolve``:
K8, then K2, their plain versions on the CPU) on CPU meshes of 1, 2 and 4
devices gives the JAX package's ``sharded_decode_resolve`` fallback flags
and the bytes of every row it does not flag on its 8-device virtual CPU
mesh (its Pallas kernels in interpret mode), and the one unsharded port
call's outputs. The batch holds corpus
blocks' bodies and the reference's corrupt vectors, scanned into op
records by the host. Equality throughout."""

import jax
import numpy as np
import pytest
import torch

from snappy_tpu.parallel import make_mesh as jax_mesh
from snappy_tpu.parallel import sharded as jsharded
from snappy_tpu_torch import native
from snappy_tpu_torch.ops.resolve import decode_resolve_batch
from snappy_tpu_torch.parallel import sharded
from torch_vectors import (
    cpu_mesh, hold_jax_native, jax_entry_outputs, share_cores_with_workers, shard_blocks,
    shard_decode_batch,
)

share_cores_with_workers()
hold_jax_native()

BLOCKS, LENS = shard_blocks()
SRCS, SRC_LENS, DECLENS, _ = shard_decode_batch(BLOCKS, LENS)
D_PAD = 16384
RECS, NOPS, ERRS, _ = native.scan_records_batch(
    SRCS, SRC_LENS.astype(np.uint64), DECLENS.astype(np.uint64), 2048)


@pytest.fixture(scope="module")
def wanted():
    jmesh = jax_mesh(jax.devices()[:8])
    want = jax_entry_outputs(jsharded.sharded_decode_resolve, jmesh, SRCS, RECS, NOPS, DECLENS, D_PAD)
    whole = [x.numpy() for x in decode_resolve_batch(
        *(torch.from_numpy(x) for x in (SRCS, RECS, NOPS.astype(np.int32), DECLENS)), D_PAD)]
    return want, whole


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_decode_resolve(wanted, n):
    want, whole = wanted
    mesh = cpu_mesh(n)
    got = [x.numpy() for x in sharded.sharded_decode_resolve(mesh, SRCS, RECS, NOPS, DECLENS, D_PAD)]
    assert len(got) == len(want) == 2
    for g, u in zip(got, whole):
        np.testing.assert_array_equal(g, u)
    dst, fallback = got
    # A flagged row's bytes are not valid (the entry's contract); on a row
    # with no record the two packages leave different bytes, as their
    # unsharded twins do (tests/test_torch_resolve_batch.py).
    np.testing.assert_array_equal(fallback, want[1])
    keep = fallback == 0
    np.testing.assert_array_equal(dst[keep], want[0][keep])
    assert not fallback[:8].any() and not ERRS[:8].any() and ERRS[8:].all()
    for i, m in enumerate(LENS):
        assert dst[i, :m].tobytes() == BLOCKS[i, :m].tobytes()
