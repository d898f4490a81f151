"""The port's sharded host-flatten decode (``sharded_decode_flat_host``: the
host flatten, then K2 ``layout=1``, its plain version on the CPU) and the
sharded flat gather it calls (``sharded_decode_streams_flat``) on CPU
meshes of 1, 2 and 4 devices give the JAX package's
``sharded_decode_flat_host`` bytes, error codes and fallback flags on its
8-device virtual CPU mesh (its Pallas gather in interpret mode), and the
one unsharded port call's. The batch holds corpus blocks' bodies and the
reference's corrupt vectors. Equality throughout."""

import jax
import numpy as np
import pytest
import torch

from snappy_tpu import native as jnative
from snappy_tpu.parallel import make_mesh as jax_mesh
from snappy_tpu.parallel import sharded as jsharded
from snappy_tpu_torch import native
from snappy_tpu_torch.ops.decode_flat import decode_flat
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


def flatten(lib):
    return lib.flatten_idx_batch(SRCS, SRC_LENS.astype(np.uint64), DECLENS.astype(np.uint64),
                                 D_PAD, layout=1)


@pytest.fixture(scope="module")
def wanted():
    """The JAX entry's ``(dst, errs, fallback)``; it gathers through the
    JAX package's ``sharded_decode_streams_flat``. Also the unsharded port
    call on the port's flatten."""
    jmesh = jax_mesh(jax.devices()[:8])
    want = jax_entry_outputs(jsharded.sharded_decode_flat_host, jmesh, SRCS, SRC_LENS, DECLENS, D_PAD)
    idx, tmeta, _, _, _ = flatten(native)
    whole = decode_flat(*(torch.from_numpy(x) for x in (SRCS, idx.view(np.int16), tmeta, DECLENS)),
                        D_PAD, 1).numpy()
    return want, whole


def test_port_flatten_is_the_jax_package_flatten():
    for ours, theirs in zip(flatten(native), flatten(jnative)):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_decode_flat_host(wanted, n):
    (want_dst, want_err, want_fb), whole = wanted
    mesh = cpu_mesh(n)
    dst, err, fb = sharded.sharded_decode_flat_host(mesh, SRCS, SRC_LENS, DECLENS, D_PAD)
    np.testing.assert_array_equal(dst.numpy(), want_dst)
    np.testing.assert_array_equal(dst.numpy(), whole)
    np.testing.assert_array_equal(err, want_err)
    np.testing.assert_array_equal(fb, want_fb)
    assert not fb.any() and not err[:8].any() and err[8:].all()
    for i, m in enumerate(LENS):
        assert dst.numpy()[i, :m].tobytes() == BLOCKS[i, :m].tobytes()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_decode_streams_flat(wanted, n):
    (want_dst, _, _), whole = wanted
    idx, tmeta, _, _, _ = flatten(native)
    mesh = cpu_mesh(n)
    dst = sharded.sharded_decode_streams_flat(mesh, SRCS, idx, tmeta, DECLENS, D_PAD)
    np.testing.assert_array_equal(dst.numpy(), want_dst)
    np.testing.assert_array_equal(dst.numpy(), whole)
