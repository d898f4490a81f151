"""The chain-resolution stages of the port (``ops/resolve.py``) equal the
JAX package's, stage by stage, on the contents of its own resolve tests at
``d_pad`` 65536: the first-hop plane and K8's record inputs against
``snappy_tpu.ops.resolve`` (XLA), the plain versions of K8 and K9 against
``resolve_fh_pallas`` and ``resolve_pallas`` (interpret mode), and the
flat gather's inputs against the JAX function and the host flatten. Every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappy_tpu.ops import resolve as jres
from snappy_tpu.ops.pallas.resolve import resolve_fh_pallas, resolve_pallas
from snappy_tpu_torch import native
from snappy_tpu_torch.ops import resolve
from torch_vectors import (
    hold_jax_native, raw_body, resolve_cases, scan_batch, share_cores_with_workers,
)

share_cores_with_workers()
hold_jax_native()

D_PAD = 1 << 16


@pytest.fixture(scope="module")
def batch():
    srcs, lens, declens, recs, nops, errs = scan_batch([raw_body(c) for c in resolve_cases()])
    assert not errs.any()
    return srcs, lens, declens, recs, nops


def _jax_args(recs, nops, declens):
    return jnp.asarray(recs), jnp.asarray(nops), jnp.asarray(declens.astype(np.int64))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_records_to_pointers_matches_jax(batch):
    _, _, declens, recs, nops = batch
    want, _ = jres.records_to_pointers(*_jax_args(recs, nops, declens), D_PAD)
    got = resolve.records_to_pointers(*_t(recs, nops, declens), D_PAD)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_records_to_kernel_inputs_match_jax_planes(batch):
    """``startsx`` and ``payload`` are the JAX function's f32 record planes
    without their padding: the starts plane row-major, the pack's lanes 0
    and 1 of every 8."""
    _, _, declens, recs, nops = batch
    st_pln, rec_pack, *_ = jres.records_to_kernel_inputs(*_jax_args(recs, nops, declens), D_PAD)
    startsx, payload = resolve.records_to_kernel_inputs(*_t(recs, nops, declens), D_PAD)
    b, cap = startsx.shape
    assert cap == recs.shape[1] and startsx.dtype == payload.dtype == torch.int32
    np.testing.assert_array_equal(
        startsx.numpy(), np.asarray(st_pln)[:, : cap // 128].reshape(b, cap).astype(np.int64))
    pack = np.asarray(rec_pack)[:, : cap // 16].reshape(b, cap, 8)
    np.testing.assert_array_equal(startsx.numpy(), pack[:, :, 0].astype(np.int64))
    np.testing.assert_array_equal(payload.numpy(), pack[:, :, 1].astype(np.int64))


def test_resolve_reference_matches_jax(batch):
    _, _, declens, recs, nops = batch
    a0, _ = jres.records_to_pointers(*_jax_args(recs, nops, declens), D_PAD)
    want = np.asarray(jres.resolve_reference(a0))
    got = resolve.resolve_reference(_t(a0)[0])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want >= jres.FLAG).all()
    # A budget of one round leaves chains: the same partial plane.
    np.testing.assert_array_equal(
        resolve.resolve_reference(_t(a0)[0], 1).numpy(),
        np.asarray(jres.resolve_reference(a0, 1)))


def test_k9_plain_matches_resolve_pallas(batch):
    _, _, declens, recs, nops = batch
    a0, rmeta = jres.records_to_pointers(*_jax_args(recs, nops, declens), D_PAD)
    want = np.asarray(resolve_pallas(a0, rmeta, interpret=True))
    got = resolve.resolve(resolve.records_to_pointers(*_t(recs, nops, declens), D_PAD))
    np.testing.assert_array_equal(got.numpy(), want)


def test_k8_plain_matches_resolve_fh_pallas(batch):
    """Whole planes: every live byte's origin, ``FLAG`` past ``declen``."""
    _, _, declens, recs, nops = batch
    want = np.asarray(resolve_fh_pallas(
        *jres.records_to_kernel_inputs(*_jax_args(recs, nops, declens), D_PAD),
        jnp.asarray(declens.astype(np.int64)), D_PAD, interpret=True))
    startsx, payload = resolve.records_to_kernel_inputs(*_t(recs, nops, declens), D_PAD)
    got = resolve.resolve_fh(startsx, payload, torch.from_numpy(declens), D_PAD)
    np.testing.assert_array_equal(got.numpy(), want)
    for i, dl in enumerate(declens):
        assert (want[i, dl:] == resolve.FLAG).all() and (want[i] >= resolve.FLAG).all()


def test_k8_plain_on_error_rows_matches_resolve_fh_pallas():
    """Rows the scan cut short: a row with no record (its hop is -1, which
    never resolves) and a row whose last record extends past its end. The
    fused kernel and the plain version flag the same rows, and agree on
    every row that resolves."""
    rows = [(b"\x61", 3), (b"\x00a\x1d\x01", 5), raw_body(resolve_cases()[5]), (b"\x00a", 4)]
    srcs, lens, declens, recs, nops, errs = scan_batch(rows, 512)
    assert list(nops[:2]) == [0, 1] and errs[0] and errs[1] and errs[3]
    d_pad = 16384
    want = np.asarray(resolve_fh_pallas(
        *jres.records_to_kernel_inputs(*_jax_args(recs, nops, declens), d_pad),
        jnp.asarray(declens.astype(np.int64)), d_pad, interpret=True))
    startsx, payload = resolve.records_to_kernel_inputs(*_t(recs, nops, declens), d_pad)
    got = resolve.resolve_fh(startsx, payload, torch.from_numpy(declens), d_pad).numpy()
    unresolved = (got < resolve.FLAG).any(axis=1)
    np.testing.assert_array_equal(unresolved, (want < resolve.FLAG).any(axis=1))
    assert unresolved.tolist() == [True, False, False, False]
    assert (got[0, :3] == -1).all() and (got[0, 3:] == resolve.FLAG).all()
    np.testing.assert_array_equal(got[1:], want[1:])
    # Past its one literal, the cut row reads on through its source.
    assert (got[1, :5] - resolve.FLAG).tolist() == [1, 2, 3, 4, 5]


def test_idx_to_v2_inputs_match_jax_and_the_host_flatten(batch):
    srcs, lens, declens, recs, nops = batch
    a0, _ = jres.records_to_pointers(*_jax_args(recs, nops, declens), D_PAD)
    a = jres.resolve_reference(a0)
    s_rows = srcs.shape[1] // 128
    want = [np.asarray(x) for x in
            jres.idx_to_v2_inputs(a, jnp.asarray(declens.astype(np.int64)), D_PAD, s_rows)]
    idx, tmeta, fallback = resolve.idx_to_v2_inputs(
        _t(a)[0], torch.from_numpy(declens), D_PAD, s_rows)
    assert idx.dtype == torch.int16
    np.testing.assert_array_equal(idx.numpy().view(np.uint16), want[0])
    np.testing.assert_array_equal(tmeta.numpy(), want[1])
    np.testing.assert_array_equal(fallback.numpy(), want[2])
    h_idx, h_tmeta, h_fb, h_errs, _ = native.flatten_idx_batch(
        srcs, lens.astype(np.uint64), declens.astype(np.uint64), D_PAD, layout=1)
    assert not h_fb.any() and not h_errs.any() and not fallback.any()
    np.testing.assert_array_equal(idx.numpy().view(np.uint16), h_idx)
    np.testing.assert_array_equal(tmeta.numpy(), h_tmeta)


def test_wrappers_check_their_inputs():
    a0 = torch.full((2, 2048), resolve.FLAG, dtype=torch.int32)
    with pytest.raises(TypeError):
        resolve.resolve(a0.to(torch.int64))
    with pytest.raises(ValueError):
        resolve.resolve(torch.zeros((1, 1000), dtype=torch.int32))  # not whole tiles
    i32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        resolve.resolve_fh(a0[:, :8].contiguous(), a0[:, :9].contiguous(), i32, 2048)
    with pytest.raises(ValueError):
        resolve.records_to_pointers(torch.zeros((1, 512, 2), dtype=torch.int32), i32[:1], i32[:1],
                                    1 << 17)
    assert torch.equal(resolve.resolve(a0), a0)
