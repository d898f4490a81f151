"""K11's plain version (the grouped flat gather) equals the JAX package's
``decode_flat_pallas_v3`` and ``decode_flat_pallas_v4`` (interpret mode),
on group buckets from ``group_buckets`` and on hand-made ones: a dead
group that is live, a bucket of 3 (zeros for v3, the wide window for v4)
and a bucket narrower than its tiles'. The port's ``group_buckets`` equals
the JAX one, and with its buckets K11 gives K2's bytes. Output bytes are
integers: equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_corpus
from snappy_tpu.format import reference as jref
from snappy_tpu.format.varint import read_varu64
from snappy_tpu.ops.pallas.decode import decode_flat_pallas_v3, decode_flat_pallas_v4
from snappy_tpu.ops.pallas.decode import group_buckets as jax_group_buckets
from snappy_tpu_torch import native
from snappy_tpu_torch.ops import decode_flat as flat
from snappy_tpu_torch.ops import packing
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

PALLAS = {3: decode_flat_pallas_v3, 4: decode_flat_pallas_v4}


def _group(datas, d_pad, width):
    bodies = []
    for d in datas:
        c = jref.compress(d)
        bodies.append(c[read_varu64(c)[1]:])
    srcs, lens = packing.batch_streams(bodies, width)
    declens = np.asarray([len(d) for d in datas], np.int32)
    idx, tmeta, fallb, errs, _ = native.flatten_idx_batch(
        srcs, lens.astype(np.uint64), declens.astype(np.uint64), d_pad, layout=1
    )
    assert not fallb.any() and not errs.any()
    return srcs, idx, tmeta, declens


def _port_buckets(tmeta, declens, d_pad):
    return flat.group_buckets(torch.from_numpy(tmeta), torch.from_numpy(declens), d_pad).numpy()


def _port(srcs, idx, tmeta, gbuck, declens, d_pad, variant):
    out = flat.decode_flat_grouped(
        torch.from_numpy(srcs), torch.from_numpy(idx.view(np.int16)), torch.from_numpy(tmeta),
        torch.from_numpy(gbuck), torch.from_numpy(declens), d_pad, variant,
    )
    assert out.dtype == torch.uint8 and out.shape == (srcs.shape[0], d_pad)
    return out.numpy()


def _rows(case):
    """``(datas, d_pad, width)``. ``wide``: 32 KiB rows (``s_rows`` 256, so
    the wide window clamps to 256), one with a 256-row tile bucket and one
    whose second group is past its length; ``narrow``: two highly
    compressible rows in 2 KiB (``s_rows`` 16, under every window)."""
    rng = np.random.default_rng(23)
    if case == "narrow":
        return [b"z" * 30000, (b"pattern!" * 4000)[:32000]], 32768, 2048
    return [
        load_corpus("lcet10.txt")[:32768],
        load_corpus("kppkn.gtb")[:30000],
        bytes(rng.integers(0, 4, 20000, dtype=np.uint8)),
        (b"pattern!" * 4000)[:32000],
        b"ab" * 5000,
    ], 32768, 32768


def _handmade(gbuck):
    """Buckets no ``group_buckets`` gives: a live group marked dead, a 3, a
    bucket narrower than the group's tiles' and one wider."""
    hand = gbuck.copy()
    assert hand[0, 1] == 1  # lcet10's second group holds a 256-row tile
    hand[0, 1] = 0
    hand[1, 0] = -1
    hand[1, 1] = 3
    hand[2, 0] = 2
    return hand


@pytest.mark.parametrize("case", ["wide", "narrow"])
@pytest.mark.parametrize("variant", [3, 4])
def test_plain_matches_pallas_interpret(variant, case):
    datas, d_pad, width = _rows(case)
    srcs, idx, tmeta, declens = _group(datas, d_pad, width)
    gbuck = _port_buckets(tmeta, declens, d_pad)
    np.testing.assert_array_equal(gbuck, jax_group_buckets(tmeta, declens, d_pad))
    cases = [gbuck] if case == "narrow" else [gbuck, _handmade(gbuck)]
    for k, gb in enumerate(cases):
        want = np.asarray(PALLAS[variant](
            *(jnp.asarray(a) for a in (srcs, idx, tmeta, gb, declens)), d_pad, interpret=True
        ))
        got = _port(srcs, idx, tmeta, gb, declens, d_pad, variant)
        np.testing.assert_array_equal(got, want)
        for i, d in enumerate(datas):
            assert (got[i, : len(d)].tobytes() == d) == (k == 0 or i >= 2), (k, i)
            assert not got[i, len(d):].any()
    if case == "wide":
        assert not got[1, :16384].any()  # the dead group
        assert got[1, 16384:].any() == (variant == 4)  # bucket 3
        assert got[2, : len(datas[2])].tobytes() == datas[2]  # a wider window


def test_group_buckets_match_jax_package():
    """The JAX package's five v3/v4 test rows (``tests/test_pallas.py``):
    partial tails, an incompressible row, overlap-heavy and random rows."""
    rng = np.random.default_rng(23)
    datas = [
        load_corpus("html")[:65536],
        load_corpus("geo.protodata")[:50000],
        b"ab" * 20000,
        bytes(rng.integers(0, 4, 65536, dtype=np.uint8)),
        load_corpus("fireworks.jpeg")[:30000],
    ]
    d_pad = 65536
    srcs, idx, tmeta, declens = _group(datas, d_pad, None)
    gbuck = _port_buckets(tmeta, declens, d_pad)
    np.testing.assert_array_equal(gbuck, jax_group_buckets(tmeta, declens, d_pad))
    assert (gbuck == -1).any() and gbuck.max() >= 1
    k2 = flat.decode_flat(
        *(torch.from_numpy(a) for a in (srcs, idx.view(np.int16), tmeta, declens)), d_pad, 1
    ).numpy()
    for variant in (3, 4):
        got = _port(srcs, idx, tmeta, gbuck, declens, d_pad, variant)
        np.testing.assert_array_equal(got, k2)
    for i, d in enumerate(datas):
        assert k2[i, : len(d)].tobytes() == d and not k2[i, len(d):].any()


def test_wrapper_checks_its_inputs():
    srcs = torch.zeros((1, 128), dtype=torch.uint8)
    idx = torch.zeros((1, 16384), dtype=torch.int16)
    meta = torch.zeros((1, 16, 2), dtype=torch.int32)
    gb = torch.zeros((1, 1), dtype=torch.int32)
    dl = torch.full((1,), 16384, dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        flat.decode_flat_grouped(srcs, idx, meta, gb, dl, 16384, 2)
    with pytest.raises(TypeError):
        flat.decode_flat_grouped(srcs, idx, meta, gb.to(torch.int64), dl, 16384, 3)
    with pytest.raises(ValueError):
        flat.decode_flat_grouped(srcs[:, :100], idx, meta, gb, dl, 16384, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        flat.decode_flat_grouped(*(t.to("meta") for t in (srcs, idx, meta, gb, dl)), 16384, 4)
    with pytest.raises(ValueError):
        flat.group_buckets(meta, dl, 8192)
    # Every index 0 reads the source's first byte (0) up to declen.
    assert not flat.decode_flat_grouped(srcs, idx, meta, gb, dl, 16384, 4).any()
