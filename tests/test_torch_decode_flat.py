"""K2's plain version equals the JAX package's flat-gather Pallas kernels
(interpret mode): ``layout=0`` against ``decode_flat_pallas``, ``layout=1``
against ``decode_flat_pallas_v2``, on indices from the host flatten.
Output bytes are integers, so the comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_corpus
from snappy_tpu.format import reference as jref
from snappy_tpu.format.varint import read_varu64
from snappy_tpu.ops.pallas.decode import decode_flat_pallas, decode_flat_pallas_v2
from snappy_tpu_torch import native
from snappy_tpu_torch.ops import decode_flat as flat
from snappy_tpu_torch.ops import packing
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

def _group(datas, d_pad, layout):
    bodies = []
    for d in datas:
        c = jref.compress(d)
        bodies.append(c[read_varu64(c)[1]:])
    srcs, lens = packing.batch_streams(bodies)
    declens = np.asarray([len(d) for d in datas], np.int32)
    idx, tmeta, fallb, errs, _ = native.flatten_idx_batch(
        srcs, lens.astype(np.uint64), declens.astype(np.uint64), d_pad, layout=layout
    )
    assert not fallb.any() and not errs.any()
    return srcs, idx, tmeta, declens


def _port(srcs, idx, tmeta, declens, d_pad, layout):
    out = flat.decode_flat(
        torch.from_numpy(srcs), torch.from_numpy(idx.view(np.int16)),
        torch.from_numpy(tmeta), torch.from_numpy(declens), d_pad, layout,
    )
    assert out.dtype == torch.uint8 and out.shape == (srcs.shape[0], d_pad)
    return out.numpy()


CASES = {
    # two rows of at most 16 KiB each: text, and an overlap-heavy short row
    "text": lambda n: [load_corpus("html")[:n], (b"ab" * n)[: n // 3]],
    "binary": lambda n: [load_corpus("fireworks.jpeg")[:n], load_corpus("kppkn.gtb")[:n - 77]],
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("layout", [0, 1])
def test_plain_gather_matches_pallas_interpret(case, layout):
    d_pad = 16384 if layout else 9216
    datas = CASES[case](d_pad if layout else d_pad - 300)
    args = _group(datas, d_pad, layout)
    fn = decode_flat_pallas_v2 if layout else decode_flat_pallas
    want = np.asarray(fn(*(jnp.asarray(a) for a in args), d_pad, interpret=True))
    got = _port(*args, d_pad, layout)
    np.testing.assert_array_equal(got, want)
    for i, d in enumerate(datas):
        assert got[i, : len(d)].tobytes() == d
        assert not got[i, len(d):].any()


def test_layouts_are_one_permutation():
    """The flatten's layout-1 indices are its layout-0 indices at
    ``phys_index``, and both layouts decode to the same bytes."""
    datas = [load_corpus("lcet10.txt")[:40000], load_corpus("urls.10K")[:32768]]
    d_pad = 49152
    a0 = _group(datas, d_pad, 0)
    a1 = _group(datas, d_pad, 1)
    d = np.arange(d_pad)
    np.testing.assert_array_equal(a1[1][:, flat.phys_index(d, 1)], a0[1])
    np.testing.assert_array_equal(_port(*a0, d_pad, 0), _port(*a1, d_pad, 1))


def test_wrapper_checks_its_inputs():
    srcs = torch.zeros((1, 128), dtype=torch.uint8)
    idx = torch.zeros((1, 1024), dtype=torch.int16)
    meta = torch.zeros((1, 1, 2), dtype=torch.int32)
    dl = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        flat.decode_flat(srcs, idx, meta, dl, 1024, 1)  # layout 1 needs 16 KiB groups
    with pytest.raises(TypeError):
        flat.decode_flat(srcs, idx.to(torch.int32), meta, dl, 1024, 0)
    assert not flat.decode_flat(srcs, idx, meta, dl, 1024, 0).any()
