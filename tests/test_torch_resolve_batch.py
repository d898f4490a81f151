"""``decode_resolve_batch`` of the port equals the JAX package's: the bytes
of every row it does not flag, and the fallback flag of every row, each
setting against its twin. With ``use_fused=False`` (``records_to_pointers``
and K9's plain version) against ``decode_resolve_batch(use_pallas=False)``
(XLA, with the JAX flat gather in interpret mode) on the JAX package's
resolve cases, its oversized body and two rows the scan cut short; with
``use_fused=True`` (K8's plain version) against the fused Pallas kernel in
interpret mode on three small rows. Every comparison is exact."""

import numpy as np
import torch

from snappy_tpu.ops import resolve as jres
from snappy_tpu_torch.ops import resolve
from torch_vectors import (
    hold_jax_native, jax_call_outputs, raw_body, resolve_cases, scan_batch,
    share_cores_with_workers,
)

share_cores_with_workers()
hold_jax_native()

#: A row with no record (a truncated copy; the scan's ``nops`` is 0) and a
#: row whose one literal is followed by a copy past its end.
CUT_ROWS = [(b"\x61", 3), (b"\x00a\x1d\x01", 5)]


def _compare(rows, d_pad, use_fused):
    srcs, lens, declens, recs, nops, errs = scan_batch(rows)
    want_out, want_fb = jax_call_outputs(
        jres.decode_resolve_batch, srcs, recs, nops, declens.astype(np.int64), d_pad,
        interpret=True, use_pallas=use_fused, use_fused=use_fused,
    )
    t = [torch.from_numpy(x) for x in (srcs, recs, nops.astype(np.int32), declens)]
    out, fb = resolve.decode_resolve_batch(*t, d_pad, use_fused=use_fused)
    assert out.dtype == torch.uint8 and fb.dtype == torch.int32
    np.testing.assert_array_equal(fb.numpy(), want_fb)
    keep = fb.numpy() == 0
    np.testing.assert_array_equal(out.numpy()[keep], want_out[keep])
    return out.numpy(), fb.numpy(), errs


def test_scatter_route_matches_jax_xla():
    rng = np.random.default_rng(5)
    oversized = rng.integers(0, 256, 65536, dtype=np.uint8).tobytes()
    cases = resolve_cases() + [oversized]
    rows = [raw_body(c) for c in cases] + CUT_ROWS
    out, fb, errs = _compare(rows, 1 << 16, use_fused=False)
    n = len(cases)
    assert fb.tolist() == [0] * (n - 1) + [1, 1, 0]  # the oversized body and the empty row
    for i, c in enumerate(cases[:-1]):
        assert out[i, : len(c)].tobytes() == c and not out[i, len(c):].any()
    assert out[-1, :5].tolist() == [97, 29, 1, 0, 0] and errs[-1]


def test_fused_route_matches_pallas_interpret():
    rows = CUT_ROWS + [raw_body(resolve_cases()[5])]
    out, fb, _ = _compare(rows, 1 << 14, use_fused=True)
    assert fb.tolist() == [1, 0, 0]
    assert out[1, :5].tolist() == [97, 29, 1, 0, 0]
    assert out[2, :777].tobytes() == resolve_cases()[5]
