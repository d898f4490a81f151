"""Each stage of the port's flat encoder equals the JAX package's, exactly.

The same numpy blocks go through ``snappy_tpu.ops.encode_flat`` (its
Pallas kernels in interpret mode) and ``snappy_tpu_torch.ops`` (the
kernels' plain versions, on CPU tensors): the prepass, K4 against
``parse_blocks_pallas``, the record fields, the header plane, the
breakpoint plan, K5 against ``fused_emit_pallas`` and the reference
emission, and K6 against ``shift_idx_pallas`` and ``records_to_bytes_fast``.
Every output is an integer: tolerance 0. Batches are 4 blocks each, so the
JAX side compiles each function once per file.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import load_corpus
from snappy_tpu.ops import encode_flat as jef
from snappy_tpu.ops.pallas import encode_flat as jpef
from snappy_tpu_torch.ops import emit, encode_flat as ef, parse
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()
_rng = np.random.default_rng(11)
BATCHES = {
    "corpus": lambda: [
        load_corpus("alice29.txt")[:65536], load_corpus("fireworks.jpeg")[:65536],
        load_corpus("geo.protodata")[:65536], b"",  # a zero-length padding row
    ],
    "mixed": lambda: [
        (b"the quick brown fox jumps over the lazy dog. " * 200)[:8192],
        bytes(_rng.integers(0, 256, 4096, dtype=np.uint8)),  # incompressible
        b"ab" * 4096,  # overlap-heavy
        bytes(_rng.integers(0, 4, 6000, dtype=np.uint8)),  # low entropy
    ],
    "edges": lambda: [
        b"z" * 65536,  # a long run: copy splitting at every segment
        b"\x07", bytes(range(10)), b"\x03" * 15,  # below MIN_NON_LITERAL_BLOCK_SIZE
    ],
}


def _blocks(datas):
    blocks = np.zeros((len(datas), 65536), np.uint8)
    lens = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        blocks[i, : len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return blocks, lens


@jax.jit
def _jax_plan(lens, rec0, rec1, cnt):
    f = jef._record_fields(lens, rec0, rec1, cnt)
    plane = jef._hdr_plane(f)
    return {k: v for k, v in f.items() if k != "nr"}, plane, jef._breakpoints(f)


@pytest.fixture(scope="module", params=sorted(BATCHES))
def case(request):
    """One batch through the JAX package, stage by stage."""
    blocks, lens = _blocks(BATCHES[request.param]())
    jb, jl = jnp.asarray(blocks), jnp.asarray(lens)
    jw, u32seg, planes = jax.jit(jef.prepass)(jb, jl)
    rec = jpef._parse_blocks_pallas(jl, jw, u32seg, planes, True)
    fields, plane, bps = _jax_plan(jl, *rec)
    fplan = jax.jit(lambda *a: jef._fused_plan(*a)[:10])(jb, jl, *rec)
    lo_row, base, rows_g, hb8, cb8, cbk, out_len, bp_rows, dlt_rows, stack = fplan
    fused = jpef.fused_emit_pallas(
        lo_row, base, rows_g, hb8, cb8, cbk, out_len, bp_rows, dlt_rows, stack,
        hdr_w=256, interpret=True,
    )
    idx = jpef.shift_idx_pallas(lo_row, base, rows_g, out_len, bp_rows, dlt_rows, interpret=True)
    fast = jef.records_to_bytes_fast(jb, jl, *rec, interpret=True)
    ref = jax.jit(jef.records_to_bytes)(jb, jl, *rec)
    host = lambda t: jax.tree.map(np.array, t)  # noqa: E731  (writable copies)
    return dict(
        name=request.param, blocks=torch.from_numpy(blocks), lens=torch.from_numpy(lens),
        jw=host(jw), u32seg=host(u32seg), rec=host(rec), fields=host(fields),
        plane=host(plane), bps=host(bps), fplan=host(fplan), fused=host(fused),
        idx=host(idx), fast=host(fast), ref=host(ref),
    )


def _rec(case):
    return tuple(torch.from_numpy(x) for x in case["rec"])


def test_prepass_matches(case):
    jw, u32seg = ef.prepass(case["blocks"], case["lens"])
    assert jw.dtype == u32seg.dtype == torch.int32
    np.testing.assert_array_equal(jw.numpy(), case["jw"])
    np.testing.assert_array_equal(u32seg.numpy(), case["u32seg"])


def test_parse_plain_matches_pallas(case):
    jw = torch.from_numpy(case["jw"])
    got = parse.parse_blocks(case["lens"], jw, case["blocks"])
    for g, w in zip(got, case["rec"]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    assert not got[2][..., 1].any()
    if case["name"] == "corpus":
        assert int(got[2][..., 0].max()) > 50  # the walks found real copies


def test_record_fields_plane_and_breakpoints_match(case):
    f = ef._record_fields(case["lens"], *_rec(case))
    plane = ef._hdr_plane(f)  # adds the rank-space fields
    # The JAX dict also holds clamped counts for its rank-permutation
    # tooling, which the port does not carry.
    assert set(case["fields"]) - set(f) == {"cnt"}
    for k in set(f) - {"nr"}:
        np.testing.assert_array_equal(f[k].numpy(), case["fields"][k], err_msg=k)
    assert plane.dtype == torch.uint8 and plane.shape == case["plane"].shape
    np.testing.assert_array_equal(plane.numpy(), case["plane"].astype(np.float32).astype(np.uint8))
    bp, dlt, lo_row, base, rows_g, ovf = ef._breakpoints(f)
    jbp, jdlt, jlo, jbase, jrows, jovf = case["bps"]
    np.testing.assert_array_equal(bp.numpy(), jbp)
    np.testing.assert_array_equal(dlt.numpy(), jdlt)
    np.testing.assert_array_equal(ovf.numpy(), jovf)
    # Groups past OUT_W hold no output byte. There the JAX count of
    # breakpoints below a group's bound also counts the sentinels it pads
    # its chunked count with, which depend on its batch size.
    real = slice(0, ef.N_GROUPS_REAL)
    np.testing.assert_array_equal(lo_row[:, real].numpy(), jlo[:, real])
    np.testing.assert_array_equal(base[:, real].numpy(), jbase[:, real])
    np.testing.assert_array_equal(rows_g[:, real].numpy(), jrows[:, real])


def _plan(case):
    return ef._fused_plan(case["blocks"], case["lens"], *_rec(case))


def test_fused_plan_keeps_the_jax_fields(case):
    lo_row, base, rows_g, out_len, bp_rows, dlt_rows, src, ovf = _plan(case)
    jlo, jbase, jrows, _, _, _, jolen, jbp, jdlt, jstack = case["fplan"]
    real = slice(0, ef.N_GROUPS_REAL)
    np.testing.assert_array_equal(lo_row[:, real].numpy(), jlo[:, real])
    np.testing.assert_array_equal(base[:, real].numpy(), jbase[:, real])
    np.testing.assert_array_equal(rows_g[:, real].numpy(), jrows[:, real])
    np.testing.assert_array_equal(out_len.numpy(), jolen)
    np.testing.assert_array_equal(bp_rows.numpy(), jbp)
    np.testing.assert_array_equal(dlt_rows.numpy(), jdlt)
    stack = jstack.astype(np.float32).astype(np.uint8).reshape(src.shape)
    np.testing.assert_array_equal(src.numpy(), stack)


def test_fused_emit_plain_matches_pallas_and_reference(case):
    lo_row, base, rows_g, out_len, bp_rows, dlt_rows, src, _ = _plan(case)
    out = emit.fused_emit(lo_row, base, rows_g, out_len, bp_rows, dlt_rows, src)
    assert out.dtype == torch.uint8 and out.shape == (4, emit.N_GROUPS * emit.GROUP)
    np.testing.assert_array_equal(out.numpy(), case["fused"])
    ref_out, ref_len = case["ref"]
    np.testing.assert_array_equal(out[:, : ef.OUT_W].numpy(), ref_out)
    np.testing.assert_array_equal(out_len.numpy(), ref_len)
    assert not out[:, ef.OUT_W :].any()


def test_records_to_bytes_matches_reference_emission(case):
    out, out_len = ef.records_to_bytes(case["blocks"], case["lens"], *_rec(case))
    np.testing.assert_array_equal(out.numpy(), case["ref"][0])
    np.testing.assert_array_equal(out_len.numpy(), case["ref"][1])


def test_split_emission_matches_pallas(case):
    lo_row, base, rows_g, out_len, bp_rows, dlt_rows, src, _ = _plan(case)
    idx = emit.shift_idx(lo_row, base, rows_g, out_len, bp_rows, dlt_rows)
    assert idx.dtype == torch.int32
    # The Pallas kernel writes only the groups below out_len; the port
    # writes 0 in the rest.
    live = -(-out_len.numpy() // emit.GROUP)
    want = case["idx"].reshape(4, -1)
    for i, ng in enumerate(live):
        np.testing.assert_array_equal(idx[i, : ng * emit.GROUP].numpy(), want[i, : ng * emit.GROUP])
        assert not idx[i, ng * emit.GROUP :].any()
    out = emit.emit_bytes(src, idx, out_len)
    np.testing.assert_array_equal(out.numpy(), case["fused"])
    fast = ef.records_to_bytes_fast(case["blocks"], case["lens"], *_rec(case))
    for g, w in zip(fast, case["fast"]):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("out_len", emit.EDGE_LENS)
def test_emit_bytes_on_edge_rows_equals_numpy(out_len):
    """The card tests' edge rows (``emit.edge_batch``) on the CPU: each byte
    below ``out_len`` is its source byte, or 0 where the index leaves the
    row (-1, ``src_w``, and the random ones outside); 0 from ``out_len``."""
    src, idx, olen = emit.edge_batch([out_len, 81920 - out_len], "cpu")
    s, ix = src.numpy(), idx.numpy().astype(np.int64)
    assert (ix[:, :3] == [-1, s.shape[1], s.shape[1] - 1]).all()
    ok = (ix >= 0) & (ix < s.shape[1]) & (np.arange(ix.shape[1]) < olen.numpy()[:, None])
    want = np.where(ok, np.take_along_axis(s, np.clip(ix, 0, s.shape[1] - 1), 1), 0)
    np.testing.assert_array_equal(emit.emit_bytes(src, idx, olen).numpy(), want)


def test_plain_windowed_sum_needs_no_sorted_window():
    """The plain step sum is literal: unsorted breakpoints give what the
    windowed sum gives, not what a prefix search would."""
    rows = torch.zeros((1, 2, emit.LANES), dtype=torch.int32)
    bp = torch.full_like(rows, 10**6)
    dl = torch.zeros_like(rows)
    bp[0, 0, :2] = torch.tensor([5, 3])  # out of order
    dl[0, 0, :2] = torch.tensor([100, 7])
    z = torch.zeros((1, emit.N_GROUPS), dtype=torch.int32)
    idx = emit.shift_idx(z, z, z + 1, torch.tensor([8], dtype=torch.int32), bp, dl)
    assert idx[0, :8].tolist() == [0, 1, 2, 10, 11, 112, 113, 114]


def test_wrappers_check_their_inputs():
    z = torch.zeros((1, emit.N_GROUPS), dtype=torch.int32)
    rows = torch.zeros((1, 1, emit.LANES), dtype=torch.int32)
    olen = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        emit.shift_idx(z.to(torch.int64), z, z, olen, rows, rows)
    with pytest.raises(ValueError):
        emit.emit_bytes(torch.zeros((2, 8), dtype=torch.uint8), z, olen)
    with pytest.raises(ValueError, match="unsupported device"):
        emit.shift_idx(*(t.to("meta") for t in (z, z, z, olen, rows, rows)))
    with pytest.raises(ValueError):
        parse.parse_blocks(olen, torch.zeros((1, 128, 511), dtype=torch.int32),
                           torch.zeros((1, 65536), dtype=torch.uint8))
