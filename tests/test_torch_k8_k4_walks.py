"""K8's and K4's algorithms as their kernels now run them, on the CPU.

K8: ``resolve.resolve_fh_windows`` follows the fused resolve kernel step
by step (start bits, first hops in a uint16 plane, pointer doubling window
by window, each origin's value) and must equal its plain version
(``resolve_fh_plain``) and the JAX package's ``resolve_fh_pallas``
(interpret mode, ``d_pad`` 16384) on deep chains, overlapping copies of
offsets 1-129 and rows the scan cut short; and the route must give the
host codec's bytes for a 64 KiB run. K4: the plain version against
``parse_blocks_pallas`` (interpret mode) on ragged batches, and
``parse_lockstep``'s per-segment step counts against a serial walk. Every
comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_corpus
from snappy_tpu.ops import encode_flat as jef
from snappy_tpu.ops import resolve as jres
from snappy_tpu.ops.pallas import encode_flat as jpef
from snappy_tpu.ops.pallas.resolve import resolve_fh_pallas
from snappy_tpu_torch.ops import encode_flat as ef
from snappy_tpu_torch.ops import parse, resolve
from torch_vectors import (
    hold_jax_native, overlap_rows, raw_body, scan_batch, share_cores_with_workers,
)

share_cores_with_workers()
hold_jax_native()

D_PAD = 16384

K8_ROWS = {
    # a run (every copy reads the last byte of the copy before: chains of
    # about 64 hops across tiles and windows), a period of 7, and a corpus
    # block's deepest chains
    "deep_chains": lambda: [raw_body(b"a" * 4096), raw_body(bytes(range(7)) * 2000),
                            raw_body(load_corpus("kppkn.gtb")[:D_PAD])],
    "overlaps": lambda: overlap_rows(tuple(range(1, 130, 8)) + (128, 129), copies=3),
    # no record at all; one literal and a cut copy; a whole row; a literal
    # cut short
    "cut_rows": lambda: [(b"\x61", 3), (b"\x00a\x1d\x01", 5), raw_body(b"xyz" * 300),
                         (b"\x00a", 4)],
}


def _k8_inputs(rows, d_pad=D_PAD):
    srcs, _, declens, recs, nops, _ = scan_batch(rows, 4096)
    r_t, n_t, d_t = (torch.from_numpy(np.ascontiguousarray(x))
                     for x in (recs, nops.astype(np.int32), declens))
    return srcs, r_t, n_t, d_t


@pytest.mark.parametrize("name", sorted(K8_ROWS))
def test_k8_model_matches_plain_and_pallas(name):
    """Whole planes against the plain version; against the Pallas kernel,
    the same rows flagged and the same values on every row it resolves."""
    _, r_t, n_t, d_t = _k8_inputs(K8_ROWS[name]())
    startsx, payload = resolve.records_to_kernel_inputs(r_t, n_t, d_t, D_PAD)
    got, rounds = resolve.resolve_fh_windows(startsx, payload, d_t, D_PAD)
    plain = resolve.resolve_fh_plain(startsx, payload, d_t, D_PAD)
    assert got.dtype == torch.int32 and rounds.shape == (len(d_t), D_PAD // 4096)
    assert torch.equal(got, plain)
    jargs = (jnp.asarray(r_t.numpy()), jnp.asarray(n_t.numpy()), jnp.asarray(d_t.numpy().astype(np.int64)))
    want = np.asarray(resolve_fh_pallas(
        *jres.records_to_kernel_inputs(*jargs, D_PAD), jargs[2], D_PAD, interpret=True))
    flagged = (got.numpy() < resolve.FLAG).any(axis=1)
    np.testing.assert_array_equal(flagged, (want < resolve.FLAG).any(axis=1))
    np.testing.assert_array_equal(got.numpy()[~flagged], want[~flagged])
    if name == "cut_rows":
        assert flagged.tolist() == [True, False, False, False]
        assert (got[0, :3] == -1).all() and (got[0, 3:] == resolve.FLAG).all()
    else:
        assert not flagged.any()
    if name == "deep_chains":
        assert int(rounds[0].sum()) >= 5  # the run's chains took doubling rounds


@pytest.mark.parametrize("window", [512, 1024, 4096])
def test_k8_model_is_the_same_for_any_window(window):
    """The windows only order the work: every window size gives the plain
    version's plane, and a smaller window leaves fewer rounds to each."""
    rows = K8_ROWS["deep_chains"]() + K8_ROWS["cut_rows"]()
    _, r_t, n_t, d_t = _k8_inputs(rows)
    startsx, payload = resolve.records_to_kernel_inputs(r_t, n_t, d_t, D_PAD)
    got, rounds = resolve.resolve_fh_windows(startsx, payload, d_t, D_PAD, window)
    assert torch.equal(got, resolve.resolve_fh_plain(startsx, payload, d_t, D_PAD))
    assert rounds.shape[1] == D_PAD // window and int(rounds.max()) <= (window - 1).bit_length()


def test_k8_model_and_route_on_a_64_kib_run():
    """``b"a" * 65536`` at ``d_pad`` 65536 (no interpret mode): the model,
    the plain version and the route's bytes, against the host codec."""
    data = b"a" * 65536
    srcs, r_t, n_t, d_t = _k8_inputs([raw_body(data)], 65536)
    startsx, payload = resolve.records_to_kernel_inputs(r_t, n_t, d_t, 65536)
    got, rounds = resolve.resolve_fh_windows(startsx, payload, d_t, 65536)
    assert torch.equal(got, resolve.resolve_fh_plain(startsx, payload, d_t, 65536))
    # every byte reads the one literal byte, after its tag byte
    assert (got == resolve.FLAG + 1).all() and rounds.shape == (1, 16)
    out, fallback = resolve.decode_resolve_batch(torch.from_numpy(srcs), r_t, n_t, d_t, 65536)
    assert fallback.tolist() == [0] and out[0].numpy().tobytes() == data


K4_BATCHES = {
    # a padding row between live rows, a block shorter than one segment, a
    # length that is not a multiple of 512
    "ragged": lambda: [load_corpus("alice29.txt")[:5000], b"", b"abcabcabd" * 33,
                       load_corpus("html")[:9999]],
    "short": lambda: [b"", (b"0123456789" * 60)[:511], b"", load_corpus("geo.protodata")[:1537]],
}


def _blocks(datas):
    blocks = np.zeros((len(datas), 65536), np.uint8)
    lens = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        blocks[i, : len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return blocks, lens


@pytest.mark.parametrize("name", sorted(K4_BATCHES))
def test_k4_plain_matches_pallas_on_ragged_batches(name):
    blocks, lens = _blocks(K4_BATCHES[name]())
    jb, jl = jnp.asarray(blocks), jnp.asarray(lens)
    jw, u32seg, planes = jax.jit(jef.prepass)(jb, jl)
    want = jpef._parse_blocks_pallas(jl, jw, u32seg, planes, True)
    tb, tl = torch.from_numpy(blocks), torch.from_numpy(lens)
    tjw, _ = ef.prepass(tb, tl)
    np.testing.assert_array_equal(tjw.numpy(), np.asarray(jw))
    got = parse.parse_blocks(tl, tjw, tb)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for i in np.flatnonzero(lens == 0):  # padding rows: all zero
        assert not any(g[i].any() for g in got)
    assert int(got[2][..., 0].sum()) > 0  # the walks found copies


def _serial_steps(jw_seg, block, n, lo):
    """One segment's walk, one step at a time, as ``csrc/parse.cu`` takes it;
    returns its steps and records."""
    hi = min(lo + parse.SEG, n)
    wide = np.concatenate([block.astype(np.int64), np.zeros(4, np.int64)])

    def u32(pos):
        return int(wide[pos] | wide[pos + 1] << 8 | wide[pos + 2] << 16 | wide[pos + 3] << 24)

    def tz(x):
        return 4 if x == 0 else ((x & -x).bit_length() - 1) >> 3

    p, lp, offc, k, ext, steps = lo, 0, 1, 0, False, 0
    while p < hi:
        steps += 1
        if not ext:
            w = int(jw_seg[min(max(p - lo, 0), parse.SEG - 1)])
            if not w & parse.JW_CAND:
                p = lo + (w & 0x3FF)
                continue
            lp, offc = (w >> 16) & 0x3FF, w & 0xFFFF
        a_p = p + lp
        up = u32(lo + min(max(a_p - lo, 0), parse.SEG - 1))
        a = max(a_p - offc, 0)
        uq = u32(min(a >> 7, 511) * 128 + (a & 127))
        adv = min(tz(up ^ uq), max(hi - a_p, 0))
        new_lp = lp + adv
        if adv == 4 and p + new_lp < hi:
            ext, lp = True, new_lp
            continue
        if k < parse.MAX_REC:
            k += 1
            p += new_lp
        else:
            p = hi
        ext, lp = False, 0
    return steps, k


@pytest.mark.parametrize("name", ["alice29.txt", "kppkn.gtb"])
def test_parse_lockstep_counts_each_segments_steps(name):
    data = load_corpus(name)[:65536]
    blocks, lens = _blocks([data, b""])
    tb, tl = torch.from_numpy(blocks), torch.from_numpy(lens)
    jw, _ = ef.prepass(tb, tl)
    rec0, rec1, cnt, lane_steps, seg_steps = parse.parse_lockstep(tl, jw, tb)
    assert seg_steps.shape == (2, parse.NSEG) and seg_steps.dtype == torch.int64
    assert int(seg_steps.sum()) == lane_steps and not seg_steps[1].any()
    serial = [_serial_steps(jw[0, s].numpy(), blocks[0], len(data), s * parse.SEG)
              for s in range(parse.NSEG)]
    assert seg_steps[0].tolist() == [st for st, _ in serial]
    assert cnt[0, :, 0].tolist() == [k for _, k in serial]
    assert int(seg_steps[0].max()) > 50  # a walk of many steps
