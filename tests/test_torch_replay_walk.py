"""K3's and K9's algorithms as their kernels now run them, on the CPU.

K3: ``replay.replay_windows`` follows the replay kernel's CTA path step by
step (a window of source positions at a time from the last op start, op
starts as the orbit of the window's first position by doubling jumps,
output starts by a prefix sum, the first bad op, the valid ops as K10's
records) and must equal its plain version (``decode_replay_plain``: bytes
and codes), the JAX package's intermediate planes (``_discover_ops``: the
op starts and their output starts; ``_first_error``: the code and the first
bad op), and ``decode_batch_pallas`` in interpret mode on two small rows.
Rows: the corrupt vectors, overlapping copies, corpus chunks, random op
streams, and the window edges (a header across a window's end, a literal
longer than several windows, an offset-1 run across windows, ``n = 0``,
``declen`` 65536), at the kernel's window of 4,096 positions and at
narrower ones that put more ops on the edges.

K9: ``resolve.resolve_windows`` follows the plane resolution kernel (K8's
windows over a first-hop plane) and must equal ``resolve_reference`` on
planes with pointers below 0, self pointers, deep chains and chains that
leave their window, and leave a row with a pointer past its own position
flagged. Every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_corpus
from snappy_tpu.ops import decode as jdec
from snappy_tpu.ops.pallas.decode import decode_batch_pallas
from snappy_tpu_torch.ops import packing, replay, resolve
from torch_vectors import (
    CORRUPT, copy1, edge_rows, hold_jax_native, k9_planes, overlap_rows, random_ops, raw_body,
    scan_batch, share_cores_with_workers,
)

share_cores_with_workers()
hold_jax_native()


def corpus_rows() -> list[tuple[bytes, int]]:
    return [raw_body(load_corpus(n)[i : i + 65536])
            for n, i in (("html", 0), ("kppkn.gtb", 4096), ("fireworks.jpeg", 0),
                         ("paper-100k.pdf", 20000))]


ROWS = {
    "corrupt": lambda: list(CORRUPT),
    "overlaps": lambda: overlap_rows((1, 3, 31, 32, 33, 127, 128, 129, 255), copies=20),
    "corpus": corpus_rows,
    "random_ops": lambda: [random_ops(s, n) for s, n in ((1, 30000), (2, 65536), (3, 777))],
    "edges": edge_rows,
}


def _batch(rows):
    srcs, lens = packing.batch_streams([r[0] for r in rows], None)
    declens = np.asarray([r[1] for r in rows], np.int32)
    return srcs, lens, declens


def _jax_planes(src: np.ndarray, n: int, declen: int):
    """The JAX package's op starts, output starts, code and first bad op."""
    s = jnp.asarray(src)
    fields = jdec._parse_positions(s, jnp.int32(n))
    op_mask, dst_start, total = jdec._discover_ops(fields["consumed"], fields["produced"], jnp.int32(n))
    err, first = jdec._first_error(op_mask, dst_start, jnp.int32(declen), total, fields)
    return np.asarray(op_mask), np.asarray(dst_start), int(err), int(first)


@pytest.mark.parametrize("window", [4096, 64])
@pytest.mark.parametrize("name", sorted(ROWS))
def test_k3_model_matches_plain_and_jax_planes(name, window):
    rows = ROWS[name]()
    srcs, lens, declens = _batch(rows)
    d_pad = 65536
    args = (torch.from_numpy(srcs), torch.from_numpy(lens), torch.from_numpy(declens))
    dst, errs, detail = replay.replay_windows(*args, d_pad, window=window)
    want_dst, want_errs = replay.decode_replay_plain(*args, d_pad)
    assert torch.equal(errs, want_errs) and torch.equal(dst, want_dst)
    for r, (n, dl) in enumerate(zip(lens.tolist(), declens.tolist())):
        mask, start, err, first = _jax_planes(srcs[r], n, dl)
        assert err == int(errs[r])
        got_first = int(detail["first"][r])
        assert got_first == first, (r, got_first, first)
        upto = np.arange(srcs.shape[1]) <= first  # the kernel stops at the first bad op
        got_mask = detail["op_mask"][r].numpy()
        np.testing.assert_array_equal(got_mask, mask & upto)
        np.testing.assert_array_equal(detail["dst_start"][r].numpy()[got_mask], start[got_mask])
    if name == "corrupt":
        assert (errs > 0).all()
    elif name != "edges":
        assert not errs.any()
    if name == "edges" and window == 4096:
        # the straddle, the long literal and the run take several windows
        assert detail["windows"][:3].tolist() == [2, 2, 3]
        assert errs.tolist()[3:] == [0, 5, 0, 0, 3]


def test_k3_model_matches_pallas_interpret():
    """Two small rows through ``decode_batch_pallas`` (interpret mode): a
    text chunk and a run, at a window of 32 positions."""
    rows = [raw_body(load_corpus("alice29.txt")[:1500]),
            (bytes([0]) + b"a" + copy1(1, 11) * 60 + b"\x00a\x1d\x01", 1 + 660 + 5)]
    srcs, lens, declens = _batch(rows)
    srcs = np.pad(srcs, ((0, 0), (0, -srcs.shape[1] % 128)))
    d_pad = 2048
    want_dst, want_err = decode_batch_pallas(
        jnp.asarray(srcs), jnp.asarray(lens), jnp.asarray(declens), d_pad, interpret=True)
    dst, errs, _ = replay.replay_windows(
        torch.from_numpy(srcs), torch.from_numpy(lens), torch.from_numpy(declens), d_pad, window=32)
    np.testing.assert_array_equal(errs.numpy(), np.asarray(want_err))
    np.testing.assert_array_equal(dst.numpy(), np.asarray(want_dst))
    assert errs.tolist() == [0, 4]


@pytest.mark.parametrize("d_pad", [8192, 20480])
def test_k9_model_matches_reference(d_pad):
    a0 = k9_planes(d_pad, d_pad)
    got, rounds = resolve.resolve_windows(a0)
    want = resolve.resolve_reference(a0)
    assert got.dtype == torch.int32 and rounds.shape == (7, -(-d_pad // 4096))
    assert torch.equal(got, want)
    flagged = (want < resolve.FLAG).any(dim=1).tolist()
    assert flagged == [False, False, False, True, True, True, False]
    assert int(rounds[1].max()) == 12 and int(rounds[6].max()) == 12
    # A pointer past its own position is never chased: its row stays flagged
    # (the plain version chases it).
    fwd = a0.clone()
    fwd[0, 10] = 5000
    got_f, _ = resolve.resolve_windows(fwd)
    assert bool((got_f[0] < resolve.FLAG).any()) and int(got_f[0, 10]) == 5000
    assert torch.equal(got_f[1:], want[1:])


def test_k9_model_on_the_route_plane():
    """The plane ``records_to_pointers`` makes from corpus rows resolves
    completely, as the plain version does."""
    rows = corpus_rows()[:2] + [raw_body(b"a" * 20000)]
    _, _, declens, recs, nops, _ = scan_batch(rows, 8192)
    a0 = resolve.records_to_pointers(
        torch.from_numpy(np.ascontiguousarray(recs)), torch.from_numpy(nops.astype(np.int32)),
        torch.from_numpy(declens), 65536)
    got, _ = resolve.resolve_windows(a0)
    assert torch.equal(got, resolve.resolve_reference(a0))
    assert bool((got >= resolve.FLAG).all())
