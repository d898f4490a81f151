"""K2 over several launch groups in one launch, on the CPU.

``ops/decode_flat.py`` ``decode_flat_groups`` takes a call's launch
groups, each of its own rows and widths, and launches K2 once a layout and
checksum kind (``csrc/flat_gather.cu`` ``stpu_cuda_flat_gather_groups``);
``ops/api.py`` ``decompress_streams`` makes every group the flat route
takes ready first and hands them to it together. The kernel has no CPU
mode. Here: the wrapper's CPU run against the one-group wrappers and the
JAX package's reference decode and masked CRC32C; how it cuts groups into
launches; and ``decompress_streams`` and ``decompress_frame`` with groups
on mixed routes against the JAX package, one launch a call or, past the
card bytes one group could hold, more.
"""

import numpy as np
import pytest
import torch

from conftest import load_corpus
from snappy_tpu.format import reference as jref
from snappy_tpu.format.crc32c import crc32c_masked as jcrc32c_masked
from snappy_tpu.format.varint import write_varu64
from snappy_tpu.ops import api as japi
from snappy_tpu_torch import native
from snappy_tpu_torch.config import configure
from snappy_tpu_torch.ops import api, decode_flat, packing, reset_launch_counts
from torch_vectors import (
    CORRUPT, fallback_row, flat_crc_rows, hold_jax_native, raw_body, share_cores_with_workers,
    wide_stream,
)

share_cores_with_workers()
hold_jax_native()


def _group(rows, d_pad, layout):
    """One launch group as ``decode_flat_groups`` takes it, from the host
    flatten: ``(srcs, idx, tile_meta, declens, d_pad, layout)``."""
    srcs, lens = packing.batch_streams([b for b, _ in rows], None)
    declens = np.asarray([n for _, n in rows], np.int32)
    idx, tmeta, fallb, errs, _ = native.flatten_idx_batch(
        srcs, lens.astype(np.uint64), declens.astype(np.uint64), d_pad, layout=layout)
    assert not fallb.any() and not errs.any()
    return (*(torch.from_numpy(x) for x in (srcs, idx.view(np.int16), tmeta, declens)),
            d_pad, layout)


#: ``(layout, d_pad)`` of the mixed groups: rows of one unit under 16 KiB,
#: partial and whole units, eight units (the checksum's widest) and nine
#: (K2 then K1).
MIXED = [(0, 1024), (0, 20480), (1, 16384), (1, 65536), (1, 131072), (1, 147456)]


def mixed_groups():
    """Groups of mixed widths, ``d_pad``s and layouts, each with a row of
    declen 0 (``flat_crc_rows``), and a group of one row."""
    groups = [_group(flat_crc_rows(d_pad), d_pad, layout) for layout, d_pad in MIXED]
    return groups + [_group([raw_body(load_corpus("html")[:5000])], 8192, 0)]


@pytest.mark.parametrize("with_crc", [False, True], ids=["k2", "k2_crc"])
def test_groups_equal_each_groups_own_decode(with_crc):
    groups = mixed_groups()
    got = decode_flat.decode_flat_groups(groups, with_crc)
    assert len(got) == len(groups)
    for (out, crc), g in zip(got, groups):
        if with_crc:
            want_out, want_crc = decode_flat.decode_flat_crc(*g)
            assert torch.equal(crc, want_crc)
        else:
            want_out = decode_flat.decode_flat(*g)
            assert crc is None
        assert torch.equal(out, want_out)


def test_groups_give_the_reference_bytes_and_crcs():
    groups = mixed_groups()
    rows = [flat_crc_rows(d_pad) for _, d_pad in MIXED] + [[raw_body(load_corpus("html")[:5000])]]
    for (out, crc), g, grows in zip(decode_flat.decode_flat_groups(groups, True), groups, rows):
        host = out.numpy()
        assert host.shape == (len(grows), g[4])
        for i, (body, n) in enumerate(grows):
            want = jref.decompress(write_varu64(n) + body)
            assert host[i, :n].tobytes() == want and not host[i, n:].any()
            assert int(crc[i]) == jcrc32c_masked(want)


def test_groups_check_each_group_and_launch_nothing_on_the_cpu():
    """Each group's arguments are checked as ``decode_flat`` checks them;
    no group is no launch; the CPU counts no launch, no group, no unit
    walked and no CTA; ``reset_launch_counts`` zeroes the walk's counts."""
    groups = mixed_groups()
    assert decode_flat.decode_flat_groups([]) == []
    bad = (*groups[2][:4], groups[2][4] + 1024, 1)
    with pytest.raises(ValueError):
        decode_flat.decode_flat_groups([groups[0], bad])
    with pytest.raises(TypeError):
        decode_flat.decode_flat_groups([groups[0], (groups[1][0], groups[1][1].to(torch.int32),
                                                    *groups[1][2:])])
    def counts():
        return (decode_flat.launches, decode_flat.crc_launches, decode_flat.launched_groups,
                decode_flat.launched_units, decode_flat.launched_ctas)

    before = counts()
    decode_flat.decode_flat_groups(groups, True)
    assert counts() == before
    decode_flat.launched_units, decode_flat.launched_ctas = 7, 3
    reset_launch_counts()
    assert counts() == (0, 0, 0, 0, 0)


@pytest.mark.parametrize("rows,crc,want", [
    ([1] * 20, False, [list(range(16)), list(range(16, 20))]),
    ([40000, 30000, 20000], False, [[0, 1, 2]]),
    ([40000, 30000, 20000], True, [[0], [1, 2]]),
    ([65535, 1], True, [[0], [1]]),
], ids=["sixteen-groups", "plain", "state-words", "full-state"])
def test_launch_sets_cut_at_the_table_and_the_state(rows, crc, want):
    """A launch holds at most ``MAX_LAUNCH_GROUPS`` groups and, with the
    checksum, at most a stream's ``STATE_WORDS`` rows; groups keep their
    order."""
    assert decode_flat.MAX_LAUNCH_GROUPS == 16 and decode_flat.STATE_WORDS == 65535
    assert decode_flat._launch_sets(list(range(len(rows))), rows, crc) == want


def _spy(monkeypatch):
    """Record the groups of every ``decode_flat_groups`` call of ``api``."""
    calls = []
    real = api.decode_flat_groups

    def spy(groups, with_crc=False):
        calls.append([(g[0].shape[0], g[0].shape[1], g[4]) for g in groups])
        return real(groups, with_crc)

    monkeypatch.setattr(api, "decode_flat_groups", spy)
    return calls


def _mixed_rows():
    """Raw rows whose groups take every route a call can mix: corpus chunks
    of three width buckets (flat), a row the flatten rejects beside a clean
    one (its group falls to K3), a stream past ``max_dpad`` of 128 KiB (the
    host codec), and the corrupt vectors beside exact neighbours."""
    datas = [load_corpus("html")[:65536], load_corpus("alice29.txt")[:65536],
             load_corpus("fireworks.jpeg")[:30000], load_corpus("urls.10K")[:9000],
             b"xyz" * 3000]
    rows = [raw_body(d) for d in datas] + [fallback_row(), raw_body(b"q" * 70000)]
    return rows + [wide_stream(3)] + CORRUPT


def test_streams_on_mixed_routes_match_the_jax_package(monkeypatch):
    rows = _mixed_rows()
    bodies, declens = [r[0] for r in rows], [r[1] for r in rows]
    calls = _spy(monkeypatch)
    monkeypatch.setattr(api, "routes", [])
    with configure(device="cpu", max_dpad=1 << 17):
        got = api.decompress_streams(bodies, declens, with_crc=True)
    want = japi.decompress_streams(bodies, declens)  # its CRC32C takes rows up to 64 KiB
    np.testing.assert_array_equal(got[1], want[1])
    ok = np.nonzero(want[1] == 0)[0]
    assert list(ok) == list(range(len(rows) - len(CORRUPT)))
    assert [got[0][i] for i in ok] == [want[0][i] for i in ok]
    assert [int(got[2][i]) for i in ok] == [jcrc32c_masked(want[0][i]) for i in ok]
    routes = [r[2] for r in api.routes]
    assert {"flat", "replay", "host"} <= set(routes)
    # One entry a group, in the groups' order; the flat ones in one launch.
    groups = api.launch_groups(bodies, 512)
    assert [r[0] for r in api.routes] == [len(g) for g in groups]
    assert calls == [[(r[0], r[3], r[1]) for r in api.routes if r[2] == "flat"]]


@pytest.mark.parametrize("cfg", [{"max_dpad": 1 << 14}, {"decode_resolve": True}],
                         ids=["host-and-flat", "resolve-and-flat"])
@pytest.mark.parametrize("flip", [None, 0.3, 0.8], ids=["clean", "early", "late"])
def test_frame_on_mixed_routes_matches_the_jax_package(cfg, flip, monkeypatch):
    """A frame whose groups take two routes (the host codec past a 16 KiB
    cap or K8's resolve, and the flat route for the rest), clean and with a
    byte of one chunk's body flipped: the port's bytes or its error, as the
    JAX package and the host codec give them."""
    parts = [load_corpus("html"), load_corpus("fireworks.jpeg")[:40000], b"tail" * 2500,
             load_corpus("kppkn.gtb")[:70000]]
    data = b"".join(parts)
    stream = b"".join(map(native.frame_compress, parts))  # chunks of 8 KiB and 16 KiB too
    if flip is not None:
        at = int(len(stream) * flip)
        stream = stream[:at] + bytes([stream[at] ^ 0x21]) + stream[at + 1:]
    calls = _spy(monkeypatch)
    monkeypatch.setattr(api, "routes", [])

    def outcome(fn):
        try:
            return ("ok", fn(stream))
        except Exception as e:  # the comparison is the test
            return (type(e).__name__, getattr(e, "_values", lambda: None)(), str(e))

    with configure(device="cpu", **cfg):
        got = outcome(api.decompress_frame)
    assert got == outcome(japi.decompress_frame) == outcome(native.frame_decompress)
    assert (got == ("ok", data)) == (flip is None)
    routes = [r[2] for r in api.routes]
    assert len(calls) <= 1 and sum(map(len, calls)) == routes.count("flat")
    if flip is None:
        assert "flat" in routes and len(set(routes)) == 2 and len(calls) == 1


def test_card_bytes_past_one_group_split_the_launch(monkeypatch):
    """The flat route's groups share a launch while their card bytes stay
    within one group of ``decode_rows_per_launch`` rows at ``max_dpad``
    (here 2 rows of 64 KiB): past that, the groups held launch first, so
    the call makes more launches, each within the bound or of one group."""
    datas = [load_corpus(n)[k:k + 65536] for n in ("html_x_4", "plrabn12.txt")
             for k in (0, 65536, 131072)] + [b"ab" * 2000, b"cd" * 3000]
    rows = [raw_body(d) for d in datas]
    bodies, declens = [r[0] for r in rows], [r[1] for r in rows]
    calls = _spy(monkeypatch)
    with configure(device="cpu"):
        assert api.decompress_streams(bodies, declens)[0] == datas
    assert len(calls) == 1 and len(calls[0]) > 1
    calls.clear()
    with configure(device="cpu", decode_rows_per_launch=2, max_dpad=1 << 16):
        outs, errs, _ = api.decompress_streams(bodies, declens)
    assert outs == datas and not errs.any()
    budget = api._card_bytes(2, 1 << 16, 1 << 16)
    assert len(calls) > 1 and sum(map(len, calls)) == len(api.launch_groups(bodies, 2))
    for launch in calls:
        assert len(launch) == 1 or sum(api._card_bytes(*g) for g in launch) <= budget
    assert any(len(launch) > 1 for launch in calls)
