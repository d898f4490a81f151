"""Each CUDA kernel against its plain PyTorch version, on the card.

Run on a machine with an NVIDIA card and ``nvcc``::

    python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips (the kernels have no CPU mode; their
plain versions are held against the JAX package by the other
``test_torch_*`` files). Bytes, codes and CRCs are integers: equality.
"""

import numpy as np
import pytest
import torch

from conftest import load_corpus
from snappy_tpu_torch import native, trace
from snappy_tpu_torch.format import reference as ref
from snappy_tpu_torch.format.varint import read_varu64, write_varu64
from snappy_tpu_torch.ops import (
    _build, api, crc32c, decode, decode_flat, emit, encode, encode_flat, packing, parse, records,
    replay, resolve,
)
from torch_vectors import (
    CORRUPT, FLAT_CRC_SHAPES, collision_rows, copy2, edge_rows, fallback_row, flat_crc_rows,
    k9_planes, literal, overlap_rows, random_ops, raw_body, resolve_cases, scan_batch, wide_stream,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _bodies(datas):
    out = []
    for d in datas:
        c = ref.compress(d)
        out.append(c[read_varu64(c)[1]:])
    return out


CHUNKS = [
    load_corpus("html")[:65536],
    load_corpus("plrabn12.txt")[:65536],
    load_corpus("fireworks.jpeg")[:40000],
    b"ab" * 20000,
    bytes(65536),
    load_corpus("kppkn.gtb")[:61234],
]


def test_crc32c_kernel_matches_plain(dev):
    rng = np.random.default_rng(7)
    b, s = 64, 65536
    rows = torch.from_numpy(rng.integers(0, 256, (b, s), dtype=np.uint8)).to(dev)
    lens_np = rng.integers(0, s + 1, b).astype(np.int32)
    lens_np[:3] = (0, s, 1)
    lens = torch.from_numpy(lens_np).to(dev)
    before = crc32c.launches
    for masked, fn in ((True, crc32c.crc32c_masked_blocks), (False, crc32c.crc32c_blocks)):
        got = fn(rows, lens)
        assert got.device.type == "cuda"
        assert torch.equal(got, crc32c.crc32c_plain(rows, lens, masked))
    assert crc32c.launches == before + 2
    # A width that is not a power of two (rows still 16-byte aligned).
    odd = rows[:, 1:4001].contiguous()
    got = crc32c.crc32c_blocks(odd, lens.clamp(max=4000))
    assert torch.equal(got, crc32c.crc32c_plain(odd, lens.clamp(max=4000), False))


def test_crc32c_kernel_on_the_group_shape(dev):
    """455 rows of 65,536 bytes, the flat route's largest launch group:
    more rows than SMs, so each persistent CTA walks several, fetching the
    next during this one."""
    rng = np.random.default_rng(17)
    b, s = 455, 65536
    rows = torch.from_numpy(rng.integers(0, 256, (b, s), dtype=np.uint8)).to(dev)
    lens_np = np.full(b, s, np.int32)
    lens_np[::7] = rng.integers(0, s + 1, len(lens_np[::7]))
    lens = torch.from_numpy(lens_np).to(dev)
    got = crc32c.crc32c_masked_blocks(rows, lens)
    assert torch.equal(got, crc32c.crc32c_plain(rows, lens, True))
    host = rows.cpu().numpy()
    for i in range(0, b, 50):
        assert int(got[i]) == native.crc32c_masked(host[i, : lens_np[i]].tobytes())


@pytest.mark.parametrize("s", [4001, 131077])
def test_crc32c_kernel_on_unaligned_and_wide_rows(dev, s):
    """Rows 4,001 bytes apart (not 16-byte aligned: the word loads go byte
    by byte) and rows past one 65,536-byte chunk, with lengths 0-17, s - 1
    and s, and dirty bytes past every length; held to the plain version and
    the host codec."""
    rng = np.random.default_rng(19)
    lens_np = np.concatenate([np.arange(18), [s - 1, s], rng.integers(0, s + 1, 12)])
    lens_np = lens_np.astype(np.int32)
    b = len(lens_np)
    rows = torch.from_numpy(rng.integers(0, 256, (b, s), dtype=np.uint8)).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    for masked, fn in ((True, crc32c.crc32c_masked_blocks), (False, crc32c.crc32c_blocks)):
        assert torch.equal(fn(rows, lens), crc32c.crc32c_plain(rows, lens, masked))
    got = crc32c.crc32c_masked_blocks(rows, lens).cpu()
    host = rows.cpu().numpy()
    assert [int(x) for x in got] == [native.crc32c_masked(host[i, :n].tobytes())
                                    for i, n in enumerate(lens_np)]


def test_crc32c_kernel_in_a_cuda_graph(dev):
    """The wrapper reads nothing back, so its launches can be captured in a
    CUDA graph and replayed (as chip_smoke.py times it), and count once."""
    rng = np.random.default_rng(23)
    rows = torch.from_numpy(rng.integers(0, 256, (300, 65536), dtype=np.uint8)).to(dev)
    lens = torch.from_numpy(rng.integers(0, 65537, 300).astype(np.int32)).to(dev)
    want = crc32c.crc32c_plain(rows, lens, True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        crc32c.crc32c_masked_blocks(rows, lens)  # builds the tables outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = crc32c.launches
    with torch.cuda.graph(graph):
        out = crc32c.crc32c_masked_blocks(rows, lens)
    assert crc32c.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def _flat_cases(layout):
    """K2's inputs from the host flatten, ``(name, rows, d_pad, width)``
    with ``rows`` ``[(body, declen)]``: corpus chunks; the wide stream
    (a body past 64 KiB, ``d_pad`` up to 1 MiB, units that read source bytes
    60 KiB apart); rows of the 81,920-byte width (incompressible 64 KiB
    chunks) beside a corpus row and a row with declen 0."""
    corpus = [raw_body(d if layout else d[:7000]) for d in CHUNKS]
    noise = np.random.default_rng(3).integers(0, 256, 65536, dtype=np.uint8).tobytes()
    wide = wide_stream(16) if layout else wide_stream(15)
    if not layout:
        wide = (wide[0] + literal(bytes(range(200)) * 5), wide[1] + 1000)
    return [
        ("corpus", corpus, 65536 if layout else 7168, None),
        ("wide", [wide], -(-wide[1] // 1024) * 1024, None),
        ("rows_81920", [raw_body(noise), raw_body(noise[::-1]), corpus[0], (b"", 0)],
         65536 if layout else 66560, 81920),
    ]


def _flatten(rows, d_pad, layout, width):
    srcs, lens = packing.batch_streams([b for b, _ in rows], width)
    declens = np.asarray([n for _, n in rows], np.int32)
    idx, tmeta, fallb, errs, _ = native.flatten_idx_batch(
        srcs, lens.astype(np.uint64), declens.astype(np.uint64), d_pad, layout=layout
    )
    assert not fallb.any() and not errs.any()
    return srcs, idx, tmeta, declens


@pytest.mark.parametrize("layout", [0, 1])
def test_flat_gather_kernel_matches_plain(dev, layout):
    for name, rows, d_pad, width in _flat_cases(layout):
        assert (d_pad % 16384 == 0) == bool(layout), name
        srcs, idx, tmeta, declens = _flatten(rows, d_pad, layout, width)
        a = [torch.from_numpy(x).to(dev) for x in (srcs, idx.view(np.int16), tmeta, declens)]
        before = decode_flat.layout_launches[layout]
        got = decode_flat.decode_flat(*a, d_pad, layout)
        torch.cuda.synchronize()
        assert decode_flat.layout_launches[layout] == before + 1
        assert torch.equal(got, decode_flat.decode_flat_plain(*a, d_pad, layout)), name
        host = got.cpu().numpy()
        for i, (body, declen) in enumerate(rows):
            want = native.decompress(write_varu64(declen) + body)
            assert host[i, :declen].tobytes() == want and not host[i, declen:].any(), name


def _flat_crc_check(dev, rows, d_pad, layout, width=None):
    """K2 with the frame checksum against K2 and K1 on the same inputs: the
    bytes, the CRCs (also the host codec's), one launch of it (K2 and K1
    past eight units), and no fault."""
    srcs, idx, tmeta, declens = _flatten(rows, d_pad, layout, width)
    a = [torch.from_numpy(x).to(dev) for x in (srcs, idx.view(np.int16), tmeta, declens)]
    fused = -(-d_pad // decode_flat.GROUP) <= decode_flat.MAX_CRC_UNITS
    before = (decode_flat.crc_launches, decode_flat.layout_launches[layout], crc32c.launches)
    out, crc = decode_flat.decode_flat_crc(*a, d_pad, layout)
    torch.cuda.synchronize()
    assert (decode_flat.crc_launches, decode_flat.layout_launches[layout], crc32c.launches) == (
        before[0] + fused, before[1] + 1, before[2] + (not fused))
    want = decode_flat.decode_flat(*a, d_pad, layout)
    assert torch.equal(out, want)
    assert torch.equal(crc, crc32c.crc32c_masked_blocks(want, a[3]))
    torch.cuda.synchronize()
    host, got = out.cpu().numpy(), crc.cpu().tolist()
    for i, (body, declen) in enumerate(rows):
        assert host[i, :declen].tobytes() == native.decompress(write_varu64(declen) + body)
        assert got[i] == native.crc32c_masked(host[i, :declen].tobytes())


@pytest.mark.parametrize("layout,d_pad", [*FLAT_CRC_SHAPES, (1, 147456)])
def test_flat_gather_crc_kernel_matches_the_pair(dev, layout, d_pad):
    """Declens 0, 1, 15, 16, 16,383, 16,384, 16,385 and d_pad, text and
    literals, in one unit under 16 KiB up to eight units; 147,456
    bytes (nine units) takes K2 and K1."""
    _flat_crc_check(dev, flat_crc_rows(d_pad), d_pad, layout)


@pytest.mark.parametrize("layout", [0, 1])
def test_flat_gather_crc_kernel_on_k2_cases(dev, layout):
    """K2's own cases: corpus chunks, the wide stream (1 MiB: K2 and K1),
    rows of the 81,920-byte width beside a row of declen 0."""
    for _, rows, d_pad, width in _flat_cases(layout):
        _flat_crc_check(dev, rows, d_pad, layout, width)


def test_flat_gather_crc_kernel_in_a_cuda_graph(dev):
    """The wrapper reads nothing back, so its launches can be captured in a
    CUDA graph and replayed (as chip_smoke.py times it) on a stream that
    launched it once before; each launch leaves the rows' state zeroed, so
    every replay gives the CRCs again. A first launch on a stream inside a
    capture raises (its state would be made by the replay, not before)."""
    rows = flat_crc_rows(65536)
    srcs, idx, tmeta, declens = _flatten(rows, 65536, 1, None)
    a = [torch.from_numpy(x).to(dev) for x in (srcs, idx.view(np.int16), tmeta, declens)]
    _, want = decode_flat.decode_flat_crc(*a, 65536, 1)
    assert torch.equal(want, crc32c.crc32c_masked_blocks(decode_flat.decode_flat(*a, 65536, 1), a[3]))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_flat.decode_flat_crc(*a, 65536, 1)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = decode_flat.crc_launches
    with torch.cuda.graph(graph, stream=side):
        outs = [decode_flat.decode_flat_crc(*a, 65536, 1)[1] for _ in range(3)]
    assert decode_flat.crc_launches == before + 3
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(c, want) for c in outs)
    fresh = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(fresh, stream=torch.cuda.Stream()):
            decode_flat.decode_flat_crc(*a, 65536, 1)
    assert decode_flat.crc_launches == before + 3
    assert torch.equal(decode_flat.decode_flat_crc(*a, 65536, 1)[1], want)


def test_frame_read_of_the_corpus_runs_no_k1(dev):
    """decompress_frame and the device reader of the corpus: K2 with the
    checksum on every launch group (``crc_launches == launches``), no K1,
    and the stream back."""
    import io

    from snappy_tpu_torch import read

    names = ("alice29.txt", "asyoulik.txt", "fireworks.jpeg", "geo.protodata", "html",
             "html_x_4", "kppkn.gtb", "lcet10.txt", "paper-100k.pdf", "plrabn12.txt", "urls.10K")
    data = b"".join(load_corpus(n) for n in names)
    stream = native.frame_compress(data)
    for fn in (lambda: api.decompress_frame(stream),
               lambda: read.FrameDecoder(io.BytesIO(stream), engine="device").read()):
        for m in (crc32c, decode_flat, replay):
            m.launches = 0
        decode_flat.crc_launches = 0
        assert fn() == data
        assert decode_flat.crc_launches == decode_flat.launches >= 1
        assert crc32c.launches == 0 and replay.launches == 0


def _frame_groups(dev, layout):
    """The 16 MiB frame read's launch groups (``whole_files_frame``: five,
    each under one wave of K2), flattened in ``layout`` and on the card as
    ``decode_flat_groups`` takes them."""
    from chip_smoke import compressed_chunks, whole_files_frame

    chunks = compressed_chunks(whole_files_frame()[1])
    bodies, declens = [c[0] for c in chunks], [c[1] for c in chunks]
    groups = []
    for g in api.launch_groups(bodies, 512):
        gd = [declens[i] for i in g]
        d_pad = packing.pad_to_bucket(max(gd), 1024)
        srcs, idx, tmeta, dl = _flatten([(bodies[i], declens[i]) for i in g], d_pad, layout,
                                        api._width_bucket(len(bodies[g[0]])))
        groups.append((*(torch.from_numpy(x).to(dev) for x in (srcs, idx.view(np.int16), tmeta,
                                                               dl)), d_pad, layout))
    assert len(groups) == 5
    return groups


def _counts():
    return (decode_flat.launches, decode_flat.layout_launches[:], decode_flat.crc_launches,
            decode_flat.launched_groups, crc32c.launches)


@pytest.mark.parametrize("with_crc", [False, True], ids=["k2", "k2_crc"])
@pytest.mark.parametrize("layout", [0, 1])
def test_flat_groups_kernel_matches_plain(dev, layout, with_crc):
    """K2 over the frame read's five launch groups in one launch, with and
    without the checksum, in both layouts: each group's bytes and CRCs as
    its plain version gives them; one launch counting five groups, no K1.
    Twenty groups (the five, four times) take two launches of 16 and 4."""
    groups = _frame_groups(dev, layout)
    before = _counts()
    got = decode_flat.decode_flat_groups(groups, with_crc)
    torch.cuda.synchronize()
    after = _counts()
    assert after[0] == before[0] + 1 and after[2] == before[2] + with_crc
    assert after[1][layout] == before[1][layout] + 1 and after[3] == before[3] + 5
    assert after[4] == before[4]
    for (out, crc), g in zip(got, groups):
        want = decode_flat.decode_flat_plain(*g)
        assert torch.equal(out, want)
        if with_crc:
            assert torch.equal(crc, crc32c.crc32c_plain(want, g[3], masked=True))
        else:
            assert crc is None
    many = decode_flat.decode_flat_groups(groups * 4, with_crc)
    torch.cuda.synchronize()
    assert decode_flat.launches == after[0] + 2 and decode_flat.launched_groups == after[3] + 20
    assert all(torch.equal(m[0], o[0]) and (not with_crc or torch.equal(m[1], o[1]))
               for m, o in zip(many, got * 4))


def test_flat_groups_kernel_launches_once_a_layout(dev):
    """Groups of both layouts in one call: one launch of each, each group
    its plain version's bytes and CRCs."""
    g0, g1 = _frame_groups(dev, 0), _frame_groups(dev, 1)
    groups = [g for pair in zip(g0, g1) for g in pair]
    before = _counts()
    got = decode_flat.decode_flat_groups(groups, True)
    torch.cuda.synchronize()
    after = _counts()
    assert after[0] == before[0] + 2 and after[2] == before[2] + 2 and after[3] == before[3] + 10
    assert [a - b for a, b in zip(after[1], before[1])] == [1, 1]
    for (out, crc), g in zip(got, groups):
        want = decode_flat.decode_flat_plain(*g)
        assert torch.equal(out, want)
        assert torch.equal(crc, crc32c.crc32c_plain(want, g[3], masked=True))


@pytest.mark.parametrize("layout", [0, 1])
def test_one_group_c_entries_are_the_groups_kernel(dev, layout):
    """The one-group C entries ``stpu_cuda_flat_gather`` and
    ``stpu_cuda_flat_gather_crc`` (signatures unchanged, now one-entry
    launches of the groups kernel) give each group's plain bytes and CRCs."""
    import ctypes

    from snappy_tpu_torch.ops import _build

    lib = _build.kernel_lib("flat_gather")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.stpu_cuda_flat_gather.argtypes = [p, i64, i64, p, p, p, i64, ctypes.c_int, p, p]
    lib.stpu_cuda_flat_gather_crc.argtypes = [p, i64, i64, p, p, p, i64, ctypes.c_int,
                                              p, p, p, p, p]
    tabs, state = decode_flat._crc_scratch(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for g in _frame_groups(dev, layout):
        srcs, idx, tmeta, dl, d_pad, _ = g
        b, s = srcs.shape
        ins = (srcs.data_ptr(), b, s, idx.data_ptr(), tmeta.data_ptr(), dl.data_ptr(), d_pad,
               layout)
        out, out_c = (torch.empty((b, d_pad), dtype=torch.uint8, device=dev) for _ in range(2))
        crc = torch.empty(b, dtype=torch.int64, device=dev)
        assert lib.stpu_cuda_flat_gather(*ins, out.data_ptr(), stream) == 0
        assert lib.stpu_cuda_flat_gather_crc(*ins, tabs.data_ptr(), out_c.data_ptr(),
                                             crc.data_ptr(), state.data_ptr(), stream) == 0
        torch.cuda.synchronize()
        want = decode_flat.decode_flat_plain(*g)
        assert torch.equal(out, want) and torch.equal(out_c, want)
        assert torch.equal(crc, crc32c.crc32c_plain(want, dl, masked=True))


def test_frame_read_of_16_mib_is_one_checksum_launch(dev):
    """One ``decompress_frame`` of the 16 MiB read: one launch of K2 with
    the checksum over its five launch groups, no K1; a second call on the
    same stream gives the bytes again (the launch left the rows' words of
    state zeroed)."""
    from chip_smoke import whole_files_frame
    from snappy_tpu_torch.ops import reset_launch_counts

    data, stream = whole_files_frame()
    for k in (1, 2):
        reset_launch_counts()
        assert api.decompress_frame(stream) == data
        assert (decode_flat.launches, decode_flat.crc_launches, decode_flat.launched_groups,
                crc32c.launches) == (1, 1, 5, 0), k


def test_flat_grouped_kernel_matches_plain(dev):
    """K11, v3 and v4, against its plain version: on corpus rows at 64 KiB,
    the wide stream at 1 MiB and rows of the 81,920-byte width (with a row
    of declen 0), with the flatten's buckets (also K2's bytes) and with a
    hand-made bucket plane (a live group marked dead, a 3, the groups of
    wider tiles cut to the narrow window), and on a batch of 2 KiB rows
    (``s_rows`` 16, under every window)."""
    narrow = [raw_body(d) for d in (b"z" * 30000, (b"pattern!" * 4000)[:32000])]
    cases = [(rows, d_pad, width) for _, rows, d_pad, width in _flat_cases(1)]
    for rows, d_pad, width in [*cases, (narrow, 32768, 2048)]:
        srcs, idx, tmeta, declens = _flatten(rows, d_pad, 1, width)
        s_t, i_t, m_t, d_t = (torch.from_numpy(x).to(dev)
                              for x in (srcs, idx.view(np.int16), tmeta, declens))
        gb = decode_flat.group_buckets(m_t, d_t, d_pad)
        hand = gb.clone()
        hand[gb > 0] = 0
        hand[0, 0] = -1
        hand[-1, min(1, hand.shape[1] - 1)] = 3
        k2 = decode_flat.decode_flat(s_t, i_t, m_t, d_t, d_pad, 1)
        for variant in (3, 4):
            for g in (gb, hand):
                before = decode_flat.grouped_launches[variant]
                got = decode_flat.decode_flat_grouped(s_t, i_t, m_t, g, d_t, d_pad, variant)
                torch.cuda.synchronize()
                assert decode_flat.grouped_launches[variant] == before + 1
                want = decode_flat.decode_flat_grouped_plain(s_t, i_t, m_t, g, d_t, d_pad, variant)
                assert torch.equal(got, want)
                if g is gb:
                    assert torch.equal(got, k2)
            assert not got[0, :16384].any()
        host = k2.cpu().numpy()
        for i, (body, declen) in enumerate(rows):
            want = native.decompress(write_varu64(declen) + body)
            assert host[i, :declen].tobytes() == want and not host[i, declen:].any()


@pytest.mark.parametrize("cfg", [{"decode_kernels": False}, {"pure_device": True}],
                         ids=["parallel_hosted", "parallel"])
def test_tensor_routes_on_the_card(dev, cfg, monkeypatch):
    """Both tensor routes decode a frame stream on the card with K1 and no
    other kernel, raise the host engine's error on a corrupt one, and give
    the CPU run's bytes, codes, totals and CRCs on frame-sized rows."""
    from snappy_tpu_torch.config import configure

    data = (load_corpus("alice29.txt") + load_corpus("fireworks.jpeg")) * 2 + b"tail" * 1000
    stream = native.frame_compress(data)
    for m in (crc32c, decode_flat, replay):
        m.launches = 0
    monkeypatch.setattr(api, "routes", [])
    route = "parallel" if "pure_device" in cfg else "parallel_hosted"
    with configure(**cfg):
        assert api.decompress_frame(stream) == data
        assert {r[2] for r in api.routes} == {route}
        assert crc32c.launches >= 1 and decode_flat.launches == 0 and replay.launches == 0
        bad = bytearray(stream)
        bad[len(bad) // 2] ^= 0x5A
        with pytest.raises(Exception) as got:
            api.decompress_frame(bytes(bad))
    with pytest.raises(Exception) as want:
        native.frame_decompress(bytes(bad))
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)

    rows = [raw_body(data[k : k + 65536]) for k in range(0, 5 * 65536, 65536)] + CORRUPT
    srcs, lens = packing.batch_streams([r[0] for r in rows], 81920)
    declens = np.asarray([r[1] for r in rows], np.int32)
    bits = np.zeros((len(rows), 81920 // 8), np.uint8)
    native.scan_ops_batch(srcs, lens.astype(np.uint64), bits)
    cpu = [torch.from_numpy(x) for x in (srcs, lens, declens)]
    card = [t.to(dev) for t in cpu]
    for fn, extra in ((decode.decode_crc_batch, ()), (decode.decode_crc_batch_hosted, (bits,))):
        extra = tuple(torch.from_numpy(x) for x in extra)
        got = fn(*card, *(t.to(dev) for t in extra), 65536)
        want = fn(*cpu, *extra, 65536)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        assert (want[1][:5] == 0).all() and (want[1][5:] != 0).all()


def _replay_rows():
    return (
        CORRUPT
        + overlap_rows((1, 3, 31, 32, 33, 127, 128, 129, 255), copies=20)
        + list(zip(_bodies(CHUNKS), [len(d) for d in CHUNKS]))
    )


def test_replay_kernel_matches_plain(dev):
    rows = _replay_rows()
    declens = np.asarray([r[1] for r in rows], np.int32)
    d_pad = packing.pad_to_bucket(int(declens.max()), 1024)
    # At d_pad 65536 both widths take the CTA path, which stages a window
    # of the source at a time; 256 KiB is wider than one block's 227 KB.
    for width in (1 << 17, 1 << 18):
        srcs, lens = packing.batch_streams([r[0] for r in rows], width)
        a = [torch.from_numpy(x).to(dev) for x in (srcs, lens, declens)]
        got = replay.decode_replay(*a, d_pad)
        want = replay.decode_replay_plain(*a, d_pad)
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    errs = got[1].cpu().numpy()
    n = len(CORRUPT)
    assert (errs[:n] > 0).all() and not errs[n:].any()


def _replay_against_plain(dev, rows, d_pad, width=None):
    srcs, lens = packing.batch_streams([r[0] for r in rows], width)
    declens = np.asarray([r[1] for r in rows], np.int32)
    a = [torch.from_numpy(x).to(dev) for x in (srcs, lens, declens)]
    before = replay.launches
    got = replay.decode_replay(*a, d_pad)
    torch.cuda.synchronize()
    assert replay.launches == before + 1
    want = replay.decode_replay_plain(*a, d_pad)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    return got


def test_replay_kernel_on_a_corpus_group(dev):
    """455 corpus chunks of 64 KiB, the shape of the frame's largest launch
    group (one CTA a row, four waves): the host codec's bytes, no error,
    and the plain version's rows on the first 24."""
    data = b"".join(load_corpus(n) for n in ("html", "lcet10.txt", "kppkn.gtb", "fireworks.jpeg",
                                              "paper-100k.pdf", "plrabn12.txt", "urls.10K"))
    data = (data * (-(-455 * 65536 // len(data))))[: 455 * 65536]
    rows = [raw_body(data[i : i + 65536]) for i in range(0, len(data), 65536)]
    srcs, lens = packing.batch_streams([r[0] for r in rows], None)
    a = [torch.from_numpy(x).to(dev) for x in (srcs, lens, np.full(455, 65536, np.int32))]
    dst, errs = replay.decode_replay(*a, 65536)
    assert not errs.any()
    assert dst.cpu().numpy().tobytes() == data
    head = [x[:24] for x in a]
    want = replay.decode_replay_plain(*head, 65536)
    assert torch.equal(dst[:24], want[0]) and torch.equal(errs[:24], want[1])


def test_replay_kernel_on_wide_rows(dev):
    """``d_pad`` 131072: the row the flatten rejects, a wide stream and a
    corpus chunk past 64 KiB among corrupt rows. At their own width the
    source and the output row share one CTA's shared memory (the CTA
    walk: long literals moved by the whole CTA in words); at 256 KiB they
    do not (one warp a row)."""
    rows = [fallback_row(), wide_stream(2), raw_body(load_corpus("html_x_4")[:120000])]
    rows += [raw_body(b"ab" * 60000), (literal(bytes(range(256)) * 4) + copy2(1024, 64) * 100, 1024 + 6400)]
    rows += list(CORRUPT[:4])
    for width in (None, 1 << 18):
        got = _replay_against_plain(dev, rows, 131072, width)
    errs = got[1].cpu().numpy()
    assert not errs[:5].any() and (errs[5:] > 0).all()
    host = got[0].cpu().numpy()
    for i, (body, n) in enumerate(rows[:5]):
        assert host[i, :n].tobytes() == native.decompress(write_varu64(n) + body)


def test_replay_kernel_on_corrupt_rows_among_valid_ones(dev):
    """Corrupt vectors between corpus chunks, random op streams and rows
    whose ops sit on the edges of the CTA path's source windows (a header
    across an edge, a literal over several windows, an offset-1 run, a row
    that turns bad in its third window, n = 0): the valid prefixes, the
    zeros and the first bad op's code, row by row."""
    valid = [raw_body(c) for c in CHUNKS[:4]] + [random_ops(s, 40000) for s in (7, 8)]
    rows = [r for pair in zip(valid + valid[:4], CORRUPT) for r in pair] + edge_rows()
    got = _replay_against_plain(dev, rows, 65536)
    errs = got[1].cpu().numpy()
    assert (errs[1 : 2 * len(CORRUPT) : 2] > 0).all() and not errs[0 : 2 * len(CORRUPT) : 2].any()


@pytest.mark.parametrize("b", [1, 3, 7])
def test_replay_kernel_on_small_batches(dev, b):
    """Batches of 1, 3 and 7 rows, with padding rows (no bytes, declen 0)
    among them, on the CTA path (d_pad 65536) and the CTA walk (131072)."""
    pool = [raw_body(CHUNKS[0]), (b"", 0), CORRUPT[0], raw_body(b"xyz" * 999), (b"", 0),
            random_ops(9, 5000), edge_rows()[2]]
    for d_pad in (65536, 131072):
        _replay_against_plain(dev, pool[:b], d_pad)


def test_plane_resolution_kernel_on_crafted_planes(dev):
    """K9 against its plain version on planes with pointers below 0 (read
    at position 0), self pointers, a chain through the whole row and a
    chain of 4,095 in every window; a pointer past its own position is
    never chased, so its row stays flagged. Through the C entry with a
    budget of 0 rounds, a row whose pointers all leave their window
    resolves and a row with a pointer inside its window stays flagged. A
    plane off a 16-byte boundary is refused."""
    for d_pad in (8192, 20480, 65536):
        a0 = k9_planes(d_pad, d_pad).to(dev)
        before = resolve.launches["resolve"]
        got = resolve.resolve(a0)
        torch.cuda.synchronize()
        assert resolve.launches["resolve"] == before + 1
        assert torch.equal(got, resolve.resolve_reference(a0))
        fwd = a0.clone()
        fwd[0, 10] = 5000
        got_f = resolve.resolve(fwd)
        assert int(got_f[0, 10]) == 5000 and torch.equal(got_f[1:], got[1:])
    p = torch.arange(65536, device=dev, dtype=torch.int32)
    leaving = torch.where(p < 4096, resolve.FLAG + p, p - 4096)
    inside = torch.where(p < 4096, resolve.FLAG + p, p - 1)
    a0 = torch.stack([leaving, inside])
    out = torch.empty_like(a0)
    _build.check(resolve._kernels()[1](a0.data_ptr(), 2, 65536, 0, out.data_ptr(),
                                       torch.cuda.current_stream().cuda_stream), "resolve")
    torch.cuda.synchronize()
    assert torch.equal(out[0], resolve.resolve_reference(a0[:1])[0])
    assert bool((out[1] < resolve.FLAG).any())
    # The kernel copies the plane 16 bytes at a time: a plane that does not
    # start on a 16-byte boundary is refused, not read.
    shifted = torch.full((2 * 8192 + 1,), resolve.FLAG, dtype=torch.int32, device=dev)[1:].view(2, 8192)
    with pytest.raises(ValueError, match="16-byte"):
        resolve.resolve(shifted)


def _encode_inputs(dev):
    blocks, lens = packing.batch_streams(CHUNKS + [b""], 65536)
    bt, lt = torch.from_numpy(blocks).to(dev), torch.from_numpy(lens).to(dev)
    jw, _ = encode_flat.prepass(bt, lt)
    return bt, lt, jw


def test_parse_kernel_matches_plain(dev):
    bt, lt, jw = _encode_inputs(dev)
    before = parse.launches
    got = parse.parse_blocks(lt, jw, bt)
    torch.cuda.synchronize()
    assert parse.launches == before + 1
    want = parse.parse_blocks_plain(lt, jw, bt)
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g, w)
    assert int(got[2][..., 0].max()) > 50 and not got[2][..., 1].any()


def test_parse_kernel_on_padding_and_short_blocks(dev):
    """Padding rows (no walk: coalesced zeros) between short blocks: a
    block shorter than one segment, lengths that are not whole segments,
    and segments whose records end part way through a sector (written a
    sector at a time, the rest of the last one zero)."""
    datas = [b"", CHUNKS[0][:300], b"", CHUNKS[1][:5000], b"", b"", CHUNKS[3][:513],
             CHUNKS[5][:777], b"", CHUNKS[0][:40000]]
    blocks, lens = packing.batch_streams(datas, 65536)
    bt, lt = torch.from_numpy(blocks).to(dev), torch.from_numpy(lens).to(dev)
    jw, _ = encode_flat.prepass(bt, lt)
    before = parse.launches
    got = parse.parse_blocks(lt, jw, bt)
    torch.cuda.synchronize()
    assert parse.launches == before + 1
    want = parse.parse_blocks_plain(lt, jw, bt)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    counts = got[2][..., 0]
    assert not counts[lt == 0].any() and int((counts % 8).max()) > 0


def test_emit_kernels_match_plain(dev):
    bt, lt, jw = _encode_inputs(dev)
    rec = parse.parse_blocks(lt, jw, bt)
    lo_row, base, rows_g, out_len, bp_rows, dlt_rows, src, ovf = encode_flat._fused_plan(
        bt, lt, *rec
    )
    plan = (lo_row, base, rows_g, out_len, bp_rows, dlt_rows)
    before = dict(emit.entry_launches)
    out = emit.fused_emit(*plan, src)
    idx = emit.shift_idx(*plan)
    out2 = emit.emit_bytes(src, idx, out_len)
    torch.cuda.synchronize()
    assert {k: emit.entry_launches[k] - before[k] for k in before} == {
        "fused_emit": 1, "shift_idx": 1, "emit_bytes": 1,
    }
    assert torch.equal(idx, emit.shift_idx_plain(*plan))
    assert torch.equal(out2, emit.emit_bytes_plain(src, idx, out_len))
    assert torch.equal(out, emit.fused_emit_plain(*plan, src)) and torch.equal(out, out2)
    ref_out, ref_len = encode_flat.records_to_bytes(bt, lt, *rec)
    assert torch.equal(out[:, : encode_flat.OUT_W], ref_out) and torch.equal(out_len, ref_len)
    assert not ovf.any()


def _emit_plan(dev, datas):
    blocks, lens = packing.batch_streams(datas, 65536)
    bt, lt = torch.from_numpy(blocks).to(dev), torch.from_numpy(lens).to(dev)
    jw, _ = encode_flat.prepass(bt, lt)
    rec = parse.parse_blocks(lt, jw, bt)
    *plan, src, ovf = encode_flat._fused_plan(bt, lt, *rec)
    assert not ovf.any()
    return bt, lt, rec, plan, src


def _emit_all_entries(plan, src):
    """K5 and K6's two entries against their plain versions."""
    out = emit.fused_emit(*plan, src)
    idx = emit.shift_idx(*plan)
    out2 = emit.emit_bytes(src, idx, plan[3])
    torch.cuda.synchronize()
    assert torch.equal(out, emit.fused_emit_plain(*plan, src))
    assert torch.equal(idx, emit.shift_idx_plain(*plan))
    assert torch.equal(out2, emit.emit_bytes_plain(src, idx, plan[3])) and torch.equal(out, out2)
    return out


def test_emit_kernels_on_an_all_padding_batch(dev):
    """Every row padding (out_len 0): K5's CTAs store zeros 16 bytes a store
    and read no plan; K6 equals its plain versions."""
    _, _, _, plan, src = _emit_plan(dev, [b""] * 6)
    assert not plan[3].any()
    out = _emit_all_entries(plan, src)
    assert not out.any()


def test_emit_kernels_on_one_live_row_among_padding(dev):
    """One live row (its out_len ends part way through a group) between
    padding rows: K5's runs of groups past out_len store zeros; the bytes
    equal the reference emission."""
    data = load_corpus("alice29.txt")[:50000]
    bt, lt, rec, plan, src = _emit_plan(dev, [b"", b"", data, b"", b""])
    olen = int(plan[3][2])
    assert olen % emit.GROUP and not plan[3][[0, 1, 3, 4]].any()
    out = _emit_all_entries(plan, src)
    ref_out, ref_len = encode_flat.records_to_bytes(bt, lt, *rec)
    assert torch.equal(out[:, : encode_flat.OUT_W], ref_out) and torch.equal(plan[3], ref_len)
    assert not out[2, olen:].any() and not out[[0, 1, 3, 4]].any()


@pytest.mark.parametrize("out_len", emit.EDGE_LENS)
def test_emit_bytes_on_one_edge_row(dev, out_len):
    """K6's gather on a batch of one row: a thread's 16 bytes cut by
    ``out_len`` at every edge, indices -1, ``src_w`` and ``src_w - 1``."""
    src, idx, olen = emit.edge_batch([out_len], dev)
    got = emit.emit_bytes(src, idx, olen)
    assert torch.equal(got, emit.emit_bytes_plain(src, idx, olen))
    assert not got[0, out_len:].any()


def test_emit_bytes_on_2049_edge_rows(dev):
    lens = [emit.EDGE_LENS[i % len(emit.EDGE_LENS)] if i % 3 else 81920 * (i % 5) // 4
            for i in range(2049)]
    src, idx, olen = emit.edge_batch(lens, dev, seed=9)
    before = emit.entry_launches["emit_bytes"]
    got = emit.emit_bytes(src, idx, olen)
    torch.cuda.synchronize()
    assert emit.entry_launches["emit_bytes"] == before + 1
    assert torch.equal(got, emit.emit_bytes_plain(src, idx, olen))


def test_emit_bytes_equals_fused_emit_on_the_compress_group(dev):
    """The 64 MiB + 5,000-byte corpus stream's 1,025 blocks in 2,048 rows,
    as ``compress(profile="fast")`` batches them: K6's two launches give
    K5's bytes and the plain version's."""
    from conftest import CORPUS_FILES

    parts, total = [], 0
    while total < (64 << 20) + 5000:
        for name in CORPUS_FILES:
            parts.append(load_corpus(name))
            total += len(parts[-1])
    blocks, lens = packing.blocks_of(b"".join(parts)[: (64 << 20) + 5000])
    rows = packing.pad_to_bucket(len(lens), 1)
    bt = torch.zeros((rows, 65536), dtype=torch.uint8, device=dev)
    lt = torch.zeros(rows, dtype=torch.int32, device=dev)
    bt[: len(lens)], lt[: len(lens)] = torch.from_numpy(blocks).to(dev), torch.from_numpy(lens).to(dev)
    jw, _ = encode_flat.prepass(bt, lt)
    rec = parse.parse_blocks(lt, jw, bt)
    *plan, src, ovf = encode_flat._fused_plan(bt, lt, *rec)
    del bt, jw, rec
    idx = emit.shift_idx(*plan)
    got = emit.emit_bytes(src, idx, plan[3])
    assert torch.equal(got, emit.fused_emit(*plan, src))
    assert torch.equal(got, emit.emit_bytes_plain(src, idx, plan[3])) and not ovf.any()


def test_gpu_pipeline_on_the_card_matches_the_cpu_run(dev):
    """``examples.gpu_pipeline`` at 512 KiB shards: K2 on one card once a
    shard gives the CPU run's rows; the losses and the table agree within
    rtol 1e-5 (float32 sums in another order)."""
    from snappy_tpu_torch.examples import gpu_pipeline

    before = decode_flat.layout_launches[1]
    l_card, p_card, r_card = gpu_pipeline.run("cuda", 512 << 10, mesh_size=1)
    assert decode_flat.layout_launches[1] == before + 2
    l_cpu, p_cpu, r_cpu = gpu_pipeline.run("cpu", 512 << 10)
    for (rows_a, n_a), (rows_b, n_b) in zip(r_card, r_cpu):
        assert torch.equal(rows_a, rows_b) and torch.equal(n_a, n_b)
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-5, atol=0)
    torch.testing.assert_close(p_card, p_cpu, rtol=1e-5, atol=1e-8)


def test_gpu_pipeline_leaves_each_cards_rows_on_that_card(dev):
    """The pipeline on every card: each step's rows lie one shard a card, and
    only each card's 256 byte counts move; the losses are the one-card
    run's within rtol 1e-5."""
    from snappy_tpu_torch.examples import gpu_pipeline

    stats = []
    losses, _, _ = gpu_pipeline.run("cuda", 512 << 10, stats=stats)
    cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    assert [st["rows_devices"] for st in stats] == [cards, cards]
    assert sorted(stats[0]["peak_device_bytes"]) == cards
    one, _, _ = gpu_pipeline.run("cuda", 512 << 10, mesh_size=1)
    np.testing.assert_allclose(losses, one, rtol=1e-5, atol=0)


def _sharded_counts():
    return (encode.launches, replay.launches, decode_flat.layout_launches[1], crc32c.launches)


@pytest.mark.parametrize("m", [1, 2])
def test_sharded_entries_leave_each_shard_on_its_card(dev, m, tmp_path):
    """The sharded entries on ``[cuda:0] * m`` from host memory: every shard
    on ``cuda:0``, each kernel launched once a mesh entry, the host codec's
    bytes; the exact compress's ``Sharded`` rows feed the replay decode in
    place; and a trace of warm calls holds no device-to-device copy."""
    import glob

    from snappy_tpu_torch.parallel import Sharded, make_mesh, sharded
    from snappy_tpu_torch.utils.profiling import (
        device_events, device_to_device_copies, device_trace,
    )

    data = b"".join(CHUNKS[:4])
    blocks, lens = packing.blocks_of(data)
    mesh = make_mesh([dev] * m)
    card = [torch.device("cuda", 0)] * m

    c0 = _sharded_counts()
    out, out_len = sharded.sharded_compress_blocks(mesh, blocks, lens)
    dst, err = sharded.sharded_decode_streams_replay(mesh, out, out_len, lens, 65536)
    rows, row_len = sharded.sharded_encode_frame_chunks(mesh, blocks, lens)
    srcs, src_lens = packing.batch_streams(
        [out.numpy()[i, : out_len.numpy()[i]].tobytes() for i in range(len(lens))], 65536)
    flat, ferr, fb = sharded.sharded_decode_flat_host(mesh, srcs, src_lens, lens, 65536)
    c1 = _sharded_counts()
    assert [b - a for a, b in zip(c0, c1)] == [2 * m, m, m, m]
    for x in (out, out_len, dst, err, rows, row_len, flat):
        assert isinstance(x, Sharded) and [t.device for t in x.shards] == card
    o, n = out.numpy(), out_len.numpy()
    assert write_varu64(len(data)) + b"".join(o[i, : n[i]].tobytes() for i in range(len(n))) \
        == native.compress(data)
    r, rl = rows.numpy(), row_len.numpy()
    assert b"\xff\x06\x00\x00sNaPpY" + b"".join(r[i, : rl[i]].tobytes() for i in range(len(rl))) \
        == native.frame_compress(data)
    for got in (dst.numpy(), flat.numpy()):
        assert b"".join(got[i, : lens[i]].tobytes() for i in range(len(lens))) == data
    assert not err.numpy().any() and not ferr.any() and not fb.any()

    with device_trace(str(tmp_path)):
        sharded.sharded_compress_blocks(mesh, blocks, lens)
        sharded.sharded_decode_flat_host(mesh, srcs, src_lens, lens, 65536)
        sharded.sharded_decode_streams_replay(mesh, out, out_len, lens, 65536)
    (path,) = glob.glob(str(tmp_path / "trace.*.json"))
    events = device_events(path)
    assert any(e["cat"] == "kernel" for e in events)
    assert device_to_device_copies(events) == []


def _graft_want(n: int) -> dict:
    """The kernels one dry run launches on a mesh of ``n`` entries: each of
    its legs' kernels once a mesh entry, K2 in the flat and the resolve leg."""
    return {"crc32c": n, "encode": n, "replay": n, "flat_gather[layout=1]": 2 * n,
            "resolve_fh": n, "parse": n, "fused_emit": n}


def test_graft_entry_on_the_card(dev):
    """``graft_entry.entry()`` on the card: its rows equal the CPU run's,
    the frame verifies, and K1 is the only kernel it launches."""
    from snappy_tpu_torch import graft_entry
    from snappy_tpu_torch.ops import launch_counts, reset_launch_counts

    fn, args = graft_entry.entry()
    assert all(a.device.type == "cuda" for a in args)
    reset_launch_counts()
    rows, row_len = fn(*args)
    torch.cuda.synchronize()
    assert {k: v for k, v in launch_counts().items() if v} == {"crc32c": 1}
    cfn, cargs = graft_entry.entry(device="cpu")
    crows, crow_len = cfn(*cargs)
    assert torch.equal(rows.cpu(), crows) and torch.equal(row_len.cpu(), crow_len)
    chunks, lens = cargs[0].numpy(), cargs[1].numpy()
    r, n = rows.cpu().numpy(), row_len.cpu().numpy()
    stream = b"\xff\x06\x00\x00sNaPpY" + b"".join(r[i, : n[i]].tobytes() for i in range(4))
    assert native.frame_decompress(stream) == b"".join(
        chunks[i, : lens[i]].tobytes() for i in range(4))


@pytest.mark.parametrize("mesh", ["every_card", "four_on_cuda0"])
def test_graft_dryrun_on_the_card(dev, mesh):
    """``dryrun_multichip`` over every card, and with four shards on
    ``cuda:0``: every leg passes, each of its kernels launched once a mesh
    entry."""
    from snappy_tpu_torch import graft_entry
    from snappy_tpu_torch.ops import launch_counts, reset_launch_counts

    n = torch.cuda.device_count() if mesh == "every_card" else 4
    reset_launch_counts()
    if mesh == "every_card":
        graft_entry.dryrun_multichip(n)
    else:
        graft_entry.dryrun_multichip(n, device="cuda:0")
    assert {k: v for k, v in launch_counts().items() if v} == _graft_want(n)


def test_compress_on_the_card(dev):
    data = load_corpus("alice29.txt") + load_corpus("fireworks.jpeg")[:70000] + b"tail" * 999
    parse.launches = 0
    for k in emit.entry_launches:
        emit.entry_launches[k] = 0
    comp = api.compress(data, profile="fast")
    assert parse.launches == 1
    assert emit.entry_launches == {"fused_emit": 1, "shift_idx": 0, "emit_bytes": 0}
    assert native.decompress(comp) == data
    assert api.decompress(comp) == data
    assert comp == api.compress(data, profile="fast", device="cpu")


def test_encode_kernel_matches_plain(dev):
    """K7 against its plain version: the edge rows, seeded repetitive
    rows, rows that crowd the table (so that lanes of a scan round share a
    hash) and corpus blocks, at 4096 and 65536 bytes a row."""
    rng = np.random.default_rng(3)
    edge = [
        b"hello world hello world hello world!", bytes(rng.integers(0, 4, 3000, dtype=np.uint8)),
        b"a" * 500, load_corpus("html")[:4096], bytes(rng.integers(0, 256, 1200, dtype=np.uint8)),
        b"xy", b"q" * 16, b"q" * 17, b"",
    ]
    for seed in range(4):
        seg = rng.integers(0, [2, 8, 64, 256][seed], 300 + 100 * seed, dtype=np.uint8)
        edge.append(np.tile(seg, 4)[: 1000 + 700 * seed].tobytes())
    blocks_cases = [
        (edge, 4096),
        ([d for rows in collision_rows().values() for d in rows], 4096),
        ([load_corpus(n)[:65536] for n in ("alice29.txt", "fireworks.jpeg", "kppkn.gtb")]
         + [b"abcdefgh" * 8192, bytes(65536), load_corpus("html")[:50000]], 65536),
    ]
    for datas, width in blocks_cases:
        rows, lens = packing.batch_streams(datas, width)
        bt, lt = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
        before = encode.launches
        out, out_len = encode.compress_blocks(bt, lt)
        torch.cuda.synchronize()
        assert encode.launches == before + 1
        want, want_len = encode.compress_blocks_plain(bt, lt)
        assert torch.equal(out_len, want_len) and torch.equal(out, want)
        host = out.cpu().numpy()
        for i, d in enumerate(datas):
            c = native.compress(d)
            body = c[read_varu64(c)[1]:] if d else b""
            assert host[i, : int(out_len[i])].tobytes() == body


def test_encode_kernel_on_the_compress_group(dev):
    """K7 on the exact compress path's own launch group: the corpus cycled
    to 64 MiB + 5,000 bytes, 1,025 blocks in 2,048 rows, each block equal
    to the host codec's stream of it (the plain version would take minutes
    here; it equals the host codec on the CPU tests' blocks)."""
    total = (64 << 20) + 5000
    names = ["html", "urls.10K", "fireworks.jpeg", "paper-100k.pdf", "html_x_4",
             "alice29.txt", "asyoulik.txt", "lcet10.txt", "plrabn12.txt", "geo.protodata",
             "kppkn.gtb"]
    corpus = b"".join(load_corpus(n) for n in names)
    data = (corpus * (total // len(corpus) + 1))[:total]
    blocks, lens = packing.blocks_of(data)
    rows = packing.pad_to_bucket(len(lens), 1)
    bt = torch.zeros((rows, blocks.shape[1]), dtype=torch.uint8, device=dev)
    lt = torch.zeros(rows, dtype=torch.int32, device=dev)
    bt[: len(lens)], lt[: len(lens)] = torch.from_numpy(blocks), torch.from_numpy(lens)
    before = encode.launches
    out, out_len = encode.compress_blocks(bt, lt)
    torch.cuda.synchronize()
    assert encode.launches == before + 1 and (len(lens), rows) == (1025, 2048)
    host, host_len = out.cpu().numpy(), out_len.cpu().numpy()
    for i in range(len(lens)):
        c = native.compress(blocks[i, : lens[i]].tobytes())
        assert host[i, : host_len[i]].tobytes() == c[read_varu64(c)[1]:], i
    assert not host_len[len(lens):].any() and not host[len(lens):].any()


def test_exact_compress_and_frame_writer_on_the_card(dev):
    import io

    from snappy_tpu_torch import read, write

    data = load_corpus("alice29.txt") + load_corpus("fireworks.jpeg")[:70000] + b"tail" * 999
    encode.launches = crc32c.launches = 0
    assert api.compress(data) == native.compress(data)
    assert encode.launches == 1 and crc32c.launches == 0
    out = io.BytesIO()
    encode.launches = 0
    write.FrameEncoder(out, engine="device").write(data)
    assert encode.launches == 1 and crc32c.launches == 1
    assert out.getvalue() == native.frame_compress(data)
    assert read.FrameDecoder(io.BytesIO(out.getvalue()), engine="device").read() == data


def test_entry_points_on_the_card(dev):
    data = (load_corpus("alice29.txt") + load_corpus("fireworks.jpeg")) * 2 + b"tail" * 1000
    stream = native.frame_compress(data)
    for m in (crc32c, decode_flat, replay):
        m.launches = 0
    decode_flat.crc_launches = 0
    assert api.decompress_frame(stream) == data
    # The flat route checks its chunks in K2's own launch: no K1.
    assert crc32c.launches == 0 and decode_flat.crc_launches >= 1 and replay.launches == 0
    assert decode_flat.launches >= 1
    body, declen = fallback_row()
    raw = write_varu64(declen) + body
    for m in (crc32c, decode_flat, replay):
        m.launches = 0
    assert api.decompress(raw) == ref.decompress(raw)
    assert replay.launches == 1 and crc32c.launches == 0 and decode_flat.launches == 0
    bad = bytearray(stream)
    bad[len(bad) // 2] ^= 0x5A
    with pytest.raises(Exception) as got:
        api.decompress_frame(bytes(bad))
    with pytest.raises(Exception) as want:
        native.frame_decompress(bytes(bad))
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def test_resolve_kernels_match_plain(dev):
    """K8 and K9 against their plain versions on the JAX package's resolve
    cases, two rows the scan cut short (one with no record at all) and
    deep chains: whole planes where the rows resolve, the unresolved flag
    everywhere (K8 also gives the plain version's values on the flagged
    rows). Then the route's bytes against the data."""
    cases = resolve_cases()
    deep = [raw_body(b"a" * 65536), raw_body(bytes(range(7)) * 9000)]
    rows = [raw_body(c) for c in cases] + [(b"\x61", 3), (b"\x00a\x1d\x01", 5)] + deep
    srcs, _, declens, recs, nops, _ = scan_batch(rows)
    s_t, r_t, n_t, d_t = _on(dev, srcs, recs, nops.astype(np.int32), declens)
    d_pad = 1 << 16
    startsx, payload = resolve.records_to_kernel_inputs(r_t, n_t, d_t, d_pad)
    a0 = resolve.records_to_pointers(r_t, n_t, d_t, d_pad)
    before = dict(resolve.launches)
    got = {"resolve_fh": resolve.resolve_fh(startsx, payload, d_t, d_pad), "resolve": resolve.resolve(a0)}
    torch.cuda.synchronize()
    assert {k: resolve.launches[k] - before[k] for k in before} == {"resolve_fh": 1, "resolve": 1}
    want = {"resolve_fh": resolve.resolve_fh_plain(startsx, payload, d_t, d_pad),
            "resolve": resolve.resolve_reference(a0)}
    for name in got:
        g, w = got[name], want[name]
        flags = (g < resolve.FLAG).any(dim=1)
        assert torch.equal(flags, (w < resolve.FLAG).any(dim=1)), name
        assert torch.equal(g[~flags], w[~flags]), name
    assert torch.equal(got["resolve_fh"], want["resolve_fh"])
    assert (got["resolve_fh"] < resolve.FLAG).any(dim=1).tolist() == (
        [False] * len(cases) + [True, False] + [False] * len(deep))
    rows = rows[: len(cases) + 2]
    s_t, r_t, n_t, d_t = s_t[: len(rows)], r_t[: len(rows)], n_t[: len(rows)], d_t[: len(rows)]
    for fused in (True, False):
        out, fb = resolve.decode_resolve_batch(s_t, r_t, n_t, d_t, d_pad, use_fused=fused)
        host = out.cpu().numpy()
        assert fb.tolist() == [0] * len(cases) + [1, 0]
        for i, c in enumerate(cases):
            assert host[i, : len(c)].tobytes() == c and not host[i, len(c):].any()
        assert host[-1, :5].tolist() == [97, 29, 1, 0, 0]


@pytest.mark.parametrize("d_pad", [16384, 32768])
def test_fused_resolve_kernel_on_narrower_rows(dev, d_pad):
    """K8 at the route's narrower widths (less shared memory, more CTAs an
    SM): corpus rows, deep chains, overlapping copies and cut rows, whole
    planes against the plain version."""
    rows = [raw_body(load_corpus("kppkn.gtb")[:d_pad]), raw_body(b"a" * d_pad),
            raw_body(bytes(range(7)) * (d_pad // 7)), (b"\x61", 3), (b"\x00a\x1d\x01", 5)]
    rows += overlap_rows(tuple(range(1, 130, 4)), copies=20)
    srcs, _, declens, recs, nops, _ = scan_batch(rows)
    _, r_t, n_t, d_t = _on(dev, srcs, recs, nops.astype(np.int32), declens)
    startsx, payload = resolve.records_to_kernel_inputs(r_t, n_t, d_t, d_pad)
    before = resolve.launches["resolve_fh"]
    got = resolve.resolve_fh(startsx, payload, d_t, d_pad)
    torch.cuda.synchronize()
    assert resolve.launches["resolve_fh"] == before + 1
    assert torch.equal(got, resolve.resolve_fh_plain(startsx, payload, d_t, d_pad))
    assert (got < resolve.FLAG).any(dim=1).tolist() == [False] * 3 + [True, False] + [False] * (len(rows) - 5)


def test_records_kernel_matches_plain(dev):
    """K10 against its plain version: corrupt rows (their valid prefix),
    overlapping copies, deep copy chains and corpus chunks, at ``d_pad``
    65536 (a CTA a row, pointer doubling in shared memory) and 262144 (a
    warp a row replaying the records in order)."""
    rows = CORRUPT + overlap_rows((1, 3, 31, 32, 33, 127, 128, 129, 255), copies=20)
    rows += [raw_body(b"a" * 65536), raw_body(bytes(range(7)) * 9000)]  # deep chains
    rows += [raw_body(c) for c in CHUNKS]
    srcs, _, declens, recs, nops, errs = scan_batch(rows, 16384)
    a = _on(dev, srcs, recs, nops.astype(np.int32), declens)
    for d_pad in (1 << 16, 1 << 18):
        before = records.launches
        got = records.decode_records(*a, d_pad)
        torch.cuda.synchronize()
        assert records.launches == before + 1
        assert torch.equal(got, records.decode_records_plain(*a, d_pad))
    host = got.cpu().numpy()
    for i, c in enumerate(CHUNKS):
        j = len(rows) - len(CHUNKS) + i
        assert host[j, : len(c)].tobytes() == c and not host[j, len(c):].any()
    assert (errs[: len(CORRUPT)] > 0).all()


@pytest.mark.parametrize("route", ["decode_resolve", "decode_records"])
def test_record_scan_routes_on_the_card(dev, route):
    from snappy_tpu_torch.config import configure

    data = (load_corpus("alice29.txt") + load_corpus("fireworks.jpeg")) * 2 + b"tail" * 1000
    stream = native.frame_compress(data)
    for m in (crc32c, decode_flat, replay, records):
        m.launches = 0
    decode_flat.layout_launches[:] = [0, 0]
    for k in resolve.launches:
        resolve.launches[k] = 0
    with configure(**{route: True}):
        assert api.decompress_frame(stream) == data
        assert crc32c.launches >= 1 and replay.launches == 0 and resolve.launches["resolve"] == 0
        if route == "decode_resolve":
            assert resolve.launches["resolve_fh"] >= 1 and records.launches == 0
            assert decode_flat.layout_launches[1] == resolve.launches["resolve_fh"]
        else:
            assert records.launches >= 1 and decode_flat.launches == 0
            assert resolve.launches["resolve_fh"] == 0
        bad = bytearray(stream)
        bad[len(bad) // 2] ^= 0x5A
        with pytest.raises(Exception) as got:
            api.decompress_frame(bytes(bad))
    with pytest.raises(Exception) as want:
        native.frame_decompress(bytes(bad))
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)


#: The kernels each device leg of the campaign launches on these cases (legs 3
#: and 4 run tensor ops only).
LEG_KERNELS = {
    3: set(), 4: set(), 5: {"flat_gather_crc", "flat_gather[layout=0]", "flat_gather[layout=1]"},
    8: {"flat_gather[layout=0]"}, 9: {"records"}, 10: {"flat_gather[layout=1]"},
    11: {"parse", "shift_idx", "emit_bytes"},
    12: {"resolve_fh", "flat_gather[layout=1]"},
}


@pytest.mark.parametrize("leg,n", [(3, 30), (4, 4), (5, 20), (8, 30), (9, 30), (10, 4), (11, 16),
                                   (12, 8)])
def test_campaign_device_leg_on_the_card(dev, leg, n):
    """Each device leg of the differential campaign at a handful of cases:
    every row held to the oracle, on the kernels of its table."""
    from snappy_tpu_torch.tools import fuzz_campaign

    fields, ok = fuzz_campaign.run_leg(leg, n, cpu=False)
    assert ok, fields
    assert set(fields[f"leg{leg}_launches"]) == LEG_KERNELS[leg]


@pytest.mark.parametrize("timer", ["graph_ms", "event_ms"])
def test_timing_helpers_check_the_timed_calls(dev, timer):
    """``utils.profiling``'s device timers (``bench`` and ``chip_smoke.py``
    time with both): one reading per turn, and ``check`` sees the output of
    the last timed call, a graph's as its last replay left it."""
    from snappy_tpu_torch.ops.crc32c import crc32c_masked_blocks
    from snappy_tpu_torch.utils import profiling

    rng = np.random.default_rng(7)
    rows = torch.from_numpy(rng.integers(0, 256, (8, 4096), np.uint8)).to(dev)
    lens = torch.from_numpy(rng.integers(0, 4097, 8).astype(np.int32)).to(dev)
    want = crc32c_masked_blocks(rows, lens).cpu()
    seen = []
    ms = getattr(profiling, timer)(lambda: crc32c_masked_blocks(rows, lens), 4, turns=3,
                                   check=lambda out: seen.append(out.cpu()))
    assert len(ms) == 3 and all(t > 0 for t in ms)
    assert len(seen) == 1 and torch.equal(seen[0], want)


#: The host-against-card tools at small sizes, and the kernels each must launch.
TOOL_RUNS = {
    "crossover_measure": (["--sizes", "65536,1048576"],
                          {"flat_gather_crc", "flat_gather[layout=1]", "parse", "fused_emit"}),
    "flatten_scale": (["--threads", "1,all"], {"flat_gather[layout=1]", "resolve_fh"}),
    "scaling_measure": (["--ranks", "1", "--blocks", "8"], {"encode"}),
}


@pytest.mark.parametrize("name", list(TOOL_RUNS))
def test_host_against_card_tool_on_the_card(dev, name, tmp_path, monkeypatch, capsys):
    """Each tool of ``snappy_tpu_torch.tools`` that times the host against the
    card, on the card: every measured call checked, every rate a number, and
    its kernels launched."""
    import importlib
    import json

    from snappy_tpu_torch import tools

    tool = importlib.import_module(f"snappy_tpu_torch.tools.{name}")
    monkeypatch.setattr(tools, "OUT_DIR", tmp_path)
    if name == "scaling_measure":
        monkeypatch.setattr(tool, "WORK", tmp_path / "work")
    args, kernels = TOOL_RUNS[name]
    assert tool.main(args) == 0
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert out["ok"] and out["device_count"] >= 1 and out["card"] != "not measured"
    if name == "crossover_measure":
        for row in out["rows"]:
            assert all(isinstance(v, float) for k, v in row.items() if k.endswith("GBps"))
            assert kernels <= set(row["launches"])
    elif name == "flatten_scale":
        assert out["cores_to_feed_one_card"] > 0 and out["scan_cores_to_feed_one_card"] > 0
        assert kernels <= set(out["launches"])
    else:
        (run,) = out["runs"]
        assert run["backend"] == "nccl" and not run["shared_card"]
        assert kernels <= set(run["per_rank"][0]["launches"])


@pytest.mark.parametrize("views", ["records", "spans", "both"])
def test_a_traced_call_waits_only_in_its_resolve(dev, views, monkeypatch):
    """With the recorder (``snappy_tpu_torch.trace``) on, no part of a call
    synchronises: the only waits are the root's resolve of its device parts'
    events, after the call's own copy back, and every device part gets its
    seconds. The zeros
    make chunks of narrower bodies: three launch groups, which K2 decodes
    and checks in one launch, one device part."""
    data = ((load_corpus("alice29.txt") + load_corpus("fireworks.jpeg")) * 2 + bytes(100000)
            + b"tail" * 1000)
    stream = native.frame_compress(data)
    assert api.decompress_frame(stream) == data
    waits, resolving = [], [False]
    real_resolve, real_wait = trace._resolve, torch.cuda.Event.synchronize

    def resolve(pending):
        resolving[0] = True
        try:
            real_resolve(pending)
        finally:
            resolving[0] = False

    def event_wait(self):
        waits.append(("event", resolving[0]))
        return real_wait(self)

    monkeypatch.setattr(trace, "_resolve", resolve)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", event_wait)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: waits.append(("card", resolving[0])))
    monkeypatch.setattr(trace, "records", None if views == "spans" else [])
    monkeypatch.setattr(trace, "spans", None if views == "records" else {})
    assert api.decompress_frame(stream) == data
    assert waits and set(waits) == {("event", True)}
    if trace.records is not None:
        device = [r for r in trace.records if r["name"] == "kernels"]
        assert len(waits) == len(device) == 1
        assert all(0 < r["device_s"] < 1 for r in device)
    if trace.spans is not None:
        assert trace.spans["kernels"] > 0 and "decompress_frame" not in trace.spans


def test_traced_parts_fit_the_call_and_its_trace(dev, tmp_path):
    """With the records on under ``torch.profiler`` (host and card): the
    parts, a host part less its ``wait_s``, add up to no more than the call;
    the ``kernels`` parts' seconds hold the kernels the trace shows; and each
    root record, placed on the trace by its anchor, starts within 0.5 ms of
    its own range."""
    import json

    from torch.profiler import ProfilerActivity, profile

    data = (load_corpus("html_x_4") + load_corpus("fireworks.jpeg")) * 8
    stream = native.frame_compress(data)
    assert api.decompress_frame(stream) == data
    trace.records = []
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                assert api.decompress_frame(stream) == data
            torch.cuda.synchronize()
        recs = trace.records
    finally:
        trace.records = None
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    roots = sorted((r for r in recs if r["parent"] is None), key=lambda r: r["t0_ns"])
    ranges = sorted(float(e["ts"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] == "decompress_frame")
    assert len(roots) == len(ranges) == 3
    for root, ts in zip(roots, ranges):
        real, perf = root["anchor"]
        assert abs((real + root["t0_ns"] - perf - doc["baseTimeNanoseconds"]) / 1e3 - ts) < 500
        parts = [r for r in recs if r["call"] == root["id"] and r is not root]
        device = [r for r in parts if r["device_s"] is not None]
        assert device and all(r["wait_s"] >= 0 for r in parts)
        view = sum(r["device_s"] if r["device_s"] is not None
                   else (r["t1_ns"] - r["t0_ns"]) / 1e9 - r["wait_s"] for r in parts)
        # each device part placed from its queued event: at most a launch's latency late
        assert view <= (root["t1_ns"] - root["t0_ns"]) / 1e9 + 50e-6 * len(device)
    kernel_s = sum(float(e["dur"]) for e in events if e.get("cat") == "kernel") / 1e6
    assert sum(r["device_s"] for r in recs if r["name"] == "kernels") >= kernel_s
