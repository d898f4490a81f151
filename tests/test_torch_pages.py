"""Parquet row groups of raw Snappy pages through the port's batched raw
decode (``ops.api.decompress_streams``) on the CPU, the kernels' plain
versions: every page byte for byte what the plain page reference
(``benchmark/reference/pages.py``) decodes, a bad page reported by its
code alone (the JAX package's code, the other pages its bytes), and what
``api.routes`` and the ``host_decode`` part count of each launch group.

Row groups are laid out as parquet-mr fills them (``reference/pages.py``
``row_group``), at small sizes: pages of 1-5 whole 64 KiB chunks of a few
corpus files, 6-12 pages, the last one cut, and seeded pages of random
bytes beside them, some incompressible, some repetitive.
"""

import numpy as np
import pytest

from benchmark import row_groups, traffic
from benchmark.reference import pages as ref_pages
from benchmark.reference import snappy as ref
from snappy_tpu.ops import api as japi
from snappy_tpu_torch import trace
from snappy_tpu_torch.config import configure
from snappy_tpu_torch.ops import api
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

CONFIG = {"corpus": ["alice29.txt", "fireworks.jpeg", "html", "kppkn.gtb"], "chunk_bytes": 65536}
SEEDS = [2**31 + 7, 11, 2**40 + 3, 5, 97, 2**33 + 1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return traffic.load_corpus(CONFIG, tmp_path_factory.mktemp("pages-cache"))


def _row_group(corpus, seed: int) -> row_groups.RowGroup:
    """6-12 pages of 1-5 chunks, then one cut to the whole chunks that fit
    (none where the first does not), in a seeded order. Page ``j`` is
    column ``j mod 4``'s next ``k`` chunks, cycled."""
    rng = np.random.default_rng(seed)
    k, want = int(rng.integers(1, 6)), int(rng.integers(6, 13))
    cols = row_groups.columns(corpus)
    op_len = [len(row_groups.ops(c)) for c in corpus.chunks]
    full = [[cols[j % len(cols)][(j // len(cols) * k + t) % len(cols[j % len(cols)])]
             for t in range(k)] for j in range(want + 1)]
    size = [ref_pages.stream_bytes(k * 65536, sum(op_len[i] for i in p)) for p in full]
    cap = sum(size[:want]) + int(rng.uniform(0.1, 0.9) * size[want])
    pages = ref_pages.row_group(cols, op_len, 65536, k, cap)
    assert pages[:want] == full[:want] and len(pages) in (want, want + 1)
    assert all(p == full[want][: len(p)] for p in pages[want:])
    return row_groups.pool(corpus, pages, {"pool_min_calls": 1}, seed)[0]


def _random_pages(seed: int) -> tuple[list[bytes], list[int]]:
    """Pages of random bytes, of repeated short runs, and of both mixed."""
    rng = np.random.default_rng(seed + 1)
    datas = []
    for kind in ("incompressible", "repetitive", "mixed"):
        n = int(rng.integers(1, 150000))
        noise = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        run = rng.integers(0, 256, int(rng.integers(1, 40)), dtype=np.uint8).tobytes()
        rep = (run * (n // len(run) + 1))[:n]
        mixed = bytes(a if i % 3000 < 1500 else b for i, (a, b) in enumerate(zip(noise, rep)))
        datas.append({"incompressible": noise, "repetitive": rep, "mixed": mixed}[kind])
    return [ref.compress(d)[len(ref.varint(len(d))):] for d in datas], [len(d) for d in datas]


def _decode(bodies, declens, **cfg):
    with configure(device="cpu", **cfg):
        return api.decompress_streams(bodies, declens)


@pytest.mark.parametrize("seed", SEEDS)
def test_row_group_pages_match_the_reference(corpus, seed):
    item = _row_group(corpus, seed)
    extra, extra_len = _random_pages(seed)
    bodies, declens = item.bodies + extra, item.declens + extra_len
    outs, errs, crcs = _decode(bodies, declens)
    want, codes = ref_pages.decode_pages(bodies, declens)
    assert crcs is None and not errs.any() and codes == [ref_pages.OK] * len(bodies)
    assert outs == want
    assert b"".join(outs[: len(item.pages)]) == row_groups.expected(corpus, item)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_a_bad_page_is_reported_alone(corpus, seed):
    """One page with a copy's offset past the bytes decoded before it, one
    with its declared length longer than its stream gives: a nonzero code
    at those two pages, the reference's verdict and the JAX package's
    codes, and the others exact."""
    item = _row_group(corpus, seed)
    rng = np.random.default_rng(seed)
    bad_copy, bad_len = (int(j) for j in rng.choice(len(item.bodies), 2, replace=False))
    bodies, declens = list(item.bodies), list(item.declens)
    bodies[bad_copy] = ref_pages.break_copy(bodies[bad_copy], int(rng.integers(1 << 30)))
    declens[bad_len] += 1 + int(rng.integers(4096))
    outs, errs, _ = _decode(bodies, declens)
    _, codes = ref_pages.decode_pages(bodies, declens)
    assert [j for j, c in enumerate(codes) if c != ref_pages.OK] == sorted((bad_copy, bad_len))
    assert [j for j, e in enumerate(errs) if e != 0] == sorted((bad_copy, bad_len))
    jouts, jerrs, _ = japi.decompress_streams(bodies, declens)
    np.testing.assert_array_equal(errs, jerrs)
    for j, page in enumerate(item.pages):
        if j not in (bad_copy, bad_len):
            assert outs[j] == jouts[j] == row_groups.page_raw(corpus, page)


def _routes(bodies, declens, **cfg):
    api.routes = []
    try:
        outs, errs, _ = _decode(bodies, declens, **cfg)
        return outs, errs, api.routes
    finally:
        api.routes = None


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_routes_list_each_groups_width_and_live_bytes(corpus, seed):
    item = _row_group(corpus, seed)
    outs, errs, rts = _routes(item.bodies, item.declens)
    assert not errs.any() and b"".join(outs) == row_groups.expected(corpus, item)
    groups = api.launch_groups(item.bodies, 512)
    assert len(rts) == len(groups)
    for (rows, d_pad, route, width, live_in, live_out), g in zip(rts, groups):
        assert route == "flat" and rows == len(g)
        assert width == api._width_bucket(len(item.bodies[g[0]]))
        assert d_pad == max(1024, 1 << (max(item.declens[i] for i in g) - 1).bit_length())
        assert live_in == sum(len(item.bodies[i]) for i in g)
        assert live_out == sum(item.declens[i] for i in g)
    assert sum(r[0] for r in rts) == len(item.bodies)


def test_a_group_past_max_dpad_enters_as_host(corpus):
    """Under a ``max_dpad`` below the pages' outputs every group turns down
    to the host codec: each enters ``routes`` as ``"host"`` with its
    fields, and decodes as on the card routes, bad pages included."""
    item = _row_group(corpus, SEEDS[0])
    bodies, declens = list(item.bodies), list(item.declens)
    declens[1] += 1
    outs, errs, rts = _routes(bodies, declens, max_dpad=16384)
    assert [j for j, e in enumerate(errs) if e != 0] == [1]
    assert {r[2] for r in rts} == {"host"} and sum(r[0] for r in rts) == len(bodies)
    assert sum(r[4] for r in rts) == sum(map(len, bodies))
    assert sum(r[5] for r in rts) == sum(declens)
    assert [o for j, o in enumerate(outs) if j != 1] == [
        row_groups.page_raw(corpus, p) for j, p in enumerate(item.pages) if j != 1]


def test_host_decode_counts_its_bytes(corpus, monkeypatch):
    """The ``host_decode`` part's bytes are its group's declared outputs;
    the spans view names it."""
    item = _row_group(corpus, SEEDS[1])
    monkeypatch.setattr(trace, "records", [])
    monkeypatch.setattr(trace, "spans", {})
    outs, errs, rts = _routes(item.bodies, item.declens, max_dpad=16384)
    assert not errs.any() and b"".join(outs) == row_groups.expected(corpus, item)
    parts = [r for r in trace.records if r["name"] == "host_decode"]
    assert [p["bytes"] for p in parts] == [r[5] for r in rts]
    assert sum(p["bytes"] for p in parts) == item.raw_bytes and trace.spans["host_decode"] > 0
