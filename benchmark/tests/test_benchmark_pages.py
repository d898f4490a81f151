"""The page-read cell (``pages-read.rowgroup``): its row groups, its plain
reference, its checks, its reader of ``api.routes`` and the per-layer
metrics it reports.

On the CPU, at sizes a test run holds, with the kernels' plain versions
in the port's place: every seed gets the same pages in its own order;
each page is its chunks' op streams after one preamble and decodes to
them; the row group of the configuration stops before its compressed
bytes would pass 128 MiB; ``pad_pct.pages``' arithmetic; the checks
``pages_off_card`` and ``errors_unreported`` fail where they must; the
cell reports every per-layer metric of the layers it runs; and the new
modules load neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from benchmark import routes, row_groups, run, traffic
from benchmark.harness import Outcome
from benchmark.reference import pages as ref_pages
from benchmark.reference import snappy as ref

KIND = "NVIDIA H100 80GB HBM3"
CELL = "pages-read.rowgroup"
SMALL = {"config": {"corpus": ["alice29.txt", "fireworks.jpeg", "html"], "page_chunks": 2,
                    "row_group_bytes": 300000, "pages": 4},
         "traffic": {"pool_min_calls": 2, "pool_min_input_bytes": 0},
         "params": {"check_calls": 2, "trace_calls": 1}}


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("cache")


@pytest.fixture(scope="module")
def small(cache):
    config = {**run.lookup(CELL)[1], **SMALL["config"]}
    corpus = traffic.load_corpus(config, cache)
    return config, corpus, row_groups.layout(corpus, config)


def test_every_seed_gets_the_same_pages_in_its_own_order(small):
    config, corpus, pages = small
    t = {"pool_min_calls": 3}
    a, b, c = (row_groups.pool(corpus, pages, t, s) for s in (2**40 + 7, 2**40 + 7, -3))
    assert [i.bodies for i in a] == [i.bodies for i in b]
    for item in a + c:
        assert sorted(item.pages) == sorted(pages)
        assert item.raw_bytes == a[0].raw_bytes and item.in_bytes == a[0].in_bytes
    assert len({tuple(map(tuple, i.pages)) for i in a + c}) > 1
    # each row group holds streams of its own, as read from its own column chunks
    assert a[0].bodies[0] is not a[1].bodies[a[1].pages.index(a[0].pages[0])]


def test_each_page_is_its_chunks_streams_and_decodes_to_them(small):
    config, corpus, pages = small
    item = row_groups.pool(corpus, pages, {"pool_min_calls": 1}, 5)[0]
    for body, n, page in zip(item.bodies, item.declens, item.pages):
        raw = row_groups.page_raw(corpus, page)
        stream = ref.varint(n) + b"".join(row_groups.ops(corpus.chunks[i]) for i in page)
        assert stream == ref.varint(n) + body == ref.compress(raw)
        assert ref.decompress(stream) == raw and n == 65536 * len(page)
    assert ref_pages.decode_pages(item.bodies, item.declens) == (
        [row_groups.page_raw(corpus, p) for p in item.pages], [ref_pages.OK] * len(pages))
    assert b"".join(row_groups.page_raw(corpus, p) for p in item.pages) == row_groups.expected(
        corpus, item)


def test_the_row_group_stops_before_128_mib(cache):
    """The configuration's row group: 265 pages of 15 chunks, under
    134,217,728 compressed bytes, which the next page, however cut, would
    pass."""
    config = run.lookup(CELL)[1]
    corpus = traffic.load_corpus(config, cache)
    pages = row_groups.layout(corpus, config)
    assert len(pages) == config["pages"] == 265 and {len(p) for p in pages} == {15}
    op_len = [len(row_groups.ops(c)) for c in corpus.chunks]
    size = sum(ref_pages.stream_bytes(65536 * len(p), sum(op_len[i] for i in p)) for p in pages)
    col = row_groups.columns(corpus)[len(pages) % len(config["corpus"])]
    nxt = col[len(pages) // len(config["corpus"]) * 15 % len(col)]
    assert size <= config["row_group_bytes"] < size + ref_pages.stream_bytes(65536, op_len[nxt])
    item = row_groups.pool(corpus, pages, {"pool_min_calls": 1}, 1)[0]
    assert (item.in_bytes, item.raw_bytes) == (134194862, 260505600)
    with pytest.raises(ValueError, match="265 pages"):
        row_groups.layout(corpus, {**config, "pages": 264})


def test_a_broken_copy_fails_every_decoder_whatever_the_draw(small):
    config, corpus, pages = small
    item = row_groups.pool(corpus, pages, {"pool_min_calls": 1}, 9)[0]
    for draw in (0, 1, 7, 2**29 + 3, 2**30 - 1):
        bad = ref_pages.break_copy(item.bodies[0], draw)
        assert len(bad) == len(item.bodies[0]) and bad != item.bodies[0]
        assert ref_pages.decode_pages([bad], item.declens[:1])[1] == [ref_pages.BAD]


def _outcome(calls, kernel_s=0.0):
    return Outcome(layer={"routes": calls, "trace": {"kernel_s": kernel_s}}, device={"kind": KIND})


def test_pad_pct_and_off_card_on_made_up_entries():
    calls = [(10, [(4, 1 << 20, "flat", 1 << 19, 1_500_000, 3_900_000),
                   (5, 1 << 20, "flat", 1 << 18, 1_000_000, 4_900_000),
                   (1, 1 << 21, "host", 1 << 20, 600_000, 1_100_000)]),
             (3, [(3, 1 << 19, "replay", 1 << 17, 300_000, 1_400_000)])]
    o = _outcome(calls, kernel_s=0.004)
    placed = 4 * (2**19 + 2**20) + 5 * (2**18 + 2**20) + 3 * (2**17 + 2**19)
    live = 1_500_000 + 3_900_000 + 1_000_000 + 4_900_000 + 300_000 + 1_400_000
    assert run.read_metric("pad_pct.pages", o) == pytest.approx(100 * (placed - live) / placed)
    assert routes.off_card(calls) == 1


def test_pad_pct_reads_nothing_from_three_field_entries():
    """The parent lists ``(rows, d_pad, route)`` a group: nothing to read."""
    three = [(265, [(72, 1 << 20, "flat"), (48, 1 << 20, "flat"), (145, 1 << 20, "flat")])]
    assert run.read_metric("pad_pct.pages", _outcome(three, kernel_s=0.5)) is None
    assert run.read_metric("pad_pct.pages", Outcome()) is None
    assert routes.off_card(three) == 0 and routes.off_card([(265, three[0][1][:2])]) == 145


CASES = [(None, {}, True), ("alter", {}, False), ("half", {}, False), ("control", {}, False),
         ("host", {"config": {"port": {"max_dpad": 16384}}}, False)]


@pytest.mark.parametrize("fault,extra,correct", CASES, ids=[c[0] or "sound" for c in CASES])
def test_the_checks_catch_each_fault_and_the_control(cache, fault, extra, correct):
    over = {k: {**SMALL[k], **extra.get(k, {})} for k in SMALL}
    _, result = run.run_cell(CELL, 2**31 + 12345, 0.3, False, device="cpu", overrides=over,
                             cache_dir=cache, fault=fault if fault in ("alter", "half") else None,
                             control=fault == "control")
    checks = {k: c["value"] for k, c in result["checks"].items()}
    assert result["correct"] is correct, checks
    assert list(result)[-1] == "checks" and {"pages_off_card", "errors_unreported"} <= set(checks)
    if fault == "control":  # reports no error: the two bad pages go unreported
        assert checks["errors_unreported"] == 2 and checks["mismatched_bytes"] == 0
    if fault == "half":  # every second page comes back empty
        assert checks["errors_unreported"] > 0
    if fault == "host":  # every page of every call, warm-up included, on the host codec
        warm = run.lookup(CELL)[0]["params"]["warm_calls"]
        assert checks["pages_off_card"] == (warm + result["attempted"]) * SMALL["config"]["pages"]
        assert checks["errors_unreported"] == 0


def test_errors_unreported_catches_a_decoder_that_drops_one_code(cache, monkeypatch):
    """A port that loses the code of the first bad page of a call."""
    from snappy_tpu_torch.ops import api

    decode = api.decompress_streams

    def drops_one(*a, **k):
        outs, errs, crcs = decode(*a, **k)
        errs[np.flatnonzero(errs)[:1]] = 0
        return outs, errs, crcs

    monkeypatch.setattr(api, "decompress_streams", drops_one)
    _, result = run.run_cell(CELL, 41, 0.3, False, device="cpu", overrides=SMALL, cache_dir=cache)
    assert result["checks"]["errors_unreported"]["value"] == 1 and result["correct"] is False


#: The per-layer metrics of the cell that a run on the CPU reads: the
#: others read the card's trace.
ON_CPU = ["decode_GBps.window", "call_p95_ms.window", "host_cpu_s_per_GB.window",
          "host_bytes_ms.read", "flatten_ms.read", "copy_ms.read", "pad_pct.pages"]


def test_the_cell_reports_every_layer_it_runs():
    names = [x["name"] for x in run.metrics_of(CELL, True)]
    assert names == [x["name"] for x in run.metrics_of("frame-read.16m", True)] + [
        "pad_pct.pages"]


@pytest.fixture(scope="module")
def traced(cache):
    return run.run_cell(CELL, 77, 0.3, True, device="cpu", overrides=SMALL, cache_dir=cache)


@pytest.mark.parametrize("name", ON_CPU)
def test_the_traced_run_reports_the_layers_on_the_cpu(traced, name):
    outcome, result = traced
    assert result["correct"] is True
    assert result["metrics"][name]["value"] > 0
    if name == "pad_pct.pages":
        assert result["metrics"][name]["value"] < 100


def test_the_traced_runs_roofline_counts_the_card_groups_live_bytes(traced):
    """``kernels_roofline.read``'s bytes, the pages in and out, are the live
    bytes that the profiled calls' card groups list."""
    outcome, _ = traced
    live = sum(r[4] + r[5] for _, rs in outcome.layer["routes"] for r in rs)
    assert outcome.layer["need_bytes"] == live > 0


def test_the_new_modules_load_neither_jax_nor_the_jax_package():
    mods = ["benchmark.row_groups", "benchmark.routes", "benchmark.reference.pages",
            "benchmark.drivers.pages_read"]
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=traffic.ROOT)
    tops = set(json.loads(out.stdout.splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "snappy_tpu"}
    code = "import benchmark.reference.pages, sys; print('snappy_tpu_torch' in sys.modules)"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=traffic.ROOT)
    assert out.stdout.split()[-1] == "False"


@pytest.mark.gpu
def test_control_fails_at_the_cells_size():
    """On the card, at the cell's own size: the control (the port with its
    codes dropped) comes out not correct on two seeds."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for seed in (2**31 + 101, 2**31 + 202):
        _, result = run.run_cell(CELL, seed, 3, False, control=True,
                                 overrides={"params": {"warm_calls": 1}})
        print(json.dumps({"cell": CELL, "seed": seed, "control": True,
                          "checks": result["checks"], "attempted": result["attempted"]}))
        assert result["correct"] is False
