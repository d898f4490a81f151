"""The port's flatten-scaling tool (``snappy_tpu_torch.tools.flatten_scale``)
on the CPU: its corpus batch is the JAX tool's (``tools/flatten_scale.py``)
byte for byte, it runs under ``--cpu`` with every field and every check,
a wrong row or a flagged host pass fails it, and without a card it
measures nothing."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_vectors import REPO, hold_jax_native, share_cores_with_workers

from snappy_tpu_torch import bench, tools
from snappy_tpu_torch.tools import flatten_scale as fs

share_cores_with_workers()
hold_jax_native()


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_flatten_scale",
                                                  REPO / "tools" / "flatten_scale.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_corpus_batch_equals_the_jax_tools():
    srcs, slens, declens = fs.corpus_batch()
    jsrcs, jslens, jdeclens = _jax_tool().corpus_batch()
    assert srcs.shape == jsrcs.shape == (49, 81920)
    for a, b in ((srcs, jsrcs), (slens, jslens), (declens, jdeclens)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture
def tool(monkeypatch, tmp_path):
    """The tool in this process, writing into ``tmp_path``, with every check
    it makes recorded by name."""
    monkeypatch.setattr(tools, "OUT_DIR", tmp_path)
    monkeypatch.setattr(fs, "REPS", 2)
    checks = []
    for name in ("_check_rows", "_check_zero"):
        real = getattr(bench, name)

        def record(*args, _real=real):
            checks.append(args[-1])
            return _real(*args)

        monkeypatch.setattr(bench, name, record)
    return checks


def _last(capsys) -> dict:
    return json.loads(capsys.readouterr().out.splitlines()[-1])


def test_runs_on_the_plain_versions_with_every_field_and_check(tool, tmp_path, capsys):
    assert fs.main(["--cpu", "--threads", "1,2,all"]) == 0
    out = _last(capsys)
    assert out == json.loads((tmp_path / "flatten_scale.json").read_text())
    assert out["ok"] and out["batch_blocks"] == 49 and out["launches"] == {}
    ncpu = len(os.sched_getaffinity(0))
    counts = sorted({1, 2, ncpu})
    assert list(out["threads"]) == list(out["scan_threads"]) == [str(t) for t in counts]
    for k in ("per_core_GBps", "scaling_1_to_4", "flatten_best_GBps", "scan_per_core_GBps",
              "scan_best_GBps", "device_GBps", "resolve_device_GBps", "cards_fed",
              "cores_to_feed_one_card", "scan_cards_fed", "scan_cores_to_feed_one_card"):
        assert out[k] == bench.NOT_MEASURED, k
    for t in out["threads"].values():
        assert t["GBps"] == bench.NOT_MEASURED and len(t["s"]) == 3 and t["s"][0] > 0
    assert {"cpu_count", "affinity_cpus", "card", "decode_bytes", "d_pad", "layout"} <= set(out)
    assert out["card"] == bench.NOT_MEASURED
    # Each thread count's passes (a warm call and REPS timed ones), then the
    # card's two paths, each checked.
    for t in counts:
        assert tool.count(f"host flatten at {t} threads") == 1 + fs.REPS
        assert tool.count(f"record scan at {t} threads") == 1 + fs.REPS
    assert "flat gather (K2)" in tool and "resolve route (K8, K2)" in tool


def test_default_thread_counts():
    ncpu = len(os.sched_getaffinity(0))
    assert fs.thread_counts(None) == [1, 2, 4, 8] + ([ncpu] if ncpu > 8 else [])
    assert fs.thread_counts("1,all") == sorted({1, ncpu})


def _wrong_row(monkeypatch, module, fn_name, flip):
    real = getattr(module, fn_name)

    def wrong(*args, **kwargs):
        return flip(real(*args, **kwargs))

    monkeypatch.setattr(module, fn_name, wrong)


def _flip_byte(dst):
    dst = dst.clone()
    dst[3, 10] ^= 1
    return dst


@pytest.mark.parametrize("fault,message", [
    ("k2", "flat gather (K2): 1 rows differ"),
    ("resolve", "resolve route (K8, K2): 1 rows differ"),
    ("flatten", "host flatten at 1 threads: rows [3] flagged"),
])
def test_a_wrong_row_fails_the_run(tool, monkeypatch, capsys, fault, message):
    from snappy_tpu_torch import native
    from snappy_tpu_torch.ops import decode_flat, resolve

    if fault == "k2":
        _wrong_row(monkeypatch, decode_flat, "decode_flat", _flip_byte)
    elif fault == "resolve":
        _wrong_row(monkeypatch, resolve, "decode_resolve_batch",
                   lambda res: (_flip_byte(res[0]), res[1]))
    else:
        def flag(res):
            res[3][3] = 1
            return res

        _wrong_row(monkeypatch, native, "flatten_idx_batch", flag)
    assert fs.main(["--cpu", "--threads", "1"]) == 1
    out = _last(capsys)
    assert not out["ok"] and message in out["failure"]


def test_without_a_card_it_measures_nothing():
    r = subprocess.run([sys.executable, "-m", "snappy_tpu_torch.tools.flatten_scale"], cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 1 and r.stdout == ""
    assert "no CUDA device" in r.stderr and "threads=" not in r.stderr
