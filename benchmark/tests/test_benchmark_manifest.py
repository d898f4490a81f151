"""``BENCHMARK.json`` against the files it names and the contract's forms,
and the imports of every module under ``benchmark/``."""

from __future__ import annotations

import ast
import json
import re

import pytest

from benchmark import run, traffic
from benchmark.harness import FORBIDDEN

ROOT = traffic.ROOT
HERE = traffic.HERE
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["paths"] == ["benchmark"] and 1 <= M["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_by_name(w):
    cell, config = run.lookup(w["name"])
    (conf,) = [c for c in M["configs"] if c["name"] == w["config"]]
    assert conf["file"] == f"benchmark/configs/{w['config']}.json"
    assert cell["name"] == w["name"] and cell["config"] == w["config"]
    assert (HERE / "drivers" / f"{cell['driver']}.py").exists()
    assert config["name"] == w["config"] and config["chips"] == w["chips"]
    for n in config["corpus"]:
        assert (HERE / "corpus" / n).exists()
    for x in run.metrics_of(w["name"], False, M) + run.metrics_of(w["name"], True, M):
        assert (HERE / "metrics" / f"{x['name']}.py").exists()
    assert {x["name"] for x in run.metrics_of(w["name"], False, M)} >= {"setup_s"}
    assert len(run.metrics_of(w["name"], False, M)) >= 2
    assert run.metrics_of(w["name"], True, M)


def test_names_units_and_entries_take_the_allowed_forms():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    names = [x["name"] for x in METRICS]
    assert len(set(names)) == len(names)
    e2e = {x["name"] for x in M["end_to_end"]}
    for x in METRICS:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    for x in M["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert x["source"] in ("host_clock", "device_trace") and 0.01 <= x["bound"] <= 0.25
    for x in M["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert x["moves"] in e2e and x["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        if "_roofline" in x["name"]:  # <kernel>_roofline, a share of it
            assert x["unit"] == "%" and x["source"] == "device_trace"
        for w in x.get("workloads", []):  # each cell listed reports what it moves
            assert x["moves"] in {m["name"] for m in run.metrics_of(w, False, M)}
    for path in HERE.rglob("*"):
        rel = str(path.relative_to(ROOT))
        if "__pycache__" not in rel:
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_every_configuration_has_a_cell():
    assert {c["name"] for c in M["configs"]} == {w["config"] for w in M["workloads"]}


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")) + [HERE / "traffic.py"],
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert "snappy_tpu_torch" not in tops and not tops & set(FORBIDDEN)
