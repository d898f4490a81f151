"""The check that decides ``correct`` fails what it must fail.

On the CPU, at sizes a test run holds, each cell runs end to end (the
look for a card skipped, the kernels' plain versions in the port's place):
sound, it comes out correct; with each fault that the cell can have
planted under its timed path (``faults.py``), or with its control in the
program's place, it comes out not correct.

On the card (``-m gpu``), each cell's control runs at the cell's own
size on three seeds and must come out not correct; the readings print.
"""

from __future__ import annotations

import json

import pytest

from benchmark import run

READ_SMALL = {"config": {"corpus": ["alice29.txt", "fireworks.jpeg", "html"]},
              "traffic": {"call_bytes": 300000, "pool_min_calls": 2, "pool_min_input_bytes": 0},
              "params": {"check_calls": 2, "trace_calls": 1}}

CASES = [
    ("frame-read.16m", None, True), ("frame-read.16m", "alter", False),
    ("frame-read.16m", "half", False), ("frame-read.16m", "control", False),
]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("cache")


@pytest.mark.parametrize("cell,fault,correct", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f, _ in CASES])
def test_the_check_catches_each_fault_and_the_control(cell, fault, correct, cache):
    outcome, result = run.run_cell(
        cell, 2**31 + 12345, 0.5, False, device="cpu", overrides=READ_SMALL, cache_dir=cache,
        fault=None if fault == "control" else fault, control=fault == "control")
    assert result["correct"] is correct, result["checks"]
    assert list(result)[-1] == "checks"
    if correct:
        assert all(c["value"] == 0 for c in result["checks"].values())


def test_the_traced_run_checks_alike(cache):
    outcome, result = run.run_cell("frame-read.16m", 77, 0.5, True, device="cpu",
                                   overrides=READ_SMALL, cache_dir=cache, fault="alter")
    assert result["correct"] is False
    outcome, result = run.run_cell("frame-read.16m", 77, 0.5, True, device="cpu",
                                   overrides=READ_SMALL, cache_dir=cache)
    assert result["correct"] is True
    assert {"host_bytes_ms.read", "flatten_ms.read", "kernel_ms.read", "decode_GBps.window",
            "call_p95_ms.window", "host_cpu_s_per_GB.window"} <= set(result["metrics"])


@pytest.fixture
def cards():
    """The cards of this machine; skips without enough of them."""
    torch = pytest.importorskip("torch")

    def need(n):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            pytest.skip(f"needs {n} CUDA card(s), this machine has {have}")
    return need


CONTROL_SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["frame-read.16m"])
def test_control_fails_at_the_cells_size(cell, cards):
    _, config = run.lookup(cell)
    cards(config["chips"])
    for seed in CONTROL_SEEDS:
        _, result = run.run_cell(cell, seed, 3, False, control=True,
                                 overrides={"params": {"warm_calls": 1}})
        print(json.dumps({"cell": cell, "seed": seed, "control": True,
                          "checks": result["checks"], "attempted": result["attempted"]}))
        assert result["correct"] is False
