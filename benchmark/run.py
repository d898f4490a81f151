"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell and its configuration are files found by name, its metrics
are listed in ``BENCHMARK.json``; the cell's file names its driver, which makes the
inputs from the seed, warms up, and runs the window (``--trace 0``: the
cell's end-to-end metrics) or the traced run (``--trace 1``: its
per-layer metrics). Each metric is read from the run by
``metrics/<name>.py``. The last line of stdout is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
``busy_s`` and ``window_s`` when traced), ``breakdown`` when traced, and
last ``checks``: each number compared with its limit, which also end
stderr. Without enough cards, with JAX or the JAX package loaded once the
calls are done, or without the port, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path

from . import harness, trace
from .traffic import CACHE

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def lookup(name: str) -> tuple[dict, dict]:
    """``(cell file, configuration file)`` of cell ``name``, each found by
    its name: ``cells/<name>.json`` and ``configs/<its config>.json``."""
    cell = json.loads((HERE / "cells" / f"{name}.json").read_text())
    return cell, json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())


def metrics_of(name: str, trace_on: bool, m: dict | None = None) -> list[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end ones, or
    with ``trace_on`` its per-layer ones."""
    m = m or manifest()
    e2e = [x for x in m["end_to_end"] if name in x.get("workloads", [name])]
    if not trace_on:
        return e2e
    moved = {x["name"] for x in e2e}
    return [x for x in m["per_layer"]
            if name in x.get("workloads", ()) or ("workloads" not in x and x["moves"] in moved)]


def read_metric(name: str, outcome: harness.Outcome):
    """``metrics/<name>.py``'s reading of the run, or ``None``."""
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "__"), HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(outcome)


def run_cell(name: str, seed: int, seconds: float, trace_on: bool, *, device: str = "cuda",
             fault: str | None = None, control: bool = False, overrides: dict | None = None,
             cache_dir: Path | None = None) -> tuple[harness.Outcome, dict]:
    """Run cell ``name`` once: returns the outcome and the result object.
    ``overrides`` replaces keys of the cell's ``traffic`` and ``params``
    and of the configuration (the tests' small sizes)."""
    m = manifest()
    cell, config = lookup(name)
    for key in ("traffic", "params"):
        cell[key] = {**cell[key], **(overrides or {}).get(key, {})}
    config = {**config, **(overrides or {}).get("config", {})}
    ctx = harness.Context(name=name, seed=seed, seconds=seconds, trace=trace_on, cell=cell,
                          config=config, device=device, fault=fault, control=control,
                          cache_dir=cache_dir or CACHE)
    outcome = importlib.import_module(f"benchmark.drivers.{cell['driver']}").run(ctx)
    values = {}
    for x in metrics_of(name, trace_on, m):
        v = read_metric(x["name"], outcome)
        if v is not None:
            values[x["name"]] = {"value": v, "unit": x["unit"]}
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": values, "device": dict(outcome.device)}
    tr = outcome.layer.get("trace")
    if trace_on and tr:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": [[k[:120], v] for k, v in trace.top(tr["device_ops"])],
                               "idle_gaps": trace.top(tr["idle"])}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return outcome, result


def _cards_or_exit(chips: int) -> None:
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s), this machine has {have}",
              file=sys.stderr)
        sys.exit(3)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # The port reads its settings from SNAPPY_TPU_* at every call: the
    # configuration runs the defaults, so none may steer it.
    for k in [k for k in os.environ if k.startswith("SNAPPY_TPU_")]:
        del os.environ[k]
    _, config = lookup(args.workload)
    _cards_or_exit(int(config["chips"]))
    # Whatever the port or a library prints goes to stderr: the result is
    # the last line of stdout.
    stdout = os.dup(1)
    os.dup2(2, 1)
    try:
        outcome, result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    finally:
        sys.stdout.flush()
        os.dup2(stdout, 1)
        os.close(stdout)
    found = harness.forbidden_loaded()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
