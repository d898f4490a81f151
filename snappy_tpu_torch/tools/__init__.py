"""Offline programs of the port that are not part of the library:
``fuzz_campaign``, the randomized differential campaign, and three
measurements of the host against the card, each the port of the
repository's ``tools/`` program of the same name:

- ``flatten_scale``: the host flatten and the host record scan against
  their threads, beside the card's rate on the same batch (K2, the resolve
  route): how many host cores keep one card busy;
- ``crossover_measure``: the host codec against the card's routes by
  input size, 64 KiB to 64 MiB: from what size the card wins;
- ``scaling_measure``: weak scaling of the multi-process exact compress
  (``parallel.multihost``) over ranks, stage by stage.

The three measurements share :func:`run`: without a card and without
``--cpu`` they exit 1 before their first measurement; every measured call
is checked and a failed check fails the run; progress goes to stderr, the
result to ``build/snappy_tpu_torch/<name>.json`` and, as the last line, to
stdout. Each carries the card's ``nvidia-smi`` line and the host's cores.
"""

from __future__ import annotations

import json
import os
import sys
import time
import traceback
from pathlib import Path

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "snappy_tpu_torch"

#: Key endings of the fields a ``--cpu`` run writes as not measured: rates,
#: and what is derived from rates.
_RATES = ("GBps", "cards_fed", "cores_to_feed_one_card", "crossover_bytes", "scaling_1_to_4",
          "efficiency_1_to_2", "efficiency_1_to_4")


def log(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", file=sys.stderr, flush=True)


def unmeasured(obj):
    """``obj`` with every rate, at any depth, written as not measured: a
    ``--cpu`` run checks the paths on the kernels' plain versions, and a
    rate taken there is no rate of the card."""
    from ..bench import NOT_MEASURED

    if isinstance(obj, dict):
        return {k: NOT_MEASURED if k.endswith(_RATES) else unmeasured(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [unmeasured(v) for v in obj]
    return obj


def run(name: str, measure, cpu: bool) -> int:
    """Run ``measure(dev)`` on the card (the CPU under ``cpu``) and report it.

    Returns 1 without a card and without ``cpu``, before ``measure``
    starts, and 1 when ``measure`` raises: a failed check, a failed call or
    a failed worker. The result carries the tool's ``ok``, its ``failure``
    when it failed, the card and the host's cores, and ``seconds``."""
    from ..bench import NOT_MEASURED, _card_line, _device

    try:
        dev = _device(cpu)
    except RuntimeError as e:
        log(name, str(e))
        return 1
    on_card = dev.type == "cuda"
    out = {
        "tool": f"snappy_tpu_torch.tools.{name}",
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "card": _card_line() if on_card else NOT_MEASURED,
        "device_count": 0,
        "cpu_count": os.cpu_count(),
        "affinity_cpus": len(os.sched_getaffinity(0)),
    }
    if on_card:
        import torch

        out["device_count"] = torch.cuda.device_count()
        out["device_name"] = torch.cuda.get_device_name(dev)
    t0 = time.perf_counter()
    try:
        out.update(measure(dev))
        out["ok"] = True
    except Exception as e:  # the tool's boundary: reported, and the run fails
        traceback.print_exc()
        out["ok"] = False
        out["failure"] = f"{type(e).__name__}: {e}"
    out["seconds"] = time.perf_counter() - t0
    if not on_card:
        out = unmeasured(out)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"{name}.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1
