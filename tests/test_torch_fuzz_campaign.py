"""The port's differential campaign (``snappy_tpu_torch.tools.fuzz_campaign``)
against the JAX campaign (``tools/fuzz_campaign.py``): at the same ``n`` and
seed each of legs 1-7 gives the JAX leg's counts (the device legs on the
kernels' plain versions, on the CPU), and the runner reports every leg, a
device leg without a card, and the case a leg diverged on.

Legs 8-12 (the kernel legs, whose JAX side runs Pallas in interpret mode)
are in ``test_torch_fuzz_kernel_legs.py``."""

import json
import os
import subprocess
import sys

import pytest
import torch

from torch_vectors import REPO, hold_jax_native, jax_campaign_leg, share_cores_with_workers

from snappy_tpu_torch.tools import fuzz_campaign as fc

share_cores_with_workers()
hold_jax_native()

CPU = torch.device("cpu")


@pytest.mark.parametrize("leg,n", [(1, 300), (2, 300), (3, 60), (4, 2), (5, 16), (6, 16), (7, 16)])
def test_leg_gives_the_jax_legs_counts(leg, n):
    want = jax_campaign_leg(leg, n)
    got = fc.LEGS[leg](n, CPU)
    assert {k: got[k] for k in want} == want
    # The cases hold rejects (or, leg 1, divergences from libsnappy), so the
    # agreement covers both sides.
    assert any(v for k, v in want.items() if k.endswith(("_rejected", "_flagged", "_with_errors",
                                                        "_classes", "_blocks")))


def test_leg3_takes_the_hosted_tensor_route():
    got = fc.leg3(12, CPU)
    assert list(got["leg3_routes"]) == ["parallel_hosted"]


def _campaign(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "snappy_tpu_torch.tools.fuzz_campaign", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300, env={**os.environ, **(env or {})},
    )


def test_campaign_runs_each_leg_in_its_own_process():
    r = _campaign("0", "8", "8", "--legs", "2,3", "--cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [json.loads(ln) for ln in r.stdout.splitlines()]
    assert sorted(ln["progress"] for ln in lines[:-1]) == ["leg2 done", "leg3 done"]
    last = lines[-1]
    assert last["ok"] and last["failed_legs"] == []
    assert last["leg2_cases"] == last["leg3_cases"] == 8
    assert last["leg2_launches"] == last["leg3_launches"] == {}  # the CPU launches no kernel
    assert last["leg3_s"] > 0


def test_device_legs_fail_without_a_card_and_host_legs_still_run():
    r = _campaign("0", "8", "8", "--legs", "2,3", env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 1
    last = json.loads(r.stdout.splitlines()[-1])
    assert last["leg2_cases"] == 8 and not last["ok"] and last["failed_legs"] == [3]
    assert "no CUDA device" in last["leg3_failure"]
    assert last["leg3_cases_at_fault"] is None  # it failed before its first case
    assert "leg3_cases" not in last


def test_a_divergence_names_its_leg_and_case(monkeypatch):
    from snappy_tpu_torch.ops import api

    real = api.decompress_frame
    calls = []

    def second_call_wrong(stream, device=None):
        # Case 1 is not mutated, so its stream is valid.
        calls.append(1)
        out = real(stream, device)
        return out + b"!" if len(calls) == 2 else out

    monkeypatch.setattr(api, "decompress_frame", second_call_wrong)
    seen = []
    fields, ok = fc.run_leg(5, 16, cpu=True, report=lambda lo, hi, cases: seen.append((lo, hi)))
    assert not ok
    assert fields["leg5_cases_at_fault"] == [1, 2] and seen[-1] == (1, 2)
    assert fields["leg5_failure"].startswith("Divergence: leg5 case 1")


def test_a_decode_leg_fault_names_its_launch_group(monkeypatch):
    """Legs 3, 8, 9 and 10 decode launch group by launch group, the groups
    ``decompress_streams`` makes of the whole batch, so a fault in one
    names that group's cases."""
    import numpy as np

    from snappy_tpu_torch.ops import api

    n = 24
    bodies, _ = fc._bodies(np.random.default_rng(0xCAFE + fc.SEED_OFFSET), n,
                           lambda r: fc.gen_input(r)[:8000])
    groups = api.launch_groups(bodies, 512)
    assert len(groups) >= 3
    real = api.decompress_streams
    calls = []

    def faults_in_the_second_group(group, declens, *a, **k):
        calls.append(group)
        if len(calls) == 2:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real(group, declens, *a, **k)

    monkeypatch.setattr(api, "decompress_streams", faults_in_the_second_group)
    fields, ok = fc.run_leg(3, n, cpu=True)
    assert not ok and fields["leg3_failure"].startswith("RuntimeError: CUDA error")
    assert fields["leg3_group_at_fault"] == groups[1]
    assert calls[1] == [bodies[i] for i in groups[1]]
    assert fields["leg3_cases_at_fault"] == [min(groups[1]), max(groups[1]) + 1]
