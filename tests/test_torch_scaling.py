"""The port's scaling tool (``snappy_tpu_torch.tools.scaling_measure``) on
the CPU: one and two gloo ranks of two blocks each under ``--cpu``, every
field present and the ranks' file the host codec's stream (the JAX
package's host codec computes it here); a corrupted file fails the run;
the rank plan on one card and on four (a run on ranks that share a card is
marked and gives no efficiency); and without a card nothing runs."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_vectors import REPO, hold_jax_native, share_cores_with_workers

from snappy_tpu_torch import bench, tools
from snappy_tpu_torch.tools import scaling_measure as sm

share_cores_with_workers()
hold_jax_native()


@pytest.fixture
def tool(monkeypatch, tmp_path):
    monkeypatch.setattr(tools, "OUT_DIR", tmp_path)
    monkeypatch.setattr(sm, "WORK", tmp_path / "work")
    return tmp_path


def _last(capsys) -> dict:
    return json.loads(capsys.readouterr().out.splitlines()[-1])


def _jax_host_stream(ranks: int, n: int, block_bytes: int) -> bytes:
    from snappy_tpu import native as jnative
    from snappy_tpu.format.varint import read_varu64

    blocks, lens = sm.rank_blocks(ranks, n, block_bytes)
    out = b""
    for i in range(len(lens)):
        c = jnative.compress(blocks[i, : lens[i]].tobytes())
        out += c[read_varu64(c)[1]:]
    return out


RUN_FIELDS = {"ranks", "backend", "shared_card", "blocks_per_rank", "bytes_per_rank",
              "allgather_payload_bytes", "encode_s", "allgather_s", "write_s", "total_s",
              "stream_bytes", "stream_sha256", "per_rank"}
RANK_FIELDS = {"rank", "ranks", "cpus", "device", "backend", "join_s", "blocks_per_rank",
               "bytes_per_rank", "stream_bytes", "warmup_s", "encode_s", "allgather_s",
               "write_s", "total_s", "rounds", "launches"}


def test_one_and_two_gloo_ranks_write_the_host_codecs_stream(tool, capsys):
    import hashlib

    assert sm.main(["--cpu", "--ranks", "1,2", "--blocks", "2"]) == 0
    out = _last(capsys)
    assert out == json.loads((tool / "scaling_measure.json").read_text())
    assert out["ok"] and out["cards"] == 0 and out["block_bytes"] == sm.CPU_BLOCK_BYTES
    assert [(r["ranks"], r["backend"], r["shared_card"]) for r in out["runs"]] == [
        (1, "gloo", False), (2, "gloo", False)]
    assert out["efficiency"] == [{"blocks_per_rank": 2, "efficiency_1_to_2": bench.NOT_MEASURED,
                                  "efficiency_1_to_4": bench.NOT_MEASURED}]
    for run in out["runs"]:
        assert set(run) == RUN_FIELDS
        n = run["ranks"]
        assert run["allgather_payload_bytes"] == 4 * 2 * n
        want = _jax_host_stream(n, 2, sm.CPU_BLOCK_BYTES)
        assert run["stream_bytes"] == len(want)
        assert run["stream_sha256"] == hashlib.sha256(want).hexdigest()
        assert [r["rank"] for r in run["per_rank"]] == list(range(n))
        for r in run["per_rank"]:
            assert set(r) == RANK_FIELDS
            assert r["device"] == "cpu" and r["launches"] == {}
            assert all(len(v) == sm.ROUNDS for v in r["rounds"].values())
            assert r["total_s"] >= r["encode_s"] > 0
        # Each rank pinned to its own share of the affinity set.
        cpus = [set(r["cpus"]) for r in run["per_rank"]]
        if len(os.sched_getaffinity(0)) >= n:
            assert all(not (a & b) for i, a in enumerate(cpus) for b in cpus[i + 1:])
    assert not sm.WORK.exists()


def test_a_corrupted_file_fails_the_run(tool, monkeypatch, capsys):
    real = sm.run_config

    def corrupt(*args):
        out = real(*args)
        path = sm.WORK / "stream_2.bin"
        data = bytearray(path.read_bytes())
        data[100] ^= 1
        path.write_bytes(bytes(data))
        return out

    monkeypatch.setattr(sm, "run_config", corrupt)
    assert sm.main(["--cpu", "--ranks", "1", "--blocks", "2"]) == 1
    out = _last(capsys)
    assert not out["ok"]
    assert "differs from the host codec's stream at byte 100" in out["failure"]


def test_a_failing_rank_fails_the_run(tool, monkeypatch, capsys):
    real = sm.run_config
    monkeypatch.setattr(sm, "run_config", lambda r, b, *rest: real(r, "no-such-backend", *rest))
    assert sm.main(["--cpu", "--ranks", "2", "--blocks", "1"]) == 1
    assert "2 ranks (no-such-backend): exit codes [" in _last(capsys)["failure"]


def _fake_rank(n: int, total: float) -> dict:
    load = {"blocks_per_rank": n, "bytes_per_rank": n * 65536, "stream_bytes": 1, "warmup_s": 1.0,
            "encode_s": total, "allgather_s": 0.0, "write_s": 0.0, "total_s": total,
            "rounds": {}, "launches": {"encode": 4}}
    return {"rank": 0, "ranks": 1, "cpus": [0], "device": "cuda:0", "backend": "nccl",
            "join_s": 1.0, "loads": [load]}


@pytest.mark.parametrize("cards", [1, 4])
def test_the_rank_plan_and_efficiencies(monkeypatch, cards):
    """One card: one NCCL rank, then two gloo ranks sharing it (no
    efficiency); four cards: 1, 2 and 4 NCCL ranks, with both efficiencies."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    started = []

    def fake_run(ranks, backend, loads, block_bytes, cpu):
        started.append((ranks, backend, block_bytes, cpu))
        return [_fake_rank(loads[0], float(ranks)) for _ in range(ranks)]

    monkeypatch.setattr(sm, "run_config", fake_run)
    monkeypatch.setattr(sm, "check_stream", lambda *a: "sha")
    out = sm.measure(torch.device("cuda"), None, [8])
    if cards == 1:
        assert started == [(1, "nccl", 65536, False), (2, "gloo", 65536, False)]
        assert [r["shared_card"] for r in out["runs"]] == [False, True]
        assert out["efficiency"] == [{"blocks_per_rank": 8, "efficiency_1_to_2": None,
                                      "efficiency_1_to_4": None}]
    else:
        assert started == [(r, "nccl", 65536, False) for r in (1, 2, 4)]
        assert not any(r["shared_card"] for r in out["runs"])
        assert out["efficiency"] == [{"blocks_per_rank": 8, "efficiency_1_to_2": 0.5,
                                      "efficiency_1_to_4": 0.25}]


def test_rank_blocks_hold_the_jax_tools_input():
    """At 64 KiB blocks the ranks' input is the JAX tool's: ``lcet10.txt``
    then ``plrabn12.txt``, four times over, cut to the world's blocks."""
    text = b"".join((REPO / "data" / f).read_bytes() for f in ("lcet10.txt", "plrabn12.txt"))
    blocks, lens = sm.rank_blocks(2, 8)
    want = (text * 4)[: 2 * 8 * 65536]
    assert blocks.shape == (16, 65536) and (lens == 65536).all()
    assert blocks.tobytes() == want
    small, slens = sm.rank_blocks(2, 2, 2048)
    assert (slens == 2048).all() and not small[:, 2048:].any()
    assert np.concatenate([small[i, :2048] for i in range(4)]).tobytes() == text[: 4 * 2048]


def test_without_a_card_nothing_runs():
    r = subprocess.run([sys.executable, "-m", "snappy_tpu_torch.tools.scaling_measure"],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 1 and r.stdout == ""
    assert "no CUDA device" in r.stderr and "ranks" not in r.stderr
