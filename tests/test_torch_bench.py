"""The port's benchmark (``snappy_tpu_torch.bench``) on the CPU: its corpus
inputs are ``bench.py``'s byte for byte, every stage runs under ``--cpu`` on
the kernels' plain versions and checks every row, the host table has
``bench.py``'s rows, and the parent kills a stage past its deadline, fails
the run when a stage fails, and refuses to start without a card."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_vectors import REPO, hold_jax_native, share_cores_with_workers

from snappy_tpu_torch import bench

share_cores_with_workers()
hold_jax_native()


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_corpus_inputs_equal_the_jax_bench():
    jb = _jax_bench()
    blocks, lens = bench._load_corpus_blocks(2)
    jblocks, jlens = jb._load_corpus_blocks(2)
    assert blocks.shape == (98, 65536) and np.array_equal(blocks, jblocks)
    assert np.array_equal(lens, jlens) and lens.dtype == jlens.dtype
    srcs, slens = bench._compressed_rows(blocks[:49], lens[:49])
    jsrcs, jslens = jb._compressed_rows(jblocks[:49], jlens[:49])
    assert np.array_equal(srcs, jsrcs) and np.array_equal(slens, jslens)


STAGE_FIELDS = {
    "canary": ["platform", "card", "canary_compile_s", "canary_tflops", "canary_hbm_gbps",
               "canary_roundtrip_ms"],
    "decode16": [f"decode16_{f}" for f in (
        "bytes", "GBps", "s", "compile_s", "hybrid_GBps", "pallas_GBps", "records_GBps",
        "flat_host_s", "flat_host_GBps", "device_route", "device_compile_s", "device_GBps",
        "e2e_GBps", "e2e_serial_GBps", "peak_bytes")],
    "decode": ["batch_blocks", "decode_GBps", "decode_hybrid_GBps", "decode_pallas_GBps",
               "decode_records_GBps", "decode_device_GBps", "decode_e2e_GBps",
               "decode_resolve_scan_host_s", "decode_resolve_device_GBps",
               "decode_resolve_e2e_GBps", "decode_resolve_chips_fed", "decode_peak_bytes"],
    "crc": ["crc32c_GBps", "crc32c_s", "crc_compile_s", "crc32c_device_GBps", "crc_peak_bytes"],
    "encode": ["compress_GBps", "encode_compile_s", "compress_device_blocks",
               "compress_flat_compile_s", "compress_device_GBps", "compress_flat_device_GBps",
               "encode_peak_bytes"],
    "sharded": ["sharded_devices", "sharded_decode_xla_1dev_GBps", "sharded_decode_xla_ndev_GBps",
                "sharded_xla_speedup", "sharded_decode_hosted_1dev_GBps",
                "sharded_decode_1dev_GBps", "sharded_decode_ndev_GBps", "sharded_speedup",
                "sharded_decode_route"],
}


@pytest.mark.parametrize("stage", bench.STAGES)
def test_stage_runs_on_the_plain_versions(stage):
    fields = bench._unmeasured(bench.STAGE_FNS[stage](True))
    assert set(STAGE_FIELDS[stage]) <= set(fields)
    # A rate taken on the CPU is no rate of the card.
    for k, v in fields.items():
        if k.endswith(("GBps", "gbps", "tflops", "speedup", "chips_fed")):
            assert v == bench.NOT_MEASURED, k
    if stage.startswith("decode"):
        assert fields[f"{stage}_bytes"] == int(bench._load_corpus_blocks(1)[1][:16].sum())
    if stage == "sharded":
        assert fields["sharded_devices"] == 4


def test_a_wrong_row_fails_the_stage(monkeypatch):
    from snappy_tpu_torch.ops import replay

    real = replay.decode_replay

    def one_byte_off(srcs, src_lens, declens, d_pad):
        dst, errs = real(srcs, src_lens, declens, d_pad)
        dst[5, 100] ^= 1
        return dst, errs

    monkeypatch.setattr(replay, "decode_replay", one_byte_off)
    with pytest.raises(AssertionError, match=r"replay decode \(K3\): 1 rows differ .* \[5\]"):
        bench._stage_decode(16, True)


def test_host_table_has_the_jax_benchs_rows(monkeypatch):
    monkeypatch.setattr(bench, "HOST_BYTES", 100_000)
    out = bench._host_table()
    rows = out["host_native_per_file"]
    assert [r["bench"] for r in rows] == [f"zflat{i:02d}/uflat{i:02d}" for i in range(12)]
    assert rows[3]["file"] == "fireworks.jpeg[..200]" and rows[3]["bytes"] == 200
    assert all(r["compress_MBps"] > 0 and r["decompress_MBps"] > 0 for r in rows)
    assert {"host_memcpy_gbps", "host_crc32c_gbps", "cpp"} <= set(out)


def test_headline_is_the_device_stage_rate():
    acc = {"decode_device_GBps": 2.5, "decode_device_route": "flat_gather", "decode_e2e_GBps": 0.5}
    line = bench.headline(acc)
    assert line["value"] == 2.5 and line["headline_path"] == "flat_gather"
    assert line["decode_e2e_GBps"] == 0.5 and "failures" not in line
    cpu = bench.headline({"decode_device_GBps": bench.NOT_MEASURED})
    assert cpu["value"] is None


def _bench(*args, env):
    return subprocess.run([sys.executable, "-m", "snappy_tpu_torch.bench", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300, env={**os.environ, **env})


def test_a_stage_past_its_deadline_is_killed_and_fails_the_run(monkeypatch, capsys):
    monkeypatch.setattr(bench, "BUDGETS_S", dict.fromkeys(bench.STAGES, 0.05))
    assert bench.main(["--cpu"]) == 1
    last = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert last["failures"] == [
        f"stage {s} overran its 0s deadline and was killed" for s in bench.STAGES]
    assert last["value"] is None
    assert json.loads(bench.PARTIAL_PATH.read_text())["failures"] == last["failures"]


def test_without_a_card_the_benchmark_runs_no_stage():
    r = _bench(env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 1 and r.stdout == ""
    assert "no CUDA device" in r.stderr and "stage" not in r.stderr
