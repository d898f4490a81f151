"""The port's crossover tool (``snappy_tpu_torch.tools.crossover_measure``)
on the CPU: its input is the JAX tool's (``tools/crossover_measure.py``)
byte for byte, it runs under ``--cpu`` at 64 KiB and 256 KiB with every
field and every check, a wrong row or stream fails it, a crossover is the
first size where the card wins or ``None``, and without a card it measures
nothing."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from torch_vectors import REPO, hold_jax_native, share_cores_with_workers

from snappy_tpu_torch import bench, tools
from snappy_tpu_torch.tools import crossover_measure as cm

share_cores_with_workers()
hold_jax_native()


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_crossover_measure",
                                                  REPO / "tools" / "crossover_measure.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("size", [1 << 16, 1 << 20, (1 << 21) + 3, 1 << 26])
def test_make_input_equals_the_jax_tools(size):
    got = cm.make_input(size)
    assert len(got) == size and got == _jax_tool().make_input(size)


@pytest.fixture
def tool(monkeypatch, tmp_path):
    """The tool in this process, writing into ``tmp_path``, with every check
    it makes recorded by name."""
    monkeypatch.setattr(tools, "OUT_DIR", tmp_path)
    checks = []
    for name in ("_check_rows", "_check_zero", "_check_compressed"):
        real = getattr(bench, name)

        def record(*args, _real=real):
            checks.append(args[-1])
            return _real(*args)

        monkeypatch.setattr(bench, name, record)
    return checks


def _last(capsys) -> dict:
    return json.loads(capsys.readouterr().out.splitlines()[-1])


ROW_FIELDS = [
    "bytes", "blocks", "enc_host_GBps", "enc_host_s", "dec_host_GBps", "dec_host_s",
    "dec_flatten_host_s", "dec_device_GBps", "dec_e2e_GBps", "dec_launches",
    "dec_device_peak_bytes", "enc_device_GBps", "enc_launches", "enc_device_peak_bytes",
    "dec_call_GBps", "dec_call_s", "dec_frame_host_GBps", "dec_frame_host_s", "dec_call_peak_bytes",
    "enc_call_GBps", "enc_call_s", "enc_call_host_GBps", "enc_call_host_s", "enc_call_peak_bytes",
    "launches",
]


def test_runs_on_the_plain_versions_with_every_field_and_check(tool, tmp_path, capsys):
    assert cm.main(["--cpu", "--sizes", "65536,262144"]) == 0
    out = _last(capsys)
    assert out == json.loads((tmp_path / "crossover_measure.json").read_text())
    assert out["ok"] and [r["bytes"] for r in out["rows"]] == [65536, 262144]
    for row, blocks in zip(out["rows"], (1, 4)):
        assert sorted(row) == sorted(ROW_FIELDS)
        assert row["blocks"] == blocks and row["dec_launches"] == row["enc_launches"] == 1
        for k, v in row.items():
            if k.endswith(("GBps", "peak_bytes")):
                assert v == bench.NOT_MEASURED, k
            elif k.endswith("_s"):
                assert len(v) == 3 and v[0] > 0, k
        assert row["launches"] == {}  # the CPU launches no kernel
    for k in ("decode_crossover_bytes", "encode_crossover_bytes", "decode_call_crossover_bytes",
              "encode_call_crossover_bytes"):
        assert out[k] == bench.NOT_MEASURED
    # Each size: the host batch calls, the flatten, K2's pass, the encoder's
    # (each with its overflow flags), a warm and a timed call each.
    for what in ("host batch compress", "host batch decompress", "host flatten",
                 "flat gather (K2)", "flat encoder (K4, K5)",
                 "flat encoder (K4, K5) (overflow flags)"):
        assert what in tool, what
    assert tool.count("host flatten") == 2 * 2  # a warm call and one timed, at each size


@pytest.mark.parametrize("fault,message", [
    ("k2", "flat gather (K2): 1 rows differ"),
    ("encoder", "flat encoder (K4, K5): row 0 does not decode to its block"),
    ("decompress_frame", "decompress_frame (K2 with its checksum): the output differs from the input"),
    ("compress", "compress(profile='fast') (K4, K5): the output differs from the input"),
])
def test_a_wrong_row_fails_the_run(tool, monkeypatch, capsys, fault, message):
    from snappy_tpu_torch.ops import api, decode_flat, encode_flat

    def wrap(module, name, flip):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, **k: flip(real(*a, **k)))

    def flip_row(t):
        t = t.clone()
        t[0, 10] ^= 1
        return t

    if fault == "k2":
        wrap(decode_flat, "decode_flat", flip_row)
    elif fault == "encoder":
        wrap(encode_flat, "compress_blocks_flat_fast", lambda r: (flip_row(r[0]), *r[1:]))
    elif fault == "decompress_frame":
        wrap(api, "decompress_frame", lambda b: b[:100] + bytes([b[100] ^ 1]) + b[101:])
    else:
        from snappy_tpu_torch import native

        wrap(api, "compress", lambda c: native.compress(native.decompress(c)[:-1] + b"?"))
    assert cm.main(["--cpu", "--sizes", "65536"]) == 1
    out = _last(capsys)
    assert not out["ok"] and message in out["failure"], out["failure"]


def test_a_crossover_is_the_first_size_the_card_wins():
    rows = [{"bytes": 1, "card": 0.5, "host": 1.0}, {"bytes": 2, "card": 2.0, "host": 1.0},
            {"bytes": 3, "card": 0.5, "host": 1.0}]
    assert cm._first_win(rows, "card", "host") == 2
    assert cm._first_win(rows[:1] + rows[2:], "card", "host") is None


def test_without_a_card_it_measures_nothing():
    r = subprocess.run([sys.executable, "-m", "snappy_tpu_torch.tools.crossover_measure"],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 1 and r.stdout == ""
    assert "no CUDA device" in r.stderr and "bytes=" not in r.stderr
