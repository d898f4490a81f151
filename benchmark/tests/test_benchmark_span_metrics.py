"""``idle_unspanned_pct.read`` on a hand-made trace, and the nine per-layer
readers that came before it, each on one fixed outcome."""

from __future__ import annotations

import pytest

from benchmark import run, trace
from benchmark.harness import Outcome

KIND = "NVIDIA H100 80GB HBM3"


def _x(name, cat, ts, dur, **extra):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, **extra}


def _range(name, ts, dur):
    return _x(name, "user_annotation", ts, dur)


def test_idle_with_only_the_root_open_over_idle_in_the_program():
    events = [
        _range(trace.WINDOW, 1000, 1000),
        _range(trace.CALL, 1000, 900),
        _range("decompress_frame", 1050, 800),
        _range("walk", 1050, 100),  # 1150-1200: only the root is open
        _range("flatten", 1200, 300),
        _range("h2d", 1500, 100),
        _x("Memcpy HtoD", "gpu_memcpy", 1520, 60, args={"device": 0}),
        _range("kernels", 1600, 50),  # the kernel runs on past the range
        _x("flat_kernel", "kernel", 1640, 100, args={"device": 0}),
        _range("join", 1740, 110),
    ]
    r = trace.reduce_events(events)
    idle = r["idle"]
    assert idle["decompress_frame"] == pytest.approx(50e-6)  # 1150-1200
    assert idle[trace.CALL] == pytest.approx(100e-6)  # 1000-1050, 1850-1900
    assert idle[trace.OUTSIDE] == pytest.approx(100e-6)
    inside = 100 + 300 + 40 + 40 + 110 + 50  # walk, flatten, h2d, kernels, join; the root
    got = run.read_metric("idle_unspanned_pct.read", Outcome(layer={"trace": r}))
    assert got == pytest.approx(100.0 * 50 / inside)


def test_idle_unspanned_is_left_out_without_an_entrys_range():
    events = [_range(trace.WINDOW, 0, 100), _range(trace.CALL, 0, 100), _range("flatten", 0, 50),
              _x("k", "kernel", 60, 10, args={"device": 0})]
    o = Outcome(layer={"trace": trace.reduce_events(events)})
    assert run.read_metric("idle_unspanned_pct.read", o) is None
    assert run.read_metric("idle_unspanned_pct.read", Outcome()) is None


def _fixed() -> Outcome:
    spans = [{"walk": 0.001, "pack": 0.002, "flatten": 0.010, "h2d": 0.003, "d2h": 0.001,
              "kernels": 0.0005, "unpack": 0.004, "join": 0.002, "stored_crc": 0.0001},
             {"walk": 0.001, "pack": 0.002, "flatten": 0.012, "h2d": 0.003, "d2h": 0.001,
              "kernels": 0.0007, "unpack": 0.004, "join": 0.002, "stored_crc": 0.0001}]
    tr = {"window_s": 1e-3, "busy_s": 2.1e-4, "kernel_s": 1e-5,
          "cards": {"0": {"busy_s": 2.1e-4, "kernel_s": 1e-5}},
          "idle": {"decompress_frame": 2e-5, "flatten": 6e-5, trace.CALL: 1e-5,
                   trace.OUTSIDE: 5e-5}}
    return Outcome(bytes_done=48_000_000, window_s=0.12, latencies_s=[0.010] * 95 + [0.050] * 5,
                   cpu_s=6.0, device={"kind": KIND},
                   layer={"spans": spans, "trace": tr, "need_bytes": 16_750_000})


@pytest.mark.parametrize("name,value", [
    ("decode_GBps.window", 0.4),
    ("call_p95_ms.window", 12.0),
    ("host_cpu_s_per_GB.window", 125.0),
    ("host_bytes_ms.read", 9.1),
    ("flatten_ms.read", 11.0),
    ("copy_ms.read", 4.0),
    ("kernel_ms.read", 0.6),
    ("kernels_roofline.read", 50.0),
    ("device_idle_pct.read", 79.0),
    ("idle_unspanned_pct.read", 25.0),
])
def test_each_per_layer_reader_on_a_fixed_outcome(name, value):
    assert run.read_metric(name, _fixed()) == pytest.approx(value)
