"""The metric arithmetic on made-up readings: rates over the whole window,
the card's rate over its kernels' time, the tail over every call, CPU per
GB, the roofline's bytes, and the trace's reduction to busy, kernel and
idle time."""

from __future__ import annotations

import pytest

from benchmark import run, stats, traffic, trace
from benchmark.harness import Outcome, mismatched, sample
from benchmark.reference import snappy as ref

KIND = "NVIDIA H100 80GB HBM3"


def test_rate_is_all_the_work_over_all_the_time():
    o = Outcome(bytes_done=3 * 16_000_000, window_s=0.12)
    assert run.read_metric("decode_GBps.window", o) == pytest.approx(0.4)
    assert stats.rate_gbps(0, 1.0) is None


def test_card_rate_is_all_the_work_over_all_its_kernels_time():
    events = [_x("flat_kernel", "kernel", 0, 100), _x("crc_kernel", "kernel", 150, 60),
              _x("Memcpy HtoD", "gpu_memcpy", 300, 500),
              _x("cudaLaunchKernel", "cuda_runtime", 0, 9),
              {"ph": "i", "name": "mark", "cat": "kernel", "ts": 5}]
    assert trace.kernel_seconds(events) == pytest.approx(160e-6)
    o = Outcome(bytes_done=3 * 16_000_000, window_s=0.12, kernel_s=160e-6)
    assert run.read_metric("kernel_decode_GBps", o) == pytest.approx(48e6 / 160e-6 / 1e9)
    assert run.read_metric("kernel_decode_GBps", Outcome(bytes_done=1)) is None


def test_p95_is_over_every_call():
    lat = [0.010] * 95 + [0.050] * 5
    o = Outcome(latencies_s=lat)
    # the 95th percentile of 100 values, interpolated: 0.95 of the way from rank 95 to 96
    assert run.read_metric("call_p95_ms.window", o) == pytest.approx(10 + 0.05 * 40)
    assert stats.p95([0.3]) == 0.3 and stats.p95([]) is None


def test_cpu_seconds_per_gb():
    o = Outcome(cpu_s=6.0, bytes_done=2_000_000_000)
    assert run.read_metric("host_cpu_s_per_GB.window", o) == pytest.approx(3.0)


def test_setup_is_left_out_when_not_measured():
    assert run.read_metric("setup_s", Outcome()) is None
    assert run.read_metric("setup_s", Outcome(setup_s=9.5)) == 9.5


def test_span_readers_take_the_mean_call():
    spans = [{"walk": 0.001, "pack": 0.002, "flatten": 0.010, "h2d": 0.003, "d2h": 0.001,
              "kernels": 0.0005, "unpack": 0.004, "join": 0.002, "stored_crc": 0.0001},
             {"walk": 0.001, "pack": 0.002, "flatten": 0.012, "h2d": 0.003, "d2h": 0.001,
              "kernels": 0.0007, "unpack": 0.004, "join": 0.002, "stored_crc": 0.0001}]
    o = Outcome(layer={"spans": spans})
    assert run.read_metric("host_bytes_ms.read", o) == pytest.approx(9.1)
    assert run.read_metric("flatten_ms.read", o) == pytest.approx(11.0)
    assert run.read_metric("copy_ms.read", o) == pytest.approx(4.0)
    assert run.read_metric("kernel_ms.read", o) == pytest.approx(0.6)
    assert run.read_metric("flatten_ms.read", Outcome(layer={"spans": [{"pack": 1.0}]})) is None


def test_roofline_counts_the_codecs_bytes_in_and_out(tmp_path):
    """A read needs its stream's bytes in and its data's bytes out, whatever
    a kernel reads again; the share is the least time at 3.35 TB/s over the
    kernels' time."""
    corpus = traffic.load_corpus({"corpus": ["html"], "chunk_bytes": 65536}, tmp_path)
    (item,) = traffic.frame_pool(corpus, {"call_bytes": 0, "pool_min_calls": 1}, 1)
    stream = item.data
    out = ref.frame_decode(stream)
    assert item.in_bytes == len(stream) and item.raw_bytes == len(out) == 102400
    need = item.in_bytes + len(out)
    o = Outcome(device={"kind": KIND}, layer={"need_bytes": need, "trace": {"kernel_s": 1e-5}})
    assert run.read_metric("kernels_roofline.read", o) == pytest.approx(
        100 * need / 3.35e12 / 1e-5)
    assert run.read_metric("kernels_roofline.read", Outcome(
        device={"kind": "some other card"}, layer=o.layer)) is None
    assert run.read_metric("kernels_roofline.read", Outcome(device={"kind": KIND})) is None


def _x(name, cat, ts, dur, **extra):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, **extra}


def test_trace_reduction():
    events = [
        _x(trace.WINDOW, "user_annotation", 1000, 1000),
        _x("flatten", "user_annotation", 1000, 400),
        _x("h2d", "user_annotation", 1400, 100),
        _x("Memcpy HtoD", "gpu_memcpy", 1420, 60, args={"device": 0}),
        _x("flat_kernel", "kernel", 1500, 100, args={"device": 0}),
        _x("crc_kernel", "kernel", 1550, 100, args={"device": 0}),  # overlaps the first
        _x("join", "user_annotation", 1700, 300),
        _x("outside", "kernel", 2500, 100, args={"device": 0}),  # after the window
    ]
    r = trace.reduce_events(events)
    assert r["window_s"] == pytest.approx(1e-3)
    assert r["busy_s"] == pytest.approx(60e-6 + 150e-6)
    assert r["kernel_s"] == pytest.approx(200e-6)
    assert r["device_ops"]["flat_kernel"] == pytest.approx(100e-6)
    assert "outside" not in r["device_ops"]
    idle = r["idle"]
    assert idle["flatten"] == pytest.approx(400e-6)
    assert idle["h2d"] == pytest.approx(40e-6)  # 1400-1420 and 1480-1500
    assert idle["join"] == pytest.approx(300e-6)
    assert idle[trace.OUTSIDE] == pytest.approx(50e-6)  # 1650-1700: no range open
    assert sum(idle.values()) == pytest.approx(r["window_s"] - r["busy_s"])
    o = Outcome(layer={"trace": r})
    assert run.read_metric("device_idle_pct.read", o) == pytest.approx(79.0)
    assert trace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]
    assert trace.reduce_events([]) == {}


def test_mismatched_counts_every_byte_wrong_or_missing():
    assert mismatched(b"abcd", b"abcd") == 0
    assert mismatched(b"abXd", b"abcd") == 1
    assert mismatched(b"ab", b"abcd") == 2
    assert mismatched(None, b"abcd") == 4


def test_sample_is_drawn_from_the_seed():
    a, b = sample(5, 300, 12), sample(5, 300, 12)
    assert a == b and 12 <= len([i for i in a if i < 300]) <= 13
    assert any(sample(s, 300, 12) != a for s in range(6, 12))
