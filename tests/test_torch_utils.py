"""The port's utilities: ``utils.profiling`` (``timed`` and
``device_trace`` over ``torch.profiler``) and ``utils.cpp_oracle``, the
ctypes binding to the system C++ libsnappy, which holds the port's exact
compress to Google's bytes, its fast profile to a stream Google's decoder
takes, and every decode route of the port to Google's streams (on the CPU,
the kernels' plain versions). Equality throughout."""

import glob
import io
import json

import pytest
import torch

import snappy_tpu_torch
from snappy_tpu_torch import native, trace
from snappy_tpu_torch.format.varint import write_varu64
from snappy_tpu_torch.ops import api
from snappy_tpu_torch.utils import cpp_oracle as cpp
from snappy_tpu_torch.utils.profiling import device_trace, timed
from torch_vectors import REPO, hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()


def corpus(name: str) -> bytes:
    return (REPO / "data" / name).read_bytes()


# tests/test_utils.py's ``timed`` case; the port keeps no ``Timer``: its
# spans are the port's recorder, ``snappy_tpu_torch.trace``
# (tests/test_torch_trace.py).


def test_timed_reports_throughput():
    out = io.StringIO()
    with timed("op", nbytes=10_000_000, out=out):
        pass
    s = out.getvalue()
    assert "op:" in s and "GB/s" in s
    out = io.StringIO()
    with timed("nothroughput", out=out):
        pass
    assert "GB/s" not in out.getvalue()


def test_timed_waits_for_the_card_when_it_is_in_use(monkeypatch):
    """Every card is synchronized before each clock read: a sharded entry's
    shards run on several."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: syncs.append(device))
    with timed("op", out=io.StringIO()):
        assert syncs == [0, 1]
    assert syncs == [0, 1, 0, 1]


def test_device_trace_writes_a_chrome_trace_naming_a_torch_op(tmp_path):
    a = torch.arange(4096, dtype=torch.float32)
    with device_trace(str(tmp_path / "trace")) as prof:
        (a * 3 + 1).sum()
    (path,) = glob.glob(str(tmp_path / "trace" / "trace.*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mul" in names and "aten::sum" in names
    assert any(e.key == "aten::mul" for e in prof.key_averages())


def test_device_trace_labels_the_api_spans(tmp_path):
    """Under a trace the recorder's spans are labelled ranges, so the host's
    gaps between launches carry the names ``trace.spans`` times."""
    data = corpus("html") * 2
    stream = native.frame_compress(data)
    assert trace.spans is None
    with device_trace(str(tmp_path)):
        assert snappy_tpu_torch.decompress_frame(stream, device="cpu") == data
    (path,) = glob.glob(str(tmp_path / "trace.*.json"))
    with open(path) as f:
        labels = {e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"}
    assert {"walk", "flatten", "h2d", "kernels", "d2h", "join"} <= labels


@pytest.fixture(scope="module")
def libsnappy():
    """The system libsnappy, or a skip (decided here, not at collection)."""
    if not cpp.available():
        pytest.skip("system libsnappy not available")
    return cpp


# libsnappy 1.1.9 compresses blocks of 500 to 16,383 bytes differently
# from the reference (tests/test_differential.py); every block here is
# outside that range.
EXACT = {
    "fireworks.jpeg": corpus("fireworks.jpeg"),
    "kppkn.gtb[:16500]": corpus("kppkn.gtb")[:16500],
    "geo.protodata[:16400]": corpus("geo.protodata")[:16400],
}


@pytest.mark.parametrize("name", sorted(EXACT))
def test_exact_compress_is_googles_bytes(libsnappy, name):
    data = EXACT[name]
    assert snappy_tpu_torch.compress(data, device="cpu") == libsnappy.compress(data)


def test_google_decodes_the_fast_profile(libsnappy):
    for name in ("html", "urls.10K", "fireworks.jpeg"):
        data = corpus(name)[:150000]
        comp = snappy_tpu_torch.compress(data, profile="fast", device="cpu")
        assert libsnappy.decompress(comp) == data
        assert libsnappy.uncompressed_length(comp) == len(data)


#: Each decode route's configuration and the route its launch groups take
#: on a frame of 64 KiB chunks.
ROUTES = {
    "flat": {},
    "resolve": {"decode_resolve": True},
    "records": {"decode_records": True},
    "replay": {"decode_flat": False},
    "parallel_hosted": {"decode_kernels": False},
    "parallel": {"pure_device": True},
}
DECODE_DATA = corpus("html") + corpus("urls.10K")[:100000] + corpus("fireworks.jpeg")[:30000]


def google_frame(data: bytes) -> bytes:
    """A frame stream whose chunks libsnappy compressed."""
    out = [b"\xff\x06\x00\x00sNaPpY"]
    for i in range(0, len(data), 65536):
        chunk = data[i : i + 65536]
        body = native.crc32c_masked(chunk).to_bytes(4, "little") + cpp.compress(chunk)
        out.append(b"\x00" + len(body).to_bytes(3, "little") + body)
    return b"".join(out)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_every_decode_route_decodes_googles_streams(libsnappy, monkeypatch, route):
    raw = libsnappy.compress(DECODE_DATA)
    frame = google_frame(DECODE_DATA)
    monkeypatch.setattr(api, "routes", [])
    with snappy_tpu_torch.configure(device="cpu", **ROUTES[route]):
        assert snappy_tpu_torch.decompress_frame(frame) == DECODE_DATA
        assert route in {r[2] for r in api.routes}
        assert snappy_tpu_torch.decompress(raw) == DECODE_DATA
        small = libsnappy.compress(DECODE_DATA[:300])
        assert snappy_tpu_torch.decompress(small) == DECODE_DATA[:300]
    assert len(raw) - len(write_varu64(len(DECODE_DATA))) > 65536  # a body past one block


def test_device_events_copies_and_overlap_from_a_trace_file(tmp_path):
    """The trace readers on a hand-made Chrome trace: two cards whose
    kernels overlap for 3 us, a card-to-card copy and a copy on one card
    among host-to-device copies, and host events they leave out."""
    from snappy_tpu_torch.utils.profiling import (
        cross_device_overlap_us, device_events, device_to_device_copies,
    )

    def ev(name, cat, dev, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": {"device": dev}}

    trace = {"traceEvents": [
        ev("k0", "kernel", 0, 0, 5), ev("k1", "kernel", 1, 2, 10), ev("k0b", "kernel", 0, 8, 1),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0, 0, 1),
        ev("Memcpy PtoP (Device -> Device)", "gpu_memcpy", 1, 20, 1),
        ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 0, 30, 1),
        ev("Memset (Device)", "gpu_memset", 0, 40, 1),
        {"ph": "X", "name": "aten::add", "cat": "cpu_op", "ts": 0, "dur": 50},
        {"ph": "i", "name": "marker", "cat": "kernel", "ts": 3},
    ]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    events = device_events(str(path))
    assert [e["name"] for e in events][:3] == ["k0", "k1", "k0b"] and len(events) == 7
    assert [e["name"][7:11] for e in device_to_device_copies(events)] == ["PtoP", "DtoD"]
    assert cross_device_overlap_us(events) == 4.0  # [2, 5) and [8, 9)
    assert cross_device_overlap_us(events, "gpu_memcpy") == 0.0
