"""The port's two record-scan decode routes, ``Config.decode_resolve`` and
``Config.decode_records``, equal the JAX package's decode on the CPU (the
kernels' plain versions): error codes of every row, bytes and CRCs of every
row that decodes, the frame and raw entry points and their errors. Spies on
``ops.api`` show which route each launch group took, with the JAX package's
precedence and fall-through."""

import io

import numpy as np
import pytest

from conftest import load_corpus
from snappy_tpu.ops import api as japi
from snappy_tpu_torch import native, read, trace
from snappy_tpu_torch.config import configure
from snappy_tpu_torch.format.varint import write_varu64
from snappy_tpu_torch.ops import api
from torch_vectors import CORRUPT, hold_jax_native, raw_body, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

ROUTES = ["resolve", "records"]


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """Run the test under one route, recording each launch group's route."""
    monkeypatch.setattr(api, "routes", [])
    with configure(device="cpu", **{f"decode_{request.param}": True}):
        yield request.param


def outcome(fn, data: bytes):
    try:
        return ("ok", fn(data))
    except Exception as e:  # the comparison is the test
        return (type(e).__name__, getattr(e, "_values", lambda: None)(), str(e))


def test_decompress_streams_matches_jax_package(route):
    datas = [load_corpus("html")[:65536], load_corpus("alice29.txt")[:65536],
             load_corpus("kppkn.gtb")[:65536], load_corpus("urls.10K")[:20000],
             b"xyz" * 3000, bytes(np.random.default_rng(3).integers(0, 256, 777, dtype=np.uint8))]
    rows = [raw_body(d) for d in datas] + CORRUPT
    bodies, declens = [r[0] for r in rows], [r[1] for r in rows]
    got = api.decompress_streams(bodies, declens, with_crc=True)
    want = japi.decompress_streams(bodies, declens, with_crc=True)
    np.testing.assert_array_equal(got[1], want[1])
    ok = np.nonzero(want[1] == 0)[0]
    assert len(ok) == len(datas) and (want[1][len(datas):] != 0).all()
    np.testing.assert_array_equal(got[2][ok], want[2][ok])
    assert [got[0][i] for i in ok] == [want[0][i] for i in ok] == datas
    assert {r[2] for r in api.routes} <= {route, "flat"} and route in {r[2] for r in api.routes}


def test_decompress_frame_and_reader_match_the_host_codec(route):
    data = (load_corpus("html") + load_corpus("fireworks.jpeg")[:70000]
            + load_corpus("kppkn.gtb")[:80000] + bytes(65536) + b"tail" * 99)
    stream = native.frame_compress(data)
    assert api.decompress_frame(stream) == native.frame_decompress(stream) == data
    assert read.FrameDecoder(io.BytesIO(stream), engine="device").read() == data
    assert {r[2] for r in api.routes} == {route}


@pytest.mark.parametrize("mutation", [
    lambda s: s[:60] + bytes([s[60] ^ 0x5A]) + s[61:],  # inside the first body
    lambda s: s[:11] + bytes([s[11] ^ 0x40]) + s[12:],  # the first CRC
    lambda s: s[:-3],
], ids=["body-flip", "crc-flip", "truncated"])
def test_corrupted_frame_raises_as_the_jax_package(route, mutation):
    stream = mutation(native.frame_compress(load_corpus("asyoulik.txt")[:100000]))
    got = outcome(api.decompress_frame, stream)
    assert got[0] != "ok"
    assert got == outcome(japi.decompress_frame, stream) == outcome(native.frame_decompress, stream)


def test_wide_raw_stream(route, monkeypatch):
    """102,400 bytes in one row at ``d_pad`` 131072: past the resolve
    route's 64 KiB, so that route falls through to the flat route; the
    records route replays it (6,934 records, within the 16 Ki cap)."""
    monkeypatch.setattr(trace, "spans", {})
    data = load_corpus("html")
    stream = native.compress(data)
    assert api.decompress(stream) == data
    body = len(stream) - len(write_varu64(len(data)))
    assert api.routes == [(1, 1 << 17, "flat" if route == "resolve" else "records",
                           api._width_bucket(body), body, len(data))]
    assert "scan" in trace.spans if route == "records" else "flatten" in trace.spans


def _spy(monkeypatch):
    calls = []
    for name in ("decode_flat_groups", "decode_replay", "decode_records", "decode_resolve_batch"):
        fn = getattr(api, name)
        monkeypatch.setattr(api, name, lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    return calls


def test_record_cap_overflow(route, monkeypatch):
    """20,000 one-byte literals: a 40,000-byte body scans to more records
    than its 64 KiB row's cap of 16,384. The records route sends the group
    to K3, the resolve route to the flat route."""
    body = b"".join(bytes([0, 97 + i % 26]) for i in range(20000))
    data = bytes(97 + i % 26 for i in range(20000))
    calls = _spy(monkeypatch)
    assert api.decompress(write_varu64(len(data)) + body) == data
    want = "decode_replay" if route == "records" else "decode_flat_groups"
    assert calls == [want]
    assert api.routes == [(1, 32768, "replay" if route == "records" else "flat", 65536,
                           len(body), len(data))]


def test_a_flagged_group_falls_through_whole(route, monkeypatch):
    """A row with no record beside a clean one: the resolve route flags the
    row (its chains never resolve), so the whole group takes the flat route
    and the flat route's codes; the records route replays both."""
    calls = _spy(monkeypatch)
    text = b"hello world, " * 800  # a 16 KiB output: the resolve route's width
    bodies, declens = [b"\x61", raw_body(text)[0]], [3, len(text)]
    outs, errs, _ = api.decompress_streams(bodies, declens)
    assert errs[0] != 0 and errs[1] == 0 and outs[1] == text
    np.testing.assert_array_equal(errs, japi.decompress_streams(bodies, declens)[1])
    group = (2, 16384, "flat" if route == "resolve" else "records",
             api._width_bucket(len(bodies[1])), sum(map(len, bodies)), sum(declens))
    if route == "resolve":
        assert calls == ["decode_resolve_batch", "decode_flat_groups"]
    else:
        assert calls == ["decode_records"]
    assert api.routes == [group]
