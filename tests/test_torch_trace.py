"""The port's span recorder (``snappy_tpu_torch.trace``) on the CPU (the
kernels' plain versions): one record a part of every call, its call id,
parent, clock times, host CPU, page faults and bytes; the ``trace.spans``
sums as a view of the same records, with a host part's wait for the card's
parts left out; nothing done while both views are off; records from many
threads and from a sharded entry's shard threads, the stages under a
sharded entry included; ``ops.api``'s names for the two views; and the
records' clock placed on a ``torch.profiler`` trace's."""

import io
import json
import os
import resource
import sys
import threading

import numpy as np
import pytest
import torch

from conftest import load_corpus
from snappy_tpu_torch import native, read, trace, write
from snappy_tpu_torch.config import configure
from snappy_tpu_torch.format.varint import write_varu64
from snappy_tpu_torch.ops import api
from snappy_tpu_torch.parallel import sharded
from snappy_tpu_torch.parallel.mesh import make_mesh
from torch_vectors import share_cores_with_workers

share_cores_with_workers()

ENTRIES = {"decompress_frame", "decompress_streams", "decompress", "compress",
           "read.FrameDecoder", "write.FrameEncoder"}
#: Compressed chunks only, and compressed with stored ones (the JPEG's).
PLAIN = load_corpus("html")[:150000]
MIXED = load_corpus("fireworks.jpeg")[:100000] + load_corpus("alice29.txt")[:90000]


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(trace, "spans", None)
    monkeypatch.setattr(trace, "records", None)
    with configure(device="cpu"):
        yield


def recorded(fn, *args, spans=False):
    """``fn(*args)`` with the records on (and the sums too with ``spans``):
    ``(result, records)``."""
    trace.records = []
    if spans:
        trace.spans = {}
    try:
        return fn(*args), trace.records
    finally:
        trace.records = None


def chunk_kinds(stream: bytes) -> set[int]:
    kinds, pos = set(), 10
    while pos < len(stream):
        kinds.add(stream[pos])
        pos += 4 + int.from_bytes(stream[pos + 1 : pos + 4], "little")
    return kinds


def test_a_call_on_compressed_and_stored_chunks_is_one_call():
    stream = native.frame_compress(MIXED)
    assert chunk_kinds(stream) == {0x00, 0x01}
    got, recs = recorded(api.decompress_frame, stream)
    assert got == MIXED
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "decompress_frame" and root["call"] == root["id"]
    assert {r["call"] for r in recs} == {root["id"]}
    assert {"walk", "pack", "flatten", "h2d", "kernels", "d2h", "unpack", "stored_crc",
            "join"} == {r["name"] for r in recs} - {"decompress_frame"}
    assert len({r["id"] for r in recs}) == len(recs)
    assert all(r["device_s"] is None for r in recs)  # no CUDA part on the CPU
    assert all(r["wait_s"] == 0.0 for r in recs)
    assert len(root["anchor"]) == 2 and "anchor" not in recs[0]


def test_every_part_lies_inside_its_parent():
    _, recs = recorded(api.decompress_frame, native.frame_compress(MIXED))
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        assert r["t0_ns"] <= r["t1_ns"]
        assert min(r["cpu_user_s"], r["cpu_sys_s"], r["minflt"]) >= 0
        if r["parent"] is None:
            continue
        p = by_id[r["parent"]]
        assert p["t0_ns"] <= r["t0_ns"] and r["t1_ns"] <= p["t1_ns"]


def test_parts_take_the_innermost_open_part_as_parent():
    """A part opened in no call opens one; an entry inside it joins it, and
    its parts have the innermost open part as parent."""
    stream = native.frame_compress(PLAIN)

    def nested():
        with trace.span("pack"), trace.span("join"):
            return api.decompress_frame(stream)

    got, recs = recorded(nested)
    assert got == PLAIN
    (outer,) = [r for r in recs if r["parent"] is None]
    (mid,) = [r for r in recs if r["parent"] == outer["id"]]
    assert (outer["name"], mid["name"]) == ("pack", "join") and outer["call"] == outer["id"]
    inner = [r for r in recs if r not in (outer, mid)]
    assert inner and all(r["parent"] == mid["id"] != r["call"] for r in inner)
    assert "walk" in {r["name"] for r in inner} and "decompress_frame" not in {
        r["name"] for r in recs}


def test_two_calls_two_ids_and_a_nested_entry_none_of_its_own():
    stream = native.frame_compress(PLAIN)

    def twice(s):
        return api.decompress_frame(s), api.decompress_frame(s)

    _, recs = recorded(twice, stream)
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["decompress_frame"] * 2
    assert len({r["call"] for r in recs}) == 2
    # decompress_frame calls decompress_streams, which joins its call
    assert not any(r["name"] == "decompress_streams" for r in recs)
    _, alone = recorded(api.decompress_streams, [native.compress(PLAIN)[3:]], [len(PLAIN)])
    assert [r["name"] for r in alone if r["parent"] is None] == ["decompress_streams"]


def test_the_readers_and_writers_entries_are_calls():
    stream = native.frame_compress(PLAIN)
    got, recs = recorded(lambda: read.FrameDecoder(io.BytesIO(stream), engine="device").read())
    assert got == PLAIN
    assert [r["name"] for r in recs if r["parent"] is None] == ["read.FrameDecoder"]
    assert "walk" in {r["name"] for r in recs} and len({r["call"] for r in recs}) == 1
    out = io.BytesIO()
    _, recs = recorded(lambda: write.FrameEncoder(out, engine="device").write(PLAIN * 2))
    assert native.frame_decompress(out.getvalue()) == PLAIN * 2
    roots = [r for r in recs if r["parent"] is None]
    assert roots and {r["name"] for r in roots} == {"write.FrameEncoder"}
    assert "kernels" in {r["name"] for r in recs}


def _bytes(recs, name):
    return sum(r["bytes"] for r in recs if r["name"] == name)


@pytest.mark.parametrize("data", [PLAIN, MIXED], ids=["compressed", "mixed"])
def test_byte_counters_are_exact(data):
    stream = native.frame_compress(data)
    _, recs = recorded(api.decompress_frame, stream)
    stored = sum(int.from_bytes(stream[p + 1 : p + 4], "little") - 4
                 for p in _chunk_starts(stream) if stream[p] == 0x01)
    assert _bytes(recs, "walk") == len(stream)
    assert _bytes(recs, "unpack") == len(data) - stored
    assert _bytes(recs, "stored_crc") == stored
    assert _bytes(recs, "join") == len(data)
    if not stored:
        assert _bytes(recs, "unpack") == _bytes(recs, "join") == len(data)
    # copied in: the rows, the int32 lengths, the flatten's indices and tile meta
    flat = _bytes(recs, "flatten")
    assert flat > 2 * (len(data) - stored)
    assert _bytes(recs, "h2d") > flat and _bytes(recs, "d2h") > len(data) - stored


def _chunk_starts(stream: bytes) -> list[int]:
    out, pos = [], 10
    while pos < len(stream):
        out.append(pos)
        pos += 4 + int.from_bytes(stream[pos + 1 : pos + 4], "little")
    return out


def _summed(recs) -> dict[str, float]:
    out: dict[str, float] = {}
    for r in recs:
        if r["parent"] is None and r["name"] in ENTRIES:
            continue
        dt = r["device_s"]
        if dt is None:
            dt = (r["t1_ns"] - r["t0_ns"]) / 1e9 - r["wait_s"]
        out[r["name"]] = out.get(r["name"], 0.0) + dt
    return out


@pytest.mark.parametrize("path", ["frame", "raw", "compress", "compress_fast"])
def test_spans_are_the_records_summed_by_name(path):
    data = MIXED
    fn, arg = {
        "frame": (api.decompress_frame, native.frame_compress(data)),
        "raw": (api.decompress, native.compress(data)),
        "compress": (api.compress, data),
        "compress_fast": (lambda d: api.compress(d, profile="fast"), data),
    }[path]
    try:
        got, recs = recorded(fn, arg, spans=True)
        sums = trace.spans
    finally:
        trace.spans = None
    assert (got == data) if path in ("frame", "raw") else native.decompress(got) == data
    assert set(sums) == set(_summed(recs)) and sums
    for name, s in _summed(recs).items():
        assert sums[name] == pytest.approx(s, abs=1e-9)


def test_spans_alone_keep_no_records():
    trace.spans = {}
    try:
        assert api.decompress_frame(native.frame_compress(PLAIN)) == PLAIN
        assert {"walk", "flatten", "join"} <= set(trace.spans)
    finally:
        trace.spans = None
    assert trace.records is None and not trace._open


def test_off_costs_no_rusage_and_keeps_nothing(monkeypatch):
    def refuse(*_):
        raise AssertionError("getrusage with tracing off")

    monkeypatch.setattr(resource, "getrusage", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    stream = native.frame_compress(MIXED)
    assert api.decompress_frame(stream) == MIXED
    assert native.decompress(api.compress(PLAIN)) == PLAIN
    assert trace.records is None and trace.spans is None and not trace._open
    assert trace._current.get() is None


@pytest.mark.parametrize("entry", ["decompress_frame", "reader", "writer", "compress"])
def test_with_both_views_off_an_entry_opens_no_call(entry, monkeypatch):
    """With no view and no profiler on, a public entry runs its body
    straight through: no root part is opened."""
    roots = []
    real = trace.span

    def span(name, *args, root=False, **kwargs):
        if root:
            roots.append(name)
        return real(name, *args, root=root, **kwargs)

    monkeypatch.setattr(trace, "span", span)
    stream = native.frame_compress(PLAIN)
    if entry == "decompress_frame":
        assert api.decompress_frame(stream) == PLAIN
    elif entry == "reader":
        assert read.FrameDecoder(io.BytesIO(stream), engine="device").read() == PLAIN
        assert read.FrameDecoder(io.BytesIO(stream), engine="native").read(1000) == PLAIN[:1000]
    elif entry == "writer":
        out = io.BytesIO()
        write.FrameEncoder(out, engine="device").write(PLAIN)
        assert native.frame_decompress(out.getvalue()) == PLAIN
    else:
        assert native.decompress(api.compress(PLAIN)) == PLAIN
    assert roots == []
    trace.records = []
    try:
        assert api.decompress_frame(stream) == PLAIN
    finally:
        trace.records = None
    assert roots == ["decompress_frame", "decompress_streams"]  # the second joins the first


class _Event:
    """A stand-in for a resolved CUDA event at ``t`` ns of the card's clock."""

    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


def _rec(name, t0, t1, thread=1):
    return {"name": name, "thread": thread, "t0_ns": t0, "t1_ns": t1, "device_s": None,
            "wait_s": 0.0}


@pytest.mark.parametrize("case", ["copy_waits", "two_launches", "other_thread", "before"])
def test_a_host_part_leaves_out_the_device_parts_it_overlaps(case):
    """The device parts are placed on the host's clock from when their first
    event was queued, one after the other on a thread; a host part's
    ``wait_s`` is its overlap with those its thread closed before it opened,
    so that the view's parts add up to no more than the call."""
    us = 1000
    kern = _rec("kernels", 0, 100 * us)
    pending = [(kern, 10 * us, _Event(0), _Event(500 * us))]  # runs 10-510 µs
    host = _rec("d2h", 150 * us, 700 * us)
    want = 360e-6
    if case == "two_launches":  # queued at 120 µs, starts once the first ends
        crc = _rec("kernels", 110 * us, 140 * us)
        pending.append((crc, 120 * us, _Event(0), _Event(100 * us)))  # 510-610 µs
        want = 460e-6
    elif case == "other_thread":
        host["thread"] = 2
        want = 0.0
    elif case == "before":  # a part that opened before the launch waits for none of it
        host = _rec("h2d", 0, 5 * us)
        want = 0.0
    done = [r for r, *_ in pending] + [host]
    trace._set_waits(done, trace._resolve(pending))
    assert kern["device_s"] == pytest.approx(500e-6)
    assert host["wait_s"] == pytest.approx(want, abs=1e-12)
    assert all(r["wait_s"] == 0.0 for r, *_ in pending)
    if case != "before":  # the view's parts fit in the call's 0-700 µs
        view = sum(r["device_s"] for r, *_ in pending) + 550e-6 - host["wait_s"]
        assert view <= 700e-6 + 1e-12 or case == "other_thread"


def test_a_failed_call_still_ends():
    stream = bytearray(native.frame_compress(PLAIN))
    stream[20] ^= 0xFF  # the first chunk's checksum
    trace.records = []
    try:
        with pytest.raises(Exception):
            api.decompress_frame(bytes(stream))
        recs = trace.records
    finally:
        trace.records = None
    assert [r["name"] for r in recs if r["parent"] is None] == ["decompress_frame"]
    assert not trace._open and trace._current.get() is None


def test_many_threads_give_a_call_each_and_lose_no_record():
    """More threads than cores, switching often: a call id each, and every
    part of every call kept."""
    stream = native.frame_compress(MIXED)
    _, one = recorded(api.decompress_frame, stream)
    n = max(12, os.cpu_count() + 2)
    barrier = threading.Barrier(n)
    results = [None] * n

    def work(i):
        barrier.wait()
        results[i] = api.decompress_frame(stream, device="cpu")

    interval = sys.getswitchinterval()
    trace.records = []
    try:
        sys.setswitchinterval(1e-5)
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        recs = trace.records
    finally:
        sys.setswitchinterval(interval)
        trace.records = None
    assert results == [MIXED] * n
    calls = {r["call"] for r in recs}
    assert len(calls) == n and len(recs) == n * len(one)
    for c in calls:
        mine = [r for r in recs if r["call"] == c]
        assert len({r["thread"] for r in mine}) == 1
        assert sorted(r["name"] for r in mine) == sorted(r["name"] for r in one)


def test_shard_threads_take_the_entrys_span_as_parent():
    """A sharded entry runs its shards in threads with a copy of the
    caller's context, so each shard's parts have the part that called
    the entry as parent. The shards meet at a barrier before they decode,
    so that both run at once, each on a thread of its own: the pool hands
    a queued shard to whichever thread asks first, and without the barrier
    a first shard that ends before the second is taken can take it too."""
    mesh = make_mesh([torch.device("cpu")] * 2)
    datas = [load_corpus("html")[:40000], load_corpus("alice29.txt")[:30000],
             load_corpus("urls.10K")[:20000], load_corpus("kppkn.gtb")[:50000]]
    bodies = [native.compress(d)[len(write_varu64(len(d))):] for d in datas]
    both = threading.Barrier(2, timeout=30)

    def shard(rows):
        both.wait()
        got, errs, _ = api.decompress_streams([bodies[i] for i in rows.tolist()],
                                              [len(datas[i]) for i in rows.tolist()])
        assert not errs.any()
        return torch.tensor([len(g) for g in got])

    def entry():
        with trace.span("map_shards", root=True):
            return sharded.map_shards(mesh, shard, torch.arange(4))

    lens, recs = recorded(entry)
    assert lens.cpu().tolist() == [len(d) for d in datas]
    (root,) = [r for r in recs if r["parent"] is None]
    parts = [r for r in recs if r is not root]
    assert {"pack", "flatten", "kernels", "unpack"} <= {r["name"] for r in parts}
    assert len({r["thread"] for r in parts if r["name"] == "flatten"}) == 2
    assert all(r["call"] == root["id"] for r in parts)
    by_id = {r["id"]: r for r in recs}
    for r in parts:  # every part's chain of parents ends at the entry's span
        while r["parent"] != root["id"]:
            r = by_id[r["parent"]]
        assert r["thread"] != root["thread"] or r["name"] == "map_shards"
    assert not any(r["name"] == "decompress_streams" for r in recs)


def test_a_sharded_compress_records_its_stages_under_the_callers_part():
    """The stages that a sharded entry runs record their own parts: the flat
    encoder's ``prepass``, ``kernels`` (K4, K5) and ``plan``, once a shard
    each, every one in the call of the part that called the entry, its
    chain of parents ending there."""
    mesh = make_mesh([torch.device("cpu")] * 2)
    blocks = np.zeros((2, 65536), np.uint8)
    lens = np.array([12000, 9000], np.int32)
    blocks[0, :12000] = np.frombuffer(PLAIN[:12000], np.uint8)
    blocks[1, :9000] = np.frombuffer(MIXED[-9000:], np.uint8)

    def entry():
        with trace.span("caller", root=True):
            return sharded.sharded_compress_blocks_flat(mesh, blocks, lens)

    (out, out_len, _), recs = recorded(entry)
    for i, n in enumerate(lens):
        stream = write_varu64(int(n)) + out.numpy()[i, : out_len.numpy()[i]].tobytes()
        assert native.decompress(stream) == blocks[i, :n].tobytes()
    (root,) = [r for r in recs if r["parent"] is None]
    assert root["name"] == "caller"
    names = [r["name"] for r in recs if r is not root]
    assert (names.count("prepass"), names.count("kernels"), names.count("plan")) == (2, 4, 2)
    by_id = {r["id"]: r for r in recs}
    for r in recs:
        assert r["call"] == root["id"]
        while r["parent"] is not None:
            r = by_id[r["parent"]]
        assert r is root


@pytest.mark.parametrize("view", ["spans", "records"])
def test_the_api_module_sets_and_reads_the_recorders_views(view):
    """``ops.api.spans`` and ``ops.api.records`` are the recorder's own views,
    set and read through the API module."""
    setattr(api, view, {} if view == "spans" else [])
    try:
        assert getattr(trace, view) is getattr(api, view)
        assert api.decompress_frame(native.frame_compress(PLAIN)) == PLAIN
        got = getattr(api, view)
        assert "walk" in (got if view == "spans" else {r["name"] for r in got})
    finally:
        setattr(api, view, None)
    assert getattr(trace, view) is None


def test_records_land_on_the_profilers_clock(tmp_path):
    """Each record's start, placed on the trace by its call's anchor and the
    trace's ``baseTimeNanoseconds``, lies within 1 ms of its own range's."""
    from torch.profiler import ProfilerActivity, profile

    stream = native.frame_compress(MIXED)
    api.decompress_frame(stream)  # warm
    trace.records = []
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(2):
                api.decompress_frame(stream)
        recs = trace.records
    finally:
        trace.records = None
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    base = doc["baseTimeNanoseconds"]
    ranges: dict[str, list[float]] = {}
    for e in sorted(doc["traceEvents"], key=lambda e: e.get("ts", 0)):
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(float(e["ts"]))
    anchors = {r["call"]: r["anchor"] for r in recs if r["parent"] is None}
    by_name: dict[str, list[dict]] = {}
    for r in sorted(recs, key=lambda r: r["t0_ns"]):
        by_name.setdefault(r["name"], []).append(r)
    assert set(by_name) == set(ranges)
    offsets = []
    for name, rs in by_name.items():
        assert len(rs) == len(ranges[name])
        for r, ts in zip(rs, ranges[name]):
            real, perf = anchors[r["call"]]
            offsets.append((real + r["t0_ns"] - perf - base) / 1e3 - ts)
    assert max(abs(o) for o in offsets) < 1000.0, np.percentile(offsets, [0, 50, 100])
