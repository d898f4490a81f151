"""The decode route selectors ``decode_kernels``, ``decode_flat`` and
``pure_device`` route as the JAX package's ``pallas_decode``, ``pallas_flat``
and ``pure_device`` do: ``decompress_frame`` and ``decompress`` (on the CPU:
the plain versions and the tensor decode) equal the input and the JAX
package's ``snappy_tpu.ops.api`` under the matching configuration, errors
included, and ``api.routes`` names the route each launch group took."""

import dataclasses

import numpy as np
import pytest

from conftest import load_corpus
from snappy_tpu import config as jconfig
from snappy_tpu.format import reference as jref
from snappy_tpu.ops import api as japi
from snappy_tpu_torch import native
from snappy_tpu_torch.config import Config, config_from_reference, configure
from snappy_tpu_torch.format.varint import write_varu64
from snappy_tpu_torch.ops import api
from torch_vectors import (
    CORRUPT, fallback_row, hold_jax_native, raw_body, share_cores_with_workers,
)

share_cores_with_workers()
hold_jax_native()

#: Route name -> (port configuration, the JAX package's), and the route
#: every launch group takes under them.
ROUTES = {
    "parallel_hosted": ({"decode_kernels": False}, {"pallas_decode": False}),
    "parallel": ({"pure_device": True}, {"pure_device": True}),
    "replay": ({"decode_flat": False}, {"pallas_flat": False}),
}


@pytest.fixture(params=sorted(ROUTES))
def route(request, monkeypatch):
    """Run the test under one configuration, in both packages, recording
    each launch group's route."""
    ours, theirs = ROUTES[request.param]
    monkeypatch.setattr(api, "routes", [])
    with configure(device="cpu", **ours), jconfig.configure(**theirs):
        yield request.param


def outcome(fn, data: bytes):
    try:
        return ("ok", fn(data))
    except Exception as e:  # the comparison is the test
        return (type(e).__name__, getattr(e, "_values", lambda: None)(), str(e))


FRAME_DATA = (load_corpus("html")[:70000] + load_corpus("fireworks.jpeg")[:70000]
              + load_corpus("kppkn.gtb")[:50000] + b"tail" * 99)


def test_decompress_frame_matches_jax_package(route):
    stream = native.frame_compress(FRAME_DATA)
    assert outcome(api.decompress_frame, stream) == ("ok", FRAME_DATA)
    assert outcome(japi.decompress_frame, stream) == ("ok", FRAME_DATA)
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


RAW = {
    "geo": jref.compress(load_corpus("geo.protodata")),
    "rle": jref.compress(b"ab" * 40000),
    "literal-overrun": b"\x05\x54hello",
    "huge-literal": b"\x05\xfc\xff\xff\xff\xff",
    "offset-past-dst": b"\x04\x0d\x01\x42\x3f",
    "truncated-copy4": b"\x05\x04abcd\x09\x00",
    "short-output": b"\x03\x04ab",
}


@pytest.mark.parametrize("case", sorted(RAW))
def test_decompress_matches_jax_package(route, case):
    data = RAW[case]
    got = outcome(api.decompress, data)
    assert got == outcome(japi.decompress, data)
    assert got[0] != "ok" or got[1] == jref.decompress(data)
    assert {r[2] for r in api.routes} <= {route}


def test_decompress_streams_codes_and_crcs_match_jax_package(route):
    datas = [load_corpus("lcet10.txt")[:65536], load_corpus("urls.10K")[:9000], b"xyz" * 3000]
    rows = [raw_body(d) for d in datas] + CORRUPT
    bodies, declens = [r[0] for r in rows], [r[1] for r in rows]
    got = api.decompress_streams(bodies, declens, with_crc=True)
    want = japi.decompress_streams(bodies, declens, with_crc=True)
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1][: len(datas)] == 0).all() and (got[1][len(datas):] != 0).all()
    np.testing.assert_array_equal(got[2][: len(datas)], want[2][: len(datas)])
    assert got[0][: len(datas)] == want[0][: len(datas)] == datas
    assert {r[2] for r in api.routes} == {route}


def _routes_of(bodies, declens, **cfg):
    """Decode on the CPU under ``cfg``; returns ``(outputs, codes, routes)``."""
    api.routes = []
    try:
        with configure(device="cpu", **cfg):
            outs, errs, _ = api.decompress_streams(bodies, declens)
        return outs, errs, api.routes
    finally:
        api.routes = None


def test_wide_groups_leave_the_replay_kernel():
    """A group the kernel routes leave whose rows are wider than
    ``replay_max_body`` takes the hosted tensor route, not K3: the flat
    route turned off, and a record-cap overflow."""
    text = raw_body(load_corpus("alice29.txt")[:40000])  # a 32 KiB row
    many_ops = (b"".join(bytes([0, 97 + i % 26]) for i in range(20000)), 20000)  # 20,000 records
    cases = [
        ({}, text, "flat"),
        ({"decode_flat": False}, text, "replay"),
        ({"decode_flat": False, "replay_max_body": 16384}, text, "parallel_hosted"),
        ({"decode_records": True}, many_ops, "replay"),
        ({"decode_records": True, "replay_max_body": 32768}, many_ops, "parallel_hosted"),
    ]
    for cfg, (body, declen), want_route in cases:
        outs, errs, rts = _routes_of([body], [declen], **cfg)
        assert not errs.any() and outs[0] == jref.decompress(write_varu64(declen) + body)
        assert [r[2] for r in rts] == [want_route], (cfg, rts)


def test_flatten_rejected_wide_row_takes_the_hosted_route():
    """The row the flatten cannot window (81,920 bytes wide) takes K3 up to
    its ``replay_max_body``, the hosted tensor route past it."""
    body, declen = fallback_row()
    want = jref.decompress(write_varu64(declen) + body)
    for cap, route in ((1 << 17, "replay"), (1 << 16, "parallel_hosted")):
        outs, errs, rts = _routes_of([body], [declen], replay_max_body=cap)
        assert outs[0] == want and not errs.any()
        assert rts == [(1, 1 << 17, route, 81920, len(body), declen)]


def test_oversized_group_under_pure_device_stays_on_the_device():
    """Past ``max_dpad`` a group decodes on the host, except under
    ``pure_device``, where it takes the all-device tensor route, as in the
    JAX package."""
    data = load_corpus("alice29.txt")[:60000]
    body, declen = raw_body(data)
    width = api._width_bucket(len(body))
    outs, _, rts = _routes_of([body], [declen], max_dpad=16384)
    assert outs == [data] and rts == [(1, 65536, "host", width, len(body), declen)]
    outs, errs, rts = _routes_of([body], [declen], max_dpad=16384, pure_device=True)
    assert outs == [data] and rts == [(1, 65536, "parallel", width, len(body), declen)]
    with jconfig.configure(pure_device=True, pallas_max_dpad=16384):
        want = japi.decompress_streams([body], [declen])
    assert want[0] == outs and (want[1] == errs).all()


def test_kernels_pinned_on_under_pure_device_take_the_replay_kernel():
    """``decode_kernels=True`` with ``pure_device``: no host scan, so no
    flat or record-scan route; K3 takes the groups it can."""
    data = load_corpus("html")[:50000]
    body, declen = raw_body(data)
    outs, _, rts = _routes_of([body], [declen], pure_device=True, decode_kernels=True)
    assert outs == [data] and [r[2] for r in rts] == ["replay"]
    outs, _, rts = _routes_of([body], [declen], pure_device=True, decode_kernels=True,
                              replay_max_body=1024)
    assert outs == [data] and [r[2] for r in rts] == ["parallel"]


def test_a_failing_kernel_raises_instead_of_taking_a_tensor_route(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("flat_gather: CUDA launch failed with error 1")

    monkeypatch.setattr(api, "decode_flat_groups", broken)  # K2, with its checksum on a frame read
    with configure(device="cpu"):
        with pytest.raises(RuntimeError, match="launch failed"):
            api.decompress_frame(native.frame_compress(FRAME_DATA))


def test_config_from_reference_carries_the_route_selectors():
    ref_cfg = jconfig.Config(pallas_decode=False, pallas_flat=False, pure_device=True)
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    assert cfg == Config(decode_kernels=False, decode_flat=False, pure_device=True)
    assert config_from_reference(dataclasses.asdict(jconfig.Config(pallas_decode=True))) == Config(
        decode_kernels=True
    )
    default = config_from_reference(dataclasses.asdict(jconfig.Config()))
    assert default.decode_kernels is None and default.decode_flat and not default.pure_device
    assert api.decode_routes(default) == (True, True)
    assert api.decode_routes(cfg) == (False, False)
    assert api.decode_routes(Config(pure_device=True, decode_kernels=True)) == (False, True)
