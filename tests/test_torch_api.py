"""The port's decode slice equals the JAX package's on the CPU.

``snappy_tpu_torch.decompress_frame`` and ``decompress`` (``device="cpu"``:
the kernels' plain versions) against ``snappy_tpu.ops.api``: the same
bytes, or an exception of the same class with the same fields and
message. Both packages run under the same routing caps, carried across
with ``config_from_reference``.
"""

import dataclasses

import numpy as np
import pytest

from conftest import load_corpus
from snappy_tpu import config as jconfig
from snappy_tpu.format import reference as jref
from snappy_tpu.format.varint import read_varu64, write_varu64
from snappy_tpu.ops import api as japi
from snappy_tpu_torch import native
from snappy_tpu_torch.config import Config, config_from_reference, configure
from snappy_tpu_torch.ops import api
from torch_vectors import fallback_row, hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()


@pytest.fixture(autouse=True)
def reference_caps():
    """Run the port under the JAX package's current routing caps."""
    cfg = config_from_reference(dataclasses.asdict(jconfig.get_config()))
    with configure(**dataclasses.asdict(cfg)):
        yield


def outcome(fn, data: bytes):
    try:
        return ("ok", fn(data))
    except Exception as e:  # the comparison is the test
        return (type(e).__name__, getattr(e, "_values", lambda: None)(), str(e))


def port_frame(data):
    return api.decompress_frame(data, device="cpu")


def port_raw(data):
    return api.decompress(data, device="cpu")


def frame(data: bytes) -> bytes:
    return native.frame_compress(data)


STREAMS = {
    "asyoulik": lambda: load_corpus("asyoulik.txt")[: 2 * 65536 + 777],
    "fireworks": lambda: load_corpus("fireworks.jpeg")[:150000],  # stored chunks
    "mixed": lambda: load_corpus("html")[:70000] + load_corpus("kppkn.gtb")[:60000],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_decompress_frame_matches_jax_package(name):
    data = STREAMS[name]()
    stream = frame(data)
    got = outcome(port_frame, stream)
    assert got == ("ok", data)
    assert got == outcome(japi.decompress_frame, stream)
    # Concatenated streams are legal (a recurring stream identifier).
    assert port_frame(stream + stream) == data + data


MUTATIONS = {
    "ident-len": lambda s: s[:1] + bytes([s[1] ^ 1]) + s[2:],
    "payload-flip": lambda s: s[:14] + bytes([s[14] ^ 0xFF]) + s[15:],
    "body-flip": lambda s: s[:60] + bytes([s[60] ^ 0x5A]) + s[61:],
    "crc-flip": lambda s: s[:11] + bytes([s[11] ^ 0x40]) + s[12:],
    "truncated": lambda s: s[:-3],
    "reserved-unskippable": lambda s: s + b"\x05\x01\x00\x00x",
    "trailing-padding": lambda s: s + b"\xfe\x02\x00\x00xy",
    "leading-garbage": lambda s: b"garbage" + s,
    "empty": lambda s: b"",
    "ident-only": lambda s: s[:10],
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_decompress_frame_errors_match_jax_package(mutation):
    stream = MUTATIONS[mutation](frame(load_corpus("asyoulik.txt")[:100000]))
    assert outcome(port_frame, stream) == outcome(japi.decompress_frame, stream)
    assert outcome(port_frame, stream) == outcome(native.frame_decompress, stream)


@pytest.mark.parametrize("name", ["baddata1.snappy", "baddata2.snappy", "baddata3.snappy"])
def test_decompress_frame_baddata_matches_jax_package(name):
    raw = load_corpus(name)
    got = outcome(port_frame, raw)
    assert got[0] != "ok"
    assert got == outcome(japi.decompress_frame, raw)


def test_decompress_golden(golden_text, golden_rawsnappy):
    assert port_raw(golden_rawsnappy) == golden_text


RAW_CASES = {
    "literal-overrun": b"\x05\x54hello",
    "huge-literal": b"\x05\xfc\xff\xff\xff\xff",
    "truncated-long-literal": b"\x05\xf4",
    "offset-past-dst": b"\x04\x0d\x01\x42\x3f",
    "truncated-copy2": b"\x02\x00abc",
    "truncated-copy4": b"\x05\x04abcd\x09\x00",
    "truncated-literal": b"\x03\x00ab",
    "short-output": b"\x03\x04ab",
    "empty": b"",
    "bad-varint": b"\xff\xff\xff\xff\xff\xff",
    "too-big": b"\xff\xff\xff\xff\x0f",
    "amplified": b"\xff\xff\x3f\x00a",
    "rle": jref.compress(b"ab" * 40000),
    "zeros": jref.compress(bytes(70000)),
    "one": jref.compress(b"a"),
    "nothing": jref.compress(b""),
    "geo": jref.compress(load_corpus("geo.protodata")),
}


@pytest.mark.parametrize("case", sorted(RAW_CASES))
def test_decompress_matches_jax_package(case):
    data = RAW_CASES[case]
    assert outcome(port_raw, data) == outcome(japi.decompress, data)


def test_flatten_rejected_row_takes_the_replay_route(monkeypatch):
    from snappy_tpu_torch.ops import replay

    body, declen = fallback_row()
    stream = write_varu64(declen) + body
    calls = []
    monkeypatch.setattr(api, "decode_replay", lambda *a: calls.append(1) or replay.decode_replay(*a))
    assert outcome(port_raw, stream) == ("ok", jref.decompress(stream))
    assert calls == [1]


def test_decompress_streams_crcs_match_jax_package():
    datas = [load_corpus("lcet10.txt")[:65536], load_corpus("urls.10K")[:9000], b"xyz" * 3000]
    bodies, declens = [], []
    for d in datas:
        c = jref.compress(d)
        bodies.append(c[read_varu64(c)[1]:])
        declens.append(len(d))
    bodies += [b"\x00a\x1d\x01", b"\x08abc"]
    declens += [5, 9]
    got = api.decompress_streams(bodies, declens, with_crc=True, device="cpu")
    want = japi.decompress_streams(bodies, declens, with_crc=True)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1][-1] != 0 and got[1][-2] != 0
    np.testing.assert_array_equal(got[2][:3], want[2][:3])
    assert got[0][:3] == want[0][:3] == datas


def test_config_from_reference_maps_the_shared_caps():
    ref_cfg = jconfig.Config(
        decode_rows_per_launch=7, max_device_stream=1 << 20, max_device_output=1 << 21,
        pallas_max_dpad=1 << 14, replay_max_body=1 << 12, threads=3, debug=True,
        pallas_fastpath="compose", pallas_records=True, pallas_resolve=True,
    )
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    assert cfg == Config(
        device="cuda", decode_rows_per_launch=7, max_device_stream=1 << 20,
        max_device_output=1 << 21, max_dpad=1 << 14, replay_max_body=1 << 12,
        threads=3, debug=True, decode_records=True, decode_resolve=True,
    )
    default = config_from_reference(dataclasses.asdict(jconfig.Config()))
    assert not default.decode_records and not default.decode_resolve


def test_routing_caps_send_wide_streams_to_the_host(monkeypatch):
    """Under a JAX config with a 16 KiB Pallas cap, the port decodes a
    64 KiB stream on the host, as the JAX package does."""
    data = load_corpus("alice29.txt")[:65536]
    stream = jref.compress(data)
    small = dataclasses.asdict(dataclasses.replace(jconfig.get_config(), pallas_max_dpad=1 << 14))
    monkeypatch.setattr(api, "decode_group", lambda *a: pytest.fail("took the device route"))
    with configure(**dataclasses.asdict(config_from_reference(small))):
        assert port_raw(stream) == data
        # Frame chunks of 64 KiB group past the cap too: the host codec.
        assert port_frame(frame(data)) == data


def test_debug_mode_cross_checks_against_the_oracle():
    data = load_corpus("html")[:30000]
    with configure(debug=True):
        assert port_frame(frame(data)) == data
        assert port_raw(jref.compress(data)) == data


def test_spans_time_the_path_without_changing_it(monkeypatch):
    data = load_corpus("fireworks.jpeg")[:100000] + load_corpus("html")[:70000]
    stream = frame(data)
    monkeypatch.setattr(api, "spans", {})
    assert port_frame(stream) == data
    parts = api.spans
    assert set(parts) == {
        "walk", "pack", "flatten", "h2d", "kernels", "d2h", "unpack", "stored_crc", "join"
    }
    assert all(t >= 0 for t in parts.values())
    monkeypatch.setattr(api, "spans", None)
    assert port_frame(stream) == data
