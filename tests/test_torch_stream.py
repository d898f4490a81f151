"""The port's exact compress and streaming adapters equal the JAX
package's, on the CPU.

Through the entry points a user calls, under ``configure(device="cpu")``
(the kernels' plain versions): ``snappy_tpu_torch.compress`` with no
profile against ``snappy_tpu.ops.api.compress`` and the golden
``.rawsnappy`` file; ``write.FrameEncoder``, ``read.FrameDecoder``,
``read.FrameEncoder`` and ``raw.Encoder``/``Decoder`` against the JAX
package's adapters of the same names, engine by engine, with their
errors. Outputs are bytes: tolerance 0. Writes that reach the device
frame writer (over 64 KiB) hold a short pattern repeated, which the
automaton crosses in few steps.
"""

import dataclasses
import io
import itertools

import numpy as np
import pytest

import snappy_tpu
from conftest import load_corpus
from snappy_tpu import frame as jframe
from snappy_tpu import raw as jraw
from snappy_tpu import read as jread
from snappy_tpu import write as jwrite
from snappy_tpu.ops import api as japi
import snappy_tpu_torch
from snappy_tpu_torch import engine, error, frame, native, raw, read, write
from snappy_tpu_torch.config import Config, config_from_reference, configure
from snappy_tpu_torch.ops import encode, frame as dframe
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

PATTERN = (b"0123456789abcdef" * 4096 * 3)[:150000]  # over 64 KiB, few automaton steps
WRITES = [b"x" * 10, load_corpus("html")[:30000], PATTERN, b"", b"a tail of a few bytes"]


@pytest.fixture(autouse=True)
def on_cpu():
    with configure(device="cpu"):
        yield


def outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:  # the comparison is the test
        return (type(e).__name__, str(e))


@pytest.mark.parametrize(
    "data",
    [b"", b"abc", load_corpus("html")[:6000], b"z" * 70000 + b"tail" * 10],
    ids=["empty", "short", "html", "two-blocks"],
)
def test_compress_default_is_exact_and_matches_jax_package(data):
    got = snappy_tpu_torch.compress(data)
    assert got == japi.compress(data) == native.compress(data)


def test_compress_reproduces_the_golden_file(golden_text, golden_rawsnappy):
    encode.launches = 0
    assert snappy_tpu_torch.compress(golden_text) == golden_rawsnappy
    assert encode.launches == 0  # the CPU takes the plain version


@pytest.mark.parametrize("eng", ["native", "device", "reference"])
def test_frame_encoder_matches_jax_package(eng):
    got, want = io.BytesIO(), io.BytesIO()
    w, jw = write.FrameEncoder(got, engine=eng), jwrite.FrameEncoder(want, engine=eng)
    for piece in WRITES:
        assert w.write(piece) == jw.write(piece) == len(piece)
    w.flush()
    jw.flush()
    assert got.getvalue() == want.getvalue()
    assert native.frame_decompress(got.getvalue()) == b"".join(WRITES)


def test_device_frame_writer_takes_the_card_path(monkeypatch):
    """A write over 64 KiB on the ``device`` engine goes to the device
    frame encoder whole, one launch group at a time; a whole-stream
    write equals the host codec's frames."""
    calls = []
    real = dframe.encode_frame_host
    monkeypatch.setattr(dframe, "encode_frame_host",
                        lambda buf, *a, **k: calls.append(len(buf)) or real(buf, *a, **k))
    out = io.BytesIO()
    with write.FrameEncoder(out, engine="device") as w:
        w.write(PATTERN)
        assert out.getvalue() == native.frame_compress(PATTERN)
    assert calls == [len(PATTERN)]


def test_device_fast_frame_writer_round_trips():
    out = io.BytesIO()
    w = write.FrameEncoder(out, engine="device-fast")
    for piece in WRITES:
        w.write(piece)
    stream = w.into_inner().getvalue()
    assert native.frame_decompress(stream) == b"".join(WRITES)


def test_frame_encoder_into_inner_and_close():
    out = io.BytesIO()
    w = write.FrameEncoder(out, engine="native")
    w.write(b"buffered")
    assert "src=[...]" in repr(w) and out.getvalue() == b""
    assert w.into_inner() is out and w.closed
    assert native.frame_decompress(out.getvalue()) == b"buffered"

    class Broken(io.RawIOBase):
        def write(self, b):
            raise OSError("disk full")

    w = write.FrameEncoder(Broken(), engine="native")
    w.write(b"x" * 100)
    with pytest.raises(error.IntoInnerError) as e:
        w.into_inner()
    assert e.value.into_inner() is w and isinstance(e.value.error(), OSError)
    out = io.BytesIO()
    w = write.FrameEncoder(out, engine="device")
    w.write(b"closed flushes")
    w.close()
    assert native.frame_decompress(out.getvalue()) == b"closed flushes"


STREAM_DATA = load_corpus("asyoulik.txt")[:70000] + load_corpus("fireworks.jpeg")[:20000] + b"end"


@pytest.mark.parametrize("eng", ["native", "device", "reference"])
def test_frame_decoder_partial_reads_round_trip(eng):
    stream = native.frame_compress(STREAM_DATA)
    r = read.FrameDecoder(io.BytesIO(stream), engine=eng)
    got = bytearray()
    for size in itertools.cycle([1, 7, 4096, 100000, 333]):
        piece = r.read(size)
        if not piece:
            break
        assert len(piece) <= size
        got += piece
    assert bytes(got) == STREAM_DATA
    assert read.FrameDecoder(io.BytesIO(stream), engine=eng).read() == STREAM_DATA
    buf = bytearray(5000)
    assert read.FrameDecoder(io.BytesIO(stream), engine=eng).readinto(buf) > 0


MUTATIONS = {
    "body-flip": lambda s: s[:60] + bytes([s[60] ^ 0x5A]) + s[61:],
    "crc-flip": lambda s: s[:11] + bytes([s[11] ^ 0x40]) + s[12:],
    "truncated": lambda s: s[:-3],
    "reserved-unskippable": lambda s: s + b"\x05\x01\x00\x00x",
    "leading-garbage": lambda s: b"garbage" + s,
    "oversized-length": lambda s: s + b"\x00\xff\xff\xff",
}


@pytest.mark.parametrize("eng", ["native", "device"])
@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_frame_decoder_errors_match_jax_package(eng, mutation):
    bad = MUTATIONS[mutation](native.frame_compress(STREAM_DATA))

    def partial(mod):
        r = mod.FrameDecoder(io.BytesIO(bad), engine=eng)
        got = bytearray()
        try:
            while piece := r.read(10000):
                got += piece
        except Exception as e:  # the comparison is the test
            return bytes(got), type(e).__name__, str(e)
        return bytes(got), None, None

    got = partial(read)
    assert got[1] is not None
    assert got == partial(jread)
    whole = outcome(lambda: read.FrameDecoder(io.BytesIO(bad), engine=eng).read())
    assert whole[0] != "ok" and whole == outcome(
        lambda: jread.FrameDecoder(io.BytesIO(bad), engine=eng).read())


@pytest.mark.parametrize("eng", ["auto", "native", "reference", "device"])
def test_raw_encoder_and_decoder_match_jax_package(eng):
    data = load_corpus("html")[:20000]
    comp = raw.Encoder(eng).compress_vec(data)
    assert comp == jraw.Encoder(eng).compress_vec(data) == native.compress(data)
    assert raw.Decoder(eng).decompress_vec(comp) == data
    for out in (bytearray(raw.max_compress_len(len(data))),
                np.zeros(raw.max_compress_len(len(data)), np.uint8)):
        n = raw.Encoder(eng).compress(data, out)
        assert bytes(out[:n]) == comp
    for out in (bytearray(len(data)), np.zeros(len(data), np.uint8)):
        assert raw.Decoder(eng).decompress(comp, out) == len(data) and bytes(out) == data
    assert raw.decompress_len(comp) == jraw.decompress_len(comp) == len(data)


@pytest.mark.parametrize("eng", ["native", "reference"])
def test_raw_buffer_errors_match_jax_package(eng):
    data = b"hello hello hello hello"
    comp = native.compress(data)
    cases = [
        lambda m: m.Encoder(eng).compress(data, bytearray(5)),
        lambda m: m.Encoder(eng).compress(data, np.zeros(5, np.uint8)),
        lambda m: m.Decoder(eng).decompress(comp, bytearray(3)),
        lambda m: m.Decoder(eng).decompress(comp, np.zeros(3, np.uint8)),
        lambda m: m.Decoder(eng).decompress(b"", bytearray(3)),
        lambda m: m.Decoder(eng).decompress_vec(b""),
        lambda m: m.Decoder(eng).decompress_vec(b"\xff\xff\xff\xff\xff\xff"),
        lambda m: m.Encoder(eng).compress(data, bytes(100)),  # read-only
    ]
    for i, case in enumerate(cases):
        got, want = outcome(case, raw), outcome(case, jraw)
        assert got[0] != "ok" and got == want, i


@pytest.mark.parametrize("eng", ["native", "device", "reference"])
def test_reader_frame_encoder_matches_jax_package(eng):
    src = STREAM_DATA
    got = read.FrameEncoder(io.BytesIO(src), engine=eng).read()
    assert got == jread.FrameEncoder(io.BytesIO(src), engine=eng).read()
    assert got == native.frame_compress(src)
    big = bytearray(read.MAX_READ_FRAME_ENCODER_BLOCK_SIZE)  # the unbuffered path
    r = read.FrameEncoder(io.BytesIO(src), engine=eng)
    n = r.readinto(big)
    assert bytes(big[:n]) == got[:n]


def test_scan_stream_prefix_matches_jax_package():
    stream = native.frame_compress(STREAM_DATA)
    for cut in (0, 5, 10, 17, 70000, len(stream) - 1, len(stream)):
        assert frame.scan_stream_prefix(stream[:cut]) == jframe.scan_stream_prefix(stream[:cut])


def test_engines_and_config_from_reference_carry_the_engine():
    ref_cfg = dataclasses.replace(snappy_tpu.config.Config(), engine="reference")
    assert config_from_reference(dataclasses.asdict(ref_cfg)).engine == "reference"
    assert Config().engine == snappy_tpu.config.Config().engine == "auto"
    with configure(engine="reference"):
        assert engine.get_engine().name == "reference"
    assert engine.get_engine("auto").name == "native"
    assert engine.get_engine("device").compress is native.compress
    assert engine.get_engine("device-fast").name == "device-fast"
    with pytest.raises(ValueError, match="unknown engine"):
        engine.get_engine("tpu")
