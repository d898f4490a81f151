"""The port's copy of the native host runtime equals the JAX package's.

Both bind the same ``core.cpp`` (the port keeps its own copy and builds it
into ``build/``); the host flatten, the op scan, the frame codec and the
CRC tables must agree exactly on corpus chunks, corrupt vectors and the
row the flatten rejects.
"""

import numpy as np
import pytest

from conftest import load_corpus
from snappy_tpu import native as jnative
from snappy_tpu.format import reference as jref
from snappy_tpu.format import tables as jtables
from snappy_tpu.format.varint import read_varu64
from snappy_tpu_torch import native
from snappy_tpu_torch.format import tables
from snappy_tpu_torch.ops import _build, packing
from torch_vectors import CORRUPT, fallback_row, hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()


def _body(data: bytes) -> tuple[bytes, int]:
    c = jref.compress(data)
    _, h = read_varu64(c)
    return c[h:], len(data)


def _rows(cases, width=None):
    srcs, lens = packing.batch_streams([c[0] for c in cases], width)
    declens = np.asarray([c[1] for c in cases], np.uint64)
    return srcs, lens.astype(np.uint64), declens


CORPUS_ROWS = [
    _body(load_corpus("html")[:65536]),
    _body(load_corpus("plrabn12.txt")[:65536]),
    _body(load_corpus("fireworks.jpeg")[:40000]),
    _body(b"ab" * 20000),
    _body(bytes(65536)),
]


@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("which", ["corpus", "corrupt", "fallback"])
def test_flatten_idx_batch_matches_jax_package(layout, which):
    cases = {"corpus": CORPUS_ROWS, "corrupt": CORRUPT, "fallback": [fallback_row()]}[which]
    srcs, lens, declens = _rows(cases, 1024 if which == "corrupt" else None)
    d_pad = packing.pad_to_bucket(int(declens.max()), 16384)
    got = native.flatten_idx_batch(srcs, lens, declens, d_pad, layout=layout)
    want = jnative.flatten_idx_batch(srcs, lens, declens, d_pad, layout=layout)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if which == "fallback":
        assert int(got[2][0]) != 0  # the flatten rejects the row
    if which == "corrupt":
        assert (got[3] > 0).all()


@pytest.mark.parametrize("which", ["corpus", "corrupt", "fallback"])
def test_scan_records_batch_matches_jax_package(which):
    cases = {"corpus": CORPUS_ROWS, "corrupt": CORRUPT, "fallback": [fallback_row()]}[which]
    srcs, lens, declens = _rows(cases)
    got = native.scan_records_batch(srcs, lens, declens, 512)
    want = jnative.scan_records_batch(srcs, lens, declens, 512)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_frame_codec_and_crc_match_jax_package():
    data = load_corpus("alice29.txt") + load_corpus("fireworks.jpeg")[:70000]
    frame = native.frame_compress(data)
    assert frame == jnative.frame_compress(data)
    assert native.frame_decompress(frame) == data
    for chunk in (b"", b"a", data[:65536], data[-5000:]):
        assert native.crc32c_masked(chunk) == jnative.crc32c_masked(chunk)
    streams = [jref.compress(load_corpus("html")[:65536]), jref.compress(b"xyz" * 999)]
    assert native.decompress_batch(streams) == jnative.decompress_batch(streams)
    assert native.decompress(streams[1]) == b"xyz" * 999


def test_crc_and_tag_tables_match_jax_package():
    np.testing.assert_array_equal(tables.crc32c_table(), jtables.crc32c_table())
    np.testing.assert_array_equal(tables.crc32c_table16(), jtables.crc32c_table16())
    np.testing.assert_array_equal(tables.tag_lookup_table(), jtables.tag_lookup_table())


def test_native_library_builds_into_the_build_directory():
    native.crc32c_masked(b"x")
    lib = native._load()
    assert str(_build.BUILD_DIR) in lib._name
    assert lib._name != jnative._load()._name
