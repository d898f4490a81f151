"""The port's host-codec batch calls equal the JAX package's.

``compress_batch_into``, ``decompress_batch_into``, ``compress_batch`` and
the unmasked ``crc32c`` of ``snappy_tpu_torch.native`` bind the same C
entries of the port's own copy of ``core.cpp``: on the corpus files and on
corrupt rows they must give the JAX package's bytes, ``(n, 4)`` error rows
and first-row exceptions.
"""

import numpy as np
import pytest

from conftest import CORPUS_FILES, load_corpus
from snappy_tpu import native as jnative
from snappy_tpu_torch import native
from snappy_tpu_torch.format.constants import max_compress_len
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()


def _blocks() -> list[bytes]:
    out = []
    for name in CORPUS_FILES:
        d = load_corpus(name)
        out.extend(d[o : o + 65536] for o in range(0, len(d), 65536))
    return out


BLOCKS = _blocks()


def _rows(items: list[bytes]):
    width = max(1, max(len(b) for b in items))
    srcs = np.zeros((len(items), width), np.uint8)
    lens = np.zeros(len(items), np.uint64)
    for i, b in enumerate(items):
        srcs[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return srcs, lens


def _into(mod, fn: str, items: list[bytes], dst_w: int, threads: int):
    srcs, lens = _rows(items)
    dsts = np.zeros((len(items), dst_w), np.uint8)
    out_lens = np.zeros(len(items), np.uint64)
    errs = np.zeros((len(items), 4), np.uint64)
    getattr(mod, fn)(srcs, lens, dsts, out_lens, errs, threads)
    return dsts, out_lens, errs


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the comparison is the check
        return (type(e).__name__, getattr(e, "_values", lambda: None)(), str(e))


@pytest.mark.parametrize("threads", [1, 0])
def test_compress_batch_into_matches_jax_package(threads):
    dst_w = max_compress_len(65536)
    got = _into(native, "compress_batch_into", BLOCKS, dst_w, threads)
    want = _into(jnative, "compress_batch_into", BLOCKS, dst_w, threads)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert not got[2].any()
    assert [got[0][i, : int(n)].tobytes() for i, n in enumerate(got[1])] == [
        jnative.compress(b) for b in BLOCKS
    ]


def _corrupt_streams() -> list[bytes]:
    good = [jnative.compress(b) for b in BLOCKS[:6]]
    return [
        good[0],
        good[1][: len(good[1]) // 2],  # truncated body
        b"\xff" * 9,  # bad varint header
        good[2][:-3],
        b"",  # empty
        b"\x05\x00a\x01\x00",  # copy offset zero
        b"\x10\x00a\x3f\x00",  # copy reads before the output
        good[3],
    ]


@pytest.mark.parametrize("rows", ["corpus", "corrupt"])
def test_decompress_batch_into_matches_jax_package(rows):
    """The same rows, lengths and error codes, and each failing row the same
    exception. The C runtime (one source in both packages) sets only the
    fields an error carries: the others hold whatever its stack held, so
    rows are compared through the exception they stand for."""
    items = [jnative.compress(b) for b in BLOCKS] if rows == "corpus" else _corrupt_streams()
    got = _into(native, "decompress_batch_into", items, 65536, 0)
    want = _into(jnative, "decompress_batch_into", items, 65536, 0)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert np.array_equal(got[2][:, 0], want[2][:, 0])
    for g, w in zip(got[2], want[2]):
        assert _outcome(lambda: native._raise_first(g[None])) == _outcome(
            lambda: jnative._raise_first(w[None]))
    assert bool(got[2][:, 0].any()) == (rows == "corrupt")
    if rows == "corrupt":
        assert {int(c) for c in got[2][:, 0]} >= {0, 1, 3, 4, 5, 7, 8}


def test_compress_batch_matches_jax_package():
    assert native.compress_batch(BLOCKS) == jnative.compress_batch(BLOCKS)
    assert native.compress_batch([]) == jnative.compress_batch([]) == []
    small = [b"", b"abc", b"ab" * 5000]
    assert native.compress_batch(small, threads=2) == jnative.compress_batch(small, threads=2)


class _Huge:
    """A row longer than any input Snappy takes; nothing reads its bytes,
    since the length check comes before any work."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n


@pytest.mark.parametrize("rows", [
    [b"ok", _Huge(2**32), _Huge(2**33)],
    [_Huge(2**32 + 7), b"ok"],
], ids=["second-row", "first-row"])
def test_compress_batch_raises_the_first_too_big_row(rows):
    got, want = _outcome(lambda: native.compress_batch(rows)), _outcome(
        lambda: jnative.compress_batch(rows))
    assert got == want and got[0] == "TooBig"


@pytest.mark.parametrize("n", [4, 8])
def test_decompress_batch_raises_the_first_failing_row(n):
    items = _corrupt_streams()[:n]
    got = _outcome(lambda: native.decompress_batch(items))
    assert got == _outcome(lambda: jnative.decompress_batch(items)) and got[0] != "ok"


def test_crc32c_matches_jax_package_at_every_length():
    rng = np.random.default_rng(11)
    blob = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    got = [native.crc32c(blob[:n]) for n in range(301)]
    assert got == [jnative.crc32c(blob[:n]) for n in range(301)]
    assert got[0] == 0 and native.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("name", CORPUS_FILES)
def test_crc32c_matches_jax_package_on_corpus(name):
    d = load_corpus(name)
    assert native.crc32c(d) == jnative.crc32c(d)
