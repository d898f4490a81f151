"""The port's fast parallel encoder and device frame encoder equal the JAX
package's, byte for byte, on the CPU.

``snappy_tpu_torch.ops.encode_fast.compress_blocks_fast`` against
``snappy_tpu.ops.encode_fast.compress_blocks_fast``, and
``snappy_tpu_torch.ops.frame.encode_frame_chunks`` (K1 and K7's plain
versions, or the fast encoder) against ``snappy_tpu.ops.frame``'s, on the
same numpy chunks; and the flat encoder's overflow route. Outputs are
bytes and integers: tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import load_corpus
from snappy_tpu.ops import encode_fast as jfast
from snappy_tpu.ops import frame as jframe
from snappy_tpu_torch import native, trace
from snappy_tpu_torch.format.varint import write_varu64
from snappy_tpu_torch.ops import encode_fast as fast, encode_flat as ef, frame, packing
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

_rng = np.random.default_rng(5)
CHUNKS = [
    load_corpus("alice29.txt")[:8000],
    bytes(_rng.integers(0, 256, 3000, dtype=np.uint8)),  # incompressible: stored raw
    b"abc" * 3000,
    bytes(_rng.integers(0, 4, 2000, dtype=np.uint8)),
    b"q" * 16,  # one literal
    b"x" * 200,  # varint of two bytes
    (b"the quick brown fox " * 4000)[:65536],  # a full chunk; varint of three bytes
    b"",
]


def _batch():
    blocks, lens = packing.batch_streams(CHUNKS, 65536)
    return blocks, lens


def test_compress_blocks_fast_matches_jax_package():
    blocks, lens = _batch()
    out, out_len = fast.compress_blocks_fast(torch.from_numpy(blocks), torch.from_numpy(lens))
    jout, jlen = jfast.compress_blocks_fast(jnp.asarray(blocks), jnp.asarray(lens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))
    for i, d in enumerate(CHUNKS):
        assert native.decompress(write_varu64(len(d)) + out[i, : out_len[i]].numpy().tobytes()) == d


@pytest.mark.parametrize("fast_codec", [False, True], ids=["exact", "fast"])
def test_encode_frame_chunks_matches_jax_package(fast_codec):
    blocks, lens = _batch()
    rows, row_len = frame.encode_frame_chunks(
        torch.from_numpy(blocks), torch.from_numpy(lens), fast=fast_codec
    )
    jrows, jlen = jframe.encode_frame_chunks(jnp.asarray(blocks), jnp.asarray(lens), fast=fast_codec)
    assert rows.shape == (len(CHUNKS), frame.CHUNK_W) and row_len.dtype == torch.int32
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(row_len.numpy(), np.asarray(jlen))
    stream = b"\xff\x06\x00\x00sNaPpY" + packing.concat_rows(rows.numpy(), row_len.numpy())
    assert native.frame_decompress(stream) == b"".join(CHUNKS)
    if not fast_codec:  # each chunk's frame is the host codec's
        for i, d in enumerate(CHUNKS[:-1]):
            assert rows[i, : row_len[i]].numpy().tobytes() == native.frame_compress(d)[10:], i
    assert int(rows[0, 0]) == 0 and int(rows[1, 0]) == 1  # compressed; stored raw


def test_encode_frame_host_launches_in_groups(monkeypatch):
    """Launches of ``CHUNKS_PER_LAUNCH`` chunks give the host codec's
    frames, and the spans cover every part."""
    data = (b"0123456789abcdef" * 4096) * 3 + b"tail"
    monkeypatch.setattr(frame, "CHUNKS_PER_LAUNCH", 2)
    monkeypatch.setattr(trace, "spans", {})
    parts = frame.encode_frame_host(data, "cpu")
    assert len(parts) == 2
    assert set(trace.spans) == {"pack", "h2d", "kernels", "assemble", "d2h", "join"}
    assert b"\xff\x06\x00\x00sNaPpY" + b"".join(parts) == native.frame_compress(data)


def test_an_overflow_flag_takes_the_fast_encoders_bytes(monkeypatch):
    """A block the flat encoder flags takes ``compress_blocks_fast``'s
    bytes, as in the JAX package; the other blocks keep the flat bytes."""
    datas = [load_corpus("html")[:20000], b"abcd" * 1000, load_corpus("kppkn.gtb")[:9000]]
    blocks, lens = packing.batch_streams(datas, 65536)
    want_flat = ef.compress_blocks_flat_host(blocks, lens, "cpu")
    want_fast = fast.compress_blocks_fast(torch.from_numpy(blocks), torch.from_numpy(lens))
    real = ef.compress_blocks_flat_fast

    def flagged(blocks, lengths):
        out, out_len, ovf = real(blocks, lengths)
        return out, out_len, torch.tensor([0, 1, 0], dtype=ovf.dtype)

    monkeypatch.setattr(ef, "compress_blocks_flat_fast", flagged)
    out, out_len = ef.compress_blocks_flat_host(blocks, lens, "cpu")
    for i in (0, 2):
        np.testing.assert_array_equal(out[i], want_flat[0][i])
        assert out_len[i] == want_flat[1][i]
    np.testing.assert_array_equal(out[1], want_fast[0][1].numpy())
    assert out_len[1] == int(want_fast[1][1])
