"""The port's fast compress equals the JAX package's flat encoder, byte for
byte, on the CPU.

``snappy_tpu_torch.compress(data, profile="fast", device="cpu")`` (the
kernels' plain versions) against ``snappy_tpu.ops.api.compress(data,
profile="fast")`` under ``configure(flat_encode=True)``, and the block-batch
functions under it against their JAX counterparts (Pallas kernels in
interpret mode). Outputs are bytes and integers: tolerance 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import snappy_tpu
from conftest import CORPUS_FILES, load_corpus
from snappy_tpu.ops import api as japi
from snappy_tpu.ops import encode_flat as jef
from snappy_tpu_torch import native
from snappy_tpu_torch.config import Config, config_from_reference, configure
from snappy_tpu_torch.format.varint import write_varu64
from snappy_tpu_torch.ops import api, encode_flat as ef, packing
from snappy_tpu_torch.ops.encode_fast import compress_blocks_fast
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

# Three full blocks and a short tail; blocks_of gives 4 rows, the batch
# shape of every JAX call below but one.
DATA = (
    load_corpus("lcet10.txt")[: 2 * 65536] + load_corpus("fireworks.jpeg")[:65536]
    + b"a short tail " * 90
)


def _jax_compress(data: bytes) -> bytes:
    with snappy_tpu.configure(flat_encode=True):
        return japi.compress(data, profile="fast")


@pytest.mark.parametrize(
    "data", [DATA, b"", b"abcabcabcabcabc"], ids=["three-blocks-and-tail", "empty", "short"]
)
def test_compress_matches_jax_package(data):
    got = api.compress(data, profile="fast", device="cpu")
    assert got == _jax_compress(data)
    assert native.decompress(got) == data


def test_compress_roundtrips_through_the_port():
    comp = api.compress(DATA, profile="fast", device="cpu")
    assert native.decompress(comp) == DATA
    assert api.decompress(comp, device="cpu") == DATA


def test_block_functions_match_jax_package():
    blocks, lens = packing.blocks_of(DATA)
    bt, lt = torch.from_numpy(blocks), torch.from_numpy(lens)
    jb, jl = jnp.asarray(blocks), jnp.asarray(lens)
    want = jef.compress_blocks_flat(jb, jl, interpret=True)
    got = ef.compress_blocks_flat(bt, lt)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want_fast = jef.compress_blocks_flat_fast(jb, jl, interpret=True)
    for fn in (ef.compress_blocks_flat_fast, ef._compress_blocks_flat_split):
        got = fn(bt, lt)
        assert got[0].shape == (4, ef.OUT_W) and got[0].dtype == torch.uint8
        for g, w in zip(got, want_fast):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[2].any()
    out, out_len = ef.compress_blocks_flat_host(blocks, lens, "cpu")
    jout, jlen = jef.compress_blocks_flat_host(blocks, lens)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(out_len, jlen)


def test_first_block_of_each_corpus_file_is_no_larger_than_the_host_codec():
    datas = [load_corpus(name)[:65536] for name in CORPUS_FILES]
    blocks, lens = packing.batch_streams(datas, 65536)
    out, out_len = ef.compress_blocks_flat_host(blocks, lens, "cpu")
    for i, (name, d) in enumerate(zip(CORPUS_FILES, datas)):
        body = out[i, : out_len[i]].tobytes()
        assert native.decompress(write_varu64(len(d)) + body) == d, name
        assert len(write_varu64(len(d))) + int(out_len[i]) <= len(native.compress(d)), name


def test_exact_profile_is_not_ported():
    """The exact profile is ported: the JAX package's exact bytes, with or
    without the profile named; an unknown profile raises."""
    text = b"hello hello hello hello"
    assert api.compress(text, profile="exact", device="cpu") == japi.compress(text, profile="exact")
    assert api.compress(text, device="cpu") == japi.compress(text) == native.compress(text)
    with pytest.raises(ValueError, match="unknown profile"):
        api.compress(b"hello hello hello hello", profile="fastest", device="cpu")


def test_an_overflow_flag_raises(monkeypatch):
    """A flagged block does not raise: as in the JAX package, it takes the
    bytes of the fast parallel encoder (``ops/encode_fast.py``)."""
    real = ef.compress_blocks_flat_fast

    def flagged(blocks, lengths, *, span):
        out, out_len, ovf = real(blocks, lengths, span=span)
        return out, out_len, torch.ones_like(ovf)

    monkeypatch.setattr(ef, "compress_blocks_flat_fast", flagged)
    data = b"abcd" * 100
    got = api.compress(data, profile="fast", device="cpu")
    blocks, lens = packing.blocks_of(data)
    out, out_len = compress_blocks_fast(torch.from_numpy(blocks), torch.from_numpy(lens))
    assert got == write_varu64(len(data)) + out[0, : int(out_len[0])].numpy().tobytes()
    assert native.decompress(got) == data


def test_blocks_per_launch_batches_and_spans(monkeypatch):
    """Launch groups of ``Config.blocks_per_launch`` rows, each padded to a
    power of two, give the same stream; the spans cover every part."""
    calls = []
    real = ef.compress_blocks_flat_host
    monkeypatch.setattr(api, "compress_blocks_flat_host",
                        lambda b, *a, **k: calls.append(b.shape) or real(b, *a, **k))
    monkeypatch.setattr(api, "spans", {})
    with configure(blocks_per_launch=3):
        got = api.compress(DATA, profile="fast", device="cpu")
    assert calls == [(4, 65536), (1, 65536)]  # 3 blocks padded to 4, then 1
    assert set(api.spans) == {"pack", "h2d", "prepass", "kernels", "plan", "d2h", "join"}
    monkeypatch.setattr(api, "spans", None)
    assert got == api.compress(DATA, profile="fast", device="cpu")


def test_config_from_reference_carries_blocks_per_launch():
    ref_cfg = dataclasses.replace(snappy_tpu.config.Config(), blocks_per_launch=7)
    cfg = config_from_reference(dataclasses.asdict(ref_cfg))
    assert cfg.blocks_per_launch == 7
    assert Config().blocks_per_launch == snappy_tpu.config.Config().blocks_per_launch
