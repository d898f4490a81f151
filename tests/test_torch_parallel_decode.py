"""The port's tensor decode (``ops/decode.py``) equals the JAX package's XLA
decode (``snappy_tpu/ops/decode.py``) on the CPU: ``decode_batch``,
``decode_batch_hosted`` and both CRC variants give the same bytes (whole
rows, past ``declen`` too), error codes, ``total_d`` and CRCs, and the
speculative parse and the op discovery give the same planes. Inputs:
corpus slices, the corrupt vectors, long literals near the length clamp,
and 240 seeded random and truncated rows; the hosted variants also on
random op-start bitmaps, whose sums wrap ``int32``. All integers:
equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_corpus
from snappy_tpu import native as jnative
from snappy_tpu.ops import decode as jdec
from snappy_tpu_torch import native
from snappy_tpu_torch.format.varint import write_varu64
from snappy_tpu_torch.ops import decode as dec
from torch_vectors import CORRUPT, hold_jax_native, raw_body, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()


def _batch(rows, width):
    srcs = np.zeros((len(rows), width), np.uint8)
    for i, (b, _) in enumerate(rows):
        srcs[i, : len(b)] = np.frombuffer(b, np.uint8)
    lens = np.asarray([len(b) for b, _ in rows], np.int32)
    declens = np.asarray([d for _, d in rows], np.int32)
    bits = np.zeros((len(rows), width // 8), np.uint8)
    native.scan_ops_batch(srcs, lens.astype(np.uint64), bits)
    return srcs, lens, declens, bits


def corpus_rows():
    datas = [load_corpus("html")[:65536], load_corpus("kppkn.gtb")[:60000],
             load_corpus("fireworks.jpeg")[:40000], b"ab" * 20000, bytes(65536),
             load_corpus("urls.10K")[:33333]]
    return [raw_body(d) for d in datas] + CORRUPT


def random_rows():
    """Valid streams, random bytes, truncated streams (real ones cut short,
    with random declared lengths) and long literals whose length nears or
    passes ``_CAP``."""
    rng = np.random.default_rng(41)
    rows = [(b"\xfc\xff\xff\xff\x3f" + b"x" * 20, 30), (b"\xfc\xff\xff\xff\xff", 1 << 30),
            (b"\xfc\x00\x00\x00\x40", 9), (b"\xf8\xff\xff\xff", 40),
            (b"\x00a\xfc\xfe\xff\xff\x3f", 5), (b"\xf4\xff\xff", 1 << 17)]
    for k in range(240):
        if k % 15 == 0:
            rows.append(raw_body(rng.integers(0, 1 + k % 5, int(rng.integers(1, 6000)),
                                              dtype=np.uint8).tobytes()))
            continue
        if k % 3 == 0:
            body, _ = raw_body(rng.integers(0, 1 + k % 7, 2000, dtype=np.uint8).tobytes())
            body = body[: int(rng.integers(1, len(body) + 1))]
        else:
            body = rng.integers(0, 256, int(rng.integers(1, 1024)), dtype=np.uint8).tobytes()
        rows.append((body, int(rng.integers(0, 5000))))
    return rows


BATCHES = {"corpus": (corpus_rows, 65536, 65536), "random": (random_rows, 2048, 8192)}


def _port(fn, *arrays, d_pad):
    out = fn(*(torch.from_numpy(a) for a in arrays), d_pad)
    return [o.numpy().astype(np.int64) for o in out]


def _jax(fn, *arrays, d_pad):
    return [np.asarray(o).astype(np.int64) for o in fn(*(jnp.asarray(a) for a in arrays), d_pad)]


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_decode_variants_match_jax_package(batch):
    make, width, d_pad = BATCHES[batch]
    rows = make()
    srcs, lens, declens, bits = _batch(rows, width)
    want = {}
    for name in ("decode_batch", "decode_crc_batch", "decode_batch_hosted",
                 "decode_crc_batch_hosted"):
        args = (srcs, lens, declens) + ((bits,) if "hosted" in name else ())
        got = _port(getattr(dec, name), *args, d_pad=d_pad)
        want[name] = _jax(getattr(jdec, name), *args, d_pad=d_pad)
        assert len(got) == len(want[name])
        for g, w in zip(got, want[name]):
            np.testing.assert_array_equal(g, w, err_msg=name)
    dst, err, total, crc = want["decode_crc_batch"]
    np.testing.assert_array_equal(want["decode_crc_batch_hosted"][1], err)
    ok = np.nonzero(err == dec.OK)[0]
    assert len(ok) and len(ok) < len(rows) and set(err.tolist()) >= {1, 3, 5}
    for i in ok:
        out = dst[i, : declens[i]].astype(np.uint8).tobytes()
        assert out == native.decompress(write_varu64(int(declens[i])) + rows[i][0])
        assert crc[i] == native.crc32c_masked(out) and total[i] == declens[i]


def test_hosted_on_random_bitmaps_matches_jax_package():
    """A wrong bitmap is validated, not trusted: random op starts, with
    literal lengths near ``_CAP``, wrap the int32 output offsets and totals
    in both packages alike."""
    rows = random_rows()
    srcs, lens, declens, _ = _batch(rows, 2048)
    bits = np.random.default_rng(5).integers(0, 256, (len(rows), 256), dtype=np.uint8)
    got = _port(dec.decode_crc_batch_hosted, srcs, lens, declens, bits, d_pad=8192)
    want = _jax(jdec.decode_crc_batch_hosted, srcs, lens, declens, bits, d_pad=8192)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert want[2].min() < 0 < want[2].max()  # some totals wrapped


@pytest.mark.parametrize("batch", sorted(BATCHES))
def test_parse_and_op_discovery_planes_match_jax_package(batch):
    make, width, _ = BATCHES[batch]
    srcs, lens, declens, bits = _batch(make(), width)
    fields = dec.parse_positions(torch.from_numpy(srcs), torch.from_numpy(lens))
    jfields = jax.jit(jax.vmap(jdec._parse_positions))(jnp.asarray(srcs), jnp.asarray(lens))
    assert set(fields) == set(jfields)
    for k in fields:
        np.testing.assert_array_equal(
            fields[k].numpy().astype(np.int64), np.asarray(jfields[k]).astype(np.int64), err_msg=k
        )
    got = dec.discover_ops(fields["consumed"], fields["produced"], torch.from_numpy(lens))
    want = jax.jit(jax.vmap(jdec._discover_ops))(
        jfields["consumed"], jfields["produced"], jnp.asarray(lens)
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), np.asarray(w).astype(np.int64))
    # The host's bitmaps mark the same op starts.
    mask = dec.hosted_op_mask(torch.from_numpy(bits), torch.from_numpy(lens), width)
    assert torch.equal(mask, got[0])


def test_scan_ops_bindings_match_jax_package():
    rows = corpus_rows()[:3] + random_rows()[:40]
    srcs, lens, _, bits = _batch(rows, 65536)
    for i, (body, _) in enumerate(rows):
        want = jnative.scan_ops(body)
        np.testing.assert_array_equal(native.scan_ops(body), want)
        np.testing.assert_array_equal(bits[i, : len(want)], want)
        assert not bits[i, len(want):].any()
    with pytest.raises(ValueError):
        native.scan_ops_batch(srcs, lens.astype(np.uint64), np.zeros((len(rows), 8), np.uint8))
