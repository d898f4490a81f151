"""The port's ``ops.decode.decode_block`` (one raw op stream, the tensor
decode on the CPU) gives the JAX package's ``decode_block``: the same
``(d_pad,)`` bytes, error code and decoded length, on corpus chunks and on
the reference's corrupt vectors. Equality throughout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_corpus
from snappy_tpu.ops.decode import decode_block as jax_decode_block
from snappy_tpu_torch.ops.decode import OK, decode_block
from torch_vectors import CORRUPT, hold_jax_native, raw_body, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

D_PAD = 8192
WIDTH = 8192
CHUNKS = [("alice29.txt", 0, 6000), ("html", 3000, 8192), ("fireworks.jpeg", 1000, 2500)]


def _jax(src, n, declen):
    fn = jax.jit(jax_decode_block, static_argnames=("d_pad",))
    dst, err, total = fn(jnp.asarray(src), jnp.int32(n), jnp.int32(declen), d_pad=D_PAD)
    return np.asarray(dst), int(err), int(total)


def _row(body: bytes) -> np.ndarray:
    src = np.zeros(WIDTH, np.uint8)
    src[: len(body)] = np.frombuffer(body, np.uint8)
    return src


def _check(body: bytes, declen: int):
    src = _row(body)
    dst, err, total = decode_block(torch.from_numpy(src), len(body), declen, D_PAD)
    assert dst.shape == (D_PAD,) and dst.dtype == torch.uint8
    assert err.dim() == 0 and total.dim() == 0 and err.dtype == total.dtype == torch.int32
    want_dst, want_err, want_total = _jax(src, len(body), declen)
    np.testing.assert_array_equal(dst.numpy(), want_dst)
    assert (int(err), int(total)) == (want_err, want_total)
    return dst.numpy(), int(err)


@pytest.mark.parametrize("name,start,n", CHUNKS)
def test_decode_block_matches_the_jax_package_on_corpus_chunks(name, start, n):
    data = load_corpus(name)[start : start + n]
    body, declen = raw_body(data)
    dst, err = _check(body, declen)
    assert err == OK and dst[:declen].tobytes() == data


@pytest.mark.parametrize("case", range(len(CORRUPT)))
def test_decode_block_matches_the_jax_package_on_corrupt_vectors(case):
    body, declen = CORRUPT[case]
    _, err = _check(body, declen)
    assert err != OK


def test_decode_block_takes_tensor_lengths():
    data = load_corpus("alice29.txt")[:3000]
    body, declen = raw_body(data)
    src = torch.from_numpy(_row(body))
    a = decode_block(src, len(body), declen, D_PAD)
    b = decode_block(src, torch.tensor(len(body)), torch.tensor(declen, dtype=torch.int64), D_PAD)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
