"""K3's plain version equals the JAX package's replay kernel
``decode_batch_pallas`` (interpret mode), bytes and error codes, error
rows included: the valid prefix, zeros after it, and the first bad op's
code. The three Pallas modes share one contract, so each is compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import load_corpus
from snappy_tpu.format import reference as jref
from snappy_tpu.format.varint import read_varu64
from snappy_tpu.ops.pallas.decode import decode_batch_pallas
from snappy_tpu_torch.ops import replay
from torch_vectors import CORRUPT, overlap_rows, hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

MODES = [False, True, "compose"]

def _body(data: bytes) -> tuple[bytes, int]:
    c = jref.compress(data)
    return c[read_varu64(c)[1]:], len(data)


def _valid_rows():
    rng = np.random.default_rng(11)
    return [
        _body(b"hello world hello world hello world!"),
        _body(bytes(rng.integers(0, 4, 3000, dtype=np.uint8))),
        _body(b"a" * 500),
        _body(load_corpus("html")[:4096]),
        _body(bytes(rng.integers(0, 256, 1500, dtype=np.uint8))),
        _body(b"x"),
    ]


def _batch(rows):
    s = -(-max(len(b) for b, _ in rows) // 128) * 128
    srcs = np.zeros((len(rows), s), np.uint8)
    for i, (b, _) in enumerate(rows):
        srcs[i, : len(b)] = np.frombuffer(b, np.uint8)
    lens = np.asarray([len(b) for b, _ in rows], np.int32)
    declens = np.asarray([d for _, d in rows], np.int32)
    return srcs, lens, declens, -(-max(int(declens.max()), 1) // 128) * 128


ROWS = {"corrupt": CORRUPT, "valid": _valid_rows(), "overlap": overlap_rows()}


@pytest.mark.parametrize("mode", MODES, ids=["plain", "fast", "compose"])
@pytest.mark.parametrize("which", sorted(ROWS))
def test_plain_replay_matches_pallas_interpret(which, mode):
    srcs, lens, declens, d_pad = _batch(ROWS[which])
    want_dst, want_err = decode_batch_pallas(
        jnp.asarray(srcs), jnp.asarray(lens), jnp.asarray(declens), d_pad,
        interpret=True, fastpath=mode,
    )
    dst, errs = replay.decode_replay(
        torch.from_numpy(srcs), torch.from_numpy(lens), torch.from_numpy(declens), d_pad
    )
    assert dst.dtype == torch.uint8 and errs.dtype == torch.int32
    np.testing.assert_array_equal(errs.numpy(), np.asarray(want_err))
    np.testing.assert_array_equal(dst.numpy(), np.asarray(want_dst))
    if which == "corrupt":
        assert (errs.numpy() > 0).all()
    else:
        assert not errs.numpy().any()


def test_error_rows_keep_their_valid_prefix():
    srcs, lens, declens, d_pad = _batch(CORRUPT[-2:])
    dst, errs = replay.decode_replay(
        torch.from_numpy(srcs), torch.from_numpy(lens), torch.from_numpy(declens), d_pad
    )
    assert errs.tolist() == [replay.E_COPYWRITE, replay.E_OFFSET]
    for row in dst.numpy():
        assert row[:4].tobytes() == b"abcd" and not row[4:].any()


def test_wrapper_checks_its_inputs():
    srcs = torch.zeros((1, 128), dtype=torch.uint8)
    i32 = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        replay.decode_replay(srcs, i32.to(torch.int64), i32, 128)
    with pytest.raises(ValueError):
        replay.decode_replay(srcs, i32 + 200, i32, 128)  # src_len past the row
