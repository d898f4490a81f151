"""K1's plain version equals the JAX package's CRC32C formulations:
the XLA matmul the decode path calls and the Pallas kernel (interpret
mode). CRCs are integers, so the comparison is exact."""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from snappy_tpu.format.crc32c import crc32c
from snappy_tpu.ops import crc32c as jcrc
from snappy_tpu.ops.pallas.crc32c import crc32c_blocks_pallas
from snappy_tpu_torch.ops import crc32c as tcrc
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

def _rows(seed: int, b: int, s: int):
    """Zero-padded random rows with random lengths, including 0 and s."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, s + 1, b).astype(np.int32)
    lens[:2] = (0, s)
    rows = np.zeros((b, s), np.uint8)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(0, 256, n, dtype=np.uint8)
    return rows, lens


def _port(fn, rows, lens):
    out = fn(torch.from_numpy(rows), torch.from_numpy(lens))
    assert out.dtype == torch.int64 and out.shape == (rows.shape[0],)
    return out.numpy().astype(np.uint32)


@pytest.mark.parametrize("s", [4, 1024, 65536])
def test_plain_masked_crc_matches_xla(s):
    rows, lens = _rows(5, 8 if s == 65536 else 16, s)
    want = np.asarray(jcrc.crc32c_masked_blocks(rows, lens))
    np.testing.assert_array_equal(_port(tcrc.crc32c_masked_blocks, rows, lens), want)
    want_u = np.asarray(jcrc.crc32c_blocks(rows, lens))
    np.testing.assert_array_equal(_port(tcrc.crc32c_blocks, rows, lens), want_u)


def test_plain_crc_matches_pallas_interpret():
    rows, lens = _rows(3, 8, 4096)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(crc32c_blocks_pallas(rows, lens))
    np.testing.assert_array_equal(_port(tcrc.crc32c_blocks, rows, lens), want)


def test_bytes_past_the_length_are_ignored():
    rows, lens = _rows(9, 12, 3000)  # not a power of two: the port needs none
    dirty = rows.copy()
    rng = np.random.default_rng(1)
    for i, n in enumerate(lens):
        dirty[i, n:] = rng.integers(1, 256, 3000 - n, dtype=np.uint8)
    want = np.array([crc32c(rows[i, :n].tobytes()) for i, n in enumerate(lens)], np.uint32)
    np.testing.assert_array_equal(_port(tcrc.crc32c_blocks, dirty, lens), want)


def test_shift_operators_match_jax_package():
    np.testing.assert_array_equal(
        tcrc.shift_operators(), np.asarray(jcrc.shift_operators()[:32], np.uint32)
    )


def test_wrapper_checks_its_inputs():
    rows = torch.zeros((2, 8), dtype=torch.uint8)
    with pytest.raises(TypeError):
        tcrc.crc32c_blocks(rows.to(torch.int32), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):
        tcrc.crc32c_blocks(rows, torch.zeros(3, dtype=torch.int32))
    assert tcrc.crc32c_blocks(rows[:0], torch.zeros(0, dtype=torch.int32)).shape == (0,)
