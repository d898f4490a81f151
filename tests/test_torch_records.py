"""K10's plain version (``ops/records.py``) equals the JAX package's record
replay kernel ``decode_records_pallas`` (interpret mode, both of its move
machineries) on the rows of its own records test and a row the scan cut
short: whole rows, the valid prefix and zeros after it; and on rows whose
copy chains are deep, copies that overlap themselves at offsets 1-129 and
corrupt rows, which the kernel's pointer doubling must resolve alike.
Exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snappy_tpu.ops.pallas.decode import decode_records_pallas
from snappy_tpu_torch import native
from snappy_tpu_torch.format.varint import write_varu64
from snappy_tpu_torch.ops import records
from torch_vectors import (
    CORRUPT, REPO, hold_jax_native, overlap_rows, raw_body, scan_batch, share_cores_with_workers,
)

share_cores_with_workers()
hold_jax_native()


def _rows():
    rng = np.random.default_rng(61)
    datas = [
        (REPO / "data" / "html").read_bytes()[:4096],
        b"a" * 700,  # offset-1 overlapping copies
        rng.integers(0, 256, 900, dtype=np.uint8).tobytes(),  # literal-heavy
        rng.integers(0, 4, 1500, dtype=np.uint8).tobytes(),  # copy-heavy
        b"z",
    ]
    return [raw_body(d) for d in datas] + [(b"\x00a\x1d\x01", 5)] + overlap_rows()


def _tensors(srcs, recs, nops, declens):
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (srcs, recs, nops.astype(np.int32), declens)]


@pytest.mark.parametrize("compose", [False, True], ids=["records", "compose"])
def test_plain_matches_decode_records_pallas(compose):
    rows = _rows()
    srcs, _, declens, recs, nops, errs = scan_batch(rows, 2048)
    r_pad = max(512, -(-int(nops.max()) // 512) * 512)
    recs = recs[:, :r_pad]
    d_pad = -(-int(declens.max()) // 128) * 128
    want = np.asarray(decode_records_pallas(
        jnp.asarray(srcs), jnp.asarray(recs), jnp.asarray(nops.astype(np.int32)),
        jnp.asarray(declens), d_pad, interpret=True, compose=compose,
    ))
    got = records.decode_records(*_tensors(srcs, recs, nops, declens), d_pad)
    assert got.dtype == torch.uint8 and got.shape == (len(rows), d_pad)
    np.testing.assert_array_equal(got.numpy(), want)
    assert errs.tolist().count(0) == len(rows) - 1
    assert got[5, :5].tolist() == [97, 0, 0, 0, 0]  # the cut row: its literal, then zeros


def test_plain_decodes_a_wide_row():
    """A 102,400-byte stream in one row at ``d_pad`` 131072 (the records
    route takes widths up to ``max_dpad``), beside a row of zeros."""
    data = (REPO / "data" / "html").read_bytes()
    rows = [raw_body(data), raw_body(bytes(70000))]
    srcs, _, declens, recs, nops, errs = scan_batch(rows, 16384)
    assert not errs.any() and int(nops[0]) == 6934
    got = records.decode_records(*_tensors(srcs, recs, nops, declens), 1 << 17).numpy()
    assert got[0, : len(data)].tobytes() == data and not got[0, len(data):].any()
    assert not got[1].any()


def test_wrapper_checks_its_inputs():
    srcs = torch.zeros((1, 128), dtype=torch.uint8)
    recs = torch.zeros((1, 512, 2), dtype=torch.int32)
    i32 = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        records.decode_records(srcs, recs.to(torch.int64), i32, i32, 1024)
    with pytest.raises(ValueError):
        records.decode_records(srcs, recs, i32 + 513, i32, 1024)  # more ops than records
    with pytest.raises(ValueError):
        records.decode_records(srcs, recs, i32, i32 + 2000, 1024)  # declen past d_pad
    assert not records.decode_records(srcs, recs, i32, i32, 1024).any()


def _chain_rows():
    """Rows for the doubling: deep chains (a run of one byte is a literal,
    then 64-byte copies that each read the last), self-overlapping copies
    of every offset from 1 to 129, and the corrupt vectors."""
    rng = np.random.default_rng(67)
    return {
        "deep": [raw_body(b"a" * 4096), raw_body(bytes(range(7)) * 500),
                 raw_body(rng.integers(0, 2, 3000, dtype=np.uint8).tobytes())],
        "overlap": overlap_rows(tuple(range(1, 130, 4)) + (128, 129), copies=3),
        "corrupt": CORRUPT + [raw_body(b"b" * 900)],
    }


@pytest.mark.parametrize("kind", ["deep", "overlap", "corrupt"])
def test_plain_matches_pallas_on_chains_and_cuts(kind):
    rows = _chain_rows()[kind]
    srcs, _, declens, recs, nops, errs = scan_batch(rows, 2048)
    r_pad = max(512, -(-int(nops.max()) // 512) * 512)
    recs = recs[:, :r_pad]
    d_pad = -(-int(declens.max()) // 128) * 128
    want = np.asarray(decode_records_pallas(
        jnp.asarray(srcs), jnp.asarray(recs), jnp.asarray(nops.astype(np.int32)),
        jnp.asarray(declens), d_pad, interpret=True,
    ))
    got = records.decode_records(*_tensors(srcs, recs, nops, declens), d_pad)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "corrupt":
        assert (errs[: len(CORRUPT)] > 0).all() and errs[-1] == 0
        assert got[-2].tolist()[:5] == [97, 98, 99, 100, 0]  # a valid literal, then the cut
    else:
        assert not errs.any()
        for i, (body, declen) in enumerate(rows):
            assert got[i, :declen].numpy().tobytes() == native.decompress(
                write_varu64(declen) + body)


def test_plain_resolves_a_64k_chain():
    """``b"a" * 65536`` at ``d_pad`` 65536, no interpret mode: a literal,
    then 1,024 copies of 64 bytes whose bytes all read the byte before
    them (a chain 65,535 deep); and ``b"a" * 4096``. Window by window
    (K10's CTA path), each 4,096-byte window chains 64 copies: 6 rounds
    and one that finds every hop an origin (windows of 1,024 bytes: 16
    copies, 4 rounds and that one)."""
    for data, d_pad in ((b"a" * 65536, 65536), (b"a" * 4096, 4096)):
        srcs, _, declens, recs, nops, errs = scan_batch([raw_body(data)], 16384)
        t = _tensors(srcs, recs, nops, declens)
        got = records.decode_records(*t, d_pad)
        assert not errs.any()
        assert got[0].numpy().tobytes() == native.decompress(native.compress(data))
        assert records.window_rounds(*t, d_pad).tolist() == [7 * d_pad // 4096]
        assert records.window_rounds(*t, d_pad, window=1024).tolist() == [5 * d_pad // 1024]
