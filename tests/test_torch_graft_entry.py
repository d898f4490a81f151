"""The port's graft entry (``snappy_tpu_torch.graft_entry``) against the
repository's ``__graft_entry__.py``, on the CPU.

``entry(device="cpu")`` takes the JAX ``entry()``'s inputs and gives its
frame rows byte for byte (lengths, chunk types, the headers' length fields,
the compressed bodies) but for one fault of the reference, which the port
does not copy. The JAX CRC (``snappy_tpu/ops/crc32c.py`` ``crc32c_blocks``)
reads every row to its full width and needs zeros past the row's length,
and ``entry()`` tiles its snippet over the whole width of every row. So the
JAX rows 2 and 3 (lengths 40000 and 517) carry the masked CRCs 0x4f85f8c5
and 0xe6a54466 in bytes 4-7, those of the full 65,536-byte rows: the host
codec refuses them (bad checksum). The CRCs of their first ``len`` bytes
are 0x33c2500f and 0x499a946c; the port's rows carry them, and the JAX CRC
gives them too once the rows are zeroed past their lengths. Rows 0 and 1
fill their width, and their CRCs agree. The reference stays as it is.

``dryrun_multichip(n, device="cpu")`` runs every leg of the JAX dry run on
a mesh of ``n`` CPU entries; a byte flipped in any leg's output makes it
raise, and asking for more cards than there are raises too. The card runs
of both functions are in ``test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
from snappy_tpu.ops import crc32c as jcrc
from snappy_tpu_torch import error, graft_entry, native
from snappy_tpu_torch.format.constants import STREAM_IDENTIFIER
from snappy_tpu_torch.format.crc32c import crc32c_masked
from torch_vectors import hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

#: Bytes 4-7 of the JAX entry's rows 2 and 3, and the CRCs of their first
#: ``len`` bytes, which the port's rows carry.
JAX_ROW_CRCS = {2: 0x4F85F8C5, 3: 0xE6A54466}
TRUE_ROW_CRCS = {2: 0x33C2500F, 3: 0x499A946C}


def _crc_field(row) -> int:
    return int.from_bytes(row[4:8].tobytes(), "little")


@pytest.fixture(scope="module")
def entries():
    """``(chunks, lengths, jax rows, jax row_len, port rows, port row_len)``."""
    jfn, jargs = jax_graft.entry()
    jrows, jlen = (np.asarray(x) for x in jfn(*jargs))
    fn, args = graft_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jargs[0]))
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jargs[1]))
    rows, row_len = (x.numpy() for x in fn(*args))
    return args[0].numpy(), args[1].numpy(), jrows, jlen, rows, row_len


def test_entry_rows_equal_the_jax_entrys_but_the_crcs_of_rows_2_and_3(entries):
    chunks, lengths, jrows, jlen, rows, row_len = entries
    assert rows.shape == jrows.shape and rows.dtype == np.uint8
    np.testing.assert_array_equal(row_len, jlen)
    assert lengths.tolist() == [65536, 65536, 40000, 517]
    for i in range(4):
        # Chunk type and length field, then the body and the zeros after it.
        np.testing.assert_array_equal(rows[i, :4], jrows[i, :4])
        np.testing.assert_array_equal(rows[i, 8:], jrows[i, 8:])
        want = crc32c_masked(chunks[i, : lengths[i]].tobytes())
        assert _crc_field(rows[i]) == want
        if i < 2:
            np.testing.assert_array_equal(rows[i, 4:8], jrows[i, 4:8])
        else:
            assert want == TRUE_ROW_CRCS[i]
            assert _crc_field(jrows[i]) == JAX_ROW_CRCS[i] != want


def test_the_jax_crc_reads_past_each_rows_length(entries):
    """The JAX CRC of the rows as ``entry()`` gives them is the JAX rows'
    field; of the rows zeroed past their lengths, the port's."""
    chunks, lengths, jrows, _, rows, _ = entries
    as_given = np.asarray(jcrc.crc32c_masked_blocks(chunks, lengths))
    zeroed = chunks.copy()
    for i, n in enumerate(lengths):
        zeroed[i, n:] = 0
    as_zeroed = np.asarray(jcrc.crc32c_masked_blocks(zeroed, lengths))
    assert [int(x) for x in as_given] == [_crc_field(r) for r in jrows]
    assert [int(x) for x in as_zeroed] == [_crc_field(r) for r in rows]


def test_the_ports_frame_verifies_and_the_jax_rows_2_and_3_do_not(entries):
    chunks, lengths, jrows, jlen, rows, row_len = entries
    want = b"".join(chunks[i, : lengths[i]].tobytes() for i in range(4))
    stream = STREAM_IDENTIFIER + b"".join(rows[i, : row_len[i]].tobytes() for i in range(4))
    assert native.frame_decompress(stream) == want
    for i in range(4):
        one = STREAM_IDENTIFIER + jrows[i, : jlen[i]].tobytes()
        if i < 2:
            assert native.frame_decompress(one) == chunks[i, : lengths[i]].tobytes()
        else:
            with pytest.raises(error.Checksum):
                native.frame_decompress(one)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_on_a_mesh_of_cpu_entries(n):
    graft_entry.dryrun_multichip(n, device="cpu")


#: One flipped byte in one output of one sharded entry, and the check that
#: catches it: ``(entry, output, position, xor, message)``.
CORRUPTIONS = {
    "frame_chunk_type": ("sharded_encode_frame_chunks", 0, 0, 0x80, "unexpected chunk type"),
    "decode_rows": ("sharded_decode_streams", 0, 5, 1, "roundtrip mismatch in block 0"),
    "decode_errors": ("sharded_decode_streams", 1, 0, 1, "device decode flagged an error"),
    "replay_rows": ("sharded_decode_streams_pallas", 0, 5, 1, "pallas route mismatch"),
    "replay_errors": ("sharded_decode_streams_pallas", 1, 0, 1, "pallas decode flagged an error"),
    "flat_rows": ("sharded_decode_streams_flat", None, 5, 1, "flat v2 route mismatch in block 0"),
    "resolve_rows": ("sharded_decode_resolve", 0, 5, 1, "resolve route mismatch in block 0"),
    "resolve_fallback": ("sharded_decode_resolve", 1, 0, 1, "resolve route flagged fallback"),
    "encoder_literal": ("sharded_compress_blocks_flat", 0, 2, 1,
                        "flat encoder roundtrip mismatch in block 0"),
    "encoder_overflow": ("sharded_compress_blocks_flat", 2, 0, 1, "flat encoder overflow flagged"),
}


@pytest.mark.parametrize("case", list(CORRUPTIONS))
def test_each_check_catches_one_flipped_byte(case, monkeypatch):
    name, output, pos, xor, message = CORRUPTIONS[case]
    real = getattr(graft_entry, name)

    def flipped(*args, **kwargs):
        out = real(*args, **kwargs)
        shard = (out if output is None else out[output]).shards[0]
        (shard[0] if shard.dim() == 2 else shard)[pos] ^= xor  # row 0, or flag 0
        return out

    monkeypatch.setattr(graft_entry, name, flipped)
    with pytest.raises(RuntimeError, match=message):
        graft_entry.dryrun_multichip(2, device="cpu")


def test_no_card_and_too_few_cards_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="needs 2 CUDA cards and this process has 0"):
        graft_entry.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2, device="cuda:0")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 2 CUDA cards and this process has 1"):
        graft_entry.dryrun_multichip(2)


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.main()
