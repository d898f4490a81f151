"""The port's sharded compress entries (``snappy_tpu_torch.parallel.sharded``)
on CPU meshes of 1, 2 and 4 devices give the JAX package's sharded entries'
bytes on its 8-device virtual CPU mesh, and the one unsharded port call's;
a batch that does not divide raises, ``pad_batch`` makes it divide, and no
sharded entry calls a ``torch.distributed`` collective. Equality
throughout: bytes, lengths and flags are integers."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from snappy_tpu.parallel import make_mesh as jax_mesh
from snappy_tpu.parallel import sharded as jsharded
from snappy_tpu_torch import native
from snappy_tpu_torch.format.varint import write_varu64
from snappy_tpu_torch.ops.encode import compress_blocks
from snappy_tpu_torch.ops.encode_fast import compress_blocks_fast
from snappy_tpu_torch.parallel import sharded
from torch_vectors import (
    cpu_mesh, hold_jax_native, jax_entry_outputs, share_cores_with_workers, shard_blocks,
    shard_bodies,
)

share_cores_with_workers()
hold_jax_native()

MESHES = [1, 2, 4]
BLOCKS, LENS = shard_blocks()


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(jax.devices()[:8])


@pytest.fixture(scope="module")
def exact(jmesh):
    want = jax_entry_outputs(jsharded.sharded_compress_blocks, jmesh, BLOCKS, LENS)
    whole = [t.numpy() for t in compress_blocks(torch.from_numpy(BLOCKS), torch.from_numpy(LENS))]
    return want, whole


@pytest.fixture(scope="module")
def fast(jmesh):
    want = jax_entry_outputs(jsharded.sharded_compress_blocks, jmesh, BLOCKS, LENS, fast=True)
    whole = [t.numpy() for t in compress_blocks_fast(torch.from_numpy(BLOCKS), torch.from_numpy(LENS))]
    return want, whole


@pytest.mark.parametrize("n", MESHES)
def test_sharded_exact_compress(exact, n):
    want, whole = exact
    got = [t.numpy() for t in sharded.sharded_compress_blocks(cpu_mesh(n), BLOCKS, LENS)]
    for g, w, u in zip(got, want, whole):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, u)
    # ... and each row is the host codec's stream for its block.
    out, out_len = got
    for i, n_i in enumerate(LENS):
        body = out[i, : out_len[i]].tobytes()
        assert write_varu64(int(n_i)) + body == native.compress(BLOCKS[i, :n_i].tobytes())


@pytest.mark.parametrize("n", MESHES)
def test_sharded_fast_compress(fast, n):
    want, whole = fast
    got = [t.numpy() for t in sharded.sharded_compress_blocks(cpu_mesh(n), BLOCKS, LENS, fast=True)]
    for g, w, u in zip(got, want, whole):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, u)


def test_ragged_batch_pads_and_an_undivided_batch_raises(exact):
    blocks, lens = BLOCKS[:6], LENS[:6]
    with pytest.raises(ValueError, match="do not divide"):
        sharded.sharded_compress_blocks(cpu_mesh(4), blocks, lens)
    pb, pl, real = sharded.pad_batch(blocks, lens, 4)
    jb, jl, jreal = jsharded.pad_batch(blocks, lens, 4)
    assert real == jreal == 6 and pb.shape == (8, 65536)
    np.testing.assert_array_equal(pb, jb)
    np.testing.assert_array_equal(pl, jl)
    out, out_len = sharded.sharded_compress_blocks(cpu_mesh(4), pb, pl)
    want_out, want_len = exact[0]
    np.testing.assert_array_equal(out.numpy()[:real], want_out[:real])
    np.testing.assert_array_equal(out_len.numpy()[:real], want_len[:real])
    assert out_len.numpy()[real:].tolist() == [0, 0]
    # An already divided batch is left as it is.
    same, same_len, b = sharded.pad_batch(BLOCKS, LENS, 4)
    assert same is BLOCKS and same_len is LENS and b == 8


def test_stream_offsets_match_the_jax_package():
    row_len = np.array([5, 0, 17, 3, 65536, 9], np.int32)
    offs, total = sharded.stream_offsets(row_len)
    joffs, jtotal = jsharded.stream_offsets(row_len)
    np.testing.assert_array_equal(offs.numpy(), np.asarray(joffs))
    assert int(total) == int(jtotal) == int(row_len.sum())


def test_one_device_mesh_is_one_call_without_a_copy(monkeypatch):
    calls = []

    def spy(blocks, lengths):
        calls.append((blocks, lengths))
        return blocks, lengths

    monkeypatch.setattr(sharded, "compress_blocks", spy)
    blocks, lens = torch.from_numpy(BLOCKS), torch.from_numpy(LENS)
    out, out_len = sharded.sharded_compress_blocks(cpu_mesh(1), blocks, lens)
    assert len(calls) == 1 and out.shards[0].data_ptr() == blocks.data_ptr()
    assert out_len.shards[0].data_ptr() == lens.data_ptr()
    calls.clear()
    sharded.sharded_compress_blocks(cpu_mesh(4), blocks, lens)
    assert [c[0].shape[0] for c in calls] == [2, 2, 2, 2]


COLLECTIVES = [
    "all_gather", "all_gather_into_tensor", "all_gather_object", "all_reduce", "all_to_all",
    "all_to_all_single", "barrier", "broadcast", "broadcast_object_list", "gather", "irecv",
    "isend", "recv", "reduce", "reduce_scatter", "reduce_scatter_tensor", "scatter", "send",
]


def test_no_sharded_entry_calls_a_collective(monkeypatch):
    """The data path shards with no communication between devices, as the
    JAX entries compile without collectives."""
    def refuse(*args, **kwargs):
        raise AssertionError("a sharded entry called a torch.distributed collective")

    for name in COLLECTIVES:
        monkeypatch.setattr(dist, name, refuse)
    mesh = cpu_mesh(2)
    srcs, src_lens = shard_bodies(BLOCKS, LENS)
    d_pad = 16384
    bits = np.zeros((8, srcs.shape[1] // 8), np.uint8)
    native.scan_ops_batch(srcs, src_lens.astype(np.uint64), bits)
    recs, nops, _, _ = native.scan_records_batch(
        srcs, src_lens.astype(np.uint64), LENS.astype(np.uint64), 2048)
    idx, tmeta, _, _, _ = native.flatten_idx_batch(
        srcs, src_lens.astype(np.uint64), LENS.astype(np.uint64), d_pad, layout=1)
    runs = {
        "compress": lambda: sharded.sharded_compress_blocks(mesh, BLOCKS, LENS)[0],
        "compress_fast": lambda: sharded.sharded_compress_blocks(mesh, BLOCKS, LENS, fast=True)[0],
        "compress_flat": lambda: sharded.sharded_compress_blocks_flat(mesh, BLOCKS, LENS)[0],
        "frame": lambda: sharded.sharded_encode_frame_chunks(mesh, BLOCKS, LENS)[0],
        "decode": lambda: sharded.sharded_decode_streams(mesh, srcs, src_lens, LENS, d_pad)[0],
        "hosted": lambda: sharded.sharded_decode_streams_hosted(
            mesh, srcs, src_lens, LENS, bits, d_pad)[0],
        "flat_host": lambda: sharded.sharded_decode_flat_host(mesh, srcs, src_lens, LENS, d_pad)[0],
        "flat": lambda: sharded.sharded_decode_streams_flat(mesh, srcs, idx, tmeta, LENS, d_pad),
        "resolve": lambda: sharded.sharded_decode_resolve(mesh, srcs, recs, nops, LENS, d_pad)[0],
        "replay": lambda: sharded.sharded_decode_streams_replay(mesh, srcs, src_lens, LENS, d_pad)[0],
    }
    for name, run in runs.items():
        rows = run().numpy()
        if name.startswith("compress") or name == "frame":
            continue
        for i, n in enumerate(LENS):
            assert rows[i, :n].tobytes() == BLOCKS[i, :n].tobytes(), (name, i)
