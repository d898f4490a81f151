"""Where the port's sharded entries (``snappy_tpu_torch.parallel.sharded``)
leave their outputs, and how they run, on CPU meshes of 2, 4 and 8 entries.

As the JAX entries' ``shard_map`` does: every entry returns ``Sharded``
outputs whose shard ``i`` lies on ``mesh.devices[i]``, equals rows
``[i * k, (i + 1) * k)`` of the JAX entry's output on its 8-device virtual
CPU mesh, and is the very tensor the shard's function returned (nothing is
concatenated or copied); the shards run at once, one thread each (a
barrier that every shard must reach before any goes on passes); a shard
that raises makes the entry raise that exception once every shard has
ended; a ``Sharded`` input on the entry's mesh is used in place. Also the
lock-guarded launch counter and ``stream_offsets`` of a ``Sharded``.
Equality throughout: bytes, lengths, codes and flags are integers.
"""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from snappy_tpu.parallel import make_mesh as jax_mesh
from snappy_tpu.parallel import sharded as jsharded
from snappy_tpu_torch import native
from snappy_tpu_torch.ops import _build, parse
from snappy_tpu_torch.parallel import Sharded, map_shards, sharded
from torch_vectors import (
    cpu_mesh, hold_jax_native, jax_entry_outputs, share_cores_with_workers, shard_blocks,
    shard_decode_batch,
)

share_cores_with_workers()
hold_jax_native()

BLOCKS, LENS = shard_blocks()
SRCS, SRC_LENS, DECLENS, BITS = shard_decode_batch(BLOCKS, LENS)
D_PAD = 16384
RECS, NOPS, _, _ = native.scan_records_batch(
    SRCS, SRC_LENS.astype(np.uint64), DECLENS.astype(np.uint64), 2048)
IDX, TMETA, _, _, _ = native.flatten_idx_batch(
    SRCS, SRC_LENS.astype(np.uint64), DECLENS.astype(np.uint64), D_PAD, layout=1)

# name: (the port's entry on a mesh, the JAX entry and its arguments, the
# name in ``sharded`` of the function each shard runs)
ENTRIES = {
    "compress": (lambda m: sharded.sharded_compress_blocks(m, BLOCKS, LENS),
                 (jsharded.sharded_compress_blocks, BLOCKS, LENS), "compress_blocks"),
    "compress_fast": (lambda m: sharded.sharded_compress_blocks(m, BLOCKS, LENS, fast=True),
                      (jsharded.sharded_compress_blocks, BLOCKS, LENS, {"fast": True}),
                      "compress_blocks_fast"),
    "compress_flat": (lambda m: sharded.sharded_compress_blocks_flat(m, BLOCKS, LENS),
                      (jsharded.sharded_compress_blocks_flat, BLOCKS, LENS),
                      "compress_blocks_flat_fast"),
    "decode_streams": (lambda m: sharded.sharded_decode_streams(m, SRCS, SRC_LENS, DECLENS, D_PAD),
                       (jsharded.sharded_decode_streams, SRCS, SRC_LENS, DECLENS, D_PAD),
                       "decode_batch"),
    "decode_hosted": (
        lambda m: sharded.sharded_decode_streams_hosted(m, SRCS, SRC_LENS, DECLENS, BITS, D_PAD),
        (jsharded.sharded_decode_streams_hosted, SRCS, SRC_LENS, DECLENS, BITS, D_PAD),
        "decode_batch_hosted"),
    "decode_flat_host": (
        lambda m: sharded.sharded_decode_flat_host(m, SRCS, SRC_LENS, DECLENS, D_PAD)[0],
        (jsharded.sharded_decode_flat_host, SRCS, SRC_LENS, DECLENS, D_PAD), "decode_flat"),
    "decode_resolve": (
        lambda m: sharded.sharded_decode_resolve(m, SRCS, RECS, NOPS, DECLENS, D_PAD),
        (jsharded.sharded_decode_resolve, SRCS, RECS, NOPS, DECLENS, D_PAD),
        "decode_resolve_batch"),
    "decode_replay": (
        lambda m: sharded.sharded_decode_streams_replay(m, SRCS, SRC_LENS, DECLENS, D_PAD),
        (jsharded.sharded_decode_streams_pallas, SRCS, SRC_LENS, DECLENS, D_PAD), "decode_replay"),
    "decode_flat": (
        lambda m: sharded.sharded_decode_streams_flat(m, SRCS, IDX, TMETA, DECLENS, D_PAD),
        (jsharded.sharded_decode_flat_host, SRCS, SRC_LENS, DECLENS, D_PAD), "decode_flat"),
    "frame_chunks": (lambda m: sharded.sharded_encode_frame_chunks(m, BLOCKS, LENS),
                     (jsharded.sharded_encode_frame_chunks, BLOCKS, LENS), "encode_frame_chunks"),
}


@pytest.fixture(scope="module")
def wanted():
    """Each JAX entry's outputs on its 8-device mesh, as the other sharded
    test files compute them (``jax_entry_outputs`` keeps them for all)."""
    jmesh = jax_mesh(jax.devices()[:8])
    out = {}
    for name, (_, (entry, *args), _) in ENTRIES.items():
        kwargs = args.pop() if isinstance(args[-1], dict) else {}
        out[name] = jax_entry_outputs(entry, jmesh, *args, **kwargs)
    # The flat gather alone: the host flatten's entry gathers through it,
    # so its rows are the flatten entry's first output.
    out["decode_flat"] = out["decode_flat"][:1]
    out["decode_flat_host"] = out["decode_flat_host"][:1]
    return out


def _spy(monkeypatch, name):
    """Wrap the shard function ``sharded.<name>``; returns the list of what
    each call returned."""
    real, returned = getattr(sharded, name), []
    lock = threading.Lock()

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        with lock:
            returned.append(out)
        return out

    monkeypatch.setattr(sharded, name, spy)
    return returned


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_each_shard_stays_on_its_device_as_the_shard_function_returned_it(
        wanted, monkeypatch, entry, m):
    port, _, shard_fn = ENTRIES[entry]
    returned = _spy(monkeypatch, shard_fn)
    mesh = cpu_mesh(m)
    out = port(mesh)
    outs = out if isinstance(out, tuple) else (out,)
    assert len(outs) == len(wanted[entry]) and len(returned) == m
    for j, (got, want) in enumerate(zip(outs, wanted[entry])):
        assert isinstance(got, Sharded) and got.mesh is mesh and len(got.shards) == m
        assert got.shape == want.shape and len(got) == want.shape[0]
        k = want.shape[0] // m
        # Shard i is one of the tensors the shard function returned, each
        # used once: no shard was concatenated or copied.
        mine = [r[j] if isinstance(r, tuple) else r for r in returned]
        assert sorted(map(id, got.shards)) == sorted(map(id, mine))
        for i, (shard, dev) in enumerate(zip(got.shards, mesh.devices)):
            assert shard.device == dev and shard.shape[0] == k
            rows = want[i * k : (i + 1) * k]
            if entry == "decode_resolve" and j == 0:
                # A flagged row's bytes are not the contract (the whole
                # batch's test in test_torch_sharded_resolve.py).
                keep = wanted[entry][1][i * k : (i + 1) * k] == 0
                np.testing.assert_array_equal(shard.numpy()[keep], rows[keep])
            else:
                np.testing.assert_array_equal(shard.numpy(), rows)


@pytest.mark.parametrize("m", [2, 4, 8])
def test_the_shards_run_at_once(monkeypatch, m):
    """Every shard waits at one barrier before it decodes: the entry returns
    only if all ``m`` run at the same time (in turn, the first would time
    out)."""
    barrier = threading.Barrier(m, timeout=20)
    real = sharded.decode_replay
    threads = set()

    def shard(*args):
        threads.add(threading.get_ident())
        barrier.wait()
        return real(*args)

    monkeypatch.setattr(sharded, "decode_replay", shard)
    rows = m * 2
    dst, err = sharded.sharded_decode_streams_replay(
        cpu_mesh(m), SRCS[:rows], SRC_LENS[:rows], DECLENS[:rows], D_PAD)
    assert len(threads) == m and not barrier.broken
    assert not err.numpy()[:8].any()
    for i in range(min(rows, 8)):
        assert dst.numpy()[i, : LENS[i]].tobytes() == BLOCKS[i, : LENS[i]].tobytes()


class ShardFailed(Exception):
    pass


@pytest.mark.parametrize("failing", [(0,), (3,), (0, 3)], ids=["first", "last", "first_of_two"])
def test_a_failing_shard_raises_after_every_shard_has_ended(monkeypatch, failing):
    """The entry raises the failing shard's own exception (the first by mesh
    order when two fail, even if the later one fails first), and only once
    every other shard has run to its end."""
    done, errors = [], {i: ShardFailed(i) for i in failing}
    lock = threading.Lock()

    def shard(blocks, lengths):
        i = int(lengths[0]) // 10_000
        if i in errors:
            time.sleep(0.2 if i == 0 else 0.0)  # shard 0 fails last in time
            raise errors[i]
        time.sleep(0.3)
        with lock:
            done.append(i)
        return blocks, lengths

    monkeypatch.setattr(sharded, "compress_blocks", shard)
    lens = np.repeat(np.arange(4, dtype=np.int32) * 10_000, 2)
    with pytest.raises(ShardFailed) as got:
        sharded.sharded_compress_blocks(cpu_mesh(4), BLOCKS, lens)
    assert got.value is errors[failing[0]]
    assert sorted(done) == [i for i in range(4) if i not in failing]


def _inputs(kind, mesh):
    arrays = (SRCS, SRC_LENS, DECLENS)
    if kind == "numpy":
        return arrays
    if kind == "tensor":
        return tuple(map(torch.from_numpy, arrays))
    return tuple(map_shards(mesh, torch.clone, a) for a in arrays)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", ["numpy", "tensor", "sharded"])
def test_numpy_tensor_and_sharded_inputs_give_the_same_shards(monkeypatch, kind, m):
    mesh = cpu_mesh(m)
    want = sharded.sharded_decode_streams_replay(mesh, SRCS, SRC_LENS, DECLENS, D_PAD)
    inputs = _inputs(kind, mesh)
    seen = []
    real = sharded.decode_replay
    monkeypatch.setattr(sharded, "decode_replay", lambda *a: seen.append(a) or real(*a))
    got = sharded.sharded_decode_streams_replay(mesh, *inputs, D_PAD)
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g.shards, w.shards))
    if kind == "sharded":  # used in place: each shard function got the inputs' own shards
        for j, x in enumerate(inputs):
            assert sorted(id(a[j]) for a in seen) == sorted(map(id, x.shards))


def test_a_sharded_input_on_another_mesh_raises():
    blocks = map_shards(cpu_mesh(2), torch.clone, BLOCKS)
    with pytest.raises(ValueError, match="does not lie on this mesh"):
        sharded.sharded_encode_frame_chunks(cpu_mesh(4), blocks, LENS)


def test_chained_entries_stay_sharded():
    """The fast compress's ``Sharded`` rows and lengths feed the replay
    decode as they lie, which gives the blocks back."""
    mesh = cpu_mesh(4)
    out, out_len = sharded.sharded_compress_blocks(mesh, BLOCKS, LENS, fast=True)
    dst, err = sharded.sharded_decode_streams_replay(mesh, out, out_len, LENS, 65536)
    assert isinstance(dst, Sharded) and dst.mesh is mesh and not err.numpy().any()
    rows = dst.numpy()
    for i, n in enumerate(LENS):
        assert rows[i, :n].tobytes() == BLOCKS[i, :n].tobytes()


def test_a_mesh_of_one_returns_the_calls_own_tensor(monkeypatch):
    returned = _spy(monkeypatch, "decode_replay")
    dst, err = sharded.sharded_decode_streams_replay(cpu_mesh(1), SRCS, SRC_LENS, DECLENS, D_PAD)
    (out,) = returned
    assert dst.shards == (out[0],) and err.shards == (out[1],)
    assert dst.shards[0] is out[0] and err.shards[0] is out[1]


def test_sharded_reads_like_the_rows_it_holds():
    mesh = cpu_mesh(4)
    x = map_shards(mesh, torch.clone, BLOCKS)
    assert x.shape == BLOCKS.shape and x.dtype == torch.uint8 and len(x) == len(BLOCKS)
    np.testing.assert_array_equal(x.numpy(), BLOCKS)
    np.testing.assert_array_equal(np.asarray(x), BLOCKS)
    assert np.asarray(x, np.int32).dtype == np.int32
    assert torch.equal(x.cpu(), torch.from_numpy(BLOCKS))
    g = x.gather()
    assert g.device == mesh.devices[0] and torch.equal(g, torch.from_numpy(BLOCKS))
    with pytest.raises(ValueError, match="shards for a mesh"):
        Sharded(mesh, x.shards[:3])


@pytest.mark.parametrize("m", [2, 4])
def test_stream_offsets_of_sharded_lengths_match_the_jax_package(m):
    mesh = cpu_mesh(m)
    _, _, total_d = sharded.sharded_decode_streams_hosted(mesh, SRCS, SRC_LENS, DECLENS, BITS, D_PAD)
    offs, total = sharded.stream_offsets(total_d)
    joffs, jtotal = jsharded.stream_offsets(total_d.numpy())
    np.testing.assert_array_equal(offs.numpy(), np.asarray(joffs))
    assert offs.device.type == "cpu" and int(total) == int(jtotal) == int(total_d.numpy().sum())


@pytest.mark.parametrize("counts,key", [(vars(parse), "launches"), ({"k": 0}, "k"), ([0, 0], 1)],
                         ids=["module_global", "dict", "list"])
def test_launch_counter_is_exact_under_threads(counts, key):
    """8 threads x 10,000 increments through ``_build.count``, with the
    interpreter switching threads as often as it can: a lost update would
    show as a short count."""
    before = counts[key]
    start = threading.Barrier(8, timeout=20)

    def bump():
        start.wait()
        for _ in range(10_000):
            _build.count(counts, key)

    threads = [threading.Thread(target=bump) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counts[key] - before == 80_000
    if counts is vars(parse):
        parse.launches = before
