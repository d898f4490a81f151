"""``snappy_tpu_torch.parallel.multihost`` over ``torch.distributed``.

In 2 and 4 gloo processes on 127.0.0.1, every rank on the CPU,
``compress_segments`` gives offsets from which the ranks' rows, each
written at its own offsets into one file, assemble the host codec's
stream, with the JAX package's offsets and total for the whole batch in
one process; ``decode_segments`` gives the JAX package's bytes and error
codes. The three contracts of ``tests/test_multihost_init.py`` hold: an
environment-configured run connects and ``initialize`` is idempotent, an
unconfigured run stays local, and a run configured to an address where
nothing listens raises instead of degrading. Equality throughout."""

import datetime
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from snappy_tpu.parallel import multihost as jmultihost
from snappy_tpu_torch import native
from snappy_tpu_torch.config import configure
from snappy_tpu_torch.format.varint import write_varu64
from snappy_tpu_torch.ops.packing import blocks_of
from snappy_tpu_torch.parallel import make_mesh, multihost
from torch_vectors import CORRUPT, REPO, hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()

#: Launch markers a test must not inherit.
LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_JOB_ID",
              "SLURM_NTASKS", "SLURM_NPROCS", "OMPI_COMM_WORLD_SIZE")


def segment_data() -> bytes:
    """Eight 64 KiB blocks (the last one short): 2 KiB of text each, then a
    short pattern of its own repeated, so that the exact encoder's plain
    version takes few steps a block."""
    text = (REPO / "data" / "alice29.txt").read_bytes()
    parts = [text[2048 * i : 2048 * (i + 1)] + (b"pattern %d; " % i) * 6000 for i in range(8)]
    data = b"".join(p[:65536] for p in parts)
    return data[: 7 * 65536 + 40000]


DATA = segment_data()
BLOCKS, LENS = blocks_of(DATA)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_ENV}
    env.update(PYTHONPATH=str(REPO), **{k: str(v) for k, v in extra.items()})
    return env


def run(script: str, envs: list[dict], args=(), timeout: float = 120.0) -> list[str]:
    """``script`` in one process per environment, together; each must exit
    0 within ``timeout`` seconds. Returns their outputs."""
    procs = [subprocess.Popen([sys.executable, "-c", script, *map(str, args)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for env in envs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


def refuse(**kwargs):
    raise AssertionError("initialize joined a process group")


def world_envs(world: int) -> list[dict]:
    port = free_port()
    return [child_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=world, RANK=r,
                      LOCAL_RANK=r) for r in range(world)]


PRELUDE = """
import datetime, sys
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(1)
from snappy_tpu_torch.config import set_config
set_config(device="cpu")
from snappy_tpu_torch.parallel import multihost
"""

SEGMENTS_WORKER = PRELUDE + """
multihost.initialize(timeout=datetime.timedelta(seconds=100))
assert dist.get_backend() == "gloo", dist.get_backend()
mesh = multihost.global_mesh()
out = sys.argv[1]
z = np.load(out + "/input.npz")
blocks, lens = z["blocks"], z["lens"]
k = len(lens) // mesh.world_size
mine = slice(mesh.rank * k, (mesh.rank + 1) * k)
seg = multihost.compress_segments(mesh, blocks[mine], lens[mine])
with open(out + "/stream.bin", "r+b") as f:   # each rank writes its rows at its offsets
    for i in range(k):
        f.seek(int(seg.offsets[i]))
        f.write(seg.rows[i, : seg.row_lens[i]].tobytes())
dst, errs = multihost.decode_segments(mesh, seg.rows, seg.row_lens, lens[mine])
np.savez(out + "/rank%d.npz" % mesh.rank, offsets=seg.offsets, row_lens=seg.row_lens,
         total=seg.total, dst=dst, errs=errs, world=mesh.world_size)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def jax_segments():
    """The JAX package's ``compress_segments`` and ``decode_segments`` of
    the whole batch in one process."""
    mesh = jmultihost.global_mesh()
    seg = jmultihost.compress_segments(mesh, BLOCKS, LENS)
    dst, errs = jmultihost.decode_segments(mesh, seg.rows, seg.row_lens, LENS)
    return seg, dst, errs


@pytest.mark.parametrize("world", [2, 4])
def test_compress_and_decode_segments_in_gloo_processes(tmp_path, jax_segments, world):
    np.savez(tmp_path / "input.npz", blocks=BLOCKS, lens=LENS)
    with open(tmp_path / "stream.bin", "wb") as f:
        f.truncate(2 * len(DATA))
    run(SEGMENTS_WORKER, world_envs(world), args=[tmp_path])
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    total = int(ranks[0]["total"])
    assert all(int(z["total"]) == total and int(z["world"]) == world for z in ranks)
    stream = (tmp_path / "stream.bin").read_bytes()[:total]
    assert write_varu64(len(DATA)) + stream == native.compress(DATA)
    seg, jdst, jerrs = jax_segments
    assert total == seg.total
    np.testing.assert_array_equal(np.concatenate([z["offsets"] for z in ranks]), seg.offsets)
    np.testing.assert_array_equal(np.concatenate([z["row_lens"] for z in ranks]), seg.row_lens)
    np.testing.assert_array_equal(np.concatenate([z["dst"] for z in ranks]), jdst)
    np.testing.assert_array_equal(np.concatenate([z["errs"] for z in ranks]), jerrs)
    assert not jerrs.any()


@pytest.mark.parametrize("fast", [False, True], ids=["exact", "fast"])
def test_segments_in_a_world_of_one_match_the_jax_package(monkeypatch, jax_segments, fast):
    for var in LAUNCH_ENV:
        monkeypatch.delenv(var, raising=False)
    with configure(device="cpu"):
        multihost.initialize()
        assert not dist.is_initialized()
        mesh = multihost.global_mesh()
        assert (mesh.devices, mesh.rank, mesh.world_size) == ((torch.device("cpu"),), 0, 1)
        seg = multihost.compress_segments(mesh, BLOCKS, LENS, fast=fast)
    want = jax_segments[0] if not fast else jmultihost.compress_segments(
        jmultihost.global_mesh(), BLOCKS, LENS, fast=True)
    np.testing.assert_array_equal(seg.rows, np.asarray(want.rows))
    np.testing.assert_array_equal(seg.row_lens, want.row_lens)
    np.testing.assert_array_equal(seg.offsets, want.offsets)
    assert seg.total == want.total
    body = b"".join(seg.rows[i, : seg.row_lens[i]].tobytes() for i in range(len(LENS)))
    assert native.decompress(write_varu64(len(DATA)) + body) == DATA


@pytest.mark.parametrize("width", [4096, 4093], ids=["whole-bytes", "ragged-width"])
def test_decode_segments_matches_the_jax_package(width):
    """Corrupt rows and valid ones, in a world of one: the same bytes and
    error codes as the JAX package's ``decode_segments``. Rows of a width
    that is not whole bitmap bytes are held to the JAX package's decode of
    the same rows zero-padded to 4,096 bytes: its own call raises on them
    (its host bitmaps and rows disagree in shape)."""
    rows = CORRUPT + [(native.compress(DATA[:3000])[2:], 3000)]
    bodies = np.zeros((len(rows), width), np.uint8)
    for i, (body, _) in enumerate(rows):
        bodies[i, : len(body)] = np.frombuffer(body, np.uint8)
    src_lens = [len(b) for b, _ in rows]
    declens = [d for _, d in rows]
    mesh = make_mesh([torch.device("cpu")])
    dst, errs = multihost.decode_segments(mesh, bodies, src_lens, declens, d_pad=4096)
    padded = np.pad(bodies, ((0, 0), (0, 4096 - width)))
    jdst, jerrs = jmultihost.decode_segments(None, padded, src_lens, declens, d_pad=4096)
    np.testing.assert_array_equal(dst, jdst)
    np.testing.assert_array_equal(errs, jerrs)
    assert errs[:-1].all() and errs[-1] == 0 and dst[-1, :3000].tobytes() == DATA[:3000]


UNEQUAL_WORKER = PRELUDE + """
multihost.initialize(timeout=datetime.timedelta(seconds=100))
mesh = multihost.global_mesh()
b = 1 + (mesh.rank == mesh.world_size - 1)   # the last rank holds one block more
try:
    multihost.compress_segments(mesh, np.zeros((b, 65536), np.uint8), np.full(b, 9, np.int32))
except ValueError as e:
    assert "same number of blocks" in str(e), e
    print("RAISED", mesh.rank)
else:
    print("SILENT", mesh.rank)
dist.destroy_process_group()
"""


@pytest.mark.parametrize("world", [2, 4])
def test_unequal_shards_raise_on_every_rank(world):
    """Ranks that hold different numbers of blocks all raise, before any
    rank compresses: the offsets would be wrong for every rank."""
    outs = run(UNEQUAL_WORKER, world_envs(world))
    assert sorted(o.split()[-2] for o in outs) == ["RAISED"] * world, outs


ENV_WORKER = PRELUDE + """
multihost.initialize()            # pure environment configuration
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
multihost.initialize()            # idempotent after the rendezvous
mesh = multihost.global_mesh()
assert (mesh.world_size, mesh.rank) == (2, dist.get_rank())
print("OK", mesh.rank)
dist.destroy_process_group()
"""


def test_initialize_from_env_two_processes():
    outs = run(ENV_WORKER, world_envs(2))
    assert sorted(o.split()[-1] for o in outs) == ["0", "1"]


def test_initialize_unconfigured_is_local_noop():
    (out,) = run(PRELUDE + """
multihost.initialize()
assert not dist.is_initialized()
mesh = multihost.global_mesh()
assert (mesh.rank, mesh.world_size) == (0, 1)
seg = multihost.compress_segments(mesh, np.zeros((1, 65536), np.uint8), np.array([9], np.int32))
assert seg.total == int(seg.row_lens[0]) > 0   # the codec still runs
print("OK")
""", [child_env()])
    assert "OK" in out


def test_initialize_without_a_listener_raises_not_degrades():
    (out,) = run(PRELUDE + """
try:
    multihost.initialize(init_method="tcp://127.0.0.1:%s" % sys.argv[1], world_size=2, rank=1,
                         timeout=datetime.timedelta(seconds=2))
except RuntimeError as e:
    print("RAISED", type(e).__name__)
else:
    print("SILENT")
assert not dist.is_initialized()
""", [child_env()], args=[free_port()])
    assert "RAISED" in out, out


@pytest.mark.parametrize("markers", [
    {"SLURM_JOB_ID": "7", "SLURM_NTASKS": "4"},
    {"OMPI_COMM_WORLD_SIZE": "2"},
    {"WORLD_SIZE": "8"},
], ids=["slurm", "open-mpi", "torchrun-without-address"])
def test_cluster_without_a_rendezvous_raises(monkeypatch, markers):
    for var in LAUNCH_ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    assert not multihost._cluster_env_detected()
    for var, value in markers.items():
        monkeypatch.setenv(var, value)
    assert multihost._cluster_env_detected()
    with configure(device="cpu"), pytest.raises(RuntimeError, match="MASTER_ADDR"):
        multihost.initialize()


def test_single_task_launch_markers_stay_local(monkeypatch):
    for var in LAUNCH_ENV:
        monkeypatch.delenv(var, raising=False)
    for var, value in (("SLURM_JOB_ID", "7"), ("SLURM_NTASKS", "1"),
                       ("OMPI_COMM_WORLD_SIZE", "1"), ("WORLD_SIZE", "1")):
        monkeypatch.setenv(var, value)
    assert not multihost._cluster_env_detected()
    monkeypatch.setattr(dist, "init_process_group", refuse)
    multihost.initialize()


def test_backend_follows_the_rank_device(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: calls.append(kw))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(d))
    for var, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1"), ("WORLD_SIZE", "2"),
                       ("RANK", "1"), ("LOCAL_RANK", "5")):
        monkeypatch.setenv(var, value)
    with configure(device="cpu"):
        multihost.initialize()
        multihost.initialize(backend="mpi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    multihost.initialize(timeout=datetime.timedelta(seconds=3))
    assert multihost.local_device() == torch.device("cuda", 1)  # LOCAL_RANK % count
    assert calls == [
        {"backend": "gloo", "init_method": "env://"},
        {"backend": "mpi", "init_method": "env://"},
        torch.device("cuda", 1),
        {"backend": "nccl", "init_method": "env://", "timeout": datetime.timedelta(seconds=3)},
    ]


def test_no_card_no_fallback(monkeypatch):
    """Without a card the default mesh and the default rank device raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.global_mesh()
    with configure(device="cpu"):
        assert multihost.global_mesh().devices == (torch.device("cpu"),)
