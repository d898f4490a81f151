"""Weak scaling of the multi-process exact compress over ranks, stage by stage.

The port of the repository's ``tools/scaling_measure.py``. Each rank is a
process of its own, pinned to its share of this process's CPU affinity
set, joined to the others through ``parallel.multihost.initialize`` (an
explicit ``tcp://127.0.0.1`` address, world size and rank). Every rank
holds the same number of 64 KiB blocks (weak scaling: the load a rank is
fixed), from ``lcet10.txt`` and ``plrabn12.txt`` cycled, and each round
times three stages between barriers (``torch.distributed.barrier``):

- ``encode_s``: ``parallel.sharded.sharded_compress_blocks`` on
  ``multihost.global_mesh()`` (K7, the exact encoder), the rows and
  lengths copied back to host memory;
- ``allgather_s``: every rank's block lengths through ``multihost``'s
  ``all_gather`` (on the card under NCCL, on CPU tensors under gloo), the
  only bytes that cross ranks (``allgather_payload_bytes``: one int32 a
  block of the world);
- ``write_s``: the rank's rows written at their offsets into one file
  (``os.pwrite``), then ``fsync``.

A warm-up round (``multihost.compress_segments``) is left out, then
``ROUNDS`` rounds; each stage reports its min over the rounds and
``total_s`` the least sum. A run's stage times are its slowest rank's.
After each run the file must hold the host codec's stream: every block's
raw op stream, in order. ``efficiency_1_to_2`` (and ``_1_to_4``) is one
rank's ``total_s`` over the ranks' at the same load.

Rank counts: one rank a card under NCCL, at 1 and 2 ranks and at 4 where
the machine has four cards. Ranks beyond the cards run under gloo, all on
``cuda:0`` (NCCL refuses two ranks on one card): such a run is marked
``shared_card`` and gives no efficiency. Loads: ``BLOCKS_PER_HOST`` (8, as
the JAX tool, and 64: the first NCCL collective costs seconds, which 8
blocks would not weigh against). Run::

    python -m snappy_tpu_torch.tools.scaling_measure [--ranks 1,2] [--blocks 8,64] [--cpu]

``--cpu`` runs the ranks under gloo on the CPU, K7's plain version, with
``CPU_BLOCK_BYTES`` of text in each 64 KiB block (the plain version is a
Python loop per automaton step), and writes every rate and efficiency as
not measured. The result is the last line of stdout and
``build/snappy_tpu_torch/scaling_measure.json``.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from . import OUT_DIR, log, run

HERE = Path(__file__).resolve().parents[2]
NAME = "scaling_measure"
BLOCKS_PER_HOST = (8, 64)
ROUNDS = 3
#: Bytes of text in each block under ``--cpu``.
CPU_BLOCK_BYTES = 2048
#: Seconds the ranks of one run may take, start-up and rendezvous included.
RUN_DEADLINE_S = 600
WORK = OUT_DIR / "scaling_measure_work"


def rank_blocks(ranks: int, blocks_per_rank: int, block_bytes: int = 65536):
    """Every rank's blocks in global order: ``(blocks (ranks * n, 65536)
    uint8, lens (ranks * n,) int32)``, each holding ``block_bytes`` of
    ``lcet10.txt`` then ``plrabn12.txt``, cycled (at 65,536, the JAX tool's
    input)."""
    from ..ops.packing import blocks_of

    text = b"".join((HERE / "data" / f).read_bytes() for f in ("lcet10.txt", "plrabn12.txt"))
    need = ranks * blocks_per_rank * block_bytes
    chunks, lens = blocks_of((text * max(4, -(-need // len(text))))[:need], block_bytes)
    blocks = np.zeros((len(lens), 65536), np.uint8)
    blocks[:, :block_bytes] = chunks
    return blocks, lens


def host_stream(blocks, lens) -> bytes:
    """The host codec's raw op streams of every block, in order."""
    from .. import native
    from ..format.varint import read_varu64

    return b"".join(c[read_varu64(c)[1]:] for c in native.compress_batch(
        [blocks[i, : lens[i]].tobytes() for i in range(len(lens))]))


def _my_cpus(rank: int, ranks: int) -> list[int]:
    """Rank ``rank``'s share of the affinity set: an equal slice each."""
    cpus = sorted(os.sched_getaffinity(0))
    k = len(cpus) // ranks
    return cpus[rank * k : (rank + 1) * k] if k else [cpus[rank % len(cpus)]]


def worker(spec: dict) -> None:
    """One rank: join the world, then for each load a warm-up round and
    ``ROUNDS`` timed rounds; its stage times go to a JSON file of its own."""
    t_start = time.perf_counter()
    rank, ranks = spec["rank"], spec["ranks"]
    cpus = _my_cpus(rank, ranks)
    os.sched_setaffinity(0, cpus)
    import torch
    import torch.distributed as dist

    from ..config import set_config
    from ..ops import launch_counts, reset_launch_counts
    from ..parallel import multihost
    from ..parallel.sharded import sharded_compress_blocks

    torch.set_num_threads(len(cpus))
    if spec["cpu"]:
        set_config(device="cpu")
    backend = spec["backend"]
    multihost.initialize(init_method=f"tcp://127.0.0.1:{spec['port']}", world_size=ranks,
                         rank=rank, backend=backend,
                         timeout=datetime.timedelta(seconds=RUN_DEADLINE_S))
    mesh = multihost.global_mesh()
    dev = mesh.devices[0]
    t_init = time.perf_counter()

    def barrier():
        if backend == "nccl":
            dist.barrier(device_ids=[dev.index])
        else:
            dist.barrier()

    out = {"rank": rank, "ranks": ranks, "cpus": cpus, "device": str(dev), "backend": backend,
           "join_s": t_init - t_start, "loads": []}
    for n in spec["loads"]:
        blocks, lens = rank_blocks(ranks, n, spec["block_bytes"])
        mine = slice(rank * n, (rank + 1) * n)
        reset_launch_counts()
        t0 = time.perf_counter()
        multihost.compress_segments(mesh, blocks[mine], lens[mine])  # warm-up, not timed
        warm_s = time.perf_counter() - t0
        stages = {"encode_s": [], "allgather_s": [], "write_s": []}
        path = Path(spec["work"]) / f"stream_{n}.bin"
        for _ in range(ROUNDS):
            barrier()
            t0 = time.perf_counter()
            rows_d, lens_d = sharded_compress_blocks(mesh, blocks[mine], lens[mine])
            rows, row_lens = rows_d.numpy(), lens_d.numpy()
            t1 = time.perf_counter()
            lens_all = multihost._all_gather(mesh, lens_d.gather())
            t2 = time.perf_counter()
            ends = np.cumsum(lens_all.astype(np.int64))
            offsets = (ends - lens_all)[mine]
            fd = os.open(path, os.O_WRONLY)
            try:
                for i in range(n):
                    os.pwrite(fd, rows[i, : row_lens[i]].tobytes(), int(offsets[i]))
                os.fsync(fd)
            finally:
                os.close(fd)
            t3 = time.perf_counter()
            barrier()
            for k, dt in zip(stages, (t1 - t0, t2 - t1, t3 - t2)):
                stages[k].append(dt)
        out["loads"].append({
            "blocks_per_rank": n,
            "bytes_per_rank": int(lens[mine].sum()),
            "stream_bytes": int(ends[-1]),
            "warmup_s": warm_s,
            **{k: min(v) for k, v in stages.items()},
            "total_s": min(map(sum, zip(*stages.values()))),
            "rounds": stages,
            "launches": {k: v for k, v in launch_counts().items() if v},
        })
    with open(Path(spec["work"]) / f"stats_{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_config(ranks: int, backend: str, loads: list[int], block_bytes: int, cpu: bool) -> list:
    """Start ``ranks`` worker processes and wait for them; returns each
    rank's record. Raises when a rank fails or the run overruns its
    deadline; every rank still running is then killed. The stream files
    stay in ``WORK`` for the caller's check."""
    from ..ops.encode import OUT_W

    shutil.rmtree(WORK, ignore_errors=True)
    WORK.mkdir(parents=True)
    for n in loads:
        with open(WORK / f"stream_{n}.bin", "wb") as f:
            f.truncate(ranks * n * OUT_W)
    spec = {"ranks": ranks, "backend": backend, "loads": loads, "block_bytes": block_bytes,
            "cpu": cpu, "port": _free_port(), "work": str(WORK)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"snappy_tpu_torch.tools.{NAME}", "--worker",
         json.dumps({**spec, "rank": r})],
        cwd=HERE, env={**os.environ, "LOCAL_RANK": str(r)}, stdout=subprocess.DEVNULL)
        for r in range(ranks)]
    deadline = time.monotonic() + RUN_DEADLINE_S
    try:
        # A rank that fails leaves the others waiting in a collective: stop
        # at the first failure.
        while any(p.poll() is None for p in procs) and not any(p.returncode for p in procs):
            if time.monotonic() > deadline:
                raise RuntimeError(f"{ranks} ranks overran their {RUN_DEADLINE_S} s deadline")
            time.sleep(0.05)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"{ranks} ranks ({backend}): exit codes {codes}")
    return [json.loads((WORK / f"stats_{r}.json").read_text()) for r in range(ranks)]


def check_stream(n: int, ranks: int, block_bytes: int, stream_bytes: int) -> str:
    """The file the ranks wrote at load ``n`` against the host codec's
    stream of the same blocks; returns the stream's SHA-256."""
    want = host_stream(*rank_blocks(ranks, n, block_bytes))
    with open(WORK / f"stream_{n}.bin", "rb") as f:
        got = f.read(len(want))
    if stream_bytes != len(want) or got != want:
        at = next((i for i, (a, c) in enumerate(zip(got, want)) if a != c), min(len(got), len(want)))
        raise AssertionError(f"{ranks} ranks, {n} blocks a rank: the file differs from the host "
                             f"codec's stream at byte {at} (stream {stream_bytes} bytes, host "
                             f"{len(want)})")
    return hashlib.sha256(got).hexdigest()


def measure(dev, rank_counts: list[int] | None, loads: list[int]) -> dict:
    import torch

    on_card = dev.type == "cuda"
    cards = torch.cuda.device_count() if on_card else 0
    if rank_counts is None:
        rank_counts = [1, 2] + ([4] if cards >= 4 else [])
    block_bytes = 65536 if on_card else CPU_BLOCK_BYTES
    runs = []
    for ranks in rank_counts:
        shared = on_card and ranks > cards
        backend = "nccl" if on_card and not shared else "gloo"
        log(NAME, f"{ranks} ranks, {backend}{', sharing cuda:0' if shared else ''}: loads {loads}")
        per_rank = run_config(ranks, backend, loads, block_bytes, not on_card)
        for i, n in enumerate(loads):
            at = [r["loads"][i] for r in per_rank]
            stream_bytes = at[0]["stream_bytes"]
            runs.append({
                "ranks": ranks, "backend": backend, "shared_card": shared,
                "blocks_per_rank": n, "bytes_per_rank": at[0]["bytes_per_rank"],
                "allgather_payload_bytes": 4 * ranks * n,
                **{k: max(a[k] for a in at) for k in ("encode_s", "allgather_s", "write_s",
                                                      "total_s")},
                "stream_bytes": stream_bytes,
                "stream_sha256": check_stream(n, ranks, block_bytes, stream_bytes),
                "per_rank": [{k: v for k, v in r.items() if k != "loads"} | a
                             for r, a in zip(per_rank, at)],
            })
            log(NAME, f"{ranks} ranks, {n} blocks a rank: total {runs[-1]['total_s']:.5f} s "
                      f"(encode {runs[-1]['encode_s']:.5f}, all_gather "
                      f"{runs[-1]['allgather_s']:.5f}, write {runs[-1]['write_s']:.5f}); "
                      "the file is the host codec's stream")
    shutil.rmtree(WORK, ignore_errors=True)

    def efficiency(n: int, ranks: int):
        one = next((r for r in runs if r["blocks_per_rank"] == n and r["ranks"] == 1), None)
        many = next((r for r in runs if r["blocks_per_rank"] == n and r["ranks"] == ranks
                     and not r["shared_card"]), None)
        return round(one["total_s"] / many["total_s"], 4) if one and many else None

    return {
        "mode": "weak scaling, the load a rank fixed",
        "cards": cards,
        "block_bytes": block_bytes,
        "rounds": ROUNDS,
        "runs": runs,
        "efficiency": [{"blocks_per_rank": n, "efficiency_1_to_2": efficiency(n, 2),
                        "efficiency_1_to_4": efficiency(n, 4)} for n in loads],
        "note": (
            "each rank a process pinned to its share of the affinity set; encode (K7 and the "
            "rows' copy back), all_gather of the lengths and pwrite+fsync timed between "
            "barriers, min over rounds after a warm-up; a run's stages are its slowest rank's; "
            "shared_card runs are gloo ranks on one card and give no efficiency"
        ),
    }


def main(argv: list[str]) -> int:
    if argv[:1] == ["--worker"]:
        worker(json.loads(argv[1]))
        return 0
    ap = argparse.ArgumentParser(prog=f"python -m snappy_tpu_torch.tools.{NAME}")
    ap.add_argument("--ranks", help="rank counts, e.g. 1,2 (default 1, 2 and 4 on four cards)")
    ap.add_argument("--blocks", help="blocks a rank, e.g. 8 (default 8,64)")
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU, K7's plain version")
    args = ap.parse_args(argv)
    counts = [int(x) for x in args.ranks.split(",")] if args.ranks else None
    loads = [int(x) for x in args.blocks.split(",")] if args.blocks else list(BLOCKS_PER_HOST)
    return run(NAME, lambda dev: measure(dev, counts, loads), args.cpu)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
