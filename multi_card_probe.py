"""The port's ``parallel/`` layer across every card of one host.

Run on a host with two or more cards (it also runs on one)::

    python3 multi_card_probe.py

1. The sharded entries (``parallel.sharded``) on ``make_mesh()``, which
   spans every card, after the one-card mesh ``[cuda:0]``: exact and flat
   compress of a 64 MiB + 5,000-byte corpus stream, its frame chunks'
   bodies decoded from the host flatten, by replay and by chain
   resolution, and its blocks framed as chunks (``chip_smoke.sharded_paths``),
   with inputs from host memory and again placed on the mesh beforehand.
   Each path runs its shards at once, one thread a card, launches each of
   its kernels once a card, leaves shard ``i`` on ``cuda:i``, gives the
   host codec's bytes, and gives the one-card mesh's rows. A kernel
   launched while another card is current fails, so every card's shard
   must run with its own card current. One warm call of each path (both
   ways, on each mesh) runs under ``utils.profiling.device_trace``: it
   must hold no card-to-card copy, and no more copies on a card or
   concatenation kernels than each shard's own function makes (the
   one-card mesh's, once a card), so nothing joins the shards; the time
   during which kernels run on two or more cards at once is printed beside
   each card's kernel time. Then the cost of the threads alone
   (``map_shards`` of the identity on placed rows, 20 calls a mesh), and
   every path timed again with the interpreter's switch interval at
   0.1 ms (``sys.setswitchinterval``, restored after), against 5 ms.
2. ``multihost`` under ``torchrun --standalone --nproc-per-node <cards>``
   (one rank a card, NCCL): ``compress_segments`` of 1,024 blocks, each
   rank's rows written at its offsets into one file, which must be the
   host codec's stream; ``decode_segments`` of each rank's rows, which
   must give its blocks back; and ranks that hold unequal numbers of blocks,
   which must all raise ``ValueError``.

``--cpu --blocks N`` runs phase 2 alone, on the CPU under gloo, with four
ranks and ``N`` blocks, to try the workers where there is no card.

Prints the cards' names and power limits, and each phase's seconds, and
writes ``chiprun_out/multi_card_probe.json``. Exits 1 on any failure.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

WORKER = """
import json, os, sys, time
import numpy as np, torch
import torch.distributed as dist
from snappy_tpu_torch.config import set_config
if sys.argv[3] == "cpu":
    set_config(device="cpu")
from snappy_tpu_torch.ops import packing
from snappy_tpu_torch.parallel import multihost
multihost.initialize()
mesh = multihost.global_mesh()
dev = mesh.devices[0]
current = torch.cuda.current_device() if dev.type == "cuda" else None
work, per_rank = sys.argv[1], int(sys.argv[2])
with open(os.path.join(work, "data.bin"), "rb") as f:
    blocks, lens = packing.blocks_of(f.read())
mine = slice(mesh.rank * per_rank, (mesh.rank + 1) * per_rank)
blocks, lens = blocks[mine], lens[mine]
t0 = time.perf_counter()
seg = multihost.compress_segments(mesh, blocks, lens)
t1 = time.perf_counter()
with open(os.path.join(work, "stream.bin"), "r+b") as f:   # this rank's rows at its offsets
    for i in range(per_rank):
        f.seek(int(seg.offsets[i]))
        f.write(seg.rows[i, : seg.row_lens[i]].tobytes())
t2 = time.perf_counter()
dst, errs = multihost.decode_segments(mesh, seg.rows, seg.row_lens, lens)
t3 = time.perf_counter()
decoded = not errs.any() and all(
    np.array_equal(dst[i, : lens[i]], blocks[i, : lens[i]]) for i in range(per_rank))
b = 1 + (mesh.rank == mesh.world_size - 1)   # the last rank holds one block more
try:
    multihost.compress_segments(mesh, np.zeros((b, 65536), np.uint8), np.full(b, 9, np.int32))
    unequal = "silent"
except ValueError as e:
    unequal = "raised" if "same number of blocks" in str(e) else repr(e)
with open(os.path.join(work, "rank%d.json" % mesh.rank), "w") as f:
    json.dump({"rank": mesh.rank, "world": mesh.world_size, "device": str(dev),
               "current_device": current, "backend": dist.get_backend(),
               "total": seg.total, "decoded": bool(decoded), "unequal_shards": unequal,
               "compress_segments_s": t1 - t0, "decode_segments_s": t3 - t2}, f)
dist.destroy_process_group()
"""


def fail(what: str):
    raise SystemExit(f"multi_card_probe: FAILED: {what}")


def torchrun_segments(data: bytes, host_stream: bytes, ranks: int, per_rank: int, cpu: bool):
    """Phase 2: ``ranks`` processes under torchrun, ``per_rank`` blocks each."""
    from snappy_tpu_torch.format.varint import write_varu64

    work = os.path.join(HERE, "build", "multi_card_probe")
    subprocess.run(["rm", "-rf", work], check=True)
    os.makedirs(work)
    n = ranks * per_rank * 65536
    with open(os.path.join(work, "data.bin"), "wb") as f:
        f.write(data[:n])
    with open(os.path.join(work, "stream.bin"), "wb") as f:
        f.truncate(2 * n)
    with open(os.path.join(work, "worker.py"), "w") as f:
        f.write(WORKER)
    t0 = time.perf_counter()
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={ranks}", os.path.join(work, "worker.py"), work, str(per_rank),
         "cpu" if cpu else "cuda"],
        env={**os.environ, "PYTHONPATH": HERE}, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        _, err = p.communicate(timeout=300)
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    seconds = time.perf_counter() - t0
    if p.returncode != 0:
        fail(f"torchrun exited {p.returncode}: {err[-3000:]}")
    got = []
    for r in range(ranks):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            got.append(json.load(f))
    want_dev = ["cpu"] * ranks if cpu else [f"cuda:{r}" for r in range(ranks)]
    if [r["device"] for r in got] != want_dev:
        fail(f"the ranks' devices: {got}")
    if not cpu and [r["current_device"] for r in got] != list(range(ranks)):
        fail(f"a rank's current card is not its own: {got}")
    if {r["backend"] for r in got} != {"gloo" if cpu else "nccl"}:
        fail(f"the ranks' backends: {got}")
    if not all(r["decoded"] for r in got):
        fail(f"decode_segments did not give a rank's blocks back: {got}")
    if ranks > 1 and not all(r["unequal_shards"] == "raised" for r in got):
        fail(f"unequal shards did not raise on every rank: {got}")
    total = got[0]["total"]
    with open(os.path.join(work, "stream.bin"), "rb") as f:
        stream = f.read(total)
    if write_varu64(n) + stream != host_stream:
        fail("the ranks' rows at their offsets differ from the host codec's stream")
    subprocess.run(["rm", "-rf", work], check=True)
    return {"ranks": ranks, "blocks_per_rank": per_rank, "seconds": seconds, "by_rank": got}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="phase 2 alone, on the CPU under gloo")
    ap.add_argument("--blocks", type=int, default=1024, help="blocks of phase 2, over every rank")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke
    from snappy_tpu_torch import native

    report = {}
    if args.cpu:
        ranks = 4
        data = chip_smoke.corpus_stream(args.blocks * 65536)
    else:
        if not torch.cuda.is_available():
            print("multi_card_probe: no CUDA device; nothing was run", file=sys.stderr)
            return 1
        ranks = torch.cuda.device_count()
        cards = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip().splitlines()
        for c in cards:
            print(c)
        report["cards"] = cards
        data = chip_smoke.corpus_stream(chip_smoke.STREAM_BYTES)
        report["mesh"] = sharded_on_every_card(chip_smoke, data)
        print(json.dumps({"mesh": {k: v for k, v in report["mesh"].items() if k != "times"}}))
    per_rank = args.blocks // ranks
    host_stream = native.compress(data[: ranks * per_rank * 65536])
    report["torchrun"] = torchrun_segments(data, host_stream, ranks, per_rank, args.cpu)
    print(json.dumps({"torchrun": report["torchrun"]}))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "multi_card_probe.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"ok": True, "ranks": ranks}))
    return 0


def sharded_on_every_card(chip_smoke, data: bytes) -> dict:
    """Phase 1: ``chip_smoke.sharded_paths`` on ``[cuda:0]``, then on
    ``make_mesh()``. Returns each path's launches and times, and each
    card's peak memory."""
    import snappy_tpu_torch
    from snappy_tpu_torch import native
    from snappy_tpu_torch.format.varint import write_varu64
    from snappy_tpu_torch.ops import api, packing
    from snappy_tpu_torch.parallel import make_mesh, map_shards

    frame = native.frame_compress(data)
    chunks = chip_smoke.compressed_chunks(frame)
    srcs, lens = packing.batch_streams([c[0] for c in chunks], 65536)
    declens = np.asarray([c[1] for c in chunks], np.int32)
    cap = api._record_cap(65536)
    recs, nops, errs, _ = native.scan_records_batch(
        srcs, lens.astype(np.uint64), declens.astype(np.uint64), cap)
    if errs.any() or int(nops.max()) > cap:
        fail("the record scan of the frame's chunks")
    r_pad = max(512, -(-int(nops.max()) // 512) * 512)
    dec = (srcs, lens, declens, np.ascontiguousarray(recs[:, :r_pad]), nops)
    want_rows = native.decompress_batch([write_varu64(d) + b for b, d, _ in chunks])
    cblocks, clens = packing.blocks_of(data)
    expect = {"exact": native.compress(data), "frame": frame,
              "fast": snappy_tpu_torch.compress(data, profile="fast", device="cuda:0")}
    by_path = {}
    mesh = make_mesh()
    for i in range(mesh.size):
        torch.cuda.reset_peak_memory_stats(i)
    times = chip_smoke.sharded_paths(
        [[torch.device("cuda", 0)], list(mesh.devices)], data, cblocks, clens, dec, want_rows,
        expect, functools.partial(chip_smoke.counted_run, by_path),
        os.path.join(HERE, "build", "multi_card_traces"))
    launches = {path: {k: v for k, v in c.items() if v} for path, c in by_path.items()}
    peak = [torch.cuda.max_memory_allocated(i) for i in range(mesh.size)]
    # What the threads cost with no work: map_shards of the identity on
    # placed rows. Then the paths again with the interpreter switching
    # threads every 0.1 ms instead of every 5 ms: how long the shards' threads
    # wait on each other for the interpreter lock.
    overhead = {}
    for devices in ([torch.device("cuda", 0)], list(mesh.devices)):
        m = make_mesh(devices)
        x = map_shards(m, lambda t: t, np.zeros((8 * m.size, 64), np.uint8))
        overhead[m.size] = chip_smoke.warm_runs(lambda: map_shards(m, lambda t: t, x), reps=20)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        fast_switch = chip_smoke.sharded_paths(
            [[torch.device("cuda", 0)], list(mesh.devices)], data, cblocks, clens, dec, want_rows,
            expect, functools.partial(chip_smoke.counted_run, {}))
    finally:
        sys.setswitchinterval(interval)
    return {"devices": [str(d) for d in mesh.devices], "launches": launches, "times": times,
            "summary": chip_smoke.sharded_summary(times), "peak_bytes_by_card": peak,
            "map_shards_overhead_s": overhead,
            "switch_interval_1e-4": {p: {"warm_s": t["warm_s"], "resident_warm_s": t["resident_warm_s"]}
                                     for p, t in fast_switch.items()}}


if __name__ == "__main__":
    sys.exit(main())
