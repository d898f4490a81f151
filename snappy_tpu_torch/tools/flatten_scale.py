"""The host passes of the scan routes against their threads, beside the card.

The port of the repository's ``tools/flatten_scale.py``. The flat route
splits decode in two: the host resolves every copy chain to per-byte
source indices (``native.flatten_idx_batch``, ``layout=1``) and the card
gathers the bytes (K2). The resolve and records routes take the host's
record scan (``native.scan_records_batch``) in its place. This program
times both host passes over ``bench``'s batch (the corpus's 49 blocks,
tiled 8 times: 392 rows) at 1, 2, 4 and 8 threads and at the affinity
count where it is larger, and the card's rate on the same batch in the
same process: K2 on the flatten's indices, and the resolve route
(``ops.resolve.decode_resolve_batch``: K8, its tensor ops, K2) on the
scan's records, both device-only (``utils.profiling.graph_ms``). From
those it derives how many cards one host feeds, and how many host cores
one card needs:

- ``cards_fed``: the flatten's best GB/s over K2's;
- ``cores_to_feed_one_card``: K2's GB/s over the flatten's
  ``per_core_GBps`` (its rate at the largest thread count of at most
  four, within the affinity set, over that count);
- ``scan_cards_fed``, ``scan_cores_to_feed_one_card``: the same for the
  scan against the resolve route.

GB/s count decoded bytes. Every host pass is checked (no row flagged, no
tile left to the replay kernel, no record cap overflowed), and the card's
last timed call decodes every row to its block. Host times are
``[min, median, max]`` seconds of ``REPS`` warm calls, the rate from the
min. Run::

    python -m snappy_tpu_torch.tools.flatten_scale [--threads 1,2,4,8,all] [--cpu]

``--cpu`` runs the card's part on the kernels' plain versions over one
tiling (49 rows) and writes every rate as not measured. The result is the
last line of stdout and ``build/snappy_tpu_torch/flatten_scale.json``.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import numpy as np

from . import log, run

HERE = Path(__file__).resolve().parents[2]
NAME = "flatten_scale"

CORPUS = [
    "html", "urls.10K", "fireworks.jpeg", "paper-100k.pdf", "html_x_4",
    "alice29.txt", "asyoulik.txt", "lcet10.txt", "plrabn12.txt",
    "geo.protodata", "kppkn.gtb",
]
#: Tilings of the corpus batch on the card: ``bench``'s 392 rows.
REPEAT = 8
#: Warm calls timed a thread count.
REPS = 7
WIDTH = 81920
D_PAD = 65536
#: Records a row the scan may write (``bench``'s cap).
REC_CAP = 16384
#: Calls of the card's part captured in one CUDA graph.
GRAPH_CALLS = 20


def _corpus_blocks():
    """Every corpus file in 64 KiB blocks: ``(blocks (49, 65536) uint8,
    lens (49,) int32)``."""
    from ..ops.packing import blocks_of

    parts = [blocks_of((HERE / "data" / name).read_bytes()) for name in CORPUS]
    return (np.concatenate([b for b, _ in parts], axis=0),
            np.concatenate([ln for _, ln in parts], axis=0))


def corpus_batch():
    """``(srcs (49, 81920) uint8, slens (49,) uint64, declens (49,) uint64)``:
    each corpus block's raw op stream (the host codec's, varint header cut)
    zero-padded to the width, with its length and the block's."""
    from .. import native
    from ..format.varint import read_varu64

    blocks, lens = _corpus_blocks()
    srcs = np.zeros((blocks.shape[0], WIDTH), np.uint8)
    slens = np.zeros(blocks.shape[0], np.uint64)
    for i in range(blocks.shape[0]):
        c = native.compress(blocks[i, : lens[i]].tobytes())
        _, h = read_varu64(c)
        body = c[h:]
        srcs[i, : len(body)] = np.frombuffer(body, np.uint8)
        slens[i] = len(body)
    return srcs, slens, lens.astype(np.uint64)


def thread_counts(spec: str | None) -> list[int]:
    """The thread counts to time: ``spec`` (``"1,all"``: ``all`` is the
    affinity count), else 1, 2, 4, 8 and the affinity count if larger."""
    ncpu = len(os.sched_getaffinity(0))
    if spec is None:
        return [1, 2, 4, 8] + ([ncpu] if ncpu > 8 else [])
    counts = [ncpu if t == "all" else int(t) for t in spec.split(",")]
    return sorted(set(counts))


def _sweep(fn, counts: list[int], decode_bytes: int, what: str, on_card: bool) -> dict:
    """``fn(threads)`` timed at each count: ``{"threads", "per_core_GBps",
    "best_GBps", "scaling_1_to_4"}``. The per-core slope is taken at the
    largest count of at most four within the affinity set, as the JAX
    tool takes it at ``min(cpu_count, 4)``."""
    from ..bench import _gbps, _time_it

    results = {}
    for t in counts:
        fn(t)  # warm, and checked
        ts = _time_it(lambda: fn(t), REPS)
        results[str(t)] = {"s": ts, "GBps": _gbps(decode_bytes, ts[0])}
        log(NAME, f"{what} threads={t}: {ts[0] * 1e3:.2f} ms, "
                  f"{results[str(t)]['GBps']} GB/s" + ("" if on_card else " (the CPU run)"))
    phys = max(t for t in counts if t <= min(len(os.sched_getaffinity(0)), 4))
    one, four = results.get("1"), results.get("4")
    return {
        "threads": results,
        "per_core_GBps": round(results[str(phys)]["GBps"] / phys, 4),
        "per_core_at_threads": phys,
        "best_GBps": max(r["GBps"] for r in results.values()),
        "scaling_1_to_4": (round(four["GBps"] / one["GBps"], 3)
                           if one and four and phys == 4 else None),
    }


def measure(dev, counts: list[int]) -> dict:
    import torch

    from .. import native
    from ..bench import NOT_MEASURED, _check_rows, _check_zero, _gbps
    from ..ops import launch_counts, reset_launch_counts
    from ..ops.decode_flat import decode_flat
    from ..ops.resolve import decode_resolve_batch
    from ..utils.profiling import graph_ms

    on_card = dev.type == "cuda"
    repeat = REPEAT if on_card else 1
    blocks, lens = _corpus_blocks()
    srcs, slens, declens = corpus_batch()
    blocks, lens = np.tile(blocks, (repeat, 1)), np.tile(lens, repeat)
    srcs = np.ascontiguousarray(np.tile(srcs, (repeat, 1)))
    slens, declens = np.tile(slens, repeat), np.tile(declens, repeat)
    decode_bytes = int(declens.sum())
    log(NAME, f"batch: {srcs.shape[0]} blocks, {decode_bytes} decode bytes, threads {counts}")

    flat_out = {}

    def flatten(threads: int):
        idx, tmeta, fallb, herrs, _ = native.flatten_idx_batch(srcs, slens, declens, D_PAD,
                                                               threads=threads, layout=1)
        _check_zero(herrs, f"host flatten at {threads} threads")
        _check_zero(fallb, f"host flatten at {threads} threads (tiles past every window)")
        flat_out["idx"], flat_out["tmeta"] = idx, tmeta

    def scan(threads: int):
        recs, nops, herrs, _ = native.scan_records_batch(srcs, slens, declens, REC_CAP,
                                                         threads=threads)
        _check_zero(herrs, f"record scan at {threads} threads")
        if int(nops.max(initial=0)) > REC_CAP:
            raise AssertionError("record scan: a row overflows the record cap")
        flat_out["recs"], flat_out["nops"] = recs, nops

    flat = _sweep(flatten, counts, decode_bytes, "flatten", on_card)
    scanned = _sweep(scan, counts, decode_bytes, "scan", on_card)

    # The card on the same batch, in this process. The resolve route takes
    # rows of at most 64 KiB: cut them to the batch's widest body, in 1 KiB
    # steps, as bench does.
    width = max(1024, -(-int(slens.max()) // 1024) * 1024)
    if width > D_PAD:
        raise AssertionError(f"a body of {int(slens.max())} bytes: the resolve route takes 64 KiB")
    srcs_d = torch.from_numpy(srcs).to(dev)
    lens_d = torch.from_numpy(lens.astype(np.int32)).to(dev)
    idx_d = torch.from_numpy(flat_out["idx"].view(np.int16)).to(dev)
    tmeta_d = torch.from_numpy(flat_out["tmeta"]).to(dev)
    r_pad = max(512, -(-int(flat_out["nops"].max()) // 512) * 512)
    cut_d = torch.from_numpy(np.ascontiguousarray(srcs[:, :width])).to(dev)
    recs_d = torch.from_numpy(np.ascontiguousarray(flat_out["recs"][:, :r_pad])).to(dev)
    nops_d = torch.from_numpy(flat_out["nops"].astype(np.int32)).to(dev)

    def k2():
        return decode_flat(srcs_d, idx_d, tmeta_d, lens_d, D_PAD, 1)

    def resolve():
        return decode_resolve_batch(cut_d, recs_d, nops_d, lens_d, D_PAD)

    def check_k2(dst):
        _check_rows(dst, blocks, lens, "flat gather (K2)")

    def check_resolve(res):
        _check_zero(res[1], "resolve route (fallback flags)")
        _check_rows(res[0], blocks, lens, "resolve route (K8, K2)")

    reset_launch_counts()
    card: dict = dict.fromkeys(["device_GBps", "resolve_device_GBps", "cards_fed",
                                "cores_to_feed_one_card", "scan_cards_fed",
                                "scan_cores_to_feed_one_card"], NOT_MEASURED)
    if on_card:
        k2_ms = graph_ms(k2, GRAPH_CALLS, turns=3, check=check_k2)
        res_ms = graph_ms(resolve, GRAPH_CALLS, turns=3, check=check_resolve)
        k2_gbps = _gbps(decode_bytes, min(k2_ms) / 1e3)
        res_gbps = _gbps(decode_bytes, min(res_ms) / 1e3)
        card = {
            "device_GBps": k2_gbps,
            "device_ms": k2_ms,
            "resolve_device_GBps": res_gbps,
            "resolve_device_ms": res_ms,
            "cards_fed": round(flat["best_GBps"] / k2_gbps, 4),
            "cores_to_feed_one_card": round(k2_gbps / flat["per_core_GBps"], 2),
            "scan_cards_fed": round(scanned["best_GBps"] / res_gbps, 4),
            "scan_cores_to_feed_one_card": round(res_gbps / scanned["per_core_GBps"], 2),
        }
    else:
        check_k2(k2())
        check_resolve(resolve())
    out = {
        "batch_blocks": int(srcs.shape[0]),
        "decode_bytes": decode_bytes,
        "d_pad": D_PAD,
        "layout": 1,
        "threads": flat["threads"],
        "per_core_GBps": flat["per_core_GBps"],
        "per_core_at_threads": flat["per_core_at_threads"],
        "scaling_1_to_4": flat["scaling_1_to_4"],
        "flatten_best_GBps": flat["best_GBps"],
        "scan_threads": scanned["threads"],
        "scan_per_core_GBps": scanned["per_core_GBps"],
        "scan_scaling_1_to_4": scanned["scaling_1_to_4"],
        "scan_best_GBps": scanned["best_GBps"],
        **card,
        "launches": {k: v for k, v in launch_counts().items() if v},
        "note": (
            "GB/s of decoded bytes; device_GBps is K2 layout=1 and resolve_device_GBps the "
            "resolve route (K8, its tensor ops, K2), each device-only (CUDA graph replays), "
            "on this batch in this process; cores_to_* divide the card's rate by the host "
            "pass's per-core slope"
        ),
    }
    if on_card:
        log(NAME, f"K2 {card['device_GBps']} GB/s, resolve route "
                  f"{card['resolve_device_GBps']} GB/s; one card needs "
                  f"{out['cores_to_feed_one_card']} flatten cores, "
                  f"{out['scan_cores_to_feed_one_card']} scan cores")
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog=f"python -m snappy_tpu_torch.tools.{NAME}")
    ap.add_argument("--threads", help="thread counts, e.g. 1,all (default 1,2,4,8 and all)")
    ap.add_argument("--cpu", action="store_true", help="the card's part on the plain versions")
    args = ap.parse_args(argv)
    counts = thread_counts(args.threads)
    return run(NAME, lambda dev: measure(dev, counts), args.cpu)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
