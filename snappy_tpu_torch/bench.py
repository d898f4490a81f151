"""Benchmark of the port: batched codec throughput over the bundled corpus.

The counterpart of the repository's ``bench.py``, which drives the JAX
package: the same stages, flags and field names, on the port's calls and
PyTorch's timing. Every stage holds every row it decodes or compresses
to the input blocks; a route that fails, or gives one wrong row, fails its
stage, and the run exits non-zero after the remaining stages.

    python -m snappy_tpu_torch.bench                   # every stage; one JSON line last
    python -m snappy_tpu_torch.bench --stage NAME      # one stage (canary, decode16,
                                                       #   decode, crc, encode, sharded)
    python -m snappy_tpu_torch.bench --host-table      # per-file host codec table
    python -m snappy_tpu_torch.bench --host-aggregate  # multithreaded host batch codec
    python -m snappy_tpu_torch.bench --sharded         # the sharded stage alone

It needs a CUDA card and exits non-zero before its first stage without
one. ``--cpu`` runs every stage on the kernels' plain versions at the
tests' sizes (one tiling of the corpus, 16 rows): it checks the routes,
and its rates and device-only fields read ``"not measured"``.

Each stage runs in a process of its own with a deadline (its budget in
``BUDGETS_S``, within ``BENCH_DEADLINE_S`` for the whole run, 900 s); the
merged fields are written to ``build/snappy_tpu_torch/bench_partial.json`` after
every stage. Sizes: ``BENCH_REPEAT`` tilings of the corpus's 64 KiB
blocks (8 on the card: 392 blocks, 23.4 MB), ``BENCH_ITERS`` warm calls
(3 on the card), ``BENCH_REPEAT_SHARDED`` tilings for the sharded stage (2).

Fields, by stage (``decode16_*`` are the decode stage's on its first 16
rows; ``*_s`` is ``[min, median, max]`` seconds of the warm calls, the
rate beside it from the min; ``*_compile_s`` is the first call's seconds:
the kernels' load and the card's warm-up, where the JAX package compiles):

- ``canary``: ``platform`` (``gpu`` or ``cpu``), ``card`` (``nvidia-smi``'s
  name and power limit), ``canary_roundtrip_ms`` (a one-element launch and
  its copy back), ``canary_tflops`` (16 chained bf16 2048² products,
  ``torch.matmul``), ``canary_hbm_gbps`` (16 elementwise passes over 256 MB);
- ``decode``: ``decode_GBps`` (``ops.decode.decode_batch``: tensor ops,
  op starts found on the card), ``decode_hybrid_GBps``
  (``native.scan_ops_batch``, then ``decode_batch_hosted``),
  ``decode_pallas_GBps`` (the replay kernel, K3), ``decode_records_GBps``
  (``native.scan_records_batch``, the copy in, K10), each call-synced:
  timed to the codes' or a row slice's copy back;
  ``decode_device_GBps`` (the flat route's gather, K2 ``layout=1``, on
  resident host-flattened indices; ``decode_device_route``) with
  ``decode_flat_host_s``, ``decode_flat_host_GBps`` (the host flatten,
  ``native.flatten_idx_batch``) and the end-to-end rates over both,
  ``decode_e2e_GBps`` (the slower stage: a pipelined host and card) and
  ``decode_e2e_serial_GBps`` (their sum); ``decode_resolve_device_GBps``
  (``ops.resolve.decode_resolve_batch``: K8, its tensor ops, K2, on
  resident records) with ``decode_resolve_scan_host_s``,
  ``decode_resolve_e2e_GBps`` and ``decode_resolve_chips_fed`` (the
  card's time over the host scan's); ``decode_peak_bytes``;
- ``crc``: ``crc32c_GBps`` (masked CRC32C of every block, K1, timed to
  the sum's copy back), ``crc32c_device_GBps``;
- ``encode``: ``compress_GBps`` (``ops.encode_fast.compress_blocks_fast``,
  timed to the lengths' copy back), ``compress_device_GBps`` (the larger
  of the two device-resident rates), ``compress_flat_device_GBps``
  (``ops.encode_flat.compress_blocks_flat_fast``: K4, the plan, K5), both
  on the whole batch;
- ``sharded``: ``sharded_devices`` (the cards of ``make_mesh()``), and
  per path the mesh of ``[cuda:0]`` against ``make_mesh()``, from host
  memory: ``sharded_decode_xla_*`` (``sharded_decode_streams``),
  ``sharded_decode_hosted_*`` (``sharded_decode_streams_hosted``) and the
  flat route's ``sharded_decode_1dev_GBps``, ``_ndev_GBps`` and
  ``sharded_speedup`` (``sharded_decode_streams_flat`` on host-flattened
  indices).

Device-only rates (``*_device_GBps``) are taken with the host out of the
window where the call reads nothing back (K2, the resolve route, K1: 20
calls captured in a CUDA graph, its replay timed with CUDA events, three
replays); the encoders wait on the card inside a call (their loops test
convergence), so theirs are CUDA events around 5 resident calls, the
host's dispatch included. The last timed call's output is checked as the
first call's is. The headline is ``decode_device_GBps``, a rate
of the card's stage alone; the ``_e2e_`` fields are what a user whose
host flattens sees.
"""

from __future__ import annotations

import json
import os
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
DATA = HERE / "data"
PARTIAL_PATH = HERE / "build" / "snappy_tpu_torch" / "bench_partial.json"

CORPUS = [
    "html",
    "urls.10K",
    "fireworks.jpeg",
    "paper-100k.pdf",
    "html_x_4",
    "alice29.txt",
    "asyoulik.txt",
    "lcet10.txt",
    "plrabn12.txt",
    "geo.protodata",
    "kppkn.gtb",
]

MAX_COMPRESSED = 76490
CPU_ROWS = 16
NOT_MEASURED = "not measured"
GRAPH_CALLS = 20
EVENT_CALLS = 5
#: Bytes each timing of the host table covers.
HOST_BYTES = 20_000_000
STAGES = ["canary", "decode16", "decode", "crc", "encode", "sharded"]
BUDGETS_S = {"canary": 120, "decode16": 240, "decode": 360, "crc": 120, "encode": 300,
             "sharded": 300}


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# Helpers of the stages (run inside the stage processes)
# ---------------------------------------------------------------------------


def _device(cpu: bool):
    """The stage's device: the card, or the CPU under ``--cpu``; without a
    card and without ``--cpu`` this raises (``ops.api.resolve_device``)."""
    from .ops.api import resolve_device

    return resolve_device("cpu" if cpu else "cuda")


def _sizes(dev) -> tuple[int, int, int | None]:
    """``(corpus tilings, warm calls, row cap)`` on ``dev``."""
    on_card = dev.type == "cuda"
    repeat = int(os.environ.get("BENCH_REPEAT", "8" if on_card else "1"))
    iters = int(os.environ.get("BENCH_ITERS", "3" if on_card else "2"))
    return repeat, iters, None if on_card else CPU_ROWS


def _load_corpus_blocks(repeat: int):
    """All corpus files split into 64 KiB blocks, tiled ``repeat`` times."""
    import numpy as np

    from .ops.packing import blocks_of

    blocks_list, lens_list = [], []
    for name in CORPUS:
        b, l = blocks_of((DATA / name).read_bytes())
        blocks_list.append(b)
        lens_list.append(l)
    blocks = np.concatenate(blocks_list, axis=0)
    lens = np.concatenate(lens_list, axis=0)
    return np.tile(blocks, (repeat, 1)), np.tile(lens, repeat)


def _compressed_rows(blocks, lens, width: int = 81920):
    """Host-native per-block compression -> padded device decode inputs."""
    import numpy as np

    from .engine import get_engine
    from .format.varint import read_varu64

    eng = get_engine("auto")
    srcs = np.zeros((blocks.shape[0], width), np.uint8)
    slens = np.zeros(blocks.shape[0], np.int32)
    cache: dict[bytes, bytes] = {}
    for i in range(blocks.shape[0]):
        key = blocks[i, : lens[i]].tobytes()
        body = cache.get(key)
        if body is None:
            c = eng.compress(key)
            _, h = read_varu64(c)
            body = cache[key] = c[h:]
        srcs[i, : len(body)] = np.frombuffer(body, np.uint8)
        slens[i] = len(body)
    return srcs, slens


def _time_it(fn, iters: int) -> list[float]:
    """``[min, median, max]`` seconds of ``iters`` calls of ``fn`` (warm:
    the caller has made the first call)."""
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return [min(ts), statistics.median(ts), max(ts)]


def _first(fn):
    """``(fn(), its seconds)``: the first, cold call."""
    t0 = time.perf_counter()
    res = fn()
    return res, time.perf_counter() - t0


def _device_s(fn, graph: bool, check) -> list[float]:
    """``[min, median, max]`` seconds a call of ``fn`` takes on the card,
    over three timed windows (``utils.profiling``). With ``graph``, each
    window is the replay of ``GRAPH_CALLS`` calls captured once in a CUDA
    graph, so the host is out of it (``fn`` must read nothing back); else
    ``EVENT_CALLS`` calls on resident inputs, the host's dispatch included.
    ``check`` is held to the last timed call's output."""
    from .utils.profiling import event_ms, graph_ms

    if graph:
        ms = graph_ms(fn, GRAPH_CALLS, turns=3, check=check)
    else:
        ms = event_ms(fn, EVENT_CALLS, turns=3, check=check)
    return [min(ms) / 1e3, statistics.median(ms) / 1e3, max(ms) / 1e3]


def _gbps(nbytes: int, seconds: float) -> float:
    return round(nbytes / seconds / 1e9, 4)


def _check_rows(dst, blocks, lens, what: str) -> None:
    """Every row of ``dst`` (on any device) holds its block's bytes below its
    length."""
    import numpy as np

    d = dst.cpu().numpy() if hasattr(dst, "cpu") else np.asarray(dst)
    w = blocks.shape[1]
    live = np.arange(w)[None, :] < np.asarray(lens)[:, None]
    bad = np.nonzero(((d[: len(lens), :w] != blocks) & live).any(axis=1))[0]
    if bad.size:
        raise AssertionError(f"{what}: {bad.size} rows differ from their blocks, first {bad[:8].tolist()}")


def _check_zero(codes, what: str) -> None:
    import numpy as np

    c = codes.cpu().numpy() if hasattr(codes, "cpu") else np.asarray(codes)
    bad = np.nonzero(c)[0]
    if bad.size:
        raise AssertionError(f"{what}: rows {bad[:8].tolist()} flagged on valid bench inputs")


def _peak_reset(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else NOT_MEASURED


def _unmeasured(fields: dict) -> dict:
    """``fields`` with every rate written as not measured: under ``--cpu``
    the stages check the routes on the plain versions, and a rate taken
    there is no rate of the card."""
    rates = ("GBps", "gbps", "tflops", "speedup", "chips_fed", "roundtrip_ms")
    return {k: NOT_MEASURED if k.endswith(rates) else v for k, v in fields.items()}


def _card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi`` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


def _stage_canary(cpu: bool) -> dict:
    """Platform health: a round trip, chained products, a memory stream.

    On the card the products are ``torch.matmul`` (a library call: the
    canary measures the platform, not the port) and the stream is 16
    elementwise passes over 256 MB; under ``--cpu`` both shrink (256² and
    4 MB) and read only as a check that the stage runs."""
    import torch

    dev = _device(cpu)
    on_card = dev.type == "cuda"
    k = 16
    n = 2048 if on_card else 256
    elems = (64 << 20) if on_card else (1 << 20)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    z = torch.zeros(1, dtype=torch.int32, device=dev)
    int((z + 1).item())
    t0 = time.perf_counter()
    for _ in range(5):
        int((z + 1).item())
    roundtrip_ms = (time.perf_counter() - t0) / 5 * 1e3

    x = torch.ones((n, n), dtype=torch.bfloat16, device=dev)

    def chain_mm():
        a = x
        for _ in range(k):
            a = (a @ a) * 1e-9
        return float(a.float().sum())

    _, compile_s = _first(chain_mm)
    sync()
    t_mm = _time_it(chain_mm, 3)
    big = torch.ones(elems, dtype=torch.float32, device=dev)

    def chain_ew():
        a = big
        for _ in range(k):
            a = a * 1.0000001
        return float(a[-1])

    chain_ew()
    t_ew = _time_it(chain_ew, 3)
    out = {
        "platform": "gpu" if on_card else "cpu",
        "card": _card_line() if on_card else NOT_MEASURED,
        "canary_compile_s": compile_s,
        "canary_tflops": round(k * 2 * n**3 / t_mm[0] / 1e12, 2),
        "canary_hbm_gbps": round(k * 2 * elems * 4 / t_ew[0] / 1e9, 2),
        "canary_roundtrip_ms": roundtrip_ms,
    }
    if on_card:
        out["device_name"] = torch.cuda.get_device_name(dev)
    return out


def _stage_decode(rows: int | None, cpu: bool) -> dict:
    """Decode throughput on the first ``rows`` corpus blocks (None = all),
    route by route in ``bench.py``'s order."""
    import numpy as np
    import torch

    from . import native
    from .ops.decode import decode_batch, decode_batch_hosted
    from .ops.decode_flat import decode_flat
    from .ops.records import decode_records
    from .ops.replay import decode_replay
    from .ops.resolve import decode_resolve_batch

    dev = _device(cpu)
    on_card = dev.type == "cuda"
    repeat, iters, cap = _sizes(dev)
    blocks, lens = _load_corpus_blocks(repeat)
    take = rows if rows is not None else cap
    if take is not None:
        blocks, lens = blocks[:take], lens[:take]
    key = "decode16" if rows is not None else "decode"
    nrows = blocks.shape[0]
    total = int(lens.sum())
    srcs, slens = _compressed_rows(blocks, lens)
    # Bucket the row width to the batch's real maximum (1 KiB steps).
    width = max(1024, -(-int(slens.max()) // 1024) * 1024)
    srcs = np.ascontiguousarray(srcs[:, :width])
    slens64, lens64 = np.asarray(slens, np.uint64), np.asarray(lens, np.uint64)
    srcs_d = torch.from_numpy(srcs).to(dev)
    slens_d = torch.from_numpy(np.asarray(slens, np.int32)).to(dev)
    lens_d = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
    _peak_reset(dev)
    out: dict = {f"{key}_bytes": total}
    if rows is None:
        out["batch_blocks"] = nrows

    def call_synced(field: str, fn, check) -> None:
        res, first = _first(fn)
        check(res)
        ts = _time_it(fn, iters)
        out[field] = _gbps(total, ts[0])
        out[field[: -len("_GBps")] + "_s"] = ts
        _log(f"{key}[{nrows} rows]: {out[field]:.4f} GB/s ({field}; first call {first:.3f} s)")
        return first

    # The tensor decode, op starts found on the card.
    def run_xla():
        dst, errs, _ = decode_batch(srcs_d, slens_d, lens_d, 65536)
        return dst, errs.cpu()

    def check_dst_errs(what):
        def check(res):
            _check_zero(res[1], what)
            _check_rows(res[0], blocks, lens, what)
        return check

    out[f"{key}_compile_s"] = call_synced(f"{key}_GBps", run_xla, check_dst_errs("decode"))

    # Hybrid: the host's op-start bitmaps, then the tensor decode.
    bits = np.zeros((nrows, width // 8), np.uint8)

    def run_hybrid():
        native.scan_ops_batch(srcs, slens64, bits)
        dst, errs, _ = decode_batch_hosted(srcs_d, slens_d, lens_d, torch.from_numpy(bits).to(dev),
                                           65536)
        return dst, errs.cpu()

    call_synced(f"{key}_hybrid_GBps", run_hybrid, check_dst_errs("hybrid decode"))

    # The replay kernel (K3).
    def run_replay():
        dst, errs = decode_replay(srcs_d, slens_d, lens_d, 65536)
        return dst, errs.cpu()

    call_synced(f"{key}_pallas_GBps", run_replay, check_dst_errs("replay decode (K3)"))

    # Record replay (K10): the host scan, the records' copy in and K10,
    # timed to a thin slice's copy back.
    rec_cap = 16384

    def scan():
        recs, nops, herrs, _ = native.scan_records_batch(srcs, slens64, lens64, rec_cap)
        _check_zero(herrs, "record scan")
        if int(nops.max(initial=0)) > rec_cap:
            raise AssertionError("record scan: a row overflows the record cap")
        return recs, nops

    recs0, nops0 = scan()
    r_pad = max(512, -(-int(nops0.max()) // 512) * 512)

    def run_records(full: bool = False):
        recs, nops = scan()
        dst = decode_records(
            srcs_d, torch.from_numpy(np.ascontiguousarray(recs[:, :r_pad])).to(dev),
            torch.from_numpy(nops.astype(np.int32)).to(dev), lens_d, 65536,
        )
        return dst if full else dst[:, :128].cpu()

    _check_rows(run_records(full=True), blocks, lens, "records decode (K10)")
    call_synced(f"{key}_records_GBps", run_records, lambda res: None)

    # The flat route: the host flatten, then K2 on resident indices.
    def flatten():
        idx, tmeta, fallb, herrs, _ = native.flatten_idx_batch(srcs, slens64, lens64, 65536,
                                                               layout=1)
        _check_zero(herrs, "host flatten")
        _check_zero(fallb, "host flatten (windows)")
        return idx, tmeta

    (idxp, tmeta), flat_first = _first(flatten)
    idx_d = torch.from_numpy(idxp.view(np.int16)).to(dev)
    tmeta_d = torch.from_numpy(tmeta).to(dev)

    def run_flat():
        return decode_flat(srcs_d, idx_d, tmeta_d, lens_d, 65536, 1)

    dst, dev_first = _first(lambda: run_flat().cpu())
    _check_rows(dst, blocks, lens, "flat decode (K2)")
    fh = min([flat_first] + _time_it(flatten, 3))
    out[f"{key}_flat_host_s"] = fh
    out[f"{key}_flat_host_GBps"] = _gbps(total, fh)
    out[f"{key}_device_route"] = "flat_gather"
    out[f"{key}_device_compile_s"] = dev_first
    if on_card:
        per = _device_s(run_flat, True,
                        lambda d: _check_rows(d, blocks, lens, "flat decode (K2), timed replays"))
        out[f"{key}_device_GBps"] = _gbps(total, per[0])
        out[f"{key}_device_s"] = per
        out[f"{key}_e2e_GBps"] = _gbps(total, max(fh, per[0]))
        out[f"{key}_e2e_serial_GBps"] = _gbps(total, fh + per[0])
        _log(f"{key}[{nrows} rows]: {out[f'{key}_device_GBps']:.4f} GB/s (device, flat route); "
             f"host flatten {out[f'{key}_flat_host_GBps']:.4f} GB/s, e2e "
             f"{out[f'{key}_e2e_GBps']:.4f} GB/s")
    else:
        for f in ("device_GBps", "e2e_GBps", "e2e_serial_GBps"):
            out[f"{key}_{f}"] = NOT_MEASURED

    # The resolve route (K8, its tensor ops, K2) on resident records.
    if key == "decode" and width <= 65536:
        scan_s = min(_time_it(scan, 3))
        recs_d = torch.from_numpy(np.ascontiguousarray(recs0[:, :r_pad])).to(dev)
        nops_d = torch.from_numpy(nops0.astype(np.int32)).to(dev)

        def run_resolve():
            return decode_resolve_batch(srcs_d, recs_d, nops_d, lens_d, 65536)

        def check_resolve(res, what="resolve decode"):
            _check_zero(res[1], f"{what} (fallback flags)")
            _check_rows(res[0], blocks, lens, f"{what} (K8, K2)")

        res, res_first = _first(lambda: tuple(t.cpu() for t in run_resolve()))
        check_resolve(res)
        out["decode_resolve_scan_host_s"] = scan_s
        out["decode_resolve_compile_s"] = res_first
        if on_card:
            per_r = _device_s(run_resolve, True,
                              lambda r: check_resolve(r, "resolve decode, timed replays"))
            out["decode_resolve_device_GBps"] = _gbps(total, per_r[0])
            out["decode_resolve_device_s"] = per_r
            out["decode_resolve_e2e_GBps"] = _gbps(total, max(scan_s, per_r[0]))
            out["decode_resolve_chips_fed"] = round(per_r[0] / scan_s, 3)
            _log(f"decode[{nrows} rows]: {out['decode_resolve_device_GBps']:.4f} GB/s "
                 "(device, resolve route)")
        else:
            for f in ("device_GBps", "e2e_GBps", "chips_fed"):
                out[f"decode_resolve_{f}"] = NOT_MEASURED
    out[f"{key}_peak_bytes"] = _peak(dev)
    return out


def _stage_crc(cpu: bool) -> dict:
    """Masked CRC32C (K1) over the corpus blocks: timed to the sum's copy
    back, and device-only."""
    import numpy as np
    import torch

    from . import native
    from .ops.crc32c import crc32c_masked_blocks

    dev = _device(cpu)
    repeat, iters, cap = _sizes(dev)
    blocks, lens = _load_corpus_blocks(repeat)
    if cap is not None:
        blocks, lens = blocks[:cap], lens[:cap]
    total = int(lens.sum())
    blocks_d = torch.from_numpy(blocks).to(dev)
    lens_d = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
    _peak_reset(dev)
    want = np.array([native.crc32c_masked(blocks[i, : lens[i]].tobytes())
                     for i in range(blocks.shape[0])], np.int64)

    def check(crc, what="crc32c (K1)"):
        bad = np.nonzero(crc.cpu().numpy() != want)[0]
        if bad.size:
            raise AssertionError(f"{what}: rows {bad[:8].tolist()} differ from the host codec's")

    crc, first = _first(lambda: crc32c_masked_blocks(blocks_d, lens_d).cpu())
    check(crc)
    ts = _time_it(lambda: int(crc32c_masked_blocks(blocks_d, lens_d).sum()), iters)
    out = {"crc32c_GBps": _gbps(total, ts[0]), "crc32c_s": ts, "crc_compile_s": first}
    if dev.type == "cuda":
        per = _device_s(lambda: crc32c_masked_blocks(blocks_d, lens_d), True,
                        lambda c: check(c, "crc32c (K1), timed replays"))
        out["crc32c_device_GBps"] = _gbps(total, per[0])
        out["crc32c_device_s"] = per
    else:
        out["crc32c_device_GBps"] = NOT_MEASURED
    out["crc_peak_bytes"] = _peak(dev)
    _log(f"crc: {out['crc32c_GBps']:.4f} GB/s (call-synced), {out['crc32c_device_GBps']} (device)")
    return out


def _check_compressed(out, out_len, blocks, lens, what: str) -> None:
    """Every row's op stream is at most ``MAX_COMPRESSED`` bytes and decodes
    (host codec) to its block."""
    from . import native
    from .format.varint import write_varu64

    o, n = out.cpu().numpy(), out_len.cpu().numpy()
    if int(n.max(initial=0)) > MAX_COMPRESSED:
        raise AssertionError(f"{what}: an output length past {MAX_COMPRESSED}")
    for i in range(len(lens)):
        got = native.decompress(write_varu64(int(lens[i])) + o[i, : n[i]].tobytes())
        if got != blocks[i, : lens[i]].tobytes():
            raise AssertionError(f"{what}: row {i} does not decode to its block")


def _stage_encode(cpu: bool) -> dict:
    """The fast profile in tensor ops (call-synced and device-resident) and
    the flat encoder (K4, the plan, K5; device-resident), on the whole batch."""
    import numpy as np
    import torch

    from .ops.encode_fast import compress_blocks_fast
    from .ops.encode_flat import compress_blocks_flat_fast

    dev = _device(cpu)
    on_card = dev.type == "cuda"
    repeat, iters, cap = _sizes(dev)
    blocks, lens = _load_corpus_blocks(repeat)
    if cap is not None:
        blocks, lens = blocks[:cap], lens[:cap]
    total = int(lens.sum())
    blocks_d = torch.from_numpy(blocks).to(dev)
    lens_d = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
    _peak_reset(dev)
    (fout, flen), first = _first(lambda: compress_blocks_fast(blocks_d, lens_d))
    _check_compressed(fout, flen, blocks, lens, "fast encode")
    ts = _time_it(lambda: compress_blocks_fast(blocks_d, lens_d)[1].cpu(), iters)
    res = {"compress_GBps": _gbps(total, ts[0]), "compress_s": ts, "encode_compile_s": first,
           "compress_device_blocks": int(blocks.shape[0])}

    def check_flat(r, what="flat encode"):
        _check_zero(r[2], f"{what} (overflow flags)")
        _check_compressed(r[0], r[1], blocks, lens, f"{what} (K4, K5)")

    flat, res["compress_flat_compile_s"] = _first(
        lambda: compress_blocks_flat_fast(blocks_d, lens_d))
    check_flat(flat)
    if on_card:
        per = _device_s(lambda: compress_blocks_fast(blocks_d, lens_d), False,
                        lambda r: _check_compressed(*r, blocks, lens, "fast encode, timed calls"))
        per_f = _device_s(lambda: compress_blocks_flat_fast(blocks_d, lens_d), False,
                          lambda r: check_flat(r, "flat encode, timed calls"))
        res["compress_device_s"] = per
        res["compress_flat_device_GBps"] = _gbps(total, per_f[0])
        res["compress_flat_device_s"] = per_f
        res["compress_device_GBps"] = max(_gbps(total, per[0]), res["compress_flat_device_GBps"])
    else:
        res["compress_device_GBps"] = res["compress_flat_device_GBps"] = NOT_MEASURED
    res["encode_peak_bytes"] = _peak(dev)
    _log(f"encode: {res['compress_GBps']:.4f} GB/s (fast, call-synced), flat "
         f"{res['compress_flat_device_GBps']} (device-resident)")
    return res


def _stage_sharded(cpu: bool) -> dict:
    """One device against the mesh: the tensor decode, its hosted variant
    and the flat route, each through its sharded entry from host memory.

    On the card the mesh is ``make_mesh()`` (every card) against
    ``[cuda:0]``; on a machine of one card both are one card, and the
    stage checks the entries rather than measuring scaling. Under
    ``--cpu`` the mesh is four entries of the CPU."""
    import numpy as np
    import torch

    from . import native
    from .parallel.mesh import make_mesh
    from .parallel.sharded import (
        pad_batch, sharded_decode_streams, sharded_decode_streams_flat,
        sharded_decode_streams_hosted,
    )

    dev = _device(cpu)
    _, iters, cap = _sizes(dev)
    blocks, lens = _load_corpus_blocks(int(os.environ.get("BENCH_REPEAT_SHARDED", "2")))
    if cap is not None:
        blocks, lens = blocks[:cap], lens[:cap]
    mesh = make_mesh([dev] * 4) if dev.type == "cpu" else make_mesh()
    one = make_mesh([dev])
    ndev = mesh.size
    srcs, slens = _compressed_rows(blocks, lens)
    width = max(1024, -(-int(slens.max()) // 1024) * 1024)
    srcs, slens_p, _ = pad_batch(np.ascontiguousarray(srcs[:, :width]), slens, ndev)
    declens = np.zeros(srcs.shape[0], np.int32)
    declens[: len(lens)] = lens
    total = int(lens.sum())
    nb = len(lens)
    bits = np.zeros((srcs.shape[0], width // 8), np.uint8)
    native.scan_ops_batch(srcs, np.asarray(slens_p, np.uint64), bits)
    idxp, tmeta, fallb, herrs, _ = native.flatten_idx_batch(
        srcs, np.asarray(slens_p, np.uint64), np.asarray(declens, np.uint64), 65536, layout=1)
    _check_zero(herrs, "host flatten")
    _check_zero(fallb, "host flatten (windows)")

    paths = {
        "xla": lambda m: sharded_decode_streams(m, srcs, slens_p, declens, 65536),
        "hosted": lambda m: sharded_decode_streams_hosted(m, srcs, slens_p, declens, bits, 65536),
        "flat": lambda m: (sharded_decode_streams_flat(m, srcs, idxp, tmeta, declens, 65536),),
    }

    def sync():
        if dev.type == "cuda":
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    _peak_reset(dev)
    out = {"sharded_devices": ndev, "sharded_mesh": [str(d) for d in mesh.devices]}
    for name, fn in paths.items():
        times = {}
        for label, m in (("1dev", one), ("ndev", mesh)):
            res = fn(m)
            if len(res) > 1:
                _check_zero(res[1].numpy()[:nb], f"sharded {name} decode on {label}")
            _check_rows(res[0].numpy()[:nb], blocks, lens, f"sharded {name} decode on {label}")

            def run():
                r = fn(m)
                (r[1] if len(r) > 1 else r[0]).numpy()
                sync()

            times[label] = _time_it(run, iters)
        stem = "sharded_decode" if name == "flat" else f"sharded_decode_{name}"
        out[f"{stem}_1dev_GBps"] = _gbps(total, times["1dev"][0])
        out[f"{stem}_ndev_GBps"] = _gbps(total, times["ndev"][0])
        out[f"{stem}_1dev_s"] = times["1dev"]
        out[f"{stem}_ndev_s"] = times["ndev"]
        speed = "sharded_speedup" if name == "flat" else f"sharded_{name}_speedup"
        out[speed] = round(times["1dev"][0] / times["ndev"][0], 3)
        _log(f"sharded {name} decode: [{one.devices[0]}] {out[f'{stem}_1dev_GBps']:.4f} GB/s, "
             f"{ndev} entries {out[f'{stem}_ndev_GBps']:.4f} GB/s")
    out["sharded_decode_route"] = "flat_gather"
    out["sharded_peak_bytes"] = _peak(dev)
    return out


def _host_canary() -> dict:
    """Machine-state canary for host captures: memcpy bandwidth and the host
    codec's CRC32C speed, to compare captures across windows."""
    import numpy as np

    from . import native

    src = np.random.default_rng(0).integers(0, 256, 1 << 26, np.uint8)
    dst = np.empty_like(src)
    t = _time_it(lambda: np.copyto(dst, src), 5)[0]
    memcpy_gbps = src.nbytes / t / 1e9
    buf = src[: 1 << 24].tobytes()
    t = _time_it(lambda: native.crc32c(buf), 5)[0]
    crc_gbps = len(buf) / t / 1e9
    _log(f"host canary: memcpy {memcpy_gbps:.1f} GB/s, crc32c {crc_gbps:.1f} GB/s")
    return {"host_memcpy_gbps": round(memcpy_gbps, 2), "host_crc32c_gbps": round(crc_gbps, 2)}


def _host_table() -> dict:
    """Per-file host codec zflat/uflat table (the reference's
    ``bench/src/bench.rs:83-114``), the 200-byte jpeg slice included, timed
    into preallocated buffers, beside the system libsnappy through the same
    ctypes shape where it is installed; each timing covers ``HOST_BYTES``."""
    import ctypes

    import numpy as np

    from . import raw
    from .utils import cpp_oracle

    enc = raw.Encoder(engine="native")
    dec = raw.Decoder(engine="native")
    cpp = cpp_oracle._load() if cpp_oracle.available() else None
    table = [
        ("html", None), ("urls.10K", None), ("fireworks.jpeg", None),
        ("fireworks.jpeg", 200), ("paper-100k.pdf", None),
        ("html_x_4", None), ("alice29.txt", None), ("asyoulik.txt", None),
        ("lcet10.txt", None), ("plrabn12.txt", None),
        ("geo.protodata", None), ("kppkn.gtb", None),
    ]
    rows = []
    for fi, (name, cut) in enumerate(table):
        fdata = (DATA / name).read_bytes()
        if cut is not None:
            fdata = fdata[:cut]
            name = f"{name}[..{cut}]"
        zbuf = np.empty(raw.max_compress_len(len(fdata)), np.uint8)
        ubuf = np.empty(max(len(fdata), 1), np.uint8)
        nc = enc.compress(fdata, zbuf)
        fc = zbuf[:nc].tobytes()
        if dec.decompress(fc, ubuf) != len(fdata) or ubuf[: len(fdata)].tobytes() != fdata:
            raise AssertionError(f"host table: {name} does not round-trip")
        reps = max(1, HOST_BYTES // max(len(fdata), 1))
        zt = _time_it(lambda: [enc.compress(fdata, zbuf) for _ in range(reps)], 3)[0] / reps
        ut = _time_it(lambda: [dec.decompress(fc, ubuf) for _ in range(reps)], 3)[0] / reps
        z_mbps, u_mbps = len(fdata) / zt / 1e6, len(fdata) / ut / 1e6
        row = {
            "bench": f"zflat{fi:02d}/uflat{fi:02d}",
            "file": name,
            "bytes": len(fdata),
            "compress_MBps": round(z_mbps, 1),
            "decompress_MBps": round(u_mbps, 1),
        }
        extra = ""
        if cpp is not None:
            czbuf = ctypes.create_string_buffer(cpp_oracle.max_compressed_length(len(fdata)))
            cubuf = ctypes.create_string_buffer(max(len(fdata), 1))
            zn, un = ctypes.c_size_t(), ctypes.c_size_t()

            def cpp_z():
                zn.value = len(czbuf)
                cpp.snappy_compress(fdata, len(fdata), czbuf, ctypes.byref(zn))

            def cpp_u():
                un.value = len(cubuf)
                cpp.snappy_uncompress(fc, len(fc), cubuf, ctypes.byref(un))

            czt = _time_it(lambda: [cpp_z() for _ in range(reps)], 3)[0] / reps
            cut_ = _time_it(lambda: [cpp_u() for _ in range(reps)], 3)[0] / reps
            cz, cu = len(fdata) / czt / 1e6, len(fdata) / cut_ / 1e6
            row.update(
                cpp_compress_MBps=round(cz, 1),
                cpp_decompress_MBps=round(cu, 1),
                z_vs_cpp=round(z_mbps / cz, 2),
                u_vs_cpp=round(u_mbps / cu, 2),
            )
            extra = f"  vs cpp z {z_mbps / cz:4.2f}x u {u_mbps / cu:4.2f}x"
        rows.append(row)
        _log(f"zflat{fi:02d}/uflat{fi:02d} {name:20s} "
             f"z {z_mbps:8.1f} MB/s  u {u_mbps:8.1f} MB/s{extra}")
    return {"host_native_per_file": rows, "cpp": cpp is not None, **_host_canary()}


def _host_aggregate() -> dict:
    """Aggregate multithreaded host raw-codec throughput (all cores) over the
    corpus in 64 KiB blocks, tiled 8 times, through the zero-allocation batch
    calls (``native.*_batch_into``)."""
    import numpy as np

    from . import native, raw

    blocks = []
    for name in CORPUS:
        d = (DATA / name).read_bytes()
        blocks.extend(d[o : o + 65536] for o in range(0, len(d), 65536))
    blocks = blocks * 8
    total = sum(len(b) for b in blocks)
    enc = raw.Encoder(engine="native")
    comp = [enc.compress_vec(b) for b in blocks]
    ctotal = sum(len(c) for c in comp)
    n = len(blocks)

    srcs_u = np.zeros((n, 65536), np.uint8)
    lens_u = np.empty(n, np.uint64)
    for i, b in enumerate(blocks):
        srcs_u[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens_u[i] = len(b)
    zcap = raw.max_compress_len(65536)
    dsts_z = np.empty((n, zcap), np.uint8)
    srcs_z = np.zeros((n, zcap), np.uint8)
    lens_z = np.empty(n, np.uint64)
    for i, c in enumerate(comp):
        srcs_z[i, : len(c)] = np.frombuffer(c, np.uint8)
        lens_z[i] = len(c)
    dsts_u = np.empty((n, 65536), np.uint8)
    out_lens = np.empty(n, np.uint64)
    errs = np.zeros((n, 4), np.uint64)

    # Warm-up and check: a failing row would stop the C++ early and inflate
    # the timed numbers.
    native.compress_batch_into(srcs_u, lens_u, dsts_z, out_lens, errs, 0)
    if errs[:, 0].any():
        raise AssertionError("compress_batch flagged errors on bench inputs")
    native.decompress_batch_into(srcs_z, lens_z, dsts_u, out_lens, errs, 0)
    if errs[:, 0].any():
        raise AssertionError("decompress_batch flagged errors on bench inputs")
    for i, b in enumerate(blocks):
        if dsts_u[i, : int(out_lens[i])].tobytes() != b:
            raise AssertionError(f"decompress_batch: row {i} differs from its block")

    res = {"host_aggregate_blocks": n, "host_aggregate_bytes": total,
           "host_cores": os.cpu_count()}
    for threads, tag in ((1, "1t"), (0, "all")):
        zt = _time_it(lambda: native.compress_batch_into(
            srcs_u, lens_u, dsts_z, out_lens, errs, threads), 5)[0]
        ut = _time_it(lambda: native.decompress_batch_into(
            srcs_z, lens_z, dsts_u, out_lens, errs, threads), 5)[0]
        res[f"host_compress_{tag}_gbps"] = round(total / zt / 1e9, 3)
        res[f"host_decompress_{tag}_gbps"] = round(total / ut / 1e9, 3)
        _log(f"host aggregate ({tag}): compress {total / zt / 1e9:.2f} GB/s, "
             f"decompress {total / ut / 1e9:.2f} GB/s ({n} blocks, "
             f"{total / 1e6:.0f} MB, ratio {ctotal / total:.3f})")
    res["host_scaling_x"] = round(
        res["host_decompress_all_gbps"] / res["host_decompress_1t_gbps"], 2)
    return {**res, **_host_canary()}


STAGE_FNS = {
    "canary": _stage_canary,
    "decode16": lambda cpu: _stage_decode(16, cpu),
    "decode": lambda cpu: _stage_decode(None, cpu),
    "crc": _stage_crc,
    "encode": _stage_encode,
    "sharded": _stage_sharded,
}


# ---------------------------------------------------------------------------
# The parent: each stage in a process of its own
# ---------------------------------------------------------------------------


def _run_stage(name: str, budget_s: float, cpu: bool) -> dict:
    """Run one stage in a killable process; returns its fields, or
    ``{"failures": [...]}`` when it fails or overruns its deadline."""
    _log(f"stage {name}: budget {budget_s:.0f}s")
    cmd = [sys.executable, "-m", "snappy_tpu_torch.bench", "--stage", name]
    proc = subprocess.Popen(
        cmd + (["--cpu"] if cpu else []),
        stdout=subprocess.PIPE, start_new_session=True, cwd=HERE,
    )
    try:
        out, _ = proc.communicate(timeout=budget_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        return {"failures": [f"stage {name} overran its {budget_s:.0f}s deadline and was killed"]}
    if proc.returncode != 0:
        return {"failures": [f"stage {name} exited with code {proc.returncode}"]}
    try:
        return json.loads(out.decode().strip().splitlines()[-1])
    except (IndexError, ValueError):
        return {"failures": [f"stage {name} printed no JSON"]}


def _merge(acc: dict, part: dict) -> None:
    for k, v in part.items():
        if k == "failures":
            acc.setdefault("failures", []).extend(v)
        else:
            acc[k] = v
    PARTIAL_PATH.parent.mkdir(parents=True, exist_ok=True)
    PARTIAL_PATH.write_text(json.dumps(acc, indent=1))


def headline(acc: dict) -> dict:
    """The result line: the device-stage rate of the production route
    (``decode_device_GBps``, the flat route's K2), with the end-to-end rates
    beside it; ``None`` where the decode stage gave none."""
    value = acc.get("decode_device_GBps")
    result = {
        "metric": "corpus_decompress_throughput_per_card",
        "value": value if isinstance(value, float) else None,
        "unit": "GB/s",
        "headline_path": acc.get("decode_device_route"),
        "headline_note": (
            "device-stage rate of the flat route (K2 on resident host-flattened "
            "indices); the host flatten's rate is decode_flat_host_GBps, and what a "
            "user sees end to end is decode_e2e_GBps (pipelined) and "
            "decode_e2e_serial_GBps"
        ),
    }
    result.update({k: v for k, v in acc.items() if k != "failures"})
    if acc.get("failures"):
        result["failures"] = acc["failures"]
    return result


def main(argv: list[str]) -> int:
    cpu = "--cpu" in argv
    try:
        _device(cpu)
    except RuntimeError as e:
        _log(str(e))
        return 1
    t_start = time.perf_counter()
    deadline = float(os.environ.get("BENCH_DEADLINE_S", "900"))

    def left() -> float:
        return deadline - (time.perf_counter() - t_start)

    acc: dict = {}
    for name in STAGES:
        if left() < 10:
            acc.setdefault("failures", []).append(f"stage {name} not run (deadline)")
            continue
        _merge(acc, _run_stage(name, min(BUDGETS_S[name], left()), cpu))
    result = headline(acc)
    PARTIAL_PATH.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 1 if result.get("failures") else 0


if __name__ == "__main__":
    args = sys.argv[1:]
    on_cpu = "--cpu" in args
    if "--stage" in args:
        fields = STAGE_FNS[args[args.index("--stage") + 1]](on_cpu)
        print(json.dumps(_unmeasured(fields) if on_cpu else fields), flush=True)
    elif "--host-table" in args:
        print(json.dumps(_host_table()), flush=True)
    elif "--host-aggregate" in args:
        print(json.dumps(_host_aggregate()), flush=True)
    elif "--sharded" in args:
        fields = _stage_sharded(on_cpu)
        print(json.dumps(_unmeasured(fields) if on_cpu else fields), flush=True)
    else:
        sys.exit(main(args))
