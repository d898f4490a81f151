"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA card, ``nvcc`` and the repository beside this file; exits
non-zero on any failure, and before printing any result when there is no
card. Phases:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. the kernels, built from ``snappy_tpu_torch/csrc``, each held against
   its plain PyTorch version on the card at the main path's shapes
   (equality: bytes, codes and CRCs are integers), and timed with CUDA
   events beside its bound;
3. the main paths' entry points: a 64 MiB + 5,000-byte frame stream of
   the ``data/`` corpus, decoded by ``snappy_tpu_torch.decompress_frame``
   and by ``read.FrameDecoder(engine="device").read()`` on the card; a
   raw stream the host flatten rejects, decoded by
   ``snappy_tpu_torch.decompress``; the same 64 MiB + 5,000 bytes
   compressed by ``snappy_tpu_torch.compress(profile="fast")`` (1,025
   blocks in one launch group of 2,048 rows), which must decode back
   exactly and whose first 64 blocks must equal the port's CPU run of
   them byte for byte; compressed by ``snappy_tpu_torch.compress`` (exact,
   the default), which must equal the host codec's stream, as the golden
   ``.rawsnappy`` must come out exactly; and written through
   ``write.FrameEncoder(engine="device")``, which must equal the host
   codec's frames. The kernels' launch counts are set to 0 just before
   each and read just after it; each path must have run its own kernels
   and no other (exact compress K7 only, the writer K1 and K7, the
   frame path and the reader K2 with its checksum over their launch groups,
   one launch a layout, and no K1). The same frame stream is decoded again
   by the two record-scan routes: under ``configure(decode_resolve=True)`` (K8, then
   K2 ``layout=1``, for every group the route takes; the tail group on
   the flat route) and under ``configure(decode_records=True)`` (K10 on
   every group, K3 only for a group whose records overflow the scan's
   cap), the reader under the latter; the route each launch group took
   is printed. It is decoded once more by each tensor route, with no
   kernel but K1: under ``configure(decode_kernels=False)`` (the host's
   op-start bitmaps) and under ``configure(pure_device=True)`` (op
   discovery on the card). The frame, fast, exact, writer, both
   record-scan, replay and both tensor route paths are then timed end
   to end, and again with ``trace.spans`` on for the breakdown of that
   same run;
   every corpus file compressed alone with the fast profile must be no
   larger than the host codec's stream; two corrupted frame streams must
   raise what the host engine raises, on every decode route;
4. the CLI: ``python -m snappy_tpu_torch.cli.szip --engine device`` in
   processes of its own compresses a corpus file (``-k``), decompresses it
   (``-d``) and round-trips it with ``--raw``; ``cmp`` holds each file to
   the original and to the host codec's;
5. the differential campaign's device legs on mutated streams
   (``python -m snappy_tpu_torch.tools.fuzz_campaign``, legs 3, 4, 5 and
   8-12 at ``CAMPAIGN_COUNTS``, each in a process of its own, all at once):
   no divergence and no fault, and each leg's launches show the kernels of
   its table (K2 with its checksum in leg 5, K2 in legs 8 and 10, K10 in leg 9, K4 and
   both entries of K6 in leg 11, K8 and K2 in leg 12), with the reason where
   K3 did not launch; one ``{"campaign": ...}`` line;
6. the benchmark, ``python -m snappy_tpu_torch.bench``, with a deadline of
   300 s: every stage passes (each checks every row) and reports the fields
   of ``BENCH_FIELDS``; one ``{"bench": ...}`` line;
7. the host-against-card tools (``TOOL_RUNS``), each a process with a
   deadline, all at once: ``tools.crossover_measure`` at 64 KiB, 1 MiB and
   16 MiB, ``tools.flatten_scale`` at one thread and every thread,
   ``tools.scaling_measure`` with one NCCL rank and two ranks (gloo, sharing
   ``cuda:0`` on a card of its own; ``shared_card`` and no efficiency) of 8
   blocks each. Each checks every call it times; each must pass, give every
   rate and launch its kernels; their output goes to
   ``chiprun_out/chip_smoke_<tool>.log``; one ``{"tools": ...}`` line.
8. the graft entry (``snappy_tpu_torch.graft_entry``, the port of
   ``__graft_entry__.py``), the counts set to 0 before each call and read
   after it: ``entry()``'s step on the card launches K1 and no other
   kernel, its rows equal the port's CPU run of ``entry(device="cpu")``
   byte for byte, and the stream identifier followed by its rows decodes
   through the host codec, CRCs verified, to each row's first ``len``
   bytes; ``dryrun_multichip`` over every card, and with four shards on
   ``cuda:0``, passes every leg and launches each leg's kernels once a
   mesh entry (K1 and K7 framing, K3 replay, K2 from the host flatten, K8
   and K2 resolving, K4 and K5 the flat encoder; the tensor decode
   launches none); one ``{"graft": ...}`` line of each call's seconds and
   launches by kernel.

K8 and K9 (chain resolution) and K10 (record replay) are held against
their plain versions on the frame's largest launch group (455 rows,
``d_pad`` 65536) as the host's record scan leaves it, and K9's path
(``decode_resolve_batch(use_fused=False)``) must give the host codec's
bytes there. K8's and K9's windowed models (``resolve.resolve_fh_windows``,
``resolve.resolve_windows``) must give their plain planes there, and
their rows carry the doubling rounds of each window (mean and most).

K3 (replay) is held against its plain version on the small and corrupt
vectors, 64 corpus chunks, the frame's largest launch group (455 rows,
also against the host codec's bytes) and the raw row the flatten
rejects; its windowed model (``replay.replay_windows``) must give the
kernel's rows and codes on 16 rows of the group. Its ``ms`` (the raw
row), ``group_ms`` and ``corpus_64_rows_device_ms`` are device-only
through its C entry (its wrapper reads lengths back), beside the times
over wrapper calls. The frame stream is also decoded under
``configure(decode_flat=False)`` (the ``frame_replay`` path): K3 and K1
once a group and nothing else.

K11 (the grouped flat gather, the JAX package's v3/v4 entry, which no
library path calls) is held on the same 455-row group, with the host
flatten's indices as K2 gets them and ``group_buckets``' buckets, against
its plain version, K2's bytes and the host codec's; and against its plain
version on hand-made buckets and on a batch of 2 KiB rows. Its own entry
path decodes every launch group of whole 16 KiB groups through v3 and v4,
as the JAX package's tools call it. K2 (both layouts) and K11 are also
held on a wide raw stream (a body past 64 KiB, ``d_pad`` up to 1 MiB,
16 KiB output units that read source bytes 60 KiB apart) and on rows of
the 81,920-byte width beside a row of declen 0. K2's and K11's rows
carry two times for the kernel and for ``torch.gather``: ``ms`` and
``library_ms`` with the host out of the window (50 calls captured in a
CUDA graph, its replay timed), ``call_ms`` and ``library_call_ms`` over 50
calls back to back, the host's cost per call included.

K7, the exact encoder, is held against its plain version (a Python loop
of small launches per automaton step) on 8 corpus blocks and timed on the
compress path's launch group; the plain version also counts every
block's automaton steps there, K7's serial bound, and the host's copy of
K7's walk (``encode.find_ops_rounds``) counts the scan rounds and
extension quanta K7 takes on the busiest block and the 8 blocks. K10's
row carries the rounds of pointer doubling its group takes, window by
window as its CTA path takes them (``records.window_rounds``). K7's and
K10's ``ms`` is device-only, their C entries' calls captured in a CUDA
graph as K2's are (their wrappers read lengths back to check them, which
a graph cannot hold), and ``call_ms`` over wrapper calls; K4's and K8's
``ms`` likewise device-only, their wrappers' calls in a graph, beside
``call_ms``. K4's row carries the compress group's longest walk a block
(mean and most over the live blocks, ``parse.parse_lockstep``'s step
counts).

K5's and both K6 halves' ``ms`` are device-only (their wrappers' calls in
a CUDA graph) beside ``call_ms`` over calls, and ``emit_bytes``' yardstick
``torch.gather`` likewise (``library_ms``, ``library_call_ms``); K6's
gather is also held against its plain version on edge rows (lengths 0, 1,
15, 16, 17, 1,023, 1,025 and 81,920, indices -1, ``src_w`` and ``src_w -
1``, batches of one row and of 2,049).

K1 is held and timed at 512 rows of 65,536 random bytes with random
lengths and on the frame's largest launch group (455 decoded rows with the
chunks' lengths, as the flat route checks them; its CRCs also against the
host codec's): ``ms`` and ``group_ms`` device-only (50 wrapper calls in a
CUDA graph), ``call_ms`` and ``group_call_ms`` over calls, and the
wrapper's host time a call on the host's clock. K2 with the frame
checksum (``flat_gather_crc``, the frame path's one kernel) is held on
the 455-row group against K2's bytes, K1's CRCs and the host codec's, and
timed as K2 is, beside K2 then K1 on the same group (``pair_ms``); its
bound counts K2's bytes. K2 over several launch groups in one launch
(``decode_flat_groups``, ``flat_groups_row``) runs the 16 MiB frame
read's five groups (each corpus file framed whole, as the frame cell's
calls): each group's bytes and CRCs against the plain versions and the
five one-group launches, one launch counting five groups and no K1, and
its time device-only beside the five launches', with and without the
checksum, which must not beat its bytes' bound. K5's ``ms`` is device-only too (its wrapper's calls in a graph), beside ``call_ms``, and
its walk followed in numpy (``emit.fused_emit_walk``) must give the plain
version's indices on the compress group's first 16 rows.

The port's ``parallel/`` and ``utils/`` run on the card too. The sharded
entries (``parallel.sharded``) run on meshes ``[cuda:0]`` and ``[cuda:0,
cuda:0]``: exact compress (K7) and flat compress (K4, K5) of the stream's
blocks, which must assemble the unsharded calls' streams; the frame
chunks' bodies decoded from the host flatten (K2), by replay (K3) and by
chain resolution (K8, K2), each row the host codec's; the blocks framed
as chunks (K1, K7), which must be the host codec's frames. The inputs
come from host memory; each entry runs its shards at once, one thread a
mesh entry, and returns ``Sharded`` outputs, each shard on its entry's
device. Each path launches exactly its kernels, once a mesh entry (counts
set to 0 before it, read after), a mesh of two gives the one-device mesh's
rows, and every card is synchronized before each clock read. Each path is
timed again with its inputs placed on the mesh beforehand, and on each
mesh one warm call of each (from host memory and from placed inputs) runs
under ``utils.profiling.device_trace``: on the mesh of two its copies on
the card and its concatenation kernels must be twice the one-device
mesh's (each shard's own), so nothing joins the shards. One
``{"sharded": ...}`` line prints each path's warm seconds both ways, its
shards' devices and its traces' copies, concatenations and cross-card
kernel overlap. ``multihost``
then joins a world of one rank from the environment (``MASTER_ADDR``,
``RANK=0``, ``WORLD_SIZE=1``), where ``initialize`` must choose NCCL:
``compress_segments`` on the 1,024 whole blocks (K7) gives rows whose
stream, each at its offset, is the host codec's, and ``decode_segments``
the frame chunks' rows (the hosted tensor decode, no kernel); the group
is destroyed after. Two worker processes (``python -c``, the port alone,
gloo, both on ``cuda:0``) each compress 512 of the blocks with K7 and
write their rows at their offsets into one file, which must be the host
codec's stream. One warm ``decompress_frame`` runs under
``utils.profiling.device_trace`` (written to ``chiprun_out/trace/``): the
trace must hold device events of K2 and K1, and the run prints the device
busy share of the traced window, the 10 longest device operations and the
5 longest gaps between them with the host ops and the API's labelled
spans in each. Whether ``ncu`` is on the path, and its ``--version``, go
to the report.

The port's examples run on the card under ``SNAPPY_TPU_ENGINE=device``,
each ``main()`` in this process with the counts set to 0 before it:
``compress`` of the stream (the device writer, K1 and K7) gives the host
codec's frame, ``decompress`` of that frame (K2 on each chunk) gives the
stream back, and ``compress_escaped`` prints the lines of its run on the
host engine; then ``compress`` piped into ``decompress``, each a process of
its own, round-trips a corpus file through the host codec's frame. The GPU
pipeline (``examples.gpu_pipeline.run``) runs at 512 KiB shards on one
card (K2 once a shard) and on four CPU entries, whose rows must be equal
and losses and table within rtol 1e-5; then at two shards of 32 MiB on
``make_mesh()``, printing each step's host seconds (walk, flatten), decode
and step seconds, loss and each card's peak device bytes, with each card's
shard of the rows on that card when the step runs.

It prints one ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# H100 SXM integer rate outside the tensor cores: 64 INT32 lanes per SM per
# clock (half the 128 float32 lanes behind its 67 TFLOP/s), 132 SMs, 1.98 GHz.
PEAK_INT32_OPS_PER_S = 64 * 132 * 1.98e9
# Integer operations in one step of a segment walk, counted in the loop body
# of csrc/parse.cu: the jump-word read, two four-byte reads, the compare,
# the record store and the state updates.
PARSE_OPS_PER_STEP = 50
CORPUS = [
    "html", "urls.10K", "fireworks.jpeg", "paper-100k.pdf", "html_x_4",
    "alice29.txt", "asyoulik.txt", "lcet10.txt", "plrabn12.txt",
    "geo.protodata", "kppkn.gtb",
]
STREAM_BYTES = (64 << 20) + 5000



def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds per call over ``reps`` warm calls (CUDA events)."""
    from snappy_tpu_torch.utils.profiling import event_ms

    return event_ms(fn, reps, warm)[0]


def device_ms(fn, reps: int) -> float:
    """Mean milliseconds per call with the host out of the window: ``reps``
    calls captured once in a CUDA graph, whose replay is timed with CUDA
    events."""
    from snappy_tpu_torch.utils.profiling import graph_ms

    return graph_ms(fn, reps)[0]


def bound_ms(nbytes: int, int_ops: int = 0) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = int_ops / PEAK_INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gather_sectors(src: torch.Tensor, idx: torch.Tensor, out_len: torch.Tensor) -> int:
    """Distinct 32-byte sectors of ``src`` that K6's gather reads: one per
    sector that some output byte below ``out_len`` takes a byte from. Device
    memory moves sectors, so this is the gather's least read traffic over
    32, where the byte bound counts one byte an output byte."""
    d = torch.arange(idx.shape[1], device=idx.device)[None, :]
    ok = (d < out_len[:, None]) & (idx >= 0) & (idx < src.shape[1])
    rows = torch.arange(idx.shape[0], device=idx.device, dtype=torch.int64)[:, None]
    per_row = (src.shape[1] + 31) // 32
    keys = (rows * per_row + (idx.to(torch.int64) >> 5))[ok]
    return int(torch.unique(keys).numel())


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def corpus_stream(nbytes: int) -> bytes:
    parts, total = [], 0
    while total < nbytes:
        for name in CORPUS:
            with open(os.path.join(HERE, "data", name), "rb") as f:
                blob = f.read()
            parts.append(blob)
            total += len(blob)
    return b"".join(parts)[:nbytes]


def compressed_chunks(frame: bytes):
    """``(body without varint, declen, chunk offset)`` of every compressed
    frame chunk."""
    from snappy_tpu_torch.format.varint import read_varu64

    out, pos = [], 0
    while pos < len(frame):
        ty = frame[pos]
        ln = int.from_bytes(frame[pos + 1 : pos + 4], "little")
        payload = frame[pos + 4 : pos + 4 + ln]
        if ty == 0x00:
            declen, h = read_varu64(payload[4:])
            out.append((payload[4 + h :], declen, pos))
        pos += 4 + ln
    return out


def whole_files_frame(nbytes: int = 16 << 20) -> tuple[bytes, bytes]:
    """``(data, stream)``: the frame cell's corpus files
    (``benchmark/configs/snappy-testdata-frame.json``, in its order) in
    turn, each framed whole by the host codec, until ``nbytes`` of data; the
    frame read's calls as the frame cell makes them. At 16 MiB its
    compressed chunks fall into five launch groups (6, 6, 54, 91 and 108
    rows), each under one wave of K2."""
    from snappy_tpu_torch import native

    bench = os.path.join(HERE, "benchmark")
    with open(os.path.join(bench, "configs", "snappy-testdata-frame.json")) as f:
        names = json.load(f)["corpus"]
    files = []
    for name in names:
        with open(os.path.join(bench, "corpus", name), "rb") as f:
            files.append(f.read())
    parts, total = [], 0
    while total < nbytes:
        parts.append(files[len(parts) % len(files)])
        total += len(parts[-1])
    return b"".join(parts), b"".join(native.frame_compress(p) for p in parts)


def flat_groups_row(dev, ptxas: list[str]) -> dict:
    """K2 with the checksum over the 16 MiB frame read's five launch groups
    (:func:`whole_files_frame`, the frame cell's shape; each group under one
    wave) in one launch (``decode_flat_groups``), against the five one-group
    launches of ``decode_flat_crc``: each group's bytes and CRCs against the
    plain versions and the five launches'; the launches, the checksum
    launches and the groups one call counts; ``ms`` and ``separate_ms``
    device-only (50 calls in a CUDA graph), with the output's GB/s over
    each, and the same for K2 alone; the ``flat_gather`` lines of
    ``ptxas``."""
    from snappy_tpu_torch.ops import api, crc32c, decode_flat, packing, reset_launch_counts

    _, stream = whole_files_frame()
    chunks = compressed_chunks(stream)
    bodies = [c[0] for c in chunks]
    groups, shape, nbytes = [], [], 0
    for g in api.launch_groups(bodies, 512):
        gd = [chunks[i][1] for i in g]
        width = api._width_bucket(len(bodies[g[0]]))
        srcs, lens = packing.batch_streams([bodies[i] for i in g], width)
        d_pad = packing.pad_to_bucket(max(gd), 1024)
        idx, tmeta, fallb, herrs, _ = native_flatten(srcs, lens, gd, d_pad)
        check(not fallb.any() and not herrs.any(), "the flatten rejected a row")
        groups.append((*(torch.from_numpy(x).to(dev) for x in (
            srcs, idx.view(np.int16), tmeta, np.asarray(gd, np.int32))), d_pad, 1))
        shape.append([len(g), width, d_pad])
        # K2's bound (the kernel table's): index and source bytes, tile data, output
        nbytes += (2 * sum(gd) + int(lens.sum()) + 8 * sum(-(-n // 1024) for n in gd)
                   + 4 * len(g) + len(g) * d_pad)
    check(len(groups) == 5, f"the 16 MiB read's groups: {shape}")
    out_bytes = sum(chunks[i][1] for i in range(len(chunks)))
    reset_launch_counts()
    got = decode_flat.decode_flat_groups(groups, True)
    torch.cuda.synchronize()
    counts = {"launches": decode_flat.launches, "crc_launches": decode_flat.crc_launches,
              "launched_groups": decode_flat.launched_groups, "crc32c": crc32c.launches}
    sep = [decode_flat.decode_flat_crc(*g) for g in groups]
    equal, err = True, 0
    for (out, crc), (s_out, s_crc), g in zip(got, sep, groups):
        want = decode_flat.decode_flat_plain(*g)
        want_crc = crc32c.crc32c_plain(want, g[3], masked=True)
        equal &= (torch.equal(out, want) and torch.equal(out, s_out) and torch.equal(crc, s_crc)
                  and torch.equal(crc, want_crc))
        err = max(err, max_abs_err(out, want), max_abs_err(crc, want_crc))
    bnd, by = bound_ms(nbytes)
    one = lambda: decode_flat.decode_flat_groups(groups, True)  # noqa: E731
    five = lambda: [decode_flat.decode_flat_crc(*g) for g in groups]  # noqa: E731
    one_k2 = lambda: decode_flat.decode_flat_groups(groups)  # noqa: E731
    five_k2 = lambda: [decode_flat.decode_flat(*g) for g in groups]  # noqa: E731
    row = {
        "name": "flat_gather_groups", "route": "cuda",
        "source": "snappy_tpu_torch/csrc/flat_gather.cu stpu_cuda_flat_gather_groups",
        "replaces": "snappy_tpu/ops/pallas/decode.py:1334 decode_flat_pallas_v2 on each launch "
                    "group, then snappy_tpu/ops/pallas/crc32c.py:64 crc32c_blocks_pallas",
        "shape": shape, "equal": bool(equal), "max_abs_err": err, "counts": counts,
        "ms": device_ms(one, 50), "separate_ms": device_ms(five, 50),
        "k2_ms": device_ms(one_k2, 50), "k2_separate_ms": device_ms(five_k2, 50),
        "out_bytes": out_bytes, "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "ptxas": [ln for ln in ptxas if "flat_gather" in ln],
    }
    for k in ("ms", "separate_ms", "k2_ms", "k2_separate_ms"):
        row[k.replace("ms", "GBps")] = out_bytes / (row[k] * 1e6)
    return row


def native_flatten(srcs, lens, declens, d_pad: int, layout: int = 1):
    """The host flatten of a launch group (``native.flatten_idx_batch``)."""
    from snappy_tpu_torch import native

    return native.flatten_idx_batch(srcs, np.asarray(lens, np.uint64),
                                    np.asarray(declens, np.uint64), d_pad, layout=layout)


def literal(b: bytes) -> bytes:
    """A literal op of 61..65536 bytes."""
    n = len(b) - 1
    return (bytes([60 << 2, n]) if n < 256 else bytes([61 << 2, n & 255, n >> 8])) + b


def wide_stream(n_blocks: int) -> tuple[bytes, int]:
    """A raw body of ``n_blocks`` 64 KiB blocks of output whose 16 KiB
    units read source bytes 60 KiB apart: per block, a literal of 60 KiB of
    random bytes, 32 copies of 64 bytes that reach back 60 KiB, and a
    literal of 2 KiB. ``(body, declen)``."""
    rng = np.random.default_rng(5)
    body = b""
    for _ in range(n_blocks):
        body += literal(rng.integers(0, 256, 61440, dtype=np.uint8).tobytes())
        body += bytes([(63 << 2) | 2, 0x00, 0xF0]) * 32
        body += literal(rng.integers(0, 256, 2048, dtype=np.uint8).tobytes())
    return body, n_blocks * 65536


def flatten_rejected_stream() -> tuple[bytes, bytes]:
    """A raw stream whose 1024-byte output tile at 64 KiB reads both the
    first literal (via a 65535-offset copy) and a fresh literal ~66 KiB
    later: a source spread wider than the flatten's widest window."""
    from snappy_tpu_torch.format import reference as ref
    from snappy_tpu_torch.format.varint import write_varu64

    rng = np.random.default_rng(11)
    lits = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (1024, 64512, 64)]

    body = literal(lits[0]) + literal(lits[1]) + bytes([(63 << 2) | 2, 0xFF, 0xFF])
    body += literal(lits[2])
    raw = write_varu64(1024 + 64512 + 64 + 64) + body
    return raw, ref.decompress(raw)


def small_replay_rows():
    """Corrupt vectors, RLE and overlap-straddling copies (bodies, declens)."""
    from snappy_tpu_torch.format import reference as ref
    from snappy_tpu_torch.format.varint import read_varu64

    rows = [
        (b"\x00a\x1d\x01", 5), (b"\x00a\x3f\x00", 17), (b"\x00a\x01\x00", 17),
        (b"\x00a\x01\xFF", 17), (b"\x61", 3), (b"\xff\xff\xff\xff", 4),
        (b"\xf0" + b"a" * 10, 4), (b"\x00a", 4),
    ]
    rng = np.random.default_rng(31)
    for data in (b"a" * 5000, b"ab" * 3000, rng.integers(0, 4, 7000, dtype=np.uint8).tobytes()):
        c = ref.compress(data)
        _, h = read_varu64(c)
        rows.append((c[h:], len(data)))
    for off in (1, 3, 127, 128, 129, 255):
        seed = rng.integers(0, 256, off, np.uint8).tobytes()
        body = (bytes([(off - 1) << 2]) if off <= 60 else bytes([60 << 2, off - 1])) + seed
        body += bytes([(63 << 2) | 2, off & 0xFF, off >> 8]) * 20
        rows.append((body, off + 64 * 20))
    return rows


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sync_cards() -> None:
    """Wait for every card: a sharded path's shards run on several."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def warm_runs(fn, reps: int = 3) -> list[float]:
    """Seconds of ``reps`` calls of ``fn``, each ending in a synchronize of
    every card."""
    out = []
    for _ in range(reps):
        sync_cards()
        t0 = time.perf_counter()
        fn()
        sync_cards()
        out.append(time.perf_counter() - t0)
    return out


def host(x) -> np.ndarray:
    """``x`` in host memory: a ``Sharded`` shard by shard, a tensor, or numpy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return x.numpy() if hasattr(x, "shards") else np.asarray(x)


def assemble(rows, lens, n: int) -> bytes:
    """The first ``n`` rows' prefixes of their lengths, concatenated."""
    rows, lens = host(rows)[:n], host(lens)[:n]
    return b"".join(rows[i, : lens[i]].tobytes() for i in range(n))


def rows_equal(dst, want: list[bytes]) -> bool:
    """Each of the first ``len(want)`` rows of ``dst`` starts with its bytes."""
    d = host(dst)[: len(want)]
    return all(d[i, : len(w)].tobytes() == w for i, w in enumerate(want))


def union(events: list[dict]) -> list[list[float]]:
    """The spans ``events`` cover, overlapping ones merged, in time order."""
    merged = []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_us(events: list[dict]) -> float:
    """Microseconds covered by ``events`` (overlaps counted once)."""
    return sum(b - a for a, b in union(events))


def counted_run(by_path: dict, path: str, fn, want: dict):
    """``fn()`` with every launch count set to 0 just before it and kept in
    ``by_path[path]`` just after; fails unless it launched exactly the
    kernels and counts of ``want``. Returns its result and seconds."""
    from snappy_tpu_torch.ops import launch_counts as counts, reset_launch_counts as reset_counts

    reset_counts()
    sync_cards()
    t0 = time.perf_counter()
    result = fn()
    sync_cards()
    seconds = time.perf_counter() - t0
    by_path[path] = counts()
    launched = {k: v for k, v in by_path[path].items() if v}
    check(launched == want, f"the {path} path launched {launched}, not {want}")
    return result, seconds


def trace_sharded(fn, out_dir: str) -> dict:
    """One call of ``fn`` (a sharded path) under ``utils.profiling.device_trace``:
    its copies by kind, its copies from device memory to device memory on
    one card (``DtoD``) and from card to card (``PtoP``), its concatenation
    kernels (``torch.cat``'s ``CatArrayBatchedCopy``, how the entries once
    joined their shards on the first card), the kernels and kernel time on
    each card, and the time during which kernels run on two or more cards at
    once. The trace file is removed after it is read."""
    import glob

    from snappy_tpu_torch.utils.profiling import (
        cross_device_overlap_us, device_events, device_to_device_copies, device_trace,
    )

    subprocess.run(["rm", "-rf", out_dir], check=True)
    with device_trace(out_dir):
        fn()
    (path,) = glob.glob(os.path.join(out_dir, "trace.*.json"))
    events = device_events(path)
    subprocess.run(["rm", "-rf", out_dir], check=True)
    kernels = [e for e in events if e["cat"] == "kernel"]
    copies = {}
    for e in events:
        if e["cat"] == "gpu_memcpy":
            copies[e["name"]] = copies.get(e["name"], 0) + 1
    cards = sorted({e["device"] for e in kernels})
    lo = min((e["ts"] for e in events), default=0.0)
    hi = max((e["ts"] + e["dur"] for e in events), default=0.0)
    moves = [e["name"] for e in device_to_device_copies(events)]
    return {
        "dtod": sum("DtoD" in n for n in moves), "ptop": sum("PtoP" in n for n in moves),
        "cat_kernels": sum("CatArrayBatchedCopy" in e["name"] for e in kernels), "copies": copies,
        "kernels_by_card": {c: sum(e["device"] == c for e in kernels) for c in cards},
        "kernel_busy_us_by_card": {c: busy_us([e for e in kernels if e["device"] == c]) for c in cards},
        "kernel_overlap_us": cross_device_overlap_us(events), "device_window_us": hi - lo,
    }


def sharded_paths(meshes, data, cblocks, clens, dec, want_rows, expect, run_counted,
                  trace_dir=None):
    """The sharded entries on each mesh of ``meshes`` (lists of devices, the
    first of one device), their inputs in host memory: exact and flat
    compress of the stream's blocks, the frame chunks' bodies decoded by the
    flat gather from the host flatten, by the replay kernel and by chain
    resolution, and the blocks framed as chunks. Each path's outputs are
    ``Sharded`` with shard ``i`` on the mesh's device ``i``; each equals the
    unsharded port call's (``expect``: the exact and fast streams and the
    frame), each decode the host codec's rows, and a wider mesh gives the
    first mesh's rows. ``run_counted(path, fn, kernels)`` runs a path with
    the counts reset and checks its launches: each kernel once a mesh entry.
    Warm seconds are taken from host memory (``warm_s``) and with the inputs
    placed on the mesh beforehand as ``Sharded``, as a chain of entries
    leaves them (``resident_warm_s``; the flat path then runs the gather
    alone, on the host flatten's indices). With ``trace_dir`` given, one
    warm call of each path from host memory and one from placed inputs are
    traced on every mesh (:func:`trace_sharded`): on a wider mesh no copy
    may go from card to card, and the copies on a card and the
    concatenation kernels must be the one-device mesh's times the mesh's
    size, those each shard's own function makes: nothing joins the shards.
    Returns each path's times and trace readings."""
    from snappy_tpu_torch import native
    from snappy_tpu_torch.format.varint import write_varu64
    from snappy_tpu_torch.parallel import make_mesh, map_shards, sharded

    srcs, src_lens, declens, recs, nops = dec
    n_blocks, n_rows = len(clens), len(declens)
    out_bytes = int(np.asarray(declens, np.int64).sum())
    times, firsts = {}, {}
    for devices in meshes:
        mesh = make_mesh(devices)
        m = mesh.size

        def padded(x):
            return sharded.pad_batch(np.asarray(x), np.zeros(len(x), np.int32), m)[0]

        on_host = {"blocks": padded(cblocks), "lens": padded(clens)}
        on_host.update(zip(("srcs", "recs", "s_lens", "d_lens", "nops"),
                           map(padded, (srcs, recs, src_lens, declens, nops))))
        idx, tmeta, fallb, errs, _ = native.flatten_idx_batch(
            on_host["srcs"], on_host["s_lens"].astype(np.uint64),
            on_host["d_lens"].astype(np.uint64), 65536, layout=1)
        on_host.update(idx=idx.view(np.int16), tmeta=tmeta)

        def flat(a):
            if a is on_host:
                return sharded.sharded_decode_flat_host(mesh, a["srcs"], a["s_lens"], a["d_lens"], 65536)
            return sharded.sharded_decode_streams_flat(
                mesh, a["srcs"], a["idx"], a["tmeta"], a["d_lens"], 65536), errs, fallb

        paths = {
            "compress": (
                lambda a: sharded.sharded_compress_blocks(mesh, a["blocks"], a["lens"]),
                {"encode": m}, len(data),
                lambda r: write_varu64(len(data)) + assemble(*r, n_blocks) == expect["exact"]),
            "compress_flat": (
                lambda a: sharded.sharded_compress_blocks_flat(mesh, a["blocks"], a["lens"]),
                {"parse": m, "fused_emit": m}, len(data),
                lambda r: not host(r[2])[:n_blocks].any()
                and write_varu64(len(data)) + assemble(r[0], r[1], n_blocks) == expect["fast"]),
            "frame_chunks": (
                lambda a: sharded.sharded_encode_frame_chunks(mesh, a["blocks"], a["lens"]),
                {"crc32c": m, "encode": m}, len(data),
                lambda r: b"\xff\x06\x00\x00sNaPpY" + assemble(*r, n_blocks) == expect["frame"]),
            "decode_flat_host": (
                flat, {"flat_gather[layout=1]": m}, out_bytes,
                lambda r: not r[1][:n_rows].any() and not r[2][:n_rows].any()
                and rows_equal(r[0], want_rows)),
            "decode_replay": (
                lambda a: sharded.sharded_decode_streams_replay(
                    mesh, a["srcs"], a["s_lens"], a["d_lens"], 65536),
                {"replay": m}, out_bytes,
                lambda r: not host(r[1])[:n_rows].any() and rows_equal(r[0], want_rows)),
            "decode_resolve": (
                lambda a: sharded.sharded_decode_resolve(
                    mesh, a["srcs"], a["recs"], a["nops"], a["d_lens"], 65536),
                {"resolve_fh": m, "flat_gather[layout=1]": m}, out_bytes,
                lambda r: not host(r[1])[:n_rows].any() and rows_equal(r[0], want_rows)),
        }
        for name, (fn, kernels, nbytes, ok) in paths.items():
            path = f"sharded_{name}[{m}]"
            result, cold = run_counted(path, lambda: fn(on_host), kernels)
            placed = [[str(t.device) for t in x.shards] for x in result if hasattr(x, "shards")]
            check(placed and all(p == [str(d) for d in mesh.devices] for p in placed),
                  f"the {path} path's shards lie on {placed}, not on {mesh.devices}")
            check(ok(result), f"the {path} path's output differs from the unsharded call's")
            rows = host(result[0])
            if name not in firsts:
                firsts[name] = rows
            else:  # a wider mesh gives the first mesh's rows, byte for byte
                k = min(len(rows), len(firsts[name]))
                check(np.array_equal(rows[:k], firsts[name][:k]),
                      f"the {path} path's rows differ from the one-device mesh's")
            del result, rows
            warm = warm_runs(lambda: fn(on_host))
            times[path] = {"cold_s": cold, "warm_s": warm,
                           "warm_GBps": [nbytes / t / 1e9 for t in warm], "bytes": nbytes,
                           "shards_on": placed[0]}
        # The same paths with their inputs placed on the mesh beforehand.
        resident = {k: map_shards(mesh, lambda t: t, v) for k, v in on_host.items()}
        for name, (fn, _, nbytes, ok) in paths.items():
            path = f"sharded_{name}[{m}]"
            check(ok(fn(resident)), f"the {path} path from placed inputs differs")
            warm = warm_runs(lambda: fn(resident))
            times[path].update(resident_warm_s=warm,
                               resident_warm_GBps=[nbytes / t / 1e9 for t in warm])
            if trace_dir:
                traced = {src: trace_sharded(lambda: fn(a), os.path.join(trace_dir, f"{name}_{m}"))
                          for src, a in (("host", on_host), ("resident", resident))}
                times[path]["trace"] = traced
                one = times[f"sharded_{name}[1]"]["trace"]
                check(all(t["ptop"] == 0 and t[k] == m * one[src][k]
                          for src, t in traced.items() for k in ("dtod", "cat_kernels")),
                      f"the {path} path moved rows between its shards: {traced}, one device: {one}")
        del resident
    return times


def sharded_summary(times: dict) -> dict:
    """Each sharded path's warm seconds from host memory and from placed
    inputs, its shards' devices, and its traces' device-to-device copies and
    cross-card kernel overlap (microseconds)."""
    out = {}
    for path, t in times.items():
        out[path] = {"warm_s": t["warm_s"], "resident_warm_s": t["resident_warm_s"],
                     "shards_on": t["shards_on"]}
        for src, tr in t.get("trace", {}).items():
            out[path][f"{src}_trace"] = {
                k: tr[k] for k in ("dtod", "ptop", "cat_kernels", "kernel_overlap_us",
                                   "kernel_busy_us_by_card", "device_window_us")}
    return out


def nccl_world_of_one(dev, cblocks, clens, host_64mib, dec, want_rows, run_counted):
    """``multihost`` in a world of one rank on the card: ``initialize`` from
    the environment must choose NCCL; ``compress_segments`` on the 1,024
    whole blocks gives offsets whose stream is the host codec's, and
    ``decode_segments`` on the frame chunks' bodies the host codec's rows.
    The process group is destroyed and the environment restored after."""
    import torch.distributed as dist

    from snappy_tpu_torch.format.varint import write_varu64
    from snappy_tpu_torch.parallel import multihost

    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()), "RANK": "0",
           "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    out = {}
    try:
        t0 = time.perf_counter()
        multihost.initialize()
        out["init_s"] = time.perf_counter() - t0
        out["backend"] = dist.get_backend()
        check(out["backend"] == "nccl", f"multihost.initialize chose {out['backend']} on the card")
        mesh = multihost.global_mesh()
        check(mesh.devices == (dev,) and (mesh.rank, mesh.world_size) == (0, 1),
              f"the global mesh of a world of one: {mesh}")
        seg, out["compress_segments_s"] = run_counted(
            "nccl_compress_segments",
            lambda: multihost.compress_segments(mesh, cblocks[:1024], clens[:1024]), {"encode": 1})
        stream = bytearray(seg.total)
        for i in range(len(seg.row_lens)):
            o = int(seg.offsets[i])
            stream[o : o + int(seg.row_lens[i])] = seg.rows[i, : seg.row_lens[i]].tobytes()
        check(write_varu64(int(clens[:1024].sum())) + bytes(stream) == host_64mib,
              "compress_segments' rows at their offsets differ from the host codec's stream")
        srcs, src_lens, declens = dec[:3]
        (dst, errs), out["decode_segments_s"] = run_counted(
            "nccl_decode_segments",
            lambda: multihost.decode_segments(mesh, srcs, src_lens, declens, d_pad=65536), {})
        check(not errs.any() and all(dst[i, : len(w)].tobytes() == w for i, w in enumerate(want_rows)),
              "decode_segments differs from the host codec's rows")
        out["blocks"], out["decoded_rows"] = len(clens[:1024]), len(want_rows)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


RANK_WORKER = """
import json, os, sys, time
t0 = time.perf_counter()
import numpy as np, torch
import torch.distributed as dist
from snappy_tpu_torch.ops import crc32c, decode_flat, emit, encode, packing, parse, records, replay, resolve
from snappy_tpu_torch.parallel import multihost
multihost.initialize(backend="gloo")   # two ranks share one card: NCCL refuses that
mesh = multihost.global_mesh()
work = sys.argv[1]
per_rank = int(sys.argv[2])
with open(os.path.join(work, "data.bin"), "rb") as f:
    blocks, lens = packing.blocks_of(f.read())
mine = slice(mesh.rank * per_rank, (mesh.rank + 1) * per_rank)
t1 = time.perf_counter()
seg = multihost.compress_segments(mesh, blocks[mine], lens[mine])
t2 = time.perf_counter()
with open(os.path.join(work, "stream.bin"), "r+b") as f:   # this rank's rows at its offsets
    for i in range(per_rank):
        f.seek(int(seg.offsets[i]))
        f.write(seg.rows[i, : seg.row_lens[i]].tobytes())
other = (crc32c.launches + replay.launches + sum(decode_flat.layout_launches)
         + sum(decode_flat.grouped_launches.values()) + parse.launches + records.launches
         + sum(emit.entry_launches.values()) + sum(resolve.launches.values()))
print(json.dumps({"rank": mesh.rank, "device": str(mesh.devices[0]), "backend": dist.get_backend(),
                  "encode_launches": encode.launches, "other_launches": other, "total": seg.total,
                  "start_s": t1 - t0, "compress_segments_s": t2 - t1}))
dist.destroy_process_group()
"""


def two_ranks_on_one_card(dev, data: bytes, host_stream: bytes, per_rank: int):
    """Two worker processes (``python -c``, the port alone), gloo, both on
    ``dev``: each compresses ``per_rank`` blocks with K7 and writes its
    rows at its offsets into one file, which must be the host codec's
    stream of ``2 * per_rank`` blocks. Returns the phase's record (each
    worker's launch counts among it)."""
    from snappy_tpu_torch.format.varint import write_varu64

    work = os.path.join(HERE, "build", "chip_smoke_ranks")
    subprocess.run(["rm", "-rf", work], check=True)
    os.makedirs(work)
    n = 2 * per_rank * 65536
    with open(os.path.join(work, "data.bin"), "wb") as f:
        f.write(data[:n])
    with open(os.path.join(work, "stream.bin"), "wb") as f:
        f.truncate(2 * n)
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_WORKER, work, str(per_rank)],
        env={**os.environ, "PYTHONPATH": HERE, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
             "WORLD_SIZE": "2", "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    seconds = time.perf_counter() - t0
    for p, (o, e) in zip(procs, outs):
        check(p.returncode == 0, f"a rank worker failed: {e[-3000:]}")
    ranks = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    check(all(r["device"] == str(dev) and r["backend"] == "gloo" and r["encode_launches"] == 1
              and r["other_launches"] == 0 for r in ranks),
          f"the rank workers' devices, backend or launches: {ranks}")
    total = ranks[0]["total"]
    with open(os.path.join(work, "stream.bin"), "rb") as f:
        stream = f.read(total)
    check(write_varu64(n) + stream == host_stream,
          "the two ranks' rows at their offsets differ from the host codec's stream")
    subprocess.run(["rm", "-rf", work], check=True)
    return {"blocks_per_rank": per_rank, "seconds": seconds, "ranks": ranks}


def run_example(name: str, argv=(), stdin: bytes = b"", engine: str | None = None) -> bytes:
    """``snappy_tpu_torch.examples.<name>``'s ``main()`` in this process, under
    ``SNAPPY_TPU_ENGINE=engine`` (unset when None: the examples then take
    the card), with ``stdin`` as its standard input and ``argv`` as its
    arguments; returns its standard output."""
    import importlib

    mod = importlib.import_module(f"snappy_tpu_torch.examples.{name}")
    saved = sys.stdin, sys.stdout, sys.argv, os.environ.get("SNAPPY_TPU_ENGINE")
    out = io.BytesIO()
    sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
    sys.stdout = io.TextIOWrapper(out, write_through=True)
    sys.argv = [name, *argv]
    os.environ.pop("SNAPPY_TPU_ENGINE", None)
    if engine is not None:
        os.environ["SNAPPY_TPU_ENGINE"] = engine
    try:
        mod.main()
        sys.stdout.flush()
        return out.getvalue()
    finally:
        sys.stdin, sys.stdout, sys.argv = saved[:3]
        if saved[3] is None:
            os.environ.pop("SNAPPY_TPU_ENGINE", None)
        else:
            os.environ["SNAPPY_TPU_ENGINE"] = saved[3]


def examples_on_the_card(data: bytes, frame: bytes, declens: list[int], run_counted) -> dict:
    """The examples as a user runs them, naming no engine (so on the card):
    ``compress`` of the stream (the device writer: K1 and K7 on each 16 MiB
    piece) must give the host codec's frame, ``decompress`` of it (K2 on
    each compressed chunk, whose decoded lengths are ``declens``) the
    stream, and ``compress_escaped`` (its short frame written on the host,
    read back by K2 with its checksum) the lines of the host engine's run, which the
    CPU tests hold to the JAX example's. Then the two stream examples as
    processes of their own, piped into each other on a corpus file.
    ``run_counted(path, fn, want)`` runs ``fn`` with the counts reset and
    fails unless it launched exactly ``want``."""
    from snappy_tpu_torch.examples.compress import COPY_BYTES
    from snappy_tpu_torch.ops import packing

    # A piece of more than one chunk is one launch of K1 and K7; a shorter
    # tail is framed on the host.
    pieces = sum(min(COPY_BYTES, len(data) - o) > 65536 for o in range(0, len(data), COPY_BYTES))
    got, s_c = run_counted("examples_compress", lambda: run_example("compress", stdin=data),
                           {"encode": pieces, "crc32c": pieces})
    check(got == frame, "the compress example's frame differs from the host codec's")
    # The reader decodes chunk by chunk: K2 in the layout of the chunk's
    # padded width (layout 1 for whole 16 KiB groups).
    layout1 = sum(packing.pad_to_bucket(max(d, 1), 1024) % 16384 == 0 for d in declens)
    want = {"flat_gather[layout=1]": layout1, "flat_gather[layout=0]": len(declens) - layout1}
    got, s_d = run_counted("examples_decompress", lambda: run_example("decompress", stdin=frame),
                           {k: v for k, v in want.items() if v})
    check(got == data, "the decompress example did not give back the stream")
    arg = "hello\tworld 'quoted' \"x\" \\ " + "abc" * 30
    lines, _ = run_counted("examples_escaped", lambda: run_example("compress_escaped", [arg]),
                           {"flat_gather_crc": 1, "flat_gather[layout=0]": 1})
    host_lines = run_example("compress_escaped", [arg], engine="native")
    check(lines == host_lines and len(lines.splitlines()) == 2,
          f"compress_escaped on the card printed {lines!r}, the host engine {host_lines!r}")
    # As a user runs them: two processes, piped.
    pipe_dir = os.path.join(HERE, "chiprun_out", "examples")
    os.makedirs(pipe_dir, exist_ok=True)
    src = os.path.join(HERE, "data", "lcet10.txt")
    with open(src, "rb") as f:
        text = f.read()
    env = {k: v for k, v in os.environ.items() if k != "SNAPPY_TPU_ENGINE"}
    env["PYTHONPATH"] = HERE
    cmd = (f"{sys.executable} -m snappy_tpu_torch.examples.compress < {src} | tee {pipe_dir}/mid.sz "
           f"| {sys.executable} -m snappy_tpu_torch.examples.decompress > {pipe_dir}/out")
    t0 = time.perf_counter()
    r = subprocess.run(["bash", "-o", "pipefail", "-c", cmd], env=env, capture_output=True, text=True)
    s_pipe = time.perf_counter() - t0
    check(r.returncode == 0 and not r.stderr, f"the examples' pipe: {r.returncode} {r.stderr}")
    with open(os.path.join(pipe_dir, "mid.sz"), "rb") as f:
        mid = f.read()
    with open(os.path.join(pipe_dir, "out"), "rb") as f:
        back = f.read()
    from snappy_tpu_torch import native

    check(mid == native.frame_compress(text) and back == text,
          "the examples' pipe did not give the host codec's frame and the input back")
    return {"compress_s": s_c, "decompress_s": s_d, "escaped_lines": lines.decode(),
            "pipe_bytes": len(text), "pipe_s": s_pipe}


def pipeline_on_the_card(run_counted) -> dict:
    """``examples.gpu_pipeline.run`` at 512 KiB shards on one card (K2 once a
    shard) and on four CPU entries: the decoded rows equal, the losses and
    the table within rtol 1e-5 (float32 sums in another order). Then at full
    size on ``make_mesh()``: two shards of 32 MiB (512 chunks each), each
    step's host, decode and step seconds, loss and each card's peak device
    bytes; each card's shard of the rows lies on that card when the step
    runs (only each card's 256 byte counts move to the first)."""
    from snappy_tpu_torch.examples import gpu_pipeline

    (l_card, p_card, r_card), s_card = run_counted(
        "pipeline", lambda: gpu_pipeline.run("cuda", 512 << 10, mesh_size=1),
        {"flat_gather[layout=1]": 2})
    t0 = time.perf_counter()
    l_cpu, p_cpu, r_cpu = gpu_pipeline.run("cpu", 512 << 10)
    s_cpu = time.perf_counter() - t0
    check(all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(r_card, r_cpu)),
          "the pipeline's rows on the card differ from the CPU run's")
    check(np.allclose(l_card, l_cpu, rtol=1e-5, atol=0)
          and torch.allclose(p_card, p_cpu, rtol=1e-5, atol=1e-8),
          f"the pipeline's losses on the card {l_card} and on the CPU {l_cpu}")
    stats = []
    n_cards = torch.cuda.device_count()
    _, s_full = run_counted("pipeline_full", lambda: gpu_pipeline.run("cuda", 32 << 20, stats=stats),
                            {"flat_gather[layout=1]": 2 * n_cards})
    cards = [f"cuda:{i}" for i in range(n_cards)]
    check(all(st["rows_devices"] == cards for st in stats),
          f"the step's rows do not lie one shard a card on {cards}: {stats}")
    return {"small": {"shard_bytes": 512 << 10, "card_s": s_card, "cpu_s": s_cpu,
                      "losses_card": l_card, "losses_cpu": l_cpu},
            "full": {"shard_bytes": 32 << 20, "cards": n_cards, "seconds": s_full, "steps": stats}}


def trace_flat_route(fn, out_dir: str):
    """``fn`` (one warm call of the flat route) under
    ``utils.profiling.device_trace``, written to ``out_dir``. Returns the
    device busy share within the traced window, the 10 longest device
    operations and the 5 longest gaps between device operations with the
    host op that spans each (the innermost host op over the whole gap, if
    any, the time of each of the API's labelled spans within it, and the
    host ops around it), with the kernels' own busy share and each labelled
    span's time in the window. Fails if the trace holds
    no device event of K2, or one of K1 (K2 checks the chunks itself)."""
    import glob

    from snappy_tpu_torch.utils.profiling import device_trace

    subprocess.run(["rm", "-rf", out_dir], check=True)
    with device_trace(out_dir):
        result = fn()
    (path,) = glob.glob(os.path.join(out_dir, "trace.*.json"))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    on_dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host_ops = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")]
    names = [e["name"] for e in on_dev if e.get("cat") == "kernel"]
    labelled = {}  # the port's spans, which its recorder labels in a trace
    for e in events:
        if e.get("cat") == "user_annotation":
            labelled[e["name"]] = labelled.get(e["name"], 0.0) + e["dur"]
    check(any("flat_groups_kernel" in n for n in names) and not any("crc32c_rows_kernel" in n for n in names),
          f"the trace holds no device event of K2, or one of K1 (kernels: {sorted(set(names))[:10]})")
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)

    merged = union(on_dev)
    busy = sum(b - a for a, b in merged)
    kernel_busy = busy_us([e for e in on_dev if e.get("cat") == "kernel"])
    by_name = {}
    for e in on_dev:
        t, c = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (t + e["dur"], c + 1)
    longest = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])), key=lambda g: g[0] - g[1])

    def around(g0, g1):
        over = [e for e in host_ops if e["ts"] <= g0 and e["ts"] + e["dur"] >= g1]
        before = [e for e in host_ops if e["ts"] + e["dur"] <= g0]
        after = [e for e in host_ops if e["ts"] >= g1]
        inside = {}  # each labelled span's time within the gap
        for e in host_ops:
            t = min(g1, e["ts"] + e["dur"]) - max(g0, e["ts"])
            if e.get("cat") == "user_annotation" and t > 0:
                inside[e["name"]] = inside.get(e["name"], 0.0) + t
        return {
            "gap_us": g1 - g0, "labelled_us": inside,
            "spanning_host_op": min(over, key=lambda e: e["dur"])["name"] if over else None,
            "last_host_op_before": max(before, key=lambda e: e["ts"] + e["dur"])["name"] if before else None,
            "first_host_op_after": min(after, key=lambda e: e["ts"])["name"] if after else None,
        }

    return result, {
        "trace": os.path.relpath(path, HERE), "window_us": hi - lo, "device_busy_us": busy,
        "device_busy_share": busy / (hi - lo), "device_events": len(on_dev),
        "kernel_busy_us": kernel_busy, "kernel_busy_share": kernel_busy / (hi - lo),
        "kernel_launches": len(names), "labelled_host_us": labelled,
        "longest_device_ops": [{"name": n[:120], "total_us": t, "count": c} for n, (t, c) in longest],
        "longest_gaps": [around(g0, g1) for g0, g1 in gaps[:5]],
    }


def ncu_record() -> dict:
    """Whether Nsight Compute's ``ncu`` is on the path (or in the toolkit),
    and what its ``--version`` says. Records only: the run does not depend
    on it."""
    import shutil

    on_path = shutil.which("ncu")
    found = on_path or next((p for p in ("/usr/local/cuda/bin/ncu",) if os.path.exists(p)), None)
    out = {"on_path": on_path, "found": found, "version": None}
    if not found:
        return out
    r = subprocess.run([found, "--version"], capture_output=True, text=True, timeout=60)
    out.update(version=(r.stdout + r.stderr).strip()[-2000:], returncode=r.returncode)
    return out


#: The campaign's device legs as chip_smoke runs them (cases a leg), and
#: the kernels each must launch on the card.
CAMPAIGN_COUNTS = {3: 300, 4: 64, 5: 200, 8: 300, 9: 300, 10: 48, 11: 48, 12: 48}
CAMPAIGN_KERNELS = {
    5: {"flat_gather_crc", "flat_gather[layout=0]", "flat_gather[layout=1]"},
    8: {"flat_gather[layout=0]"}, 9: {"records"}, 10: {"flat_gather[layout=1]"},
    11: {"parse", "shift_idx", "emit_bytes"},
    12: {"resolve_fh", "flat_gather[layout=1]"},
}
#: Kernels the campaign's table names for a leg where they run only on some
#: inputs: K3 takes a launch group the host flatten rejects (and K1 checks
#: it on the frame path).
CAMPAIGN_MAYBE = {5: {"replay", "crc32c"}, 8: {"replay"}}


def campaign_phase(report: dict) -> None:
    """The differential campaign's device legs on the card, each in a
    process of its own, all at once (``snappy_tpu_torch.tools.fuzz_campaign``):
    no divergence, no fault, and each leg's launches show its kernels."""
    counts = [CAMPAIGN_COUNTS.get(k, 0) for k in range(1, 13)]
    legs = ",".join(str(k) for k in CAMPAIGN_COUNTS)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "snappy_tpu_torch.tools.fuzz_campaign", *map(str, counts),
         "--legs", legs], cwd=HERE, capture_output=True, text=True, timeout=400,
    )
    seconds = time.perf_counter() - t0
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke_campaign.log"), "w") as f:
        f.write(r.stdout + r.stderr)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    check(bool(lines), f"the campaign printed no result (exit {r.returncode}): {r.stderr[-2000:]}")
    out = json.loads(lines[-1])
    check(r.returncode == 0 and out.get("ok"),
          f"the campaign's device legs failed: {out.get('failed_legs')}; "
          + "; ".join(f"leg {k}: {out.get(f'leg{k}_failure')} at cases "
                      f"{out.get(f'leg{k}_cases_at_fault')}" for k in out.get("failed_legs", [])))
    summary = {"seconds": seconds, "legs": {}}
    for k in CAMPAIGN_COUNTS:
        launched = out[f"leg{k}_launches"]
        want = CAMPAIGN_KERNELS.get(k, set())
        check(want <= set(launched), f"campaign leg {k} launched {launched}, not all of {want}")
        check(set(launched) <= want | CAMPAIGN_MAYBE.get(k, set()),
              f"campaign leg {k} launched {launched}, beyond {want}")
        leg = {f: v for f, v in out.items() if f.startswith(f"leg{k}_")}
        for kernel in sorted(CAMPAIGN_MAYBE.get(k, set()) - set(launched)):
            leg[f"why_no_{kernel}"] = (
                f"every launch group took {sorted(out.get(f'leg{k}_routes', {}))}: the host "
                "flatten rejects only a tile whose sources spread past its widest window, "
                "which needs a body past 64 KiB, and this leg's bodies are at most 12,000 "
                "bytes of input")
        summary["legs"][k] = leg
    report["campaign"] = summary
    print(json.dumps({"campaign": summary}))


#: Fields every stage of ``snappy_tpu_torch.bench`` must report on the card.
BENCH_FIELDS = [
    "platform", "card", "canary_tflops", "canary_hbm_gbps", "canary_roundtrip_ms",
    "decode16_GBps", "decode16_device_GBps", "decode_GBps", "decode_hybrid_GBps",
    "decode_pallas_GBps", "decode_records_GBps", "decode_device_GBps", "decode_flat_host_GBps",
    "decode_e2e_GBps", "decode_e2e_serial_GBps", "decode_resolve_device_GBps",
    "decode_resolve_e2e_GBps", "decode_peak_bytes", "crc32c_GBps", "crc32c_device_GBps",
    "compress_GBps", "compress_device_GBps", "compress_flat_device_GBps", "encode_peak_bytes",
    "sharded_devices", "sharded_decode_xla_ndev_GBps", "sharded_decode_hosted_ndev_GBps",
    "sharded_decode_1dev_GBps", "sharded_decode_ndev_GBps",
]


def bench_phase(report: dict) -> None:
    """``python -m snappy_tpu_torch.bench`` as a user runs it, with a deadline:
    every stage passes (each checks every row it decodes or compresses) and
    reports its fields."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "snappy_tpu_torch.bench"], cwd=HERE,
                       capture_output=True, text=True, timeout=330,
                       env={**os.environ, "BENCH_DEADLINE_S": "300"})
    seconds = time.perf_counter() - t0
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke_bench.log"), "w") as f:
        f.write(r.stdout + r.stderr)
    lines = r.stdout.strip().splitlines()
    check(bool(lines), f"bench printed no result (exit {r.returncode}): {r.stderr[-2000:]}")
    out = json.loads(lines[-1])
    check(r.returncode == 0 and not out.get("failures"), f"bench failed: {out.get('failures')}")
    missing = [f for f in BENCH_FIELDS if f not in out]
    check(not missing, f"bench fields missing: {missing}")
    check(all(isinstance(out[f], (int, float)) for f in BENCH_FIELDS if f not in ("platform", "card")),
          "a bench field is not a number")
    report["bench"] = {"seconds": seconds, **out}
    print(json.dumps({"bench": {"seconds": seconds, **{f: out[f] for f in ["value", *BENCH_FIELDS]}}}))


#: The host-against-card tools as chip_smoke runs them (arguments, seconds
#: allowed), and the kernels each must launch on the card.
TOOL_RUNS = {
    "crossover_measure": (["--sizes", "65536,1048576,16777216"], 240,
                          {"flat_gather_crc", "flat_gather[layout=1]", "parse", "fused_emit"}),
    "flatten_scale": (["--threads", "1,all"], 180, {"flat_gather[layout=1]", "resolve_fh"}),
    "scaling_measure": (["--ranks", "1,2", "--blocks", "8"], 240, {"encode"}),
}


def tools_phase(report: dict) -> None:
    """The three host-against-card tools of ``snappy_tpu_torch.tools``, each a
    process with a deadline, all at once: each checks every call it times
    and must pass, give every rate, and launch its kernels (the crossover at
    each size; the scaling run's NCCL rank and its two gloo ranks sharing
    ``cuda:0``, the latter marked ``shared_card`` and given no efficiency)."""
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", f"snappy_tpu_torch.tools.{name}", *args], cwd=HERE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (args, _, _) in TOOL_RUNS.items()}
    outs = {}
    try:
        for name, p in procs.items():
            try:
                outs[name] = p.communicate(timeout=max(1.0, TOOL_RUNS[name][1]
                                                       - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                p.kill()
                outs[name] = p.communicate()
    finally:
        for p in procs.values():
            p.kill()
    summary = {"seconds": time.perf_counter() - t0}
    for name, p in procs.items():
        stdout, stderr = outs[name]
        with open(os.path.join(HERE, "chiprun_out", f"chip_smoke_{name}.log"), "w") as f:
            f.write(stdout + stderr)
        lines = stdout.strip().splitlines()
        check(p.returncode == 0 and bool(lines),
              f"{name} exited {p.returncode}: {stderr[-2000:]}")
        out = json.loads(lines[-1])
        check(out["ok"] and out["card"] != "not measured", f"{name} failed: {out.get('failure')}")
        kernels = TOOL_RUNS[name][2]
        if name == "crossover_measure":
            for row in out["rows"]:
                check(all(isinstance(v, float) for k, v in row.items() if k.endswith("GBps")),
                      f"crossover at {row['bytes']} bytes: a rate is not a number")
                check(kernels <= set(row["launches"]),
                      f"crossover at {row['bytes']} bytes launched {row['launches']}")
            summary[name] = {k: v for k, v in out.items() if k.endswith("crossover_bytes")}
            summary[name]["rows"] = [{k: v for k, v in r.items() if k == "bytes" or k.endswith(
                ("GBps", "launches"))} for r in out["rows"]]
        elif name == "flatten_scale":
            check(kernels <= set(out["launches"]), f"flatten_scale launched {out['launches']}")
            summary[name] = {k: out[k] for k in (
                "per_core_GBps", "flatten_best_GBps", "scan_per_core_GBps", "scan_best_GBps",
                "device_GBps", "resolve_device_GBps", "cards_fed", "cores_to_feed_one_card",
                "scan_cards_fed", "scan_cores_to_feed_one_card", "launches")}
        else:
            plan = [(r["ranks"], r["backend"], r["shared_card"]) for r in out["runs"]]
            shared = torch.cuda.device_count() < 2
            check(plan == [(1, "nccl", False), (2, "gloo" if shared else "nccl", shared)],
                  f"scaling_measure ran {plan}")
            check(all(kernels <= set(r["launches"]) for run in out["runs"]
                      for r in run["per_rank"]), "a scaling rank launched no K7")
            check(not shared or out["efficiency"][0]["efficiency_1_to_2"] is None,
                  "scaling_measure gave an efficiency for ranks sharing one card")
            summary[name] = {"runs": [{k: r[k] for k in (
                "ranks", "backend", "shared_card", "encode_s", "allgather_s", "write_s",
                "total_s", "stream_bytes")} for r in out["runs"]], "efficiency": out["efficiency"]}
    report["tools"] = summary
    print(json.dumps({"tools": summary}))


def graft_want(n: int) -> dict:
    """The launches of one ``graft_entry.dryrun_multichip`` on a mesh of ``n``
    entries: each leg's kernels once a mesh entry, K2 in two legs."""
    return {"crc32c": n, "encode": n, "replay": n, "flat_gather[layout=1]": 2 * n,
            "resolve_fh": n, "parse": n, "fused_emit": n}


def graft_phase(report: dict) -> None:
    """The graft entry on the card (phase 8 of the module docstring)."""
    from snappy_tpu_torch import graft_entry, native
    from snappy_tpu_torch.format.constants import STREAM_IDENTIFIER

    by_path = {}
    fn, args = graft_entry.entry()
    check(all(a.device.type == "cuda" for a in args), "entry() placed its inputs off the card")
    (rows, row_len), entry_s = counted_run(by_path, "graft_entry", lambda: fn(*args),
                                           {"crc32c": 1})
    cfn, cargs = graft_entry.entry(device="cpu")
    crows, crow_len = cfn(*cargs)
    check(torch.equal(rows.cpu(), crows) and torch.equal(row_len.cpu(), crow_len),
          "entry()'s rows on the card differ from its CPU run's")
    chunks, lens = cargs[0].numpy(), cargs[1].numpy()
    r, n = rows.cpu().numpy(), row_len.cpu().numpy()
    stream = STREAM_IDENTIFIER + b"".join(r[i, : n[i]].tobytes() for i in range(len(n)))
    check(native.frame_decompress(stream)
          == b"".join(chunks[i, : lens[i]].tobytes() for i in range(len(lens))),
          "entry()'s frame does not decode to its input")

    def launched(path):
        return {k: v for k, v in by_path[path].items() if v}

    cards = torch.cuda.device_count()
    runs = {f"dryrun_{cards}_cards": (cards, None), "dryrun_4_on_cuda0": (4, "cuda:0")}
    summary = {"entry_s": entry_s, "entry_launches": launched("graft_entry"), "dryruns": {}}
    for path, (m, device) in runs.items():
        _, seconds = counted_run(
            by_path, path, lambda m=m, device=device: graft_entry.dryrun_multichip(m, device=device),
            graft_want(m))
        summary["dryruns"][path] = {"mesh": m, "device": device or "every card",
                                    "seconds": seconds, "launches": launched(path)}
    report["graft"] = summary
    print(json.dumps({"graft": summary}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "snappy_tpu_torch")):
        print("chip_smoke: snappy_tpu_torch/ is not beside this script", file=sys.stderr)
        return 1
    import snappy_tpu_torch
    from snappy_tpu_torch import native, read, trace, write
    from snappy_tpu_torch.format.varint import read_varu64, write_varu64
    from snappy_tpu_torch.ops import (
        _build, api, crc32c, decode_flat, emit, encode, encode_flat, launch_counts as counts,
        packing, parse, records, replay, resolve, reset_launch_counts as reset_counts,
    )

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    sm_mhz = int(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0])
    report = {"card": card, "sm_max_mhz": sm_mhz, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    for src in _build.kernel_sources():
        _build.kernel_lib(src.stem)
    native.crc32c_masked(b"")
    report["build_s"] = time.perf_counter() - t0
    ptxas = []
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        ptxas += [f"{log.name}: {ln.strip()}" for ln in log.read_text().splitlines()
                  if "registers" in ln or "spill" in ln]
    report["ptxas"] = ptxas
    print(f"build: {report['build_s']:.3f} s")
    for ln in ptxas:
        print(f"  {ln}")

    # -- main-path data ----------------------------------------------------------
    data = corpus_stream(STREAM_BYTES)
    frame = native.frame_compress(data)
    chunks = compressed_chunks(frame)
    bodies = [c[0] for c in chunks]
    groups = api.launch_groups(bodies, snappy_tpu_torch.get_config().decode_rows_per_launch)
    report["stream"] = {
        "bytes": len(data), "frame_bytes": len(frame), "compressed_chunks": len(chunks),
        "groups": [[api._width_bucket(len(bodies[g[0]])), len(g)] for g in groups],
    }

    def group_inputs(g):
        gb, gd = [bodies[i] for i in g], [chunks[i][1] for i in g]
        srcs, lens = packing.batch_streams(gb, api._width_bucket(len(gb[0])))
        d_pad = packing.pad_to_bucket(max(gd), 1024)
        return srcs, lens, gd, d_pad

    kernels = []

    # -- K1 CRC32C ---------------------------------------------------------------------
    # At 512 x 65536 with random lengths (the row's shape since the first
    # port) and on the frame's largest launch group (455 decoded rows with
    # the chunks' lengths, as ops/api.py calls crc32c_masked_blocks there),
    # masked and unmasked against the plain version, and the group's CRCs
    # against the host codec's. ms and group_ms with the host out of the
    # window (50 wrapper calls in a CUDA graph), call_ms over 50 calls back
    # to back, and the wrapper's host time a call (calls issued with no
    # synchronize, the host's clock).
    def crc_case(rows, lens_t):
        got = crc32c.crc32c_masked_blocks(rows, lens_t)
        want = crc32c.crc32c_plain(rows, lens_t, masked=True)
        got_u = crc32c.crc32c_blocks(rows, lens_t)
        want_u = crc32c.crc32c_plain(rows, lens_t, masked=False)
        call = lambda: crc32c.crc32c_masked_blocks(rows, lens_t)  # noqa: E731
        n_bytes = int(lens_t.clamp(0, rows.shape[1]).sum())
        nbytes = n_bytes + 4 * rows.shape[0] + 8 * rows.shape[0] + 4 * 4 * 256
        return got, (torch.equal(got, want) and torch.equal(got_u, want_u),
                     max(max_abs_err(got, want), max_abs_err(got_u, want_u)),
                     device_ms(call, 50), cuda_ms(call, 50), bound_ms(nbytes, 3 * n_bytes))

    def host_us(fn, calls=200):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / calls * 1e6

    rng = np.random.default_rng(7)
    b, s = 512, 65536
    rows = torch.from_numpy(rng.integers(0, 256, (b, s), dtype=np.uint8)).to(dev)
    lens_np = rng.integers(0, s + 1, b).astype(np.int32)
    lens_np[:2] = (0, s)
    lens = torch.from_numpy(lens_np).to(dev)
    _, (equal, err, ms1, call1, (bnd, by)) = crc_case(rows, lens)
    big = max(groups, key=len)
    gd_big = [chunks[i][1] for i in big]
    decoded = native.decompress_batch(
        [write_varu64(gd_big[j]) + bodies[i] for j, i in enumerate(big)])
    grows = np.zeros((len(big), packing.pad_to_bucket(max(gd_big), 1024)), np.uint8)
    for j, x in enumerate(decoded):
        grows[j, : gd_big[j]] = np.frombuffer(x, np.uint8)
    grows_t = torch.from_numpy(grows).to(dev)
    glens_t = torch.tensor(gd_big, dtype=torch.int32, device=dev)
    gcrc, (g_equal, g_err, g_ms, g_call, (g_bnd, _)) = crc_case(grows_t, glens_t)
    host_codec = torch.equal(gcrc.cpu(), torch.tensor([native.crc32c_masked(x) for x in decoded]))
    kernels.append({
        "name": "crc32c", "route": "cuda", "source": "snappy_tpu_torch/csrc/crc32c.cu",
        "replaces": "snappy_tpu/ops/pallas/crc32c.py:64 crc32c_blocks_pallas",
        "shape": [b, s], "equal": equal and g_equal and host_codec, "max_abs_err": max(err, g_err),
        "ms": ms1, "call_ms": call1,
        "plain_ms": cuda_ms(lambda: crc32c.crc32c_plain(rows, lens, True), 3, warm=1),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "group_shape": list(grows.shape), "group_ms": g_ms, "group_call_ms": g_call,
        "group_bound_ms": g_bnd, "group_equals_host_codec": host_codec,
        "host_us_per_call": host_us(lambda: crc32c.crc32c_masked_blocks(grows_t, glens_t)),
    })
    print(f"K1: 512 x 65536 {ms1:.6f} ms device-only, {call1:.6f} over calls (bound {bnd:.6f}); "
          f"455-row group {g_ms:.6f} and {g_call:.6f} (bound {g_bnd:.6f}); the wrapper "
          f"{kernels[-1]['host_us_per_call']:.3f} us a call on the host's clock")
    del rows, grows_t, decoded
    check(equal and g_equal and host_codec,
          "K1 crc32c differs from its plain version or the host codec")

    # -- K2 flat gather, both layouts, on corpus chunks as the main path groups them --
    # Timed two ways, each for the kernel and for its torch.gather yardstick:
    # ms with the host out of the window (a CUDA graph of 50 calls), call_ms
    # over 50 calls back to back (the host's per-call cost included).
    def flat_inputs(srcs, glens, gd, d_pad, layout):
        idx, tmeta, fallb, herrs, _ = native.flatten_idx_batch(
            srcs, glens.astype(np.uint64), np.asarray(gd, np.uint64), d_pad, layout=layout)
        check(not fallb.any() and not herrs.any(), "the flatten rejected a row")
        return idx, tmeta, (
            torch.from_numpy(srcs).to(dev), torch.from_numpy(idx.view(np.int16)).to(dev),
            torch.from_numpy(tmeta).to(dev), torch.from_numpy(np.asarray(gd, np.int32)).to(dev))

    big = max(groups, key=len)
    tail = [g for g in groups if packing.pad_to_bucket(max(chunks[i][1] for i in g), 1024) % 16384]
    check(bool(tail), "the stream has no tail chunk for layout 0")
    for layout, g in ((1, big), (0, tail[0])):
        srcs, glens, gd, d_pad = group_inputs(g)
        check(layout == (1 if d_pad % 16384 == 0 else 0), f"group d_pad {d_pad}")
        idx, tmeta, a = flat_inputs(srcs, glens, gd, d_pad, layout)
        got = decode_flat.decode_flat(*a, d_pad, layout)
        want = decode_flat.decode_flat_plain(*a, d_pad, layout)
        expect = np.zeros((len(g), d_pad), np.uint8)
        plain = native.decompress_batch([write_varu64(gd[j]) + bodies[i] for j, i in enumerate(g)])
        for j, p in enumerate(plain):
            expect[j, : gd[j]] = np.frombuffer(p, np.uint8)
        equal = torch.equal(got, want) and bool((got.cpu().numpy() == expect).all())
        # The library yardstick: one torch.gather over absolute indices into
        # rows with a zero column appended (index S for d >= declen).
        d = np.arange(d_pad)
        rel = idx[:, decode_flat.phys_index(d, layout)].astype(np.int64)
        absidx = np.repeat(tmeta[:, :, 0].astype(np.int64), 1024, axis=1) * 128 + rel
        absidx[d[None, :] >= np.asarray(gd)[:, None]] = srcs.shape[1]
        padded = torch.cat([a[0], torch.zeros_like(a[0][:, :1])], dim=1)
        absidx_t = torch.from_numpy(absidx).to(dev)
        check(torch.equal(torch.gather(padded, 1, absidx_t), got), "torch.gather yardstick")
        live_tiles = sum(-(-x // 1024) for x in gd)
        nbytes = 2 * sum(gd) + int(glens.sum()) + 8 * live_tiles + 4 * len(g) + len(g) * d_pad
        bnd, by = bound_ms(nbytes)
        k2 = lambda: decode_flat.decode_flat(*a, d_pad, layout)  # noqa: E731
        lib = lambda: torch.gather(padded, 1, absidx_t)  # noqa: E731
        kernels.append({
            "name": f"flat_gather[layout={layout}]", "route": "cuda",
            "source": "snappy_tpu_torch/csrc/flat_gather.cu",
            "replaces": ("snappy_tpu/ops/pallas/decode.py:1334 decode_flat_pallas_v2" if layout
                         else "snappy_tpu/ops/pallas/decode.py:1395 decode_flat_pallas"),
            "shape": [len(g), srcs.shape[1], d_pad], "equal": equal,
            "max_abs_err": max_abs_err(got, want),
            "ms": device_ms(k2, 50), "call_ms": cuda_ms(k2, 50),
            "plain_ms": cuda_ms(lambda: decode_flat.decode_flat_plain(*a, d_pad, layout), 5),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": device_ms(lib, 50), "library_call_ms": cuda_ms(lib, 50),
        })
        check(equal, f"K2 flat gather layout {layout} differs from its plain version")
        if layout == 1:
            big_k2 = (a, got, expect, padded, absidx_t, nbytes + 4 * len(g) * (d_pad // 16384))
            # K2 with the frame checksum, as the frame path launches it on this
            # group: K2's bytes, K1's CRCs of them and the host codec's; timed
            # as K2 is, beside K2 then K1; the bound is K2's bytes.
            f_out, f_crc = decode_flat.decode_flat_crc(*a, d_pad, 1)
            k1_crc = crc32c.crc32c_masked_blocks(got, a[3])
            host_crc = torch.tensor([native.crc32c_masked(x) for x in plain])
            f_equal = (torch.equal(f_out, got) and torch.equal(f_crc, k1_crc)
                       and torch.equal(f_crc.cpu(), host_crc))
            fused = lambda: decode_flat.decode_flat_crc(*a, d_pad, 1)  # noqa: E731
            pair = lambda: crc32c.crc32c_masked_blocks(  # noqa: E731
                decode_flat.decode_flat(*a, d_pad, 1), a[3])
            kernels.append({
                "name": "flat_gather_crc", "route": "cuda",
                "source": "snappy_tpu_torch/csrc/flat_gather.cu",
                "replaces": "snappy_tpu/ops/pallas/decode.py:1334 decode_flat_pallas_v2 with "
                            "snappy_tpu/ops/pallas/crc32c.py:64 crc32c_blocks_pallas after it",
                "shape": [len(g), srcs.shape[1], d_pad], "equal": f_equal,
                "max_abs_err": max(max_abs_err(f_out, got), max_abs_err(f_crc, k1_crc)),
                "ms": device_ms(fused, 50), "call_ms": cuda_ms(fused, 50),
                "pair_ms": device_ms(pair, 50), "pair_call_ms": cuda_ms(pair, 50),
                "plain_ms": cuda_ms(lambda: crc32c.crc32c_plain(
                    decode_flat.decode_flat_plain(*a, d_pad, 1), a[3], True), 5),
                "bound_ms": bnd, "bound_by": by, "library_ms": None,
            })
            print(f"K2 with the checksum: {kernels[-1]['ms']:.6f} ms device-only, K2 then K1 "
                  f"{kernels[-1]['pair_ms']:.6f} (bound {bnd:.6f})")
            check(f_equal, "K2 with the checksum differs from K2, K1 or the host codec")

    # -- K2 over the 16 MiB frame read's five launch groups in one launch ----------
    k = flat_groups_row(dev, ptxas)
    kernels.append(k)
    print(f"K2 over five groups: one launch {k['ms']:.6f} ms device-only ({k['GBps']:.2f} GB/s), "
          f"five launches {k['separate_ms']:.6f} ({k['separate_GBps']:.2f}); K2 alone "
          f"{k['k2_ms']:.6f} against {k['k2_separate_ms']:.6f}; bound {k['bound_ms']:.6f}; "
          f"counts {k['counts']}")
    check(min(k["ms"], k["k2_ms"]) >= k["bound_ms"],
          "K2 over five groups reads faster than its bytes' bound: no true reading")
    check(k["equal"], "K2 over several groups differs from its plain version or five launches")
    check(k["counts"] == {"launches": 1, "crc_launches": 1, "launched_groups": 5, "crc32c": 0},
          f"K2 over five groups: {k['counts']}")

    # -- K11 grouped flat gather (v3, v4) on the frame's largest group, as K2 gets it ----
    # With group_buckets' buckets it must give K2's bytes and the host codec's;
    # a hand-made bucket plane (a live group marked dead, a 3: zeros for v3, the
    # wide window for v4, and every wider group cut to the narrow window) and a
    # batch of 2 KiB rows (s_rows 16, under every window) are held against the
    # plain version. The bound and the torch.gather yardstick are K2's, plus the
    # bucket plane.
    a, k2_out, expect, padded, absidx_t, nbytes = big_k2
    d_pad = a[1].shape[1]
    gbuck = decode_flat.group_buckets(a[2], a[3], d_pad)
    hand = gbuck.clone()
    hand[gbuck > 0] = 0
    hand[0, 0], hand[1, 1] = -1, 3
    narrow_rows = [b"z" * 30000, (b"pattern!" * 4000)[:32000]]
    n_srcs, n_lens = packing.batch_streams(
        [c[read_varu64(c)[1]:] for c in map(native.compress, narrow_rows)], 2048)
    *_, narrow = flat_inputs(n_srcs, n_lens, [len(r) for r in narrow_rows], 32768, 1)
    narrow = [*narrow[:3], decode_flat.group_buckets(narrow[2], narrow[3], 32768), narrow[3]]
    report["grouped"] = {"gbuck_histogram": torch.bincount(gbuck.flatten().long() + 1).tolist(),
                         "hand_made_differs": None}
    bnd, by = bound_ms(nbytes)
    lib = lambda: torch.gather(padded, 1, absidx_t)  # noqa: E731
    for variant in (3, 4):
        got = decode_flat.decode_flat_grouped(*a[:3], gbuck, a[3], d_pad, variant)
        want = decode_flat.decode_flat_grouped_plain(*a[:3], gbuck, a[3], d_pad, variant)
        got_h = decode_flat.decode_flat_grouped(*a[:3], hand, a[3], d_pad, variant)
        want_h = decode_flat.decode_flat_grouped_plain(*a[:3], hand, a[3], d_pad, variant)
        got_n = decode_flat.decode_flat_grouped(*narrow, 32768, variant)
        want_n = decode_flat.decode_flat_grouped_plain(*narrow, 32768, variant)
        host_n = got_n.cpu().numpy()
        equal = (torch.equal(got, want) and torch.equal(got, k2_out)
                 and bool((got.cpu().numpy() == expect).all()) and torch.equal(got_h, want_h)
                 and torch.equal(got_n, want_n)
                 and all(host_n[i, : len(r)].tobytes() == r for i, r in enumerate(narrow_rows)))
        report["grouped"]["hand_made_differs"] = not torch.equal(got_h, got)
        k11 = lambda: decode_flat.decode_flat_grouped(*a[:3], gbuck, a[3], d_pad, variant)  # noqa: E731
        kernels.append({
            "name": f"flat_grouped[v{variant}]", "route": "cuda",
            "source": "snappy_tpu_torch/csrc/flat_gather.cu",
            "replaces": "snappy_tpu/ops/pallas/decode.py:" + (
                "1248 decode_flat_pallas_v3" if variant == 3 else "1166 decode_flat_pallas_v4"),
            "shape": [a[0].shape[0], a[0].shape[1], d_pad], "equal": equal,
            "max_abs_err": max(max_abs_err(got, want), max_abs_err(got, k2_out),
                               max_abs_err(got_h, want_h), max_abs_err(got_n, want_n)),
            "ms": device_ms(k11, 50), "call_ms": cuda_ms(k11, 50),
            "plain_ms": cuda_ms(lambda: decode_flat.decode_flat_grouped_plain(
                *a[:3], gbuck, a[3], d_pad, variant), 5),
            "bound_ms": bnd, "bound_by": by,
            "library_ms": device_ms(lib, 50), "library_call_ms": cuda_ms(lib, 50),
            "k2_ms_same_call": device_ms(lambda: decode_flat.decode_flat(*a, d_pad, 1), 50),
        })
        check(equal, f"K11 v{variant} differs from its plain version, K2 or the host codec")
    check(report["grouped"]["hand_made_differs"], "the hand-made buckets changed no byte")
    print(f"K11: bucket histogram (-1, 0, 1, 2) {report['grouped']['gbuck_histogram']}")
    del big_k2, a, k2_out, expect, padded, absidx_t, narrow, got, want, got_h, want_h

    # -- K2 and K11 past the main path's shapes ----------------------------------------
    # A wide raw stream (a body past 64 KiB, d_pad up to 1 MiB, units that
    # read source bytes 60 KiB apart) in both layouts, and rows of the
    # 81,920-byte width (incompressible 64 KiB chunks) beside a corpus chunk
    # and a row of declen 0: K2 against its plain version and the host codec,
    # and in layout 1 K11 v3 and v4 against theirs and K2's bytes.
    noise = np.random.default_rng(3).integers(0, 256, 65536, dtype=np.uint8).tobytes()
    w15, w16 = wide_stream(15), wide_stream(16)
    rows81920 = [(c[read_varu64(c)[1]:], len(x)) for x in (noise, noise[::-1], data[:65536], b"")
                 for c in (native.compress(x),)]
    report["flat_edge_cases"] = {}
    by_name = {k["name"]: k for k in kernels}
    for name, rows, layout, d_pad, width in (
        ("wide", [w16], 1, 1 << 20, None),
        ("wide", [(w15[0] + literal(bytes(range(200)) * 5), w15[1] + 1000)], 0, 984064, None),
        ("rows_81920", rows81920, 1, 65536, 81920),
        ("rows_81920", rows81920, 0, 66560, 81920),
    ):
        srcs, glens = packing.batch_streams([r[0] for r in rows], width)
        gd = [r[1] for r in rows]
        check(max(gd) <= d_pad and (d_pad % 16384 == 0) == bool(layout), f"{name} d_pad {d_pad}")
        _, _, a = flat_inputs(srcs, glens, gd, d_pad, layout)
        got = decode_flat.decode_flat(*a, d_pad, layout)
        want = decode_flat.decode_flat_plain(*a, d_pad, layout)
        host = got.cpu().numpy()
        equal = torch.equal(got, want) and all(
            host[i, :n].tobytes() == native.decompress(write_varu64(n) + body)
            and not host[i, n:].any() for i, (body, n) in enumerate(rows))
        k = by_name[f"flat_gather[layout={layout}]"]
        k["equal"] = k["equal"] and equal
        k["max_abs_err"] = max(k["max_abs_err"], max_abs_err(got, want))
        case = {"shape": list(srcs.shape) + [d_pad], "equal": equal}
        if layout:
            gb = decode_flat.group_buckets(a[2], a[3], d_pad)
            for variant in (3, 4):
                got11 = decode_flat.decode_flat_grouped(*a[:3], gb, a[3], d_pad, variant)
                want11 = decode_flat.decode_flat_grouped_plain(*a[:3], gb, a[3], d_pad, variant)
                eq11 = torch.equal(got11, want11) and torch.equal(got11, got)
                k = by_name[f"flat_grouped[v{variant}]"]
                k["equal"] = k["equal"] and eq11
                k["max_abs_err"] = max(k["max_abs_err"], max_abs_err(got11, want11),
                                       max_abs_err(got11, got))
                case[f"v{variant}_equal"] = eq11
                equal = equal and eq11
        report["flat_edge_cases"][f"{name}[layout={layout}]"] = case
        check(equal, f"K2 or K11 differs on the {name} case, layout {layout}")
    print(f"K2/K11 edge cases: {report['flat_edge_cases']}")
    del a, got, want, host

    # -- K3 replay ----------------------------------------------------------------------
    def replay_case(rows_bodies, declens, width=None):
        srcs, rlens = packing.batch_streams(rows_bodies, width)
        d_pad = packing.pad_to_bucket(max(max(declens), 1), 1024)
        a = (
            torch.from_numpy(srcs).to(dev), torch.from_numpy(rlens).to(dev),
            torch.from_numpy(np.asarray(declens, np.int32)).to(dev),
        )
        got = replay.decode_replay(*a, d_pad)
        want = replay.decode_replay_plain(*a, d_pad)
        err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
        return a, d_pad, got, torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), err

    small = small_replay_rows()
    _, _, got_small, eq_small, err_small = replay_case([r[0] for r in small], [r[1] for r in small])
    check(eq_small, "K3 replay differs from its plain version on the small vectors")
    check(bool((got_small[1][:8] > 0).all()), "a corrupt vector decoded clean")
    sample = big[:64]
    corpus_a, corpus_dpad, got_c, eq_c, err_c = replay_case(
        [bodies[i] for i in sample], [chunks[i][1] for i in sample])
    check(eq_c and not bool(got_c[1].any()), "K3 replay differs on corpus chunks")
    raw_fb, plain_fb = flatten_rejected_stream()
    fb_declen, fb_h = read_varu64(raw_fb)
    fb_body = raw_fb[fb_h:]
    a, d_pad, got, eq_fb, err_fb = replay_case([fb_body], [fb_declen], api._width_bucket(len(fb_body)))
    check(eq_fb and got[0][0, :fb_declen].cpu().numpy().tobytes() == plain_fb, "K3 on the rejected row")
    # The frame's largest launch group (455 corpus chunks, d_pad 65536), as
    # the frame_replay route gives it to K3: against the plain version once
    # (a Python walk of every op, about 20 s) and the host codec's bytes.
    group_a, group_dpad, got_g, eq_g, err_g = replay_case(
        [bodies[i] for i in big], [chunks[i][1] for i in big])
    plain_g = native.decompress_batch(
        [write_varu64(chunks[i][1]) + bodies[i] for i in big])
    host_g = got_g[0].cpu().numpy()
    eq_g = eq_g and not bool(got_g[1].any()) and all(
        host_g[j, : len(p)].tobytes() == p for j, p in enumerate(plain_g))
    check(eq_g, "K3 replay differs on the 455-row group")
    del host_g, plain_g
    # K3's algorithm in tensor ops (replay.replay_windows) on the group's
    # first 16 rows: the kernel's bytes and codes, its source windows a row
    # and its doubling rounds a window.
    m_dst, m_errs, m_det = replay.replay_windows(*(x[:16] for x in group_a), group_dpad)
    check(torch.equal(m_dst, got_g[0][:16]) and torch.equal(m_errs, got_g[1][:16]),
          "K3's windowed model differs from the kernel on 16 rows of the group")
    k3_model = {"rows": 16, "windows_per_row": float(m_det["windows"].double().mean()),
                "rounds_per_window": float(m_det["rounds"].sum() / m_det["windows"].sum())}
    del m_dst, m_errs, m_det

    def k3_device_ms(args, dp, want, reps):
        """K3 device-only through its C entry (the wrapper reads
        src_lens.max() and declens.max() back to check them, which a CUDA
        graph cannot hold); the entry's rows and codes must be the
        wrapper's."""
        srcs_t, lens_t, decl_t = args
        dst = torch.empty((srcs_t.shape[0], dp), dtype=torch.uint8, device=dev)
        errs = torch.empty(srcs_t.shape[0], dtype=torch.int32, device=dev)

        def call():
            _build.check(replay._kernel()(
                srcs_t.data_ptr(), srcs_t.shape[0], srcs_t.shape[1], lens_t.data_ptr(),
                decl_t.data_ptr(), dp, dst.data_ptr(), errs.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "replay")

        ms = device_ms(call, reps)
        check(torch.equal(dst, want[0]) and torch.equal(errs, want[1]),
              "K3's C entry and its wrapper differ")
        return ms

    nbytes = len(fb_body) + 8 + d_pad + 4
    bnd, by = bound_ms(nbytes)
    g_bytes = int(group_a[1].sum()) + 12 * len(big) + len(big) * group_dpad
    g_bnd, _ = bound_ms(g_bytes)
    kernels.append({
        "name": "replay", "route": "cuda", "source": "snappy_tpu_torch/csrc/replay.cu",
        "replaces": "snappy_tpu/ops/pallas/decode.py:1523 decode_batch_pallas",
        "shape": [1, a[0].shape[1], d_pad], "equal": eq_small and eq_c and eq_fb and eq_g,
        "max_abs_err": max(err_small, err_c, err_fb, err_g),
        "ms": k3_device_ms(a, d_pad, got, 20),
        "call_ms": cuda_ms(lambda: replay.decode_replay(*a, d_pad), 20),
        "plain_ms": cuda_ms(lambda: replay.decode_replay_plain(*a, d_pad), 3, warm=1),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
        "group_shape": [len(big), group_a[0].shape[1], group_dpad],
        "group_ms": k3_device_ms(group_a, group_dpad, got_g, 5),
        "group_call_ms": cuda_ms(lambda: replay.decode_replay(*group_a, group_dpad), 5),
        "group_bound_ms": g_bnd,
        "corpus_64_rows_ms": cuda_ms(lambda: replay.decode_replay(*corpus_a, corpus_dpad), 5),
        "corpus_64_rows_device_ms": k3_device_ms(corpus_a, corpus_dpad, got_c, 5),
        "model": k3_model,
    })
    k = kernels[-1]
    print(f"K3: raw row {k['ms']:.6f} ms device-only, {k['call_ms']:.6f} over calls (bound "
          f"{bnd:.6f}); 455-row group {k['group_ms']:.6f} device-only, {k['group_call_ms']:.6f} "
          f"over calls (bound {g_bnd:.6f}); 64 corpus rows {k['corpus_64_rows_device_ms']:.6f} "
          f"device-only, {k['corpus_64_rows_ms']:.6f} over calls; model on 16 rows {k3_model}")
    del group_a, got_g

    # -- compress: K4, K5 and K6 on the compress path's own launch group ------------
    # The stream's 1,025 blocks padded to 2,048 rows, as compress() batches
    # them; the inputs of each kernel are made by the path's own stages.
    cblocks, clens = packing.blocks_of(data)
    rows = packing.pad_to_bucket(len(clens), 1)
    pad = rows - len(clens)
    cb = torch.from_numpy(np.concatenate([cblocks, np.zeros((pad, cblocks.shape[1]), np.uint8)])).to(dev)
    cl = torch.from_numpy(np.concatenate([clens, np.zeros(pad, np.int32)])).to(dev)
    live_blocks = int((clens > 0).sum())
    jw, _ = encode_flat.prepass(cb, cl)
    rec = parse.parse_blocks(cl, jw, cb)
    *want4, lane_steps, seg_steps = parse.parse_lockstep(cl, jw, cb)
    eq4 = all(torch.equal(g, w) for g, w in zip(rec, want4))
    longest = seg_steps.max(dim=1).values[cl > 0].double()  # a block's longest walk
    nbytes = (live_blocks * (4 * 128 * 512 + 65536)
              + rows * (2 * 4 * 128 * parse.MAX_REC + 4 * 128 * 8 + 4))
    bnd, by = bound_ms(nbytes, PARSE_OPS_PER_STEP * lane_steps)
    kernels.append({
        "name": "parse", "route": "cuda", "source": "snappy_tpu_torch/csrc/parse.cu",
        "replaces": "snappy_tpu/ops/pallas/encode_flat.py:195 parse_blocks_pallas",
        "shape": [rows, 65536], "live_blocks": live_blocks, "lane_steps": lane_steps,
        "longest_walk_per_block": {"mean": float(longest.mean()), "max": int(longest.max())},
        "equal": eq4, "max_abs_err": max(max_abs_err(g, w) for g, w in zip(rec, want4)),
        "ms": device_ms(lambda: parse.parse_blocks(cl, jw, cb), 10),
        "call_ms": cuda_ms(lambda: parse.parse_blocks(cl, jw, cb), 10),
        "plain_ms": cuda_ms(lambda: parse.parse_blocks_plain(cl, jw, cb), 1, warm=0),
        "bound_ms": bnd, "bound_by": by, "library_ms": None,
    })
    check(eq4, "K4 parse differs from its plain version")
    del want4

    lo_row, base, rows_g, out_len, bp_rows, dlt_rows, src, _ = encode_flat._fused_plan(cb, cl, *rec)
    plan = (lo_row, base, rows_g, out_len, bp_rows, dlt_rows)
    out5 = emit.fused_emit(*plan, src)
    idx6 = emit.shift_idx(*plan)
    out6 = emit.emit_bytes(src, idx6, out_len)
    idx_plain = emit.shift_idx_plain(*plan)
    want5 = emit.emit_bytes_plain(src, idx_plain, out_len)  # = fused_emit_plain
    want6 = emit.emit_bytes_plain(src, idx6, out_len)
    ref_out, ref_len = encode_flat.records_to_bytes(cb[:64], cl[:64], *(r[:64] for r in rec))
    check(torch.equal(out5[:64, : encode_flat.OUT_W], ref_out) and torch.equal(out_len[:64], ref_len),
          "K5 differs from the reference emission on the first 64 rows")
    # Work the data needs: one source byte per output byte below out_len,
    # every output byte written, and every plan row that some live group's
    # window covers, once: neighbouring groups share a row where a window
    # ends mid-row, and memory moves that row once. Operations: a binary
    # search of its window per output byte and a scan step per window entry,
    # in every group.
    gs = torch.arange(emit.N_GROUPS, device=dev)[None, :] * emit.GROUP
    live_g = gs < out_len[:, None]
    rows_w = torch.where(live_g, rows_g.clamp(0, emit.BP_WIN_ROWS), 0)
    win = (rows_w * emit.LANES).to(torch.int64)
    live_d = (out_len[:, None] - gs).clamp(0, emit.GROUP).to(torch.int64)
    search = (live_d * (6 + 4 * torch.ceil(torch.log2(win.double() + 1)).long())).sum()
    ops5 = int(search + 4 * win.sum())
    n_bp_rows = bp_rows.shape[1]
    w_lo = lo_row.clamp(0, n_bp_rows).to(torch.int64)
    w_hi = torch.maximum((lo_row + rows_w).clamp(0, n_bp_rows).to(torch.int64), w_lo)
    cover = torch.zeros((rows, n_bp_rows + 1), dtype=torch.int32, device=dev)
    cover.scatter_add_(1, w_lo, live_g.to(torch.int32))
    cover.scatter_add_(1, w_hi, -live_g.to(torch.int32))
    covered_rows = int((cover.cumsum(1)[:, :n_bp_rows] > 0).sum())
    win_bytes = 8 * emit.LANES * covered_rows + 12 * int(live_g.sum())
    report["emit_window_rows"] = {"covered": covered_rows, "per_group_sum": int(rows_w.sum())}
    sum_len = int(out_len.to(torch.int64).sum())
    out_bytes = rows * emit.N_GROUPS * emit.GROUP
    # The yardstick of the gather: torch.gather over int64 indices into the
    # rows with a zero column appended (index W for d >= out_len).
    d_all = torch.arange(out_bytes // rows, device=dev)[None, :]
    absidx = torch.where(d_all < out_len[:, None], idx6.to(torch.int64), src.shape[1])
    padded = torch.cat([src, torch.zeros_like(src[:, :1])], dim=1)
    check(torch.equal(torch.gather(padded, 1, absidx), out6), "torch.gather yardstick")
    for name, got, want, fn, plain, nbytes, ops, lib, where in (
        ("fused_emit", out5, want5,
         lambda: emit.fused_emit(*plan, src), lambda: emit.fused_emit_plain(*plan, src),
         win_bytes + sum_len + out_bytes + 4 * rows, ops5, None,
         "snappy_tpu/ops/pallas/encode_flat.py:668 fused_emit_pallas"),
        ("shift_idx", idx6, idx_plain,
         lambda: emit.shift_idx(*plan), lambda: emit.shift_idx_plain(*plan),
         win_bytes + 4 * out_bytes + 4 * rows, ops5, None,
         "snappy_tpu/ops/pallas/encode_flat.py:323 shift_idx_pallas"),
        ("emit_bytes", out6, want6,
         lambda: emit.emit_bytes(src, idx6, out_len),
         lambda: emit.emit_bytes_plain(src, idx6, out_len),
         5 * sum_len + out_bytes + 4 * rows, 0, lambda: torch.gather(padded, 1, absidx),
         "snappy_tpu/ops/pallas/encode_flat.py:474 emit_bytes_pallas"),
    ):
        # "ms" device-only: the wrappers read nothing back, so their calls go
        # into a CUDA graph; "call_ms" over wrapper calls. torch.gather, K6's
        # yardstick, likewise.
        bnd, by = bound_ms(nbytes, ops)
        kernels.append({
            "name": name, "route": "cuda", "source": "snappy_tpu_torch/csrc/emit.cu",
            "replaces": where, "shape": [rows, emit.N_GROUPS * emit.GROUP],
            "equal": torch.equal(got, want), "max_abs_err": max_abs_err(got, want),
            "ms": device_ms(fn, 10), "call_ms": cuda_ms(fn, 20),
            "plain_ms": cuda_ms(plain, 1, warm=0), "bound_ms": bnd, "bound_by": by,
            "library_ms": device_ms(lib, 10) if lib else None,
            "library_call_ms": cuda_ms(lib, 20) if lib else None,
        })
    k5, k6a, k6b = kernels[-3:]
    # Device memory moves 32-byte sectors: the sectors K6's gather reads (a
    # header byte's cell is one) bound it more tightly than a byte each.
    k6b["src_sectors"] = gather_sectors(src, idx6, out_len)
    k6b["bound_with_sectors_ms"] = bound_ms(
        4 * sum_len + 32 * k6b["src_sectors"] + out_bytes + 4 * rows)[0]
    print(f"K6: shift_idx {k6a['ms']:.6f} ms device-only, {k6a['call_ms']:.6f} over calls "
          f"(bound {k6a['bound_ms']:.6f}); emit_bytes {k6b['ms']:.6f} device-only, "
          f"{k6b['call_ms']:.6f} over calls (bound {k6b['bound_ms']:.6f}, with the "
          f"{k6b['src_sectors']} source sectors it reads {k6b['bound_with_sectors_ms']:.6f}; torch.gather "
          f"{k6b['library_ms']:.6f} device-only, {k6b['library_call_ms']:.6f} over calls)",
          flush=True)
    # K5's walk, followed in numpy (emit.fused_emit_walk), must give the plain
    # version's indices on the group's first 16 rows.
    walk_rows = [x[:16].cpu() for x in plan]
    k5["walk_equals_plain"] = torch.equal(emit.fused_emit_walk(*walk_rows),
                                          emit.shift_idx_plain(*walk_rows))
    check(k5["walk_equals_plain"], "K5's walk model differs from its plain version")
    # K6's gather on edge rows (emit.edge_batch): lengths 0, 1, 15, 16, 17,
    # 1,023, 1,025 and 81,920, indices -1, src_w and src_w - 1, batches of one
    # row and of 2,049.
    k6b["edge_rows_equal"] = all(
        torch.equal(emit.emit_bytes(*e), emit.emit_bytes_plain(*e))
        for e in (emit.edge_batch(lens, dev) for lens in
                  [[n] for n in emit.EDGE_LENS] + [[emit.EDGE_LENS[i % 8] for i in range(2049)]]))
    check(k6b["edge_rows_equal"], "K6's emit_bytes differs from its plain version on edge rows")
    print(f"K5: {k5['ms']:.6f} ms device-only, {k5['call_ms']:.6f} over calls (bound "
          f"{k5['bound_ms']:.6f}); its walk model equals the plain version on 16 rows")
    check(torch.equal(out5, out6), "K5 and K6 give different bytes")
    check(all(k["equal"] for k in kernels[-3:]), "K5 or K6 differs from its plain version")

    # -- K7 exact encoder ----------------------------------------------------------------
    # Against its plain version on 8 corpus blocks of 64 KiB (a Python loop of
    # small launches per automaton step), timed on the compress path's own
    # launch group. Its bound, two ways: the bytes (every live block read once,
    # every output row and length written once), and the serial work: the
    # most automaton steps of any block of the group, which the plain version
    # counts (K7 takes exactly these steps, each after the last), at one step
    # per clock of the SM's highest clock.
    sample = list(range(0, 64, 8))
    sb, sl = cb[sample].contiguous(), cl[sample].contiguous()
    got7 = encode.compress_blocks(sb, sl)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want7 = encode.compress_blocks_plain(sb, sl)
    torch.cuda.synchronize()
    plain7_ms = (time.perf_counter() - t0) * 1e3
    eq7 = all(torch.equal(g, w) for g, w in zip(got7, want7))
    check(eq7, "K7 differs from its plain version on 8 corpus blocks")
    t0 = time.perf_counter()
    *_, scan_steps, extend_steps = encode.find_ops_lockstep(cb, cl)
    steps = (scan_steps + extend_steps)[: len(clens)]
    report["encode_steps"] = {
        "max": int(steps.max()), "mean": float(steps.double().mean()),
        "scan_max": int(scan_steps.max()), "extend_max": int(extend_steps.max()),
        "count_s": time.perf_counter() - t0,
    }
    # K7's own chain: scan rounds of up to 32 probes and 128-byte quanta
    # (find_ops_rounds, the host's copy of its walk, about a second a block
    # here), on the busiest block of the group and the 8 blocks above; the
    # quanta of every block are the lockstep's extension steps.
    busiest = int(steps.argmax())
    picked = [busiest] + sample
    *_, r_rounds, r_quanta, r_probes = encode.find_ops_rounds(cblocks[picked], clens[picked])
    check(torch.equal(r_quanta, extend_steps[picked].cpu())
          and torch.equal(r_probes, scan_steps[picked].cpu()),
          "find_ops_rounds and find_ops_lockstep count different steps")
    report["encode_rounds"] = {
        "busiest_block": busiest, "busiest_rounds": int(r_rounds[0]),
        "busiest_quanta": int(r_quanta[0]), "busiest_steps": int(steps[busiest]),
        "sample_rounds": r_rounds[1:].tolist(), "sample_quanta": r_quanta[1:].tolist(),
        "sample_steps": steps[sample].tolist(),
    }
    t_bytes7 = (int(clens.sum()) + 4 * rows + rows * (encode.OUT_W + 4)) / PEAK_BYTES_PER_S * 1e3
    t_serial7 = int(steps.max()) / (sm_mhz * 1e6) * 1e3
    # Timed device-only through K7's C entry (the wrapper reads the lengths
    # back to check them, a host sync that a CUDA graph cannot hold), and
    # over wrapper calls; the entry's bytes are the wrapper's.
    o7 = torch.empty((rows, encode.OUT_W), dtype=torch.uint8, device=dev)
    ol7 = torch.empty(rows, dtype=torch.int32, device=dev)

    def k7_entry():
        _build.check(encode._kernel()(cb.data_ptr(), cb.shape[1], cl.data_ptr(), rows, o7.data_ptr(),
                                      ol7.data_ptr(), torch.cuda.current_stream().cuda_stream), "encode")

    k7_ms = device_ms(k7_entry, 5)
    w7, wl7 = encode.compress_blocks(cb, cl)
    check(torch.equal(o7, w7) and torch.equal(ol7, wl7), "K7's C entry and its wrapper differ")
    del o7, ol7, w7, wl7
    kernels.append({
        "name": "encode", "route": "cuda", "source": "snappy_tpu_torch/csrc/encode.cu",
        "replaces": "snappy_tpu/ops/pallas/encode.py:320 compress_blocks_pallas",
        "shape": [rows, 65536], "live_blocks": live_blocks, "equal": eq7,
        "max_abs_err": max(max_abs_err(g, w) for g, w in zip(got7, want7)),
        "ms": k7_ms, "call_ms": cuda_ms(lambda: encode.compress_blocks(cb, cl), 5),
        "plain_ms": plain7_ms, "plain_rows": len(sample),
        "ms_plain_rows": cuda_ms(lambda: encode.compress_blocks(sb, sl), 5),
        "bound_ms": max(t_bytes7, t_serial7),
        "bound_by": "bytes" if t_bytes7 >= t_serial7 else "operations",
        "bound_bytes_ms": t_bytes7, "bound_serial_ms": t_serial7,
        "max_steps": report["encode_steps"]["max"],
        "busiest_rounds": int(r_rounds[0]), "busiest_quanta": int(r_quanta[0]), "library_ms": None,
    })
    print(f"K7: plain version on {len(sample)} blocks {plain7_ms:.1f} ms; steps "
          f"{report['encode_steps']}; rounds {report['encode_rounds']}")
    del sb, sl, got7, want7
    del cb, jw, rec, plan, bp_rows, dlt_rows, src, out5, out6, idx6, idx_plain, want5, want6
    del absidx, padded, ref_out

    # -- K8, K9 and K10 on the frame's largest launch group, as the host scans it -------
    srcs, glens, gd, d_pad = group_inputs(big)
    rec_cap = api._record_cap(srcs.shape[1])
    t0 = time.perf_counter()
    recs, nops, herrs, _ = native.scan_records_batch(
        srcs, glens.astype(np.uint64), np.asarray(gd, np.uint64), rec_cap)
    report["scan_largest_group_s"] = time.perf_counter() - t0
    check(int(nops.max()) <= rec_cap and not herrs.any(), "the scan rejected a corpus chunk")
    r_pad = max(512, -(-int(nops.max()) // 512) * 512)
    s_t, r_t, n_t, d_t = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        srcs, recs[:, :r_pad], nops.astype(np.int32), np.asarray(gd, np.int32)))
    expect = np.zeros((len(big), d_pad), np.uint8)
    plain = native.decompress_batch([write_varu64(gd[j]) + bodies[i] for j, i in enumerate(big)])
    for j, p in enumerate(plain):
        expect[j, : gd[j]] = np.frombuffer(p, np.uint8)
    startsx, payload = resolve.records_to_kernel_inputs(r_t, n_t, d_t, d_pad)
    a0 = resolve.records_to_pointers(r_t, n_t, d_t, d_pad)
    # Bytes the work needs: each input read once (the valid records, 8
    # bytes each, and the lengths; K9's first-hop plane; K10's literal
    # bytes) and each plane or row written once. K8 and K9 also read their
    # own plane back once for every first hop that leaves its window (K8's
    # 4,096 positions) or 1024-byte tile (K9); those reads hit lines the CTA
    # has written before, and are counted only in bound_with_hops_ms.
    n_rec = int(nops.sum())
    pos = torch.arange(d_pad, device=dev)[None, :]
    cross_hops = int(((a0 >= 0) & (a0 < pos // 1024 * 1024)).sum())
    cross_windows = int(((a0 >= 0) & (a0 < pos // 4096 * 4096)).sum())
    valid_rec = torch.arange(r_pad, device=dev)[None, :] < n_t[:, None]
    w0 = r_t[:, :, 0]
    lit_bytes = int(torch.where(valid_rec & (w0 >> 30 == 1), w0 & 0x3FFFFFFF, 0).sum())
    plane_bytes = 4 * len(big) * d_pad
    report["resolve_group"] = {"rows": len(big), "d_pad": d_pad, "records": n_rec,
                               "record_cap": rec_cap, "r_pad": r_pad,
                               "cross_tile_hops": cross_hops, "cross_window_hops": cross_windows,
                               "literal_bytes": lit_bytes}
    w_rounds = records.window_rounds(s_t, r_t, n_t, d_t, d_pad)
    report["resolve_group"]["window_rounds"] = {"max": int(w_rounds.max()),
                                                "mean": float(w_rounds.double().mean())}
    got8 = resolve.resolve_fh(startsx, payload, d_t, d_pad)
    want8 = resolve.resolve_fh_plain(startsx, payload, d_t, d_pad)
    # K8's algorithm in tensor ops: its plane, and its doubling rounds in
    # each window that holds live bytes.
    model8, fh_rounds = resolve.resolve_fh_windows(startsx, payload, d_t, d_pad)
    check(torch.equal(model8, want8), "K8's windowed model differs from its plain version")
    live_win = torch.arange(fh_rounds.shape[1], device=dev)[None, :] * 4096 < d_t[:, None]
    report["resolve_group"]["fh_rounds_per_window"] = {
        "max": int(fh_rounds.max()), "mean": float(fh_rounds[live_win].double().mean())}
    del model8, fh_rounds
    got9 = resolve.resolve(a0)
    want9 = resolve.resolve_reference(a0)
    got10 = records.decode_records(s_t, r_t, n_t, d_t, d_pad)
    want10 = records.decode_records_plain(s_t, r_t, n_t, d_t, d_pad)
    out9, fb9 = resolve.decode_resolve_batch(s_t, r_t, n_t, d_t, d_pad, use_fused=False)
    check(not fb9.any() and bool((out9.cpu().numpy() == expect).all()),
          "K9's path (decode_resolve_batch, use_fused=False) differs from the host codec")
    check(bool((got8 >= resolve.FLAG).all()), "K8 left a chain of a corpus chunk unresolved")
    check(bool((got10.cpu().numpy() == expect).all()), "K10 differs from the host codec")
    for name, got, want, fn, plain_fn, nbytes, hop_bytes, where in (
        ("resolve_fh", got8, want8, lambda: resolve.resolve_fh(startsx, payload, d_t, d_pad),
         lambda: resolve.resolve_fh_plain(startsx, payload, d_t, d_pad),
         8 * n_rec + 4 * len(big) + plane_bytes, 4 * cross_windows,
         "snappy_tpu/ops/pallas/resolve.py:439 resolve_fh_pallas"),
        ("resolve", got9, want9, lambda: resolve.resolve(a0), lambda: resolve.resolve_reference(a0),
         2 * plane_bytes, 4 * cross_hops, "snappy_tpu/ops/pallas/resolve.py:207 resolve_pallas"),
        ("records", got10, want10, lambda: records.decode_records(s_t, r_t, n_t, d_t, d_pad),
         lambda: records.decode_records_plain(s_t, r_t, n_t, d_t, d_pad),
         8 * n_rec + 8 * len(big) + lit_bytes + len(big) * d_pad, 0,
         "snappy_tpu/ops/pallas/decode.py:1451 decode_records_pallas"),
    ):
        bnd, by = bound_ms(nbytes)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"snappy_tpu_torch/csrc/{'records' if name == 'records' else 'resolve'}.cu",
            "replaces": where, "shape": [len(big), srcs.shape[1], d_pad, r_pad],
            "equal": torch.equal(got, want), "max_abs_err": max_abs_err(got, want),
            "ms": cuda_ms(fn, 10), "plain_ms": cuda_ms(plain_fn, 3, warm=1),
            "bound_ms": bnd, "bound_by": by, "library_ms": None,
            "bound_with_hops_ms": bound_ms(nbytes + hop_bytes)[0],
        })
        check(kernels[-1]["equal"], f"{name} differs from its plain version")
    # K8 device-only: its wrapper reads nothing back, so its calls go into a
    # CUDA graph as K2's do; "ms" above is over wrapper calls.
    k8 = next(k for k in kernels if k["name"] == "resolve_fh")
    k8["call_ms"] = k8["ms"]
    k8["ms"] = device_ms(lambda: resolve.resolve_fh(startsx, payload, d_t, d_pad), 10)
    k8["rounds_per_window"] = report["resolve_group"]["fh_rounds_per_window"]
    # K9 likewise: its wrapper reads nothing back.
    k9 = next(k for k in kernels if k["name"] == "resolve")
    k9["call_ms"] = k9["ms"]
    k9["ms"] = device_ms(lambda: resolve.resolve(a0), 10)
    # K9's algorithm in tensor ops: its plane, and its doubling rounds in
    # each window.
    model9, rounds9 = resolve.resolve_windows(a0)
    check(torch.equal(model9, want9), "K9's windowed model differs from its plain version")
    k9["rounds_per_window"] = {"max": int(rounds9.max()), "mean": float(rounds9.double().mean())}
    del model9, rounds9
    print(f"K9: {k9['ms']:.6f} ms device-only, {k9['call_ms']:.6f} over calls "
          f"(bound {k9['bound_ms']:.6f}); doubling rounds a window {k9['rounds_per_window']}")
    # K10 device-only through its C entry (the wrapper reads the counts and
    # lengths back to check them); "ms" above is over wrapper calls.
    o10 = torch.empty((len(big), d_pad), dtype=torch.uint8, device=dev)

    def k10_entry():
        _build.check(records._kernel()(
            s_t.data_ptr(), len(big), srcs.shape[1], r_t.data_ptr(), r_pad, n_t.data_ptr(),
            d_t.data_ptr(), d_pad, o10.data_ptr(), torch.cuda.current_stream().cuda_stream), "records")

    kernels[-1]["call_ms"] = kernels[-1]["ms"]
    kernels[-1]["ms"] = device_ms(k10_entry, 10)
    check(torch.equal(o10, got10), "K10's C entry and its wrapper differ")
    kernels[-1]["window_rounds"] = report["resolve_group"]["window_rounds"]
    del o10
    print(f"K8/K9/K10 group: {report['resolve_group']}, host scan "
          f"{report['scan_largest_group_s']:.4f} s")
    del s_t, r_t, n_t, d_t, startsx, payload, a0, pos, valid_rec, w0
    del got8, want8, got9, want9, got10, want10, out9

    # -- main paths --------------------------------------------------------------------
    # Each entry point runs with every count set to 0 just before it and read
    # just after: the frame stream takes K2 (both layouts) and K1, the
    # flatten-rejected raw stream takes K3, the compress takes K4 and K5, and
    # none takes another's.
    def under(fn, **cfg):
        def run():
            with snappy_tpu_torch.configure(**cfg):
                return fn()
        return run

    def write_frames():
        out = io.BytesIO()
        w = write.FrameEncoder(out, engine="device")
        w.write(data)
        w.flush()
        return out.getvalue()

    def grouped_entry():
        """The v3/v4 entry as the JAX package's tools drive it (no library
        route does): every launch group of whole 16 KiB groups flattened on
        the host, bucketed, and decoded by K11 v3 and v4 on the card. Returns
        each decoded chunk's bytes by chunk index."""
        out = {}
        for g in groups:
            srcs, glens, gd, d_pad = group_inputs(g)
            if d_pad % 16384:
                continue
            idx, tmeta, fallb, _, _ = native.flatten_idx_batch(
                srcs, glens.astype(np.uint64), np.asarray(gd, np.uint64), d_pad, layout=1)
            check(not fallb.any(), "flatten rejected a corpus chunk")
            t = [torch.from_numpy(x).to(dev) for x in (srcs, idx.view(np.int16), tmeta)]
            d_t = torch.from_numpy(np.asarray(gd, np.int32)).to(dev)
            gb = decode_flat.group_buckets(t[2], d_t, d_pad)
            v3 = decode_flat.decode_flat_grouped(*t, gb, d_t, d_pad, 3)
            v4 = decode_flat.decode_flat_grouped(*t, gb, d_t, d_pad, 4)
            check(torch.equal(v3, v4), "K11 v3 and v4 differ on a launch group")
            rows = v3.cpu().numpy()
            out.update((i, rows[j, : gd[j]].tobytes()) for j, i in enumerate(g))
        return out

    def chunk_bytes(decoded):
        want = native.decompress_batch(
            [write_varu64(chunks[i][1]) + bodies[i] for i in sorted(decoded)])
        return list(want) == [decoded[i] for i in sorted(decoded)] and len(decoded) > 0

    host_raw = native.compress(data)
    runs = {
        "frame": (lambda: snappy_tpu_torch.decompress_frame(frame), lambda out: out == data),
        "raw": (lambda: snappy_tpu_torch.decompress(raw_fb), lambda out: out == plain_fb),
        "compress": (lambda: snappy_tpu_torch.compress(data, profile="fast"),
                     lambda out: native.decompress(out) == data),
        "exact": (lambda: snappy_tpu_torch.compress(data), lambda out: out == host_raw),
        "writer": (write_frames, lambda out: out == frame),
        "reader": (lambda: read.FrameDecoder(io.BytesIO(frame), engine="device").read(),
                   lambda out: out == data),
        "frame_resolve": (under(lambda: snappy_tpu_torch.decompress_frame(frame),
                                decode_resolve=True), lambda out: out == data),
        "frame_records": (under(lambda: snappy_tpu_torch.decompress_frame(frame),
                                decode_records=True), lambda out: out == data),
        "reader_records": (under(lambda: read.FrameDecoder(io.BytesIO(frame), engine="device")
                                 .read(), decode_records=True), lambda out: out == data),
        "frame_replay": (under(lambda: snappy_tpu_torch.decompress_frame(frame),
                               decode_flat=False), lambda out: out == data),
        "frame_hosted": (under(lambda: snappy_tpu_torch.decompress_frame(frame),
                               decode_kernels=False), lambda out: out == data),
        "frame_parallel": (under(lambda: snappy_tpu_torch.decompress_frame(frame),
                                 pure_device=True), lambda out: out == data),
        "grouped": (grouped_entry, chunk_bytes),
    }
    by_path, t_cold, results, group_routes = {}, {}, {}, {}
    for path, (fn, ok) in runs.items():
        reset_counts()
        api.routes = []
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results[path] = fn()
        torch.cuda.synchronize()
        t_cold[path] = time.perf_counter() - t0
        by_path[path] = counts()
        group_routes[path], api.routes = api.routes, None
        report.setdefault("peak_device_bytes", {})[path] = torch.cuda.max_memory_allocated() - mem0
        check(ok(results[path]), f"{path} path output differs from the input")
    fr, rw, cp = by_path["frame"], by_path["raw"], by_path["compress"]
    encode_names = ("parse", "fused_emit", "shift_idx", "emit_bytes", "encode")
    scan_names = ("resolve_fh", "resolve", "records")
    grouped_names = ("flat_grouped[v3]", "flat_grouped[v4]")
    for path, c in by_path.items():
        check(path == "grouped" or not any(c[k] for k in grouped_names),
              f"K11 ran on the library's {path} path: {c}")
    c = by_path["grouped"]
    check(c["flat_grouped[v3]"] >= 1 and c["flat_grouped[v3]"] == c["flat_grouped[v4]"]
          and not any(v for k, v in c.items() if k not in grouped_names),
          f"K11 on its entry's path: {c}")
    for path, route in (("frame_hosted", "parallel_hosted"), ("frame_parallel", "parallel")):
        c = by_path[path]
        check(c["crc32c"] >= 1 and not any(v for k, v in c.items() if k != "crc32c"),
              f"the {path} path ran another kernel than K1: {c}")
        check({r[2] for r in group_routes[path]} == {route},
              f"a group of the {path} path left its route: {group_routes[path]}")
    for path in ("frame", "reader"):
        c = by_path[path]
        check(c["crc32c"] == 0 and c["flat_gather_crc"] == 2
              and c["flat_gather[layout=0]"] == 1 and c["flat_gather[layout=1]"] == 1,
              f"K2 with its checksum over the {path} path's groups, one launch a layout, "
              f"and no K1: {c}")
        check(c["replay"] == 0 and not any(c[k] for k in encode_names + scan_names),
              f"K3, a compress kernel or a record-scan kernel ran on the {path} path: {c}")
    c = by_path["frame_resolve"]
    check(c["resolve_fh"] >= 1 and c["flat_gather[layout=1]"] == c["resolve_fh"]
          and c["flat_gather[layout=0]"] >= 1 and c["crc32c"] >= 1,
          f"K8, K2 or K1 on the resolve path: {c}")
    check(not any(c[k] for k in ("replay", "resolve", "records") + encode_names),
          f"the resolve path ran another kernel: {c}")
    check([r for r in group_routes["frame_resolve"] if r[2] == "resolve"]
          == [r for r in group_routes["frame_resolve"] if r[1] % 16384 == 0],
          f"a group left the resolve route: {group_routes['frame_resolve']}")
    for path in ("frame_records", "reader_records"):
        c, rts = by_path[path], group_routes[path]
        overflow = sum(r[2] == "replay" for r in rts)
        check(c["records"] == len(rts) - overflow and c["replay"] == overflow
              and c["crc32c"] >= 1 and {r[2] for r in rts} <= {"records", "replay"},
              f"K10, K3 or K1 on the {path} path: {c}, routes {rts}")
        check(not any(c[k] for k in ("flat_gather[layout=0]", "flat_gather[layout=1]",
                                      "resolve_fh", "resolve") + encode_names),
              f"the {path} path ran another kernel: {c}")
    # decode_flat=False: K3 takes every launch group, then K1 checks it.
    c, rts = by_path["frame_replay"], group_routes["frame_replay"]
    check(c["replay"] == len(groups) and c["crc32c"] == len(groups)
          and not any(v for k, v in c.items() if k not in ("replay", "crc32c"))
          and [r[2] for r in rts] == ["replay"] * len(groups),
          f"K3 and K1 once a group on the frame_replay path: {c}, routes {rts}")
    ex, wr = by_path["exact"], by_path["writer"]
    check(ex["encode"] >= 1 and not any(v for k, v in ex.items() if k != "encode"),
          f"the exact compress path ran other kernels than K7: {ex}")
    check(wr["encode"] >= 1 and wr["crc32c"] >= 1
          and not any(v for k, v in wr.items() if k not in ("encode", "crc32c")),
          f"the frame writer ran other kernels than K1 and K7: {wr}")
    check(rw["replay"] >= 1, "K3 replay did not run on the raw path")
    check(not any(v for k, v in rw.items() if k != "replay"), f"the raw path ran another kernel: {rw}")
    check(cp["parse"] >= 1 and cp["fused_emit"] >= 1, f"K4 or K5 did not run on the compress path: {cp}")
    check(not any(v for k, v in cp.items() if k not in ("parse", "fused_emit")),
          f"the compress path ran another kernel: {cp}")
    # -- the sharded entries; multihost under NCCL; two ranks on one card ------------
    # Each path runs with every count set to 0 just before it and read just
    # after, and must launch exactly its kernels: the sharded compresses K7,
    # or K4 and K5; the frame chunks K1 and K7; the decodes K2 (layout 1),
    # K3, or K8 and K2; compress_segments K7; decode_segments none (the
    # tensor decode from the host's op-start bitmaps).
    def run_counted(path, fn, want):
        return counted_run(by_path, path, fn, want)

    card0 = torch.device("cuda", 0)
    dec_srcs, dec_lens = packing.batch_streams(bodies, 65536)
    dec_declens = np.asarray([c[1] for c in chunks], np.int32)
    cap = api._record_cap(65536)
    recs, nops, herrs, _ = native.scan_records_batch(
        dec_srcs, dec_lens.astype(np.uint64), dec_declens.astype(np.uint64), cap)
    check(not herrs.any() and int(nops.max()) <= cap, "the record scan of the frame's chunks")
    r_pad = max(512, -(-int(nops.max()) // 512) * 512)
    dec = (dec_srcs, dec_lens, dec_declens, np.ascontiguousarray(recs[:, :r_pad]), nops)
    del recs
    want_rows = native.decompress_batch([write_varu64(d) + b for b, d, _ in chunks])
    sharded_s = sharded_paths(
        [[card0], [card0, card0]], data, cblocks, clens, dec, want_rows,
        {"exact": results["exact"], "fast": results["compress"], "frame": results["writer"]},
        run_counted, os.path.join(HERE, "build", "sharded_traces"))
    report["sharded"] = sharded_s
    print(json.dumps({"sharded": sharded_summary(sharded_s)}))
    host_64mib = native.compress(data[: 1024 * 65536])
    report["nccl_world_of_one"] = nccl_world_of_one(
        card0, cblocks, clens, host_64mib, dec, want_rows, run_counted)
    print(f"multihost, NCCL in a world of one: {report['nccl_world_of_one']}")
    del dec, want_rows
    report["two_ranks_one_card"] = two_ranks_on_one_card(card0, data, host_64mib, 512)
    by_path["two_ranks"] = {**{k: 0 for k in counts()}, "encode": sum(
        r["encode_launches"] for r in report["two_ranks_one_card"]["ranks"])}
    print(f"two gloo ranks on cuda:0, 512 blocks each with K7, rows at their offsets equal to "
          f"the host codec's stream: {report['two_ranks_one_card']}")

    # -- the examples and the GPU pipeline --------------------------------------------
    # Each runs with every count set to 0 just before it and read just after.
    report["examples"] = examples_on_the_card(data, frame, [c[1] for c in chunks], run_counted)
    print(f"examples on the card (no engine named): compress {report['examples']['compress_s']:.4f} s "
          f"(the host codec's frame), decompress {report['examples']['decompress_s']:.4f} s "
          f"(the stream back), compress_escaped's lines equal the host engine's, the pipe of "
          f"two processes {report['examples']['pipe_s']:.4f} s; launches "
          f"{ {p: {k: v for k, v in by_path[p].items() if v} for p in by_path if p.startswith('examples')} }")
    report["pipeline"] = pipeline_on_the_card(run_counted)
    print(f"gpu_pipeline at 512 KiB shards: rows on the card equal the CPU run's, losses "
          f"{report['pipeline']['small']['losses_card']} (card) and "
          f"{report['pipeline']['small']['losses_cpu']} (CPU)")
    for k, st in enumerate(report["pipeline"]["full"]["steps"]):
        print(f"gpu_pipeline at 32 MiB shards, step {k}: {json.dumps(st)}")

    # -- a torch.profiler trace of one warm call of the flat route -------------------
    traced, report["flat_trace"] = trace_flat_route(
        lambda: snappy_tpu_torch.decompress_frame(frame), os.path.join(HERE, "chiprun_out", "trace"))
    check(traced == data, "the traced flat route's output differs from the input")
    print(f"flat route trace: {json.dumps(report['flat_trace'])}")
    report["ncu"] = ncu_record()
    print(f"ncu: {report['ncu']}")

    for k in kernels:
        if k["name"] == "flat_gather_groups":  # its launches count under K2's names
            continue
        k["launches_by_path"] = {path: c[k["name"]] for path, c in by_path.items()}
        k["launches"] = sum(k["launches_by_path"].values())

    # The port's contract for compress is the JAX package's bytes, which the
    # CPU tests hold the CPU run to. The card's stream must start with the
    # CPU run's bytes for the first blocks of its launch group (every corpus
    # file, the JPEG included, has a block among them), so the card's
    # prepass and plan at 2,048 rows agree with the CPU's byte for byte.
    n_cmp = 64
    cpu_out, cpu_len = encode_flat.compress_blocks_flat_host(cblocks[:n_cmp], clens[:n_cmp], "cpu")
    want_head = write_varu64(len(data)) + b"".join(
        cpu_out[i, : int(cpu_len[i])].tobytes() for i in range(n_cmp))
    check(results["compress"][: len(want_head)] == want_head,
          f"the card's compressed stream differs from the CPU run in its first {n_cmp} blocks")
    report["compress_equals_cpu"] = {"blocks": n_cmp, "bytes": len(want_head)}
    print(f"compress: the card's first {n_cmp} blocks ({len(want_head)} bytes) equal the CPU run's")
    # The exact path: the host codec's stream over all 1,025 blocks (checked
    # above), and the golden raw stream.
    with open(os.path.join(HERE, "data", "Mark.Twain-Tom.Sawyer.txt"), "rb") as f:
        golden_text = f.read()
    with open(os.path.join(HERE, "data", "Mark.Twain-Tom.Sawyer.txt.rawsnappy"), "rb") as f:
        golden_raw = f.read()
    check(snappy_tpu_torch.compress(golden_text) == golden_raw, "the golden .rawsnappy differs")
    print(f"exact compress: {len(results['exact'])} bytes, equal to the host codec's; "
          "the golden .rawsnappy reproduced; the device frame writer equals native.frame_compress")

    # The frame and compress paths end to end, warm, with timing off; then
    # again with trace.spans on, each run's breakdown against its own
    # end-to-end time.
    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed_paths = ("frame", "frame_resolve", "frame_records", "frame_replay", "frame_hosted",
                   "frame_parallel", "compress", "exact", "writer")
    for path in timed_paths:
        fn = runs[path][0]
        e2e = [timed(fn) for _ in range(3)]
        traced = []
        for _ in range(3):
            trace.spans = {}
            t = timed(fn)
            parts, trace.spans = trace.spans, None
            parts["other"] = t - sum(parts.values())
            # device spans: the kernels and the tensor ops (compress plan, tensor decode)
            on_dev = sum(parts.get(k, 0.0)
                         for k in ("kernels", "prepass", "plan", "assemble", "tensor"))
            traced.append({"e2e_s": t, "parts_s": parts,
                           "kernel_share": parts.get("kernels", 0.0) / t,
                           "device_busy_share": on_dev / t})
        best = min(traced, key=lambda r: r["e2e_s"])
        report[f"{path}_path"] = {
            "launches": by_path[path], "cold_s": t_cold[path],
            "e2e_s": e2e, "e2e_GBps": [len(data) / t / 1e9 for t in e2e],
            "traced": traced,
            "kernels_GBps": len(data) / best["parts_s"].get("kernels", float("nan")) / 1e9,
            "peak_device_bytes": report["peak_device_bytes"][path],
            "routes": group_routes[path],
        }
    report["compress_path"]["ratio"] = len(results["compress"]) / len(data)
    report["compress_path"]["host_codec_bytes"] = len(host_raw)
    print(f"main paths: {len(data)} bytes; frame {len(frame)} bytes, "
          f"{len(chunks)} compressed chunks in groups {report['stream']['groups']}; "
          f"compressed raw {len(results['compress'])} bytes (host codec "
          f"{report['compress_path']['host_codec_bytes']})")
    print(f"  cold (s): {t_cold}")
    print(f"  peak device bytes above the resident set: {report['peak_device_bytes']}")
    for path in timed_paths:
        r = report[f"{path}_path"]
        print(f"  {path} launch groups (rows, d_pad, route, width, live_in, live_out): "
              f"{r['routes']}")
        print(f"  {path} end to end, warm (s): {r['e2e_s']}  GB/s of input/output: {r['e2e_GBps']}")
        for t in r["traced"]:
            print(f"  {path} traced run {t['e2e_s']} s: {t['parts_s']}, kernels "
                  f"{t['kernel_share']}, device busy {t['device_busy_share']}")
    print(f"  launches by path: {by_path}")

    # Every corpus file compressed alone: no larger than the host codec's
    # stream (the reference encoder), and it decodes back.
    sizes = {}
    for name in CORPUS:
        with open(os.path.join(HERE, "data", name), "rb") as f:
            blob = f.read()
        comp = snappy_tpu_torch.compress(blob, profile="fast")
        sizes[name] = {"bytes": len(blob), "port": len(comp), "host_codec": len(native.compress(blob))}
        check(native.decompress(comp) == blob, f"{name} does not decode back")
    report["corpus_sizes"] = sizes
    print(f"corpus file sizes, port vs host codec: {sizes}")
    over = [n for n, s in sizes.items() if s["port"] > s["host_codec"]]
    check(not over, f"compressed larger than the host codec: {over}")

    # A corrupted compressed chunk raises what the host engine raises, on
    # every decode route: a flipped byte inside the first compressed body
    # (the chunk's checksum fails) and its first tag made a copy from
    # before the output's start (the decode fails).
    report["corrupt"] = {}
    for what, at, value in (("body byte", 48, None), ("first tag", 11, 0xFF)):
        bad = bytearray(frame)
        pos = chunks[0][2] + at
        bad[pos] = bad[pos] ^ 0x5A if value is None else value
        bad = bytes(bad)
        want_e = None
        try:
            native.frame_decompress(bad)
        except Exception as e:  # the comparison below is the check
            want_e = e
        check(want_e is not None, f"the host engine decoded the stream with a bad {what}")
        for route, cfg in (("flat", {}), ("resolve", {"decode_resolve": True}),
                           ("records", {"decode_records": True}),
                           ("replay", {"decode_flat": False}),
                           ("parallel_hosted", {"decode_kernels": False}),
                           ("parallel", {"pure_device": True})):
            got_e = None
            try:
                under(lambda: snappy_tpu_torch.decompress_frame(bad), **cfg)()
            except Exception as e:
                got_e = e
            check(type(got_e) is type(want_e) and str(got_e) == str(want_e)
                  and getattr(got_e, "_values", lambda: None)() == want_e._values(),
                  f"a bad {what} on the {route} route: port raised {got_e!r}, "
                  f"host engine {want_e!r}")
        report["corrupt"][what] = repr(want_e)
    print(f"corrupt streams raise what the host engine raises on every route: {report['corrupt']}")

    # The CLI, as a user runs it, in processes of its own on the card: a
    # corpus file compressed with -k and decompressed with -d on the device
    # engine, and a --raw round trip; each result compared with cmp against
    # the original and the host codec's bytes.
    cli_dir = os.path.join(HERE, "chiprun_out", "cli")
    subprocess.run(["rm", "-rf", cli_dir], check=True)
    os.makedirs(os.path.join(cli_dir, "raw"))
    with open(os.path.join(HERE, "data", "lcet10.txt"), "rb") as f:
        text = f.read()
    for name, blob in (("lcet10.txt", text), ("orig.txt", text),
                       ("host.sz", native.frame_compress(text)),
                       ("host.raw", native.compress(text))):
        with open(os.path.join(cli_dir, name), "wb") as f:
            f.write(blob)
    env = {**os.environ, "PYTHONPATH": HERE}

    def szip(*args, cwd=cli_dir):
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "snappy_tpu_torch.cli.szip", "--engine",
                            "device", *args], cwd=cwd, env=env, capture_output=True, text=True)
        check(r.returncode == 0 and not r.stderr, f"szip {args}: {r.returncode} {r.stderr}")
        return time.perf_counter() - t0

    def same(a, b):
        r = subprocess.run(["cmp", a, b], cwd=cli_dir, capture_output=True, text=True)
        check(r.returncode == 0, f"cmp {a} {b}: {r.stdout}{r.stderr}")

    cli_s = {"compress": szip("-k", "lcet10.txt")}
    same("lcet10.txt.sz", "host.sz")
    os.remove(os.path.join(cli_dir, "lcet10.txt"))
    cli_s["decompress"] = szip("-d", "lcet10.txt.sz")
    same("lcet10.txt", "orig.txt")
    cli_s["raw_compress"] = szip("--raw", "-k", "orig.txt")
    same("orig.txt.sz", "host.raw")
    os.replace(os.path.join(cli_dir, "orig.txt.sz"), os.path.join(cli_dir, "raw", "r.sz"))
    cli_s["raw_decompress"] = szip("--raw", "-d", "r.sz", cwd=os.path.join(cli_dir, "raw"))
    same("raw/r", "orig.txt")
    report["cli_s"] = cli_s
    print(f"szip --engine device on {len(text)} bytes: -k, -d and --raw both ways equal the "
          f"original and the host codec's files (cmp); seconds per process {cli_s}")

    # The campaign's device legs on mutated streams, then the benchmark, each
    # in processes of their own.
    campaign_phase(report)
    bench_phase(report)
    tools_phase(report)
    graft_phase(report)

    report["kernels"] = kernels
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    check(all(k["equal"] and k["max_abs_err"] == 0 for k in kernels), "a kernel disagrees")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
