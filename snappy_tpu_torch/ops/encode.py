"""Exact raw-block compression: kernel K7 (``csrc/encode.cu``) and its
plain version.

The port of the JAX package's ``ops/encode.py``. The reference encoder is
a greedy byte-pointer automaton (a hash-table probe loop with an
accelerating skip, match extension and copy emission) whose choices,
hash collisions included, decide the output bytes, so the automaton
itself cannot be reordered; the parallelism is across blocks.

The plain version runs in two phases, as the JAX package does:

- :func:`find_ops` steps every block's automaton in lockstep, one Python
  iteration per step, all lane state in ``(B,)`` tensors. A step runs one
  probe (scan) or one 128-byte match-extension quantum per lane (the JAX
  package compares 16 bytes; only the final match length is observable).
  It records ``(literal, copy)`` ops, not bytes.
- :func:`serialize_ops` turns ops into bytes in closed form per output
  byte: each op's start by a prefix sum, the covering op of every output
  byte by ``scatter_reduce(amax)`` and ``cummax``, then branch-free byte
  synthesis with the reference's copy splitting and literal headers.

:func:`compress_blocks` launches K7 for a CUDA tensor (one warp per block
walks the same automaton, its scan 32 probes a round, and writes the
bytes directly; :func:`find_ops_rounds` follows that walk on the host)
and runs the plain version for a CPU tensor, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..format.constants import (
    HASH_MULTIPLIER,
    INPUT_MARGIN,
    MAX_BLOCK_SIZE,
    MIN_NON_LITERAL_BLOCK_SIZE,
    TAG_COPY1,
    TAG_COPY2,
    TAG_LITERAL,
)
from ..trace import span
from . import _build
from .parse import _tz_bytes

S = MAX_BLOCK_SIZE
#: Worst-case ops per 64 KiB block: copies cover >= 4 bytes each, at most
#: one pending literal per copy, plus the final literal.
MAX_OPS = S // 4 + S // 4 + 4
#: Output row width: >= max_compress_len(65536) = 76490, 256-aligned.
OUT_W = 76800
#: Bytes one extension step compares, in the kernel and the plain version.
QUANTUM = 128
TABLE = 1 << 14

#: Kernel launches since the count was last reset (main-path evidence).
launches = 0

I64 = torch.int64
_SCAN = 0
_EXTEND = 1


def u32_plane(blocks, extra: int):
    """Little-endian u32 at every position of the rows and ``extra``
    positions past them, zeros past the rows; ``(B, W + extra)`` int64."""
    b = blocks.to(I64)
    k = b.shape[1] + extra
    bp = torch.cat([b, torch.zeros((b.shape[0], extra + 3), dtype=I64, device=b.device)], 1)
    return bp[:, :k] | bp[:, 1 : k + 1] << 8 | bp[:, 2 : k + 2] << 16 | bp[:, 3 : k + 3] << 24


def find_ops_lockstep(blocks, lengths):
    """Phase 1, the automaton, with its step counts.

    ``blocks``: ``(B, W)`` uint8 zero-padded, ``W <= 65536``; ``lengths``:
    ``(B,)`` integers in ``[0, W]``. Returns ``(op_kind, op_a, op_b, nops,
    overflow, scan_steps, extend_steps)``: the op planes ``(B, MAX_OPS)``
    int32 (kind 0 a literal of source range ``[a, b)``, kind 1 a copy of
    offset ``a`` and length ``b``), ``nops (B,)`` int32, ``overflow (B,)``
    bool as the JAX package's ``find_ops`` returns them, and each block's
    number of probe steps and of 128-byte extension steps, ``(B,)`` int64:
    K7 takes exactly these steps, one after another.
    """
    bsz, w = blocks.shape
    dev = blocks.device
    u32 = u32_plane(blocks, QUANTUM + 8)
    top = u32.shape[1] - 1
    n = lengths.to(I64)
    rows = torch.arange(bsz, device=dev)

    # Table sizing: bits = clip(ceil_log2(n), 8, 14), the bit length of n - 1.
    nm1 = torch.clamp(n - 1, min=1)
    bits = (nm1[:, None] >= 1 << torch.arange(17, device=dev)).sum(1)
    shift = 32 - bits.clamp(8, 14)

    def hash_(x):
        return ((x * HASH_MULTIPLIER) & 0xFFFFFFFF) >> shift

    def u32at(idx):
        return u32.gather(1, idx.clamp(0, top)[:, None])[:, 0]

    small = n < MIN_NON_LITERAL_BLOCK_SIZE
    s_limit = n - INPUT_MARGIN
    zero = torch.zeros(bsz, dtype=I64, device=dev)
    one = torch.ones_like(zero)
    mode = zero.clone()
    done = small | (n == 0)
    s, s_next, skip = one.clone(), one.clone(), torch.full_like(zero, 32)
    next_emit = zero.clone()
    next_hash = hash_(u32at(one))
    candidate, base, ext_s, ext_cand = zero.clone(), zero.clone(), zero.clone(), zero.clone()
    overflow = torch.zeros(bsz, dtype=torch.bool, device=dev)
    scan_steps, extend_steps = zero.clone(), zero.clone()
    # A masked-off write goes to a spare last column (TABLE, MAX_OPS),
    # which is never read.
    table = torch.zeros((bsz, TABLE + 1), dtype=I64, device=dev)
    planes = torch.zeros((3, bsz, MAX_OPS + 1), dtype=I64, device=dev)
    q_off = torch.arange(0, QUANTUM, 4, device=dev)[None, :]
    q_pos = q_off.expand(bsz, -1)

    # Small blocks are one literal op.
    emit_small = small & (n > 0)
    planes[2, :, 0] = torch.where(emit_small, n, 0)
    nops = emit_small.to(I64)

    def record_op(active, kind, a, b):
        nonlocal nops, overflow
        overflow = overflow | (active & (nops >= MAX_OPS))
        at = torch.where(active, nops.clamp(max=MAX_OPS - 1), MAX_OPS)[:, None]
        vals = torch.stack([torch.broadcast_to(torch.as_tensor(v, device=dev), (bsz,))
                            for v in (kind, a, b)])
        planes.scatter_(2, at[None].expand(3, -1, -1), vals[..., None])
        nops = nops + active.to(I64)

    def finish(active):
        nonlocal done
        record_op(active & (next_emit < n), 0, next_emit, n)
        done = done | active

    # A step of a finished lane changes nothing, so on the card the loop
    # reads `done` back (a synchronisation) only every 16 steps.
    check_every = 1 if dev.type == "cpu" else 16
    step = 0
    while step % check_every or not bool(done.all()):
        step += 1
        # -- scan: one probe ----------------------------------------------
        act = ~done & (mode == _SCAN)
        s_new = s_next
        bb = skip >> 5
        s_next2 = s_new + bb
        out_of_input = s_next2 > s_limit
        probe = act & ~out_of_input
        cand = table[rows, next_hash]
        table[rows, torch.where(probe, next_hash, TABLE)] = s_new
        pair = u32.gather(1, torch.stack([s_new, cand], 1).clamp(0, top))
        matched = probe & (pair[:, 0] == pair[:, 1])
        scan_steps = scan_steps + act.to(I64)
        s = torch.where(act, s_new, s)
        s_next = torch.where(act, s_next2, s_next)
        skip = torch.where(act, skip + bb, skip)
        next_hash = torch.where(probe, hash_(u32at(s_next2)), next_hash)
        candidate = torch.where(matched, cand, candidate)
        record_op(matched & (s > next_emit), 0, next_emit, s)
        base = torch.where(matched, s, base)
        ext_s = torch.where(matched, s + 4, ext_s)
        ext_cand = torch.where(matched, cand + 4, ext_cand)
        mode = torch.where(matched, _EXTEND, mode)
        finish(act & out_of_input)

        # -- extend: one quantum ------------------------------------------
        act = ~done & (mode == _EXTEND)
        es, ec = ext_s, ext_cand
        x = (u32.gather(1, (es[:, None] + q_pos).clamp(0, top))
             ^ u32.gather(1, (ec[:, None] + q_pos).clamp(0, top)))
        first = torch.where(x != 0, q_off + _tz_bytes(x), QUANTUM).amin(1)
        ext = torch.minimum(first, n - es)
        es2 = es + ext
        finished = act & ((first < QUANTUM) | (ext < first))
        extend_steps = extend_steps + act.to(I64)
        ext_s = torch.where(act, es2, es)
        ext_cand = torch.where(act, ec + ext, ec)
        record_op(finished, 1, base - candidate, es2 - base)
        next_emit = torch.where(finished, es2, next_emit)
        s = torch.where(finished, es2, s)
        hit_limit = finished & (es2 >= s_limit)
        finish(hit_limit)
        cont = finished & ~hit_limit

        # the double table update after a copy, and the re-match check
        table[rows, torch.where(cont, hash_(u32at(s - 1)), TABLE)] = s - 1
        cur = u32at(s)
        ch = hash_(cur)
        cand = table[rows, ch]
        table[rows, torch.where(cont, ch, TABLE)] = s
        again = cont & (cur == u32at(cand))
        candidate = torch.where(again, cand, candidate)
        base = torch.where(again, s, base)
        ext_s = torch.where(again, s + 4, ext_s)
        ext_cand = torch.where(again, cand + 4, ext_cand)
        back = cont & ~again
        next_hash = torch.where(back, hash_(u32at(s + 1)), next_hash)
        s = torch.where(back, s + 1, s)
        s_next = torch.where(back, s, s_next)
        skip = torch.where(back, 32, skip)
        mode = torch.where(back, _SCAN, mode)

    op_kind, op_a, op_b = (p[:, :MAX_OPS].to(torch.int32) for p in planes)
    return (op_kind, op_a, op_b, nops.to(torch.int32), overflow, scan_steps, extend_steps)


def find_ops(blocks, lengths):
    """Phase 1: ``(op_kind, op_a, op_b, nops, overflow)`` as the JAX
    package's ``find_ops`` returns them (see :func:`find_ops_lockstep`)."""
    return find_ops_lockstep(blocks, lengths)[:5]


# ---------------------------------------------------------------------------
# K7's round structure, on the host
# ---------------------------------------------------------------------------

LANES = 32


def _advance_table() -> np.ndarray:
    """``A[k]``: how far probe ``k`` of a scan run lies from the run's
    start. Every (re)start sets ``skip`` to 32 and probe ``k`` advances by
    ``skip >> 5`` then grows ``skip`` by as much, whatever the data, so the
    positions of a run are known before any probe is made. The table runs
    until a run from position 1 passes any 64 KiB block, plus a round of
    lanes."""
    a, skip = [0], 32
    while a[-1] <= S:
        a.append(a[-1] + (skip >> 5))
        skip += skip >> 5
    for _ in range(LANES):
        a.append(a[-1] + (skip >> 5))
        skip += skip >> 5
    return np.asarray(a, np.int64)


ADVANCE = _advance_table()


def _block_rounds(row: np.ndarray, n: int):
    """One block's automaton as K7 walks it: ``(ops, rounds, quanta,
    probes)``, ``probes`` the serial scan steps (:func:`find_ops_lockstep`'s
    ``scan_steps``).

    A scan round is one warp's 32 probes of a run at once: lane ``j``
    probes ``r + A[k0 + j]`` and exists while the next position stays
    within ``s_limit``. Lane ``j``'s candidate is the position of the
    highest earlier lane of the round with the same hash, or else the
    table's entry. The first matching lane ends the round; the lanes up to
    it store their positions, a lane only when no later storing lane shares
    its hash (so the table ends as the serial stores leave it). After a
    copy ending at ``s``, ``h(s - 1) <- s - 1`` and the re-match probe at
    ``s`` come first, on their own; if it misses, the run restarts from
    ``s + 1``. An extension quantum compares 128 bytes."""
    if n < MIN_NON_LITERAL_BLOCK_SIZE:
        return ([(0, 0, n)] if n else []), 0, 0, 0
    src = np.zeros(n + 2 * QUANTUM + 8, np.int64)
    src[:n] = row[:n]
    u32 = src[:-3] | src[1:-2] << 8 | src[2:-1] << 16 | src[3:] << 24
    bits = min(max(int(n - 1).bit_length(), 8), 14)
    hashes = ((u32 * HASH_MULTIPLIER) & 0xFFFFFFFF) >> (32 - bits)
    top = len(u32) - 1
    table = np.zeros(TABLE, np.int64)
    s_limit = n - INPUT_MARGIN
    lanes = np.arange(LANES)
    earlier = lanes[:, None] < lanes[None, :]  # [i, j]: lane i comes before lane j
    ops, rounds, quanta, probes = [], 0, 0, 0
    next_emit, run, k0 = 0, 1, 0
    s = None  # a match the re-match probe found
    while True:
        if s is None:
            rounds += 1
            k = k0 + lanes
            pos = np.minimum(run + ADVANCE[k], top)
            valid = run + ADVANCE[k + 1] <= s_limit
            h = hashes[pos]
            peer = np.where((h[:, None] == h[None, :]) & earlier, lanes[:, None], -1).max(0)
            cand = np.where(peer >= 0, pos[np.maximum(peer, 0)], table[h])
            hit = np.flatnonzero(valid & (u32[pos] == u32[cand]))
            if not hit.size and not valid.all():
                probes += int(np.argmin(valid)) + 1  # the last step makes no probe
                if next_emit < n:
                    ops.append((0, next_emit, n))
                break
            last = hit[0] if hit.size else LANES - 1
            probes += last + 1
            # Storing lanes whose hash no later storing lane shares.
            hs = h[: last + 1][::-1]
            _, first_from_end = np.unique(hs, return_index=True)
            keep = last - first_from_end
            table[h[keep]] = pos[keep]
            if not hit.size:
                k0 += LANES
                continue
            s, c = int(pos[last]), int(cand[last])
            if s > next_emit:
                ops.append((0, next_emit, s))
        es, ec = s + 4, c + 4
        while True:
            quanta += 1
            diff = np.flatnonzero(src[es : es + QUANTUM] != src[ec : ec + QUANTUM])
            first = int(diff[0]) if diff.size else QUANTUM
            ext = min(first, n - es)
            es, ec = es + ext, ec + ext
            if first < QUANTUM or ext < first:
                break
        ops.append((1, s - c, es - s))
        next_emit = es
        if es >= s_limit:
            if es < n:
                ops.append((0, es, n))
            break
        s, run, k0 = None, es + 1, 0
        table[hashes[es - 1]] = es - 1
        c = int(table[hashes[es]])
        table[hashes[es]] = es
        if u32[es] == u32[c]:
            s = es
    return ops, rounds, quanta, probes


def find_ops_rounds(blocks, lengths):
    """The automaton as K7's scan rounds take it, one block after another
    on the host (numpy), for the tests and the step report.

    Takes what :func:`find_ops_lockstep` takes and returns ``(op_kind,
    op_a, op_b, nops, overflow, rounds, quanta, probes)``: the same op
    planes (CPU tensors), and each block's scan rounds (32 probes at most)
    and 128-byte extension quanta, which K7 takes one after another
    beside a re-match probe after every copy, and its serial scan steps,
    ``(B,)`` int64."""
    rows = np.asarray(blocks.cpu() if isinstance(blocks, torch.Tensor) else blocks, np.uint8)
    lens = np.asarray(lengths.cpu() if isinstance(lengths, torch.Tensor) else lengths)
    bsz = rows.shape[0]
    planes = np.zeros((3, bsz, MAX_OPS), np.int32)
    nops = np.zeros(bsz, np.int32)
    rounds = np.zeros(bsz, np.int64)
    quanta = np.zeros(bsz, np.int64)
    probes = np.zeros(bsz, np.int64)
    for b in range(bsz):
        ops, rounds[b], quanta[b], probes[b] = _block_rounds(rows[b], int(lens[b]))
        nops[b] = len(ops)
        if ops:
            planes[:, b, : len(ops)] = np.asarray(ops, np.int32).T
    t = torch.from_numpy
    return (t(planes[0]), t(planes[1]), t(planes[2]), t(nops),
            torch.zeros(bsz, dtype=torch.bool), t(rounds), t(quanta), t(probes))


# ---------------------------------------------------------------------------
# Phase 2: closed-form serialization
# ---------------------------------------------------------------------------


def _copy_split(off, clen):
    """The reference's copy splitting: ``(n64, peel60, rem, use_copy1)``."""
    n64 = torch.where(clen >= 68, (clen - 68) // 64 + 1, 0)
    rem1 = clen - 64 * n64
    peel60 = (rem1 > 64).to(clen.dtype)
    rem = rem1 - 60 * peel60
    return n64, peel60, rem, (rem <= 11) & (off <= 2047)


def _emit_sizes(op_kind, op_a, op_b, valid):
    """Emitted byte count per op (closed-form tag splitting)."""
    lit_len = op_b - op_a
    llm1 = lit_len - 1
    lit_sz = torch.where(llm1 <= 59, 1, torch.where(llm1 < 256, 2, 3)) + lit_len
    n64, peel60, _, use_copy1 = _copy_split(op_a, op_b)
    copy_sz = 3 * n64 + 3 * peel60 + torch.where(use_copy1, 2, 3)
    return torch.where(valid, torch.where(op_kind == 0, lit_sz, copy_sz), 0)


def serialize_ops(blocks, op_kind, op_a, op_b, nops):
    """Phase 2: ops -> raw op-stream bytes.

    Returns ``(out (B, OUT_W) uint8, out_len (B,) int32)``, no varint
    preamble, zero past ``out_len``, as the JAX package's
    ``serialize_ops``."""
    bsz, w = blocks.shape
    dev = blocks.device
    i32 = torch.int32
    op_kind, op_a, op_b = (t.to(i32) for t in (op_kind, op_a, op_b))
    oi = torch.arange(MAX_OPS, dtype=i32, device=dev)[None, :]
    valid = oi < nops.to(i32)[:, None]

    sizes = _emit_sizes(op_kind, op_a, op_b, valid)
    ends = torch.cumsum(sizes, 1, dtype=i32)
    starts = ends - sizes
    out_len = ends[:, -1]

    # Covering op per output byte: each op's index at its start offset
    # (a spare column takes the rest), then a running max.
    live = valid & (sizes > 0)
    pos = torch.where(live, starts, OUT_W).clamp(max=OUT_W).to(I64)
    cover = torch.full((bsz, OUT_W + 1), -1, dtype=i32, device=dev)
    cover.scatter_reduce_(1, pos, torch.where(live, oi, -1).expand(bsz, -1), "amax")
    cover = torch.cummax(cover[:, :OUT_W], 1).values
    cov = cover.clamp(0, MAX_OPS - 1).to(I64)

    kind, a, b, start = (t.gather(1, cov) for t in (op_kind, op_a, op_b, starts))
    p = torch.arange(OUT_W, dtype=i32, device=dev)[None, :]
    rel = p - start

    # literal bytes
    llm1 = b - a - 1
    hdr = torch.where(llm1 <= 59, 1, torch.where(llm1 < 256, 2, 3))
    h0 = torch.where(
        llm1 <= 59, (llm1 << 2) | TAG_LITERAL,
        torch.where(hdr == 2, (60 << 2) | TAG_LITERAL, (61 << 2) | TAG_LITERAL),
    )
    lit_hdr = torch.where(rel == 0, h0, torch.where(rel == 1, llm1 & 0xFF, (llm1 >> 8) & 0xFF))
    content = blocks.gather(1, (a + rel - hdr).clamp(0, w - 1).to(I64)).to(i32)
    lit_byte = torch.where(rel < hdr, lit_hdr, content)

    # copy bytes: 64-byte peels, an optional 60-byte peel, the copy1/copy2 tail
    off = a
    n64, peel60, rem, use_copy1 = _copy_split(a, b)
    in64 = rel < 3 * n64
    in60 = ~in64 & (rel < 3 * (n64 + peel60))
    j = rel % 3
    tail_rel = rel - 3 * (n64 + peel60)
    sub_len = torch.where(in64, 64, torch.where(in60, 60, rem))
    copy_byte = torch.where(
        in64 | in60,
        torch.where(j == 0, ((sub_len - 1) << 2) | TAG_COPY2, torch.where(j == 1, off & 0xFF, off >> 8)),
        torch.where(
            use_copy1,
            torch.where(tail_rel == 0, ((off >> 8) << 5) | ((rem - 4) << 2) | TAG_COPY1, off & 0xFF),
            torch.where(tail_rel == 0, ((rem - 1) << 2) | TAG_COPY2,
                        torch.where(tail_rel == 1, off & 0xFF, off >> 8)),
        ),
    )
    byte = torch.where(kind == 0, lit_byte, copy_byte)
    byte = torch.where((cover >= 0) & (p < out_len[:, None]), byte, 0)
    return byte.to(torch.uint8), out_len


def compress_blocks_plain(blocks, lengths):
    """:func:`find_ops`, then :func:`serialize_ops`; an overflowed lane's
    ``out_len`` is poisoned to ``OUT_W + 1``, as in the JAX package."""
    op_kind, op_a, op_b, nops, overflow = find_ops(blocks, lengths)
    out, out_len = serialize_ops(blocks, op_kind, op_a, op_b, nops)
    return out, torch.where(overflow, OUT_W + 1, out_len)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


@functools.cache
def _kernel():
    fn = _build.kernel_lib("encode").stpu_cuda_encode
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_int64, p, ctypes.c_int64, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def compress_blocks(blocks, lengths):
    """Compress a ``(B, W)`` batch of independent blocks, exactly.

    ``blocks``: uint8, zero-padded, ``W % 128 == 0`` and ``W <= 65536``;
    ``lengths``: ``(B,)`` int32 in ``[0, W]``. Returns ``(out (B, 76800)
    uint8, out_len (B,) int32)``: per-block raw op streams, byte for byte
    the reference encoder's (no varint preamble), zero past ``out_len``.
    A CUDA input launches K7 (or raises); a CPU input runs
    :func:`compress_blocks_plain`.
    """
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise TypeError(f"blocks must be a 2-D uint8 tensor, got {blocks.dtype} {tuple(blocks.shape)}")
    b, w = blocks.shape
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise TypeError(f"lengths must be int32 of shape ({b},)")
    if w % 128 or w > S:
        raise ValueError(f"row width {w} must be a multiple of 128 and at most {S}")
    if lengths.device != blocks.device:
        raise ValueError("blocks and lengths must be on one device")
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {blocks.device}")
    if b and (int(lengths.min()) < 0 or int(lengths.max()) > w):
        raise ValueError(f"lengths must lie in [0, {w}]")
    if blocks.device.type == "cpu":
        return compress_blocks_plain(blocks, lengths)
    if not (blocks.is_contiguous() and lengths.is_contiguous()) or blocks.data_ptr() % 16:
        raise ValueError("inputs must be contiguous and blocks 16-byte aligned")
    out = torch.empty((b, OUT_W), dtype=torch.uint8, device=blocks.device)
    out_len = torch.empty(b, dtype=torch.int32, device=blocks.device)
    if b == 0:
        return out, out_len
    if b > 2**31 - 1:
        raise ValueError(f"{b} rows exceed one launch's grid")
    _build.count(globals(), "launches")
    _build.launch(blocks.device, "encode", _kernel(),
                  blocks.data_ptr(), w, lengths.data_ptr(), b, out.data_ptr(), out_len.data_ptr())
    return out, out_len


def compress_blocks_host(blocks: np.ndarray, lengths: np.ndarray, device):
    """Host-facing wrapper: numpy blocks and lengths in, numpy ``(out,
    out_len)`` out, computed on ``device``. A poisoned ``out_len`` (an
    op-count overflow, which the bound argument rules out) raises."""
    dev = torch.device(device)
    with span("h2d"):
        blocks_t = torch.from_numpy(np.ascontiguousarray(blocks, np.uint8)).to(dev)
        lens_t = torch.from_numpy(np.asarray(lengths, np.int32)).to(dev)
    with span("kernels", dev):
        out, out_len = compress_blocks(blocks_t, lens_t)
    with span("d2h"):
        out, out_len = out.cpu().numpy(), out_len.cpu().numpy()
    if np.any(out_len > OUT_W):
        raise RuntimeError(
            "device encoder op-count overflow (MAX_OPS bound violated); "
            "this is a bug — the bound argument covers every valid block"
        )
    return out, out_len
