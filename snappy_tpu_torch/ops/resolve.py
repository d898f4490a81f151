"""Copy-chain resolution on the card from the host's op records: kernels K8
and K9 (``csrc/resolve.cu``).

The port of the JAX package's ``ops/resolve.py``. The host contributes only
the O(records) validated op scan (``native.scan_records_batch``): one packed
``(len, payload)`` int32 pair per op. Everything per byte happens on the
card:

1. each byte's first hop: ``FLAG + content + j`` for the ``j``-th byte of a
   literal (resolved: an absolute source index, biased by :data:`FLAG`), or
   ``start - off + (j mod off)`` for a copy (an earlier output position;
   ``j mod off`` covers overlapping copies, whose period is the offset);
2. pointer jumping until every byte carries ``FLAG``: K8 (:func:`resolve_fh`)
   builds the first hops itself from the records and doubles them window
   by window in shared memory (:func:`resolve_fh_windows` follows it), K9
   (:func:`resolve`) reads them from the plane :func:`records_to_pointers`
   makes and doubles them in the same windows (:func:`resolve_windows`
   follows it);
3. :func:`idx_to_v2_inputs`: the resolved plane to the flat gather's inputs,
   the C++ flatten's window choice bit for bit, and K2 (``layout=1``) emits
   the bytes.

The host scan validates in lockstep with the replay kernel (same checks,
order and codes), so the route reproduces the replay decode's bytes and
error codes; records cover the valid prefix only.

Each wrapper launches its kernel on a CUDA tensor (or raises) and runs its
plain version on a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..trace import span
from . import _build
from .decode_flat import decode_flat

#: Resolution flag: values ``>= FLAG`` are final absolute source indices
#: (biased by ``FLAG``). Source rows of the route are at most 64 KiB, so
#: source indices fit 17 bits.
FLAG = 1 << 17

#: K9's doubling rounds a window of 4,096 positions after its first hops:
#: doubling covers 2^12 hops by then, past the 4,095 a window can chain
#: (the JAX package's tile of 1,024 takes one first round and
#: ``_MAX_PASSES``, 11).
MAX_ROUNDS = 12

#: Kernel launches since the counts were last reset, per kernel.
launches = {"resolve_fh": 0, "resolve": 0}


def _fields(recs, nops):
    """Per-record ``(valid, ln, starts, payload)``, all ``(B, CAP)`` int64;
    ``payload = islit << 17 | (w1 & 0x1FFFF)``, and records at and past
    ``nops`` count as empty copies."""
    cap = recs.shape[1]
    w0 = recs[:, :, 0].to(torch.int64)
    valid = torch.arange(cap, device=recs.device)[None, :] < nops.to(torch.int64)[:, None]
    islit = torch.where(valid, (w0 >> 30) & 1, 0)
    ln = torch.where(valid, w0 & 0x3FFFFFFF, 0)
    starts = torch.cumsum(ln, dim=1) - ln
    payload = (islit << 17) | (recs[:, :, 1].to(torch.int64) & 0x1FFFF)
    return valid, ln, starts, payload


def _first_hops(start, payload, d, declens):
    """First hop of every byte ``d`` from its covering record's ``start`` and
    ``payload`` (``islit << 17 | w1``); ``FLAG`` at and past ``declen``."""
    islit = payload >> 17
    w1 = payload & 0x1FFFF
    j = d - start
    off = w1.clamp(min=1)
    jj = torch.where(j < off, j, j % off)
    hop = torch.where(islit == 1, FLAG + w1 + j, start - off + jj)
    live = d < declens.to(torch.int64)[:, None]
    return torch.where(live, hop, FLAG)


def records_to_pointers(recs, nops, declens, d_pad: int):
    """Op records to the first-hop plane ``a0`` (``(B, d_pad)`` int32).

    ``recs``: ``(B, CAP, 2)`` int32 from ``native.scan_records_batch``
    (``w0 = len | literal << 30``; ``w1`` the content index of a literal or
    the offset of a copy); records at and past ``nops`` are ignored. The
    covering record's fields reach its bytes by a scatter of packed keys at
    each record's start and a running max (keys rise with the starts), as
    ``snappy_tpu/ops/resolve.py`` does; a byte no record covers decodes its
    all-ones key. The JAX function's ``rmeta`` (matrix-unit gather windows)
    has no use here.
    """
    if d_pad > 1 << 16:
        raise ValueError(f"d_pad {d_pad}: the route packs positions in 16 bits")
    b = recs.shape[0]
    valid, ln, starts, payload = _fields(recs, nops)
    pos = torch.where(valid & (ln > 0), starts, d_pad)
    keys = []
    for key in ((starts << 15) | (payload & 0x7FFF), (starts << 3) | (payload >> 15)):
        z = torch.full((b, d_pad + 1), -1, dtype=torch.int64, device=recs.device)
        z.scatter_reduce_(1, pos, key, reduce="amax")
        keys.append(torch.cummax(z[:, :d_pad], dim=1).values)
    zlo, zhi = keys
    d = torch.arange(d_pad, device=recs.device)[None, :]
    pay = ((zhi & 0x7) << 15) | (zlo & 0x7FFF)
    return _first_hops(zlo >> 15, pay, d, declens).to(torch.int32)


def records_to_kernel_inputs(recs, nops, declens, d_pad: int):
    """Record-scale inputs of K8: ``(startsx, payload)``, both ``(B, CAP)``
    int32. ``startsx`` holds each record's exclusive start, and ``declen``
    for the records at and past ``nops`` (they never cover a live byte);
    ``payload`` is ``islit << 17 | (w1 & 0x1FFFF)``. The JAX function's f32
    record planes and windows exist for a kernel with no gather and are not
    made here.
    """
    if d_pad > 1 << 16:
        raise ValueError(f"d_pad {d_pad}: the route packs positions in 16 bits")
    valid, _, starts, payload = _fields(recs, nops)
    startsx = torch.where(valid, starts, declens.to(torch.int64)[:, None])
    return startsx.to(torch.int32), payload.to(torch.int32)


def resolve_reference(a0, max_rounds: int | None = None):
    """Jacobi pointer doubling over whole rows (the oracle, and the plain
    version of K9): each round replaces every unresolved pointer with its
    target's value, targets clipped to the row, until every value of the
    batch is ``>= FLAG`` or ``max_rounds`` (default ``ceil(log2(d_pad))``)
    have run."""
    d_pad = a0.shape[1]
    rounds = max_rounds or max(1, (d_pad - 1).bit_length())
    a = a0
    for _ in range(rounds):
        g = a.gather(1, a.clamp(0, d_pad - 1).to(torch.int64))
        a = torch.where(a >= FLAG, a, g)
        if bool((a >= FLAG).all()):
            break
    return a


def resolve_fh_plain(startsx, payload, declens, d_pad: int):
    """K8's plain version: each byte's covering record by ``searchsorted``
    (the last record whose start is at or before it), its first hop, then
    :func:`resolve_reference`; ``FLAG`` past ``declen``. A byte no record
    covers gets hop ``-1`` (start 0, payload 0: a copy of offset 1), which
    never resolves, as in the JAX package's fused kernel."""
    d = torch.arange(d_pad, device=startsx.device).expand(startsx.shape[0], d_pad)
    sx = startsx.to(torch.int64).contiguous()
    r = torch.searchsorted(sx, d.contiguous(), right=True) - 1
    rc = r.clamp(min=0)
    covered = r >= 0
    start = torch.where(covered, sx.gather(1, rc), 0)
    pay = torch.where(covered, payload.to(torch.int64).gather(1, rc), 0)
    a0 = _first_hops(start, pay, d, declens).to(torch.int32)
    return resolve_reference(a0)


def resolve_fh_windows(startsx, payload, declens, d_pad: int, window: int = 4096):
    """K8's algorithm step by step in tensor ops (a model of the kernel, not
    its plain version): a bit at each covering record's start (of records
    sharing a start, the last), each position's record by the count of bits
    at or before it, its first hop (a literal byte and a chain's stop are
    roots, here pointing to themselves; a hop below 0 reads position 0);
    then window by window in order, a first hop that leaves the window
    takes its root there at once and pointer doubling settles the chains
    inside the window; and each root's value. Returns ``(plane, rounds)``:
    the ``(B, d_pad)`` int32 plane, which equals :func:`resolve_fh_plain`'s,
    and the doubling rounds of each window, ``(B, ceil(d_pad / window))``
    int64, every round taken all at once (the kernel doubles in place,
    which can only end sooner)."""
    b, cap = startsx.shape
    dev = startsx.device
    sx = startsx.to(torch.int64)
    lim = declens.to(torch.int64).clamp(0, d_pad)[:, None]
    nxt = torch.cat([sx[:, 1:], torch.full((b, 1), 1 << 62, device=dev)], dim=1)
    covers = (sx >= 0) & (sx < lim) & (sx != nxt)
    # 1: the covering records in order, and a bit at each one's start.
    crank = torch.cumsum(covers, dim=1) - 1
    slot = torch.where(covers, crank, cap)
    c_start = torch.zeros((b, cap + 1), dtype=torch.int64, device=dev).scatter_(1, slot, sx)
    c_pay = torch.zeros_like(c_start).scatter_(1, slot, payload.to(torch.int64))
    bits = torch.zeros((b, d_pad + 1), dtype=torch.int64, device=dev)
    bits.scatter_(1, torch.where(covers, sx, d_pad), 1)
    rank = torch.cumsum(bits[:, :d_pad], dim=1) - 1
    # 2: first hops; before the first record, a copy of offset 1 at 0.
    start = torch.where(rank >= 0, c_start.gather(1, rank.clamp(min=0)), 0)
    pay = torch.where(rank >= 0, c_pay.gather(1, rank.clamp(min=0)), 0)
    d = torch.arange(d_pad, device=dev).expand(b, d_pad)
    j = d - start
    w1 = pay & 0x1FFFF
    lit = (pay >> 17) == 1
    off = w1.clamp(min=1)
    h = start - off + torch.where(j < off, j, j % off)
    hop = torch.where(lit, d, torch.where((h >= 0) & (h < d), h, torch.where((h < 0) & (d > 0), 0, d)))
    live = d < lim
    hop = torch.where(live, hop, d)
    val = torch.where(lit, FLAG + w1 + j, h)
    # 3: origins, window by window in order.
    n_win = -(-d_pad // window)
    rounds = torch.zeros((b, n_win), dtype=torch.int64, device=dev)
    for k, base in enumerate(range(0, d_pad, window)):
        g = hop[:, base : base + window]
        g = torch.where(g < base, hop.gather(1, g), g)
        hop[:, base : base + window] = g  # the kernel's entries before doubling
        p = d[:, base : base + window]
        open_ = (g >= base) & (g != p)
        while bool(open_.any()):
            rounds[:, k] += open_.any(1).to(torch.int64)
            g2 = hop.gather(1, g)
            root = g2 == g
            g = torch.where(open_ & ~root, g2, g)
            open_ = open_ & ~root & (g >= base)
            hop[:, base : base + window] = g
        hop[:, base : base + window] = g
    # 4: each origin's value, FLAG past declen.
    return torch.where(live, val.gather(1, hop), FLAG).to(torch.int32), rounds


def resolve_windows(a0, window: int = 4096, max_rounds: int = MAX_ROUNDS):
    """K9's algorithm step by step in tensor ops (a model of the kernel, not
    its plain version): window by window in order, each position's first
    hop (a value ``>= FLAG``, position 0's value below 0 and a pointer at or
    past its own position are roots, which keep their values; a pointer
    below 0 reads position 0); a hop before the window takes the final value
    stored there at once; the rest double inside the window, at most
    ``max_rounds`` rounds, and each position takes its root's value (a
    chain still open keeps its position, below ``FLAG``). Returns ``(plane,
    rounds)``: the ``(B, d_pad)`` int32 plane, which equals
    :func:`resolve_reference`'s on every plane with no pointer past its own
    position, and the doubling rounds of each window, ``(B, ceil(d_pad /
    window))`` int64, every round taken all at once (the kernel doubles in
    place, which can only end sooner)."""
    b, d_pad = a0.shape
    dev = a0.device
    a = a0.to(torch.int64)
    p = torch.arange(d_pad, device=dev).expand(b, d_pad)
    tgt = torch.where(a >= FLAG, -1,
                      torch.where(a < 0, torch.where(p > 0, 0, -1), torch.where(a < p, a, -1)))
    out = torch.empty_like(a)
    rounds = torch.zeros((b, -(-d_pad // window)), dtype=torch.int64, device=dev)
    for k, base in enumerate(range(0, d_pad, window)):
        t = tgt[:, base : base + window]
        q = p[:, : t.shape[1]]
        val = torch.where((t >= 0) & (t < base), out.gather(1, t.clamp(min=0)),
                          a[:, base : base + window])
        open_ = t >= base
        h = torch.where(open_, t - base, q)
        for _ in range(max_rounds):
            if not bool(open_.any()):
                break
            rounds[:, k] += open_.any(1).to(torch.int64)
            h2 = h.gather(1, h)
            root = h2 == h
            h = torch.where(open_ & ~root, h2, h)
            open_ = open_ & ~root
        out[:, base : base + window] = torch.where(h.gather(1, h) == h, val.gather(1, h), base + h)
    return out.to(torch.int32), rounds


@functools.cache
def _kernels():
    lib = _build.kernel_lib("resolve")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    fh = lib.stpu_cuda_resolve_fh
    fh.argtypes = [p, p, i64, i64, p, i64, p, p]
    fh.restype = ctypes.c_int
    rs = lib.stpu_cuda_resolve
    rs.argtypes = [p, i64, i64, ctypes.c_int, p, p]
    rs.restype = ctypes.c_int
    return fh, rs


def _check_plane_inputs(tensors, d_pad: int):
    if any(t.dtype != torch.int32 for t in tensors):
        raise TypeError("inputs must be int32")
    if d_pad <= 0 or d_pad % 1024 or d_pad > 1 << 16:
        raise ValueError(f"d_pad {d_pad} must be whole 1024-byte tiles up to 64 KiB")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError("all inputs must be on one device")
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")


def resolve_fh(startsx, payload, declens, d_pad: int):
    """K8: records to the resolved plane ``(B, d_pad)`` int32, every live
    byte ``FLAG + src`` (or left ``< FLAG`` where its chain does not end at
    a literal) and ``FLAG`` past ``declen``: the plane of
    :func:`resolve_fh_plain`. Inputs from :func:`records_to_kernel_inputs`
    and ``declens`` ``(B,)`` int32."""
    b, cap = startsx.shape
    _check_plane_inputs((startsx, payload, declens), d_pad)
    if payload.shape != (b, cap) or declens.shape != (b,):
        raise ValueError("payload and declens do not match startsx")
    if startsx.device.type == "cpu":
        return resolve_fh_plain(startsx, payload, declens, d_pad)
    out = torch.empty((b, d_pad), dtype=torch.int32, device=startsx.device)
    if b == 0:
        return out
    if b > 65535 or cap == 0:
        raise ValueError(f"{b} rows of {cap} records do not fit one launch")
    _build.count(launches, "resolve_fh")
    _build.launch(
        startsx.device, "resolve_fh", _kernels()[0],
        startsx.data_ptr(), payload.data_ptr(), b, cap, declens.data_ptr(), d_pad, out.data_ptr(),
    )
    return out


def resolve(a0):
    """K9: resolve every pointer of the first-hop plane ``a0`` ``(B, d_pad)``
    int32 (from :func:`records_to_pointers`) to ``FLAG + src``. Its plain
    version is :func:`resolve_reference`, whose plane the kernel gives on
    every plane with no pointer past its own position (a pointer below 0
    reads position 0); where the plain version chases a pointer past its
    position, the kernel leaves it, below ``FLAG``, so the row stays
    flagged (:func:`resolve_windows` follows the kernel)."""
    b, d_pad = a0.shape
    _check_plane_inputs((a0,), d_pad)
    if a0.device.type == "cpu":
        return resolve_reference(a0)
    out = torch.empty_like(a0)
    if b == 0:
        return out
    if b > 65535:
        raise ValueError(f"{b} rows exceed one launch's grid")
    if a0.data_ptr() % 16:
        raise ValueError("a0 must start on a 16-byte boundary: the kernel copies it 16 bytes at a time")
    _build.count(launches, "resolve")
    _build.launch(a0.device, "resolve", _kernels()[1],
                  a0.data_ptr(), b, d_pad, MAX_ROUNDS, out.data_ptr())
    return out


def idx_to_v2_inputs(a_resolved, declens, d_pad: int, s_rows: int):
    """Resolved plane to the flat gather's inputs, as the C++ flatten
    (``core.cpp`` ``stpu_flatten_idx``) chooses them: per 1024-byte tile the
    narrowest window of 512, 256 or 128 rows of 128 bytes (tried wide to
    narrow; each base clamped to ``s_rows - min(w, s_rows)`` and rounded
    down to 8 rows, the fit tested against the nominal ``w``) that holds
    the tile's source indices. Returns ``(idx (B, d_pad) int16``: uint16
    indices relative to the tile's base, in ``layout=1`` order;
    ``tile_meta (B, d_pad // 1024, 2)`` int32 ``[base row, bucket]``;
    ``fallback (B,)`` int32, set where a tile fits no window)."""
    b = a_resolved.shape[0]
    nt = d_pad // 1024
    d = torch.arange(d_pad, device=a_resolved.device)[None, :]
    live = (d < declens.to(torch.int64)[:, None]).reshape(b, nt, 1024)
    iv = torch.where(live, (a_resolved.to(torch.int64) - FLAG).reshape(b, nt, 1024), 0)
    any_live = live.any(dim=2)
    mn = torch.where(live, iv, 1 << 30).amin(dim=2)
    mx = torch.where(live, iv, 0).amax(dim=2)
    mn = torch.where(any_live, mn, 0)
    min_row = torch.div(mn, 128, rounding_mode="floor")
    bucket = torch.full((b, nt), -1, dtype=torch.int64, device=a_resolved.device)
    base = torch.zeros((b, nt), dtype=torch.int64, device=a_resolved.device)
    for wi, w in ((2, 512), (1, 256), (0, 128)):
        cand = min_row.clamp(max=s_rows - min(w, s_rows)).clamp(min=0) & ~7
        ok = mx - cand * 128 < w * 128
        bucket = torch.where(ok, wi, bucket)
        base = torch.where(ok, cand, base)
    fallback = (bucket < 0).any(dim=1).to(torch.int32)
    bucket = torch.where(bucket < 0, 2, bucket)
    tile_meta = torch.stack([base, bucket], dim=2).to(torch.int32)
    rel = torch.where(live, iv - base[:, :, None] * 128, 0) & 0xFFFF
    rel = ((rel ^ 0x8000) - 0x8000).to(torch.int16).reshape(b, d_pad)
    # The v2 kernel's transposed block order (decode_flat.phys_index).
    idx = rel.reshape(b, d_pad // 16384, 16, 8, 128).permute(0, 1, 4, 2, 3).reshape(b, d_pad)
    return idx.contiguous(), tile_meta, fallback


def decode_resolve_batch(srcs, recs, nops, declens, d_pad: int, interpret: bool | None = None,
                         use_pallas: bool = True, use_fused: bool = True):
    """Decode a launch group from its op records: resolve, then K2.

    ``srcs``: ``(B, S)`` uint8 zero-padded bodies (``S % 128 == 0``, at most
    64 KiB); ``recs``, ``nops``: the scan's records ``(B, CAP, 2)`` int32
    and op counts ``(B,)`` int32 (every ``nops <= CAP``: the caller routes
    overflowing groups away); ``declens`` ``(B,)`` int32; ``d_pad`` whole
    16 KiB up to 64 KiB. The arguments are the JAX package's: ``use_pallas``
    and ``use_fused`` take K8 (first hops in the kernel); ``use_fused=False``
    takes ``records_to_pointers`` and K9; ``use_pallas=False`` takes
    ``records_to_pointers`` and :func:`resolve_reference`, the explicit
    opt-in of the JAX package's (never a fallback). Every setting gathers
    with K2. ``interpret`` is accepted and selects nothing: the tensors'
    device chooses between each kernel and its plain version. Returns
    ``(out (B, d_pad) uint8, fallback (B,) int32)``: a row with
    ``fallback`` set has a tile that fits no gather window or a chain left
    unresolved, and its bytes are not valid.
    """
    if d_pad % 16384:
        raise ValueError(f"d_pad {d_pad} is not whole 16 KiB groups")
    dev = srcs.device
    fused = use_pallas and use_fused
    with span("plan", dev):
        if fused:
            startsx, payload = records_to_kernel_inputs(recs, nops, declens, d_pad)
        else:
            a0 = records_to_pointers(recs, nops, declens, d_pad)
    with span("kernels", dev):
        if fused:
            a = resolve_fh(startsx, payload, declens, d_pad)
        else:
            a = resolve(a0) if use_pallas else resolve_reference(a0)
    with span("plan", dev):
        idx, tile_meta, fallback = idx_to_v2_inputs(a, declens, d_pad, srcs.shape[1] // 128)
        # A chain left unresolved by the round budget must not ship.
        fallback = fallback | (a < FLAG).any(dim=1).to(torch.int32)
    with span("kernels", dev):
        out = decode_flat(srcs, idx, tile_meta, declens, d_pad, 1)
    return out, fallback
