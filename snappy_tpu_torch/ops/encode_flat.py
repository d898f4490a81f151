"""The flat device encoder: prepass, record math, emission plan.

The port of the JAX package's ``ops/encode_flat.py`` (its ``device-fast``
compress path). Per 64 KiB block:

1. **Prepass** (:func:`prepass`, tensor ops): u32 grams; the exact
   nearest previous occurrence of each gram by one sort of ``key << 16 |
   pos`` and an inverse-permutation scatter; the candidate set with the
   isolated-copy rule on the chain-consistency length estimate; packed
   per-position jump words in segment layout.
2. **Parse** (K4, :mod:`.parse`): 128 independent segment walks per block
   -> copy records.
3. **Emission plan** (tensor ops): record sizes by the reference's rules
   (copy splitting, literal headers with runs merged across segments), the
   header plane (every record's header bytes at a 32-byte pitch) and the
   sorted breakpoint plan of the step function ``idx(d) = d + shift(d)``.
4. **Emission** (K5, :mod:`.emit`): ``out[d] = src[idx(d)]`` over the
   source ``[block bytes | header plane]``.

:func:`records_to_bytes` is the reference emission (closed-form byte
rules, a gather per output byte), the bit-exact oracle of the fast one.
Output: valid raw Snappy per block, byte-identical to the JAX package's
``compress_blocks_flat_fast``.

Tensors stay on the blocks' device; nothing moves to the host but the
final rows. The public calls take the JAX package's arguments: their
``interpret`` is accepted and selects nothing, since the tensors' device
chooses between each kernel and its plain version; the port's ``span`` is
keyword-only after them.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..format.constants import MIN_NON_LITERAL_BLOCK_SIZE
from .emit import BP_WIN_ROWS, GROUP, N_GROUPS, emit_bytes, fused_emit, shift_idx
from .parse import JW_CAND, LANES, MAX_REC, NSEG, S, SEG, parse_blocks

OUT_W = 76800  # >= max_compress_len(65536)
OUT_ROWS = OUT_W // LANES  # 600

HDR_PITCH = 32
NREC2 = NSEG * MAX_REC + 8  # +1 tail slot, padded to a row multiple
HDR_ROWS = NREC2 * HDR_PITCH // LANES  # 4610
HDR_ROWS_PAD = -(-HDR_ROWS // 8) * 8  # 4616, the plane's rows
HDR_BASE = S  # the header plane sits after the block in the source
NBP = 3 * NREC2  # 55,320
NBP_PAD = -(-NBP // LANES) * LANES
N_GROUPS_REAL = 75  # groups below OUT_W; the rest are padding

I32 = torch.int32


def _no_span(name: str, dev=None):
    return contextlib.nullcontext()


# --- prepass --------------------------------------------------------------


def _u32_grams(blocks):
    """Little-endian u32 at every position, zeros past the block; int64."""
    b = blocks.to(torch.int64)
    b = torch.cat([b, torch.zeros((b.shape[0], 8), dtype=torch.int64, device=b.device)], 1)
    return b[:, :S] | b[:, 1 : S + 1] << 8 | b[:, 2 : S + 2] << 16 | b[:, 3 : S + 3] << 24


def _prev_two_sorts(u32, n):
    """Nearest previous same-u32 position (-1 if none).

    The JAX package sorts ``(key, position)`` on two keys and applies the
    inverse permutation with a second sort; here one sort of the int64
    ``key << 16 | position`` orders both, and a scatter inverts it."""
    bsz = u32.shape[0]
    p = torch.arange(S, device=u32.device)
    valid = p[None, :] <= (n[:, None] - 4)
    key = torch.where(valid, u32, 0xFFFFFFFF)
    skey = torch.sort(key << 16 | p, dim=1).values
    sidx = skey & 0xFFFF
    same = (skey[:, 1:] >> 16) == (skey[:, :-1] >> 16)
    prev = torch.full((bsz, S), -1, dtype=torch.int64, device=u32.device)
    prev.scatter_(1, sidx[:, 1:], torch.where(same, sidx[:, :-1], -1))
    return torch.where(valid, prev, -1).to(I32)


def _rev_cummin(x):
    return torch.cummin(x.flip(1), dim=1).values.flip(1)


def prepass(blocks, lengths):
    """Parse inputs of ``(B, 65536)`` uint8 blocks: ``(jw, u32seg)``.

    ``jw``: ``(B, 128, 512)`` int32 jump words (layout in
    :data:`.parse.JW_CAND`); ``u32seg``: the u32 grams in the same layout,
    as the int32 bit pattern. The JAX package also builds four bf16 byte
    planes for its matrix-unit routing; K4 reads the block's bytes instead.
    """
    bsz = blocks.shape[0]
    n = lengths.to(I32)
    p = torch.arange(S, dtype=I32, device=blocks.device)[None, :]
    u32 = _u32_grams(blocks)
    prev = _prev_two_sorts(u32, n)

    usable = n[:, None] >= MIN_NON_LITERAL_BLOCK_SIZE
    cand = (prev >= 0) & usable
    off = torch.where(cand, p - prev, 0)

    # chain-consistency estimate (a guaranteed lower length bound)
    nxt_prev = torch.cat([prev[:, 1:], torch.full_like(prev[:, :1], -1)], 1)
    nxt_cand = torch.cat([cand[:, 1:], torch.zeros_like(cand[:, :1])], 1)
    c = cand & nxt_cand & (nxt_prev == prev + 1)
    nxt0 = _rev_cummin(torch.where(c, S, p))
    lhat = torch.where(cand, 4 + (nxt0 - p), 0)
    lhat = torch.minimum(lhat, (n[:, None] - p).clamp(min=0))

    # isolated-copy skip on the estimate (the fast profile's cost rule)
    lp4 = torch.cat([lhat[:, 4:], torch.zeros_like(lhat[:, :4])], 1)
    iso = (lhat == 4) & (off > 2047) & (lp4 < 4)
    cand = cand & ~iso

    # segment-boundary exclusion: a copy needs >= 4 bytes before the
    # forced boundary
    seg_end = torch.minimum((p // SEG + 1) * SEG, n[:, None])
    cand = cand & (seg_end - p >= 4)
    off = torch.where(cand, off, 0)
    lhatc = torch.where(cand, torch.minimum(lhat, seg_end - p), 0)

    # skip hops over the final candidate set, segment-relative
    nxtc = _rev_cummin(torch.where(cand, p, S))
    rel = (nxtc - (p // SEG) * SEG).clamp(0, SEG)

    jw = torch.where(cand, off | (lhatc << 16) | JW_CAND, rel).to(I32)
    u32seg = (u32 - ((u32 >> 31) << 32)).to(I32)  # the uint32 -> int32 bit pattern
    return jw.view(bsz, NSEG, SEG), u32seg.view(bsz, NSEG, SEG)


# --- record algebra ---------------------------------------------------------


def _exclusive_cummax(x):
    return torch.cummax(torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1), dim=1).values


def _lit_hdr_len(lit_len):
    llm1 = lit_len - 1
    return torch.where(
        lit_len == 0, 0, torch.where(llm1 <= 59, 1, torch.where(llm1 < 256, 2, 3))
    ).to(I32)


def _copy_split(ln, off):
    """The reference's copy splitting (64-byte peels while len >= 68, a
    60-peel for 65..67, copy1 for short near copies):
    ``(n64, peel60, rem, use_c1, csize)``."""
    n64 = torch.where(ln >= 68, (ln - 68) // 64 + 1, 0)
    rem1 = ln - 64 * n64
    peel60 = (rem1 > 64).to(I32)
    rem = rem1 - 60 * peel60
    use_c1 = (rem <= 11) & (off <= 2047)
    csize = 3 * n64 + 3 * peel60 + 3 - use_c1.to(I32)
    return n64, peel60, rem, use_c1, csize


def _record_fields(lengths, rec0, rec1, cnt):
    """Shared record algebra: positions, sizes, output starts."""
    bsz = rec0.shape[0]
    dev = rec0.device
    n = lengths.to(I32)
    nr = NSEG * MAX_REC
    seg = torch.arange(NSEG, dtype=I32, device=dev)[None, :, None]
    kix = torch.arange(MAX_REC, dtype=I32, device=dev)[None, None, :]
    valid = kix < cnt[:, :, 0:1]
    pos = ((rec0 & 0x3FF) + seg * SEG).reshape(bsz, nr)
    ln = torch.where(valid, rec0 >> 10, 0).reshape(bsz, nr)
    off = rec1.reshape(bsz, nr)
    valid = valid.reshape(bsz, nr)

    end = torch.where(valid, pos + ln, 0)
    lit_len = torch.where(valid, pos - _exclusive_cummax(end), 0)
    lh = _lit_hdr_len(lit_len)
    n64, peel60, rem, use_c1, csize = _copy_split(ln, off)
    rsize = torch.where(valid, lh + lit_len + csize, 0)
    ends_out = torch.cumsum(rsize, 1, dtype=I32)
    starts = ends_out - rsize
    body_total = ends_out[:, -1]
    total_end = end.max(1).values
    tl = (n - total_end).clamp(min=0)
    th = _lit_hdr_len(tl)
    out_len = body_total + th + tl
    return dict(
        n=n, nr=nr, valid=valid, pos=pos, ln=ln, off=off, lit_len=lit_len,
        lh=lh, n64=n64, peel60=peel60, rem=rem, use_c1=use_c1, csize=csize,
        starts=starts, body_total=body_total, total_end=total_end, tl=tl,
        th=th, out_len=out_len,
    )


def _lit_hdr_byte(t, llm1, lh):
    """Byte ``t`` of a literal header (``t < lh``)."""
    h0 = torch.where(llm1 <= 59, llm1 << 2, torch.where(lh == 2, 60 << 2, 61 << 2))
    return torch.where(t == 0, h0, torch.where(t == 1, llm1 & 0xFF, (llm1 >> 8) & 0xFF))


def _copy_byte(u, off, n64, p60, rem, uc1):
    """Byte ``u`` of a copy's op bytes (the split pieces, then the rest)."""
    in64 = u < 3 * n64
    in60 = ~in64 & (u < 3 * (n64 + p60))
    j3 = u % 3
    t_rel = u - 3 * (n64 + p60)
    sub_len = torch.where(in64, 64, torch.where(in60, 60, rem))
    return torch.where(
        in64 | in60,
        torch.where(j3 == 0, ((sub_len - 1) << 2) | 2,
                    torch.where(j3 == 1, off & 0xFF, off >> 8)),
        torch.where(
            uc1,
            torch.where(t_rel == 0, ((off >> 8) << 5) | ((rem - 4) << 2) | 1, off & 0xFF),
            torch.where(t_rel == 0, ((rem - 1) << 2) | 2,
                        torch.where(t_rel == 1, off & 0xFF, off >> 8)),
        ),
    )


def records_to_bytes(blocks, lengths, rec0, rec1, cnt):
    """Records -> raw op-stream bytes: the reference emission.

    The reference's emission rules in closed form per output byte: literal
    headers (1-3 bytes by length), copy splitting, and literal spans as
    the gaps between copies, so runs merge across segment boundaries. The
    record covering output byte ``d`` is the last valid record that starts
    at or before it: output starts never decrease, so a ``searchsorted``
    finds it (the JAX package merges the two sequences with sorts).

    Returns ``(out (B, OUT_W) uint8, out_len (B,) int32)``.
    """
    f = _record_fields(lengths, rec0, rec1, cnt)
    bsz, nr = f["valid"].shape
    dev = blocks.device
    d_iota = torch.arange(OUT_W, dtype=I32, device=dev)[None, :]
    n_le = torch.searchsorted(f["starts"], d_iota.expand(bsz, OUT_W).contiguous(), right=True)
    last_valid = torch.cummax(
        torch.where(f["valid"], torch.arange(nr, device=dev)[None, :], -1), dim=1
    ).values
    cover = torch.where(n_le > 0, last_valid.gather(1, (n_le - 1).clamp(min=0)), -1)
    cover = cover.clamp(0, nr - 1)

    def g(name):
        return f[name].gather(1, cover)

    c_start, c_pos, c_ln, c_off, c_litlen = (g(k) for k in ("starts", "pos", "ln", "off", "lit_len"))
    rel = d_iota - c_start
    c_llm1 = c_litlen - 1
    c_lh = _lit_hdr_len(c_litlen)
    lit_hdr = _lit_hdr_byte(rel, c_llm1, c_lh)
    c_n64, c_p60, c_rem, c_uc1, _ = _copy_split(c_ln, c_off)
    copy_byte = _copy_byte(rel - c_lh - c_litlen, c_off, c_n64, c_p60, c_rem, c_uc1)

    # literal content (the one gather): source = pos - lit_len + (rel - lh)
    is_content = (rel >= c_lh) & (rel < c_lh + c_litlen)
    src_idx = (c_pos - c_litlen + (rel - c_lh)).clamp(0, S - 1)

    # tail literal (block-level scalars broadcast)
    bt = f["body_total"][:, None]
    t_th = f["th"][:, None]
    trel = d_iota - bt
    tail_hdr = _lit_hdr_byte(trel, (f["tl"] - 1)[:, None], t_th)
    in_tail_hdr = (trel >= 0) & (trel < t_th)
    out_len = f["out_len"]
    in_tail_ct = (trel >= t_th) & (d_iota < out_len[:, None])
    tail_src = (f["total_end"][:, None] + (trel - t_th)).clamp(0, S - 1)

    src_idx = torch.where(in_tail_ct, tail_src, src_idx)
    content = blocks.to(I32).gather(1, src_idx.to(torch.int64))

    byte = torch.where(rel < c_lh, lit_hdr, torch.where(is_content, content, copy_byte))
    byte = torch.where(in_tail_hdr, tail_hdr, byte)
    byte = torch.where(in_tail_ct, content, byte)
    byte = torch.where(d_iota < out_len[:, None], byte, 0)
    return (byte & 0xFF).to(torch.uint8), out_len


def _overflow(cnt):
    return cnt[:, :, 1].max(1).values


def compress_blocks_flat(blocks, lengths, interpret: bool | None = None):
    """Flat compress of a ``(B, 65536)`` block batch with the reference
    emission: ``(out (B, OUT_W) uint8, out_len (B,) int32, overflow (B,)
    int32)``. ``overflow[b] != 0`` flags a block whose segment filled its
    record slots (never on real data: a segment holds at most 128 copies)."""
    n = lengths.to(I32)
    jw, _ = prepass(blocks, n)
    rec0, rec1, cnt = parse_blocks(n, jw, blocks)
    out, out_len = records_to_bytes(blocks, n, rec0, rec1, cnt)
    return out, out_len, _overflow(cnt)


# --- emission plan ------------------------------------------------------------


def _hdr_plane(f):
    """``(B, HDR_ROWS_PAD, 128)`` uint8 header plane at a 32-byte pitch,
    in RANK space (valid records compacted to the front).

    Compaction keeps consecutive records' header cells adjacent, so a
    1024-byte output group's header reads span few cells. The JAX package
    compacts with a sort whose key ties only on invalid slots (zero
    payloads); here a cumsum gives each valid slot its rank and a scatter
    moves it there. Derived fields are recomputed in rank space, as there.
    Stores the rank-space fields the breakpoints need in ``f``.
    """
    v = f["valid"]
    bsz, nr = v.shape
    dest = torch.where(v, torch.cumsum(v, 1, dtype=I32) - 1, nr).to(torch.int64)

    def compact(x):
        out = torch.zeros((bsz, nr + 1), dtype=I32, device=x.device)
        out.scatter_(1, dest, torch.where(v, x, 0))
        return out[:, :nr]

    pos_r, off_r, ln_r = compact(f["pos"]), compact(f["off"]), compact(f["ln"])
    vr = torch.arange(nr, device=v.device)[None, :] < v.sum(1, keepdim=True)

    end_r = torch.where(vr, pos_r + ln_r, 0)
    lit_len_r = torch.where(vr, pos_r - _exclusive_cummax(end_r), 0)
    lh_r = _lit_hdr_len(lit_len_r)
    n64_r, peel60_r, rem_r, use_c1_r, csize_r = _copy_split(ln_r, off_r)
    rsize_r = torch.where(vr, lh_r + lit_len_r + csize_r, 0)
    f["rank_starts"] = torch.cumsum(rsize_r, 1, dtype=I32) - rsize_r
    f["rank_pos"] = pos_r
    f["rank_litlen"] = lit_len_r
    f["rank_lh"] = lh_r
    cells = dict(off=off_r, rem=rem_r, n64=n64_r, p60=peel60_r,
                 uc1=use_c1_r.to(I32), lit_len=lit_len_r, lh=lh_r)
    return _hdr_plane_tail(f, cells)


def _hdr_plane_tail(f, cells):
    """Cell bytes of every rank, the tail literal's header at rank
    ``nvalid``, the plane padded to ``HDR_ROWS_PAD`` rows.

    ``cells``: rank-space ``off, rem, n64, p60, uc1, lit_len, lh``. Every
    one of a cell's 32 bytes is computed by the same rules, also past the
    record's own bytes, so the plane equals the JAX package's byte for
    byte. Computed one byte column at a time so the intermediates stay
    ``(B, NREC2)``."""
    v = f["valid"]
    bsz, nr = v.shape
    dev = v.device

    def pad(x):
        return torch.cat([x.to(I32), torch.zeros((bsz, NREC2 - nr), dtype=I32, device=dev)], 1)

    c = {k: pad(x) for k, x in cells.items()}
    is_tail = torch.arange(NREC2, device=dev)[None, :] == v.sum(1, keepdim=True)
    lit_len = torch.where(is_tail, f["tl"][:, None], c["lit_len"])
    lh = torch.where(is_tail, f["th"][:, None], c["lh"])
    n64, p60, rem, uc1 = (torch.where(is_tail, 0, c[k]) for k in ("n64", "p60", "rem", "uc1"))
    off, llm1, uc1 = c["off"], lit_len - 1, uc1 != 0

    plane = torch.zeros((bsz, HDR_ROWS_PAD * LANES), dtype=torch.uint8, device=dev)
    cell = plane[:, : NREC2 * HDR_PITCH].view(bsz, NREC2, HDR_PITCH)
    for t in range(HDR_PITCH):
        lit_b = _lit_hdr_byte(torch.tensor(t, device=dev), llm1, lh)
        copy_b = _copy_byte(t - lh, off, n64, p60, rem, uc1)
        cell[:, :, t] = (torch.where(t < lh, lit_b, copy_b) & 0xFF).to(torch.uint8)
    return plane.view(bsz, HDR_ROWS_PAD, LANES)


def _breakpoints(f):
    """Flattened sorted ``(bp, delta)`` step plan for ``shift(d)``, rank
    space, and each output group's window.

    Per rank r three steps: bp1 = start (shift -> the header cell), bp2 =
    start + lh (shift -> the literal's source), bp3 = bp2 + lit_len (shift
    -> the copy's bytes in the cell); then the tail literal's two steps at
    rank nvalid, then sentinels past OUT_W. Deltas telescope from the
    previous step's shift. Starts never decrease and each record spans its
    three steps, so ``bp`` is sorted by construction: each group's window
    (``lo_row``, ``rows_g``) comes from a ``searchsorted`` at the group
    bounds where the JAX package counts. Returns ``(bp, dlt, lo_row, base,
    rows_g, overflow)``.
    """
    v = f["valid"]
    bsz, nr = v.shape
    dev = v.device
    nvalid = v.sum(1, keepdim=True)
    rankix = torch.arange(nr, dtype=I32, device=dev)[None, :]
    vr = rankix < nvalid
    starts = f["rank_starts"]
    pos = f["rank_pos"]
    litlen = torch.where(vr, f["rank_litlen"], 0)
    lh = torch.where(vr, f["rank_lh"], 0)
    hpos = HDR_BASE + rankix * HDR_PITCH

    s1 = hpos - starts
    s2 = (pos - litlen) - starts - lh
    s3 = hpos - starts - litlen
    bp1 = starts
    bp2 = starts + lh
    bp3 = bp2 + litlen

    # tail literal at rank nvalid; pads follow at the sentinel
    bt = f["body_total"][:, None]
    th = f["th"][:, None]
    tpos = HDR_BASE + nvalid * HDR_PITCH
    is_tail = rankix == nvalid
    big = OUT_W + 1
    bp1 = torch.where(is_tail, bt, torch.where(vr, bp1, big))
    bp2 = torch.where(is_tail, bt + th, torch.where(vr, bp2, big))
    bp3 = torch.where(vr, bp3, big)
    s1 = torch.where(is_tail, tpos - bt, torch.where(vr, s1, 0))
    s2 = torch.where(is_tail, f["total_end"][:, None] - bt - th, torch.where(vr, s2, 0))
    s3 = torch.where(vr, s3, torch.where(is_tail, s2, 0))

    padn = NBP_PAD - 3 * nr
    bp = torch.stack([bp1, bp2, bp3], 2).reshape(bsz, 3 * nr).to(I32)
    sv = torch.stack([s1, s2, s3], 2).reshape(bsz, 3 * nr).to(I32)
    bp = torch.cat([bp, torch.full((bsz, padn), big, dtype=I32, device=dev)], 1)
    sv = torch.cat([sv, torch.zeros((bsz, padn), dtype=I32, device=dev)], 1)
    dlt = sv - torch.cat([torch.zeros_like(sv[:, :1]), sv[:, :-1]], 1)

    # per-group window rows + prefix base
    cum = torch.cat([torch.zeros_like(dlt[:, :1]), torch.cumsum(dlt, 1, dtype=I32)], 1)
    bounds = (torch.arange(N_GROUPS + 1, dtype=I32, device=dev) * GROUP).expand(bsz, -1)
    cnt_below = torch.searchsorted(bp, bounds.contiguous(), out_int32=True)  # #(bp < bound)
    below = cnt_below[:, :N_GROUPS]
    lo_row = below >> 7  # the window starts at a row boundary
    base = cum.gather(1, (lo_row * LANES).to(torch.int64))
    below_end = cnt_below[:, 1:]  # #(bp < 1024 * (g + 1))
    rows_g = ((below_end - lo_row * LANES + LANES - 1) >> 7).clamp(0, BP_WIN_ROWS)
    over_g = below_end - lo_row * LANES > BP_WIN_ROWS * LANES
    overflow = over_g[:, :N_GROUPS_REAL].to(I32).max(1).values
    return bp, dlt, lo_row, base, rows_g, overflow


def _fused_plan(blocks, lengths, rec0, rec1, cnt):
    """Emission plan of K5: ``(lo_row, base, rows_g, out_len, bp_rows,
    dlt_rows, src, overflow)``, with ``src = [block bytes | header plane]``.

    The JAX package's plan also computes per-tile header and content
    window bases (``hb8``, ``cb8``, ``cbk``) and the ``(B, 80, nr)`` record
    counts behind them: its kernel routes bytes through matrix products
    over windows because Mosaic has no gather. On the card a gather is a
    load, so they are not computed."""
    bsz = blocks.shape[0]
    f = _record_fields(lengths, rec0, rec1, cnt)
    plane = _hdr_plane(f)
    bp, dlt, lo_row, base, rows_g, ovf_bp = _breakpoints(f)
    src = torch.cat([blocks, plane.view(bsz, -1)], 1)
    return (lo_row, base, rows_g, f["out_len"], bp.view(bsz, NBP_PAD // LANES, LANES),
            dlt.view(bsz, NBP_PAD // LANES, LANES), src, ovf_bp)


def records_to_bytes_fused(blocks, lengths, rec0, rec1, cnt, interpret: bool | None = None, *,
                           span=_no_span):
    """Fused fast emission, plan -> bytes in one launch (K5).

    Bit-exact with :func:`records_to_bytes`. Returns ``(out (B, OUT_W)
    uint8, out_len, overflow)``; ``overflow`` flags a block whose
    breakpoints overran a group's window (impossible, see
    :data:`.emit.BP_WIN_ROWS`)."""
    with span("plan", blocks.device):
        lo_row, base, rows_g, out_len, bp_rows, dlt_rows, src, ovf = _fused_plan(
            blocks, lengths, rec0, rec1, cnt
        )
    with span("kernels", blocks.device):
        out = fused_emit(lo_row, base, rows_g, out_len, bp_rows, dlt_rows, src)
    return out[:, :OUT_W], out_len, ovf


def records_to_bytes_fast(blocks, lengths, rec0, rec1, cnt, interpret: bool | None = None):
    """Split fast emission, K6: the same plan, then the index and the
    gather in two launches. The JAX package permutes ``idx`` into its v2
    tile layout and bases a header window on it per tile (``hbase``), TPU
    layout artefacts; :func:`.emit.emit_bytes` takes ``idx`` in output
    order. Same result as :func:`records_to_bytes_fused`."""
    lo_row, base, rows_g, out_len, bp_rows, dlt_rows, src, ovf = _fused_plan(
        blocks, lengths, rec0, rec1, cnt
    )
    idx = shift_idx(lo_row, base, rows_g, out_len, bp_rows, dlt_rows)
    out = emit_bytes(src, idx, out_len)
    return out[:, :OUT_W], out_len, ovf


def _parse(blocks, lengths, span):
    n = lengths.to(I32)
    with span("prepass", blocks.device):
        jw, _ = prepass(blocks, n)
    with span("kernels", blocks.device):
        rec0, rec1, cnt = parse_blocks(n, jw, blocks)
    return n, rec0, rec1, cnt


def _compress_blocks_flat_split(blocks, lengths):
    """The split pipeline (K4, then K6's two launches); the JAX package
    keeps it for A/B measurement. Same contract as
    :func:`compress_blocks_flat_fast`."""
    n, rec0, rec1, cnt = _parse(blocks, lengths, _no_span)
    out, out_len, ovf_bp = records_to_bytes_fast(blocks, n, rec0, rec1, cnt)
    return out, out_len, torch.maximum(_overflow(cnt), ovf_bp)


def compress_blocks_flat_fast(blocks, lengths, interpret: bool | None = None, *, span=_no_span):
    """Fast flat compress of a ``(B, 65536)`` uint8 block batch on its
    device: prepass, K4, the plan and K5. Same contract as
    :func:`compress_blocks_flat`.

    ``span(name, device)`` is a context manager around each stage
    (``prepass``, ``kernels``, ``plan``); the API passes its timer. The
    overflow flag is unreachable: copies are >= 4 bytes apart, so a
    512-byte segment holds at most 128 records (< MAX_REC = 144), and the
    breakpoint window is sized to the wire format's worst case."""
    n, rec0, rec1, cnt = _parse(blocks, lengths, span)
    out, out_len, ovf_bp = records_to_bytes_fused(blocks, n, rec0, rec1, cnt, span=span)
    return out, out_len, torch.maximum(_overflow(cnt), ovf_bp)


def compress_blocks_flat_host(blocks, lengths, device, *, span=_no_span):
    """Host-facing wrapper: numpy ``(B, 65536)`` uint8 blocks and ``(B,)``
    lengths in, numpy ``(out (B, OUT_W) uint8, out_len (B,) int32)`` out,
    computed on ``device``.

    A block the flat encoder flags (unreachable, see
    :func:`compress_blocks_flat_fast`) takes the bytes of
    :func:`.encode_fast.compress_blocks_fast` instead, as in the JAX
    package, so callers always get valid streams."""
    dev = torch.device(device)
    with span("h2d"):
        blocks_t = torch.from_numpy(np.ascontiguousarray(blocks, np.uint8)).to(dev)
        lens_t = torch.from_numpy(np.asarray(lengths, np.int32)).to(dev)
    out, out_len, ovf = compress_blocks_flat_fast(blocks_t, lens_t, span=span)
    bad = ovf != 0
    if bool(bad.any()):
        from .encode_fast import compress_blocks_fast

        fout, flen = compress_blocks_fast(blocks_t[bad], lens_t[bad])
        out[bad], out_len[bad] = fout, flen
    with span("d2h"):
        return out.cpu().numpy(), out_len.cpu().numpy()
