"""Flat-gather decode over host-flattened indices: kernels K2 and K11,
one CUDA kernel with two entry points (``csrc/flat_gather.cu``).

The host flatten (``native.flatten_idx_batch``) turns every copy chain
into the index of the literal byte it reads, relative to its 1024-byte
tile's window base row. Decode is then one gather::

    out[b, d] = src[b, tile_meta[b, d >> 10, 0] * 128 + idx[b, phys(d)]]

for ``d < declens[b]`` and a position inside the row, and 0 up to
``d_pad``. ``layout=0`` keeps ``idx`` in output order (``phys(d) = d``);
``layout=1`` is the transposed block order the flatten writes for widths
that are whole 16 KiB groups (:func:`phys_index`). The bucket column of
``tile_meta`` only sized the TPU kernels' matrix-unit windows and K2
ignores it.

K11, :func:`decode_flat_grouped`, is the JAX package's v3/v4 entry
(``decode_flat_pallas_v3``/``_v4``): ``layout=1`` with one window bucket
per 16 KiB group (``gbuck``, from :func:`group_buckets`). It keeps what
the windows do to the bytes: a dead group is zeros, and a byte whose
window-relative row lies past its group's window, or past the source
row, is 0.

``idx`` travels as ``int16`` (torch's ``uint16`` support is thin); the
kernel reads it as ``uint16`` and the plain version masks with 0xFFFF.

:func:`decode_flat_crc` is K2 with the frame checksum: the same kernel,
built with its checksum on, also writes each row's masked CRC32C, which
the frame read would otherwise take from K1 after K2. A row's CTAs combine
their 16 KiB units' shares of its register in a 64-bit word of state a row
(one atomic a unit), so rows of up to :data:`MAX_CRC_UNITS` units; wider
rows take K2 and then K1.

:func:`decode_flat_groups` decodes several launch groups, each of its own
rows and widths, in one launch of the same kernel a layout and checksum
kind: a unit finds its group from a table in the launch's parameters, so
groups that are each under one wave of the card fill it together. The
kernel is persistent: its grid is the smaller of the launch's units and the
CTAs the card holds at once, and each CTA walks its units with the next
ones' indices already loading.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from . import _build
from .crc32c import (
    crc32c_masked_blocks, crc32c_plain, five_bit_tables, inverse_nibble_tables, nibble_tables,
)

#: Kernel launches since the count was last reset: K2 in all and per
#: layout (its checksum instance included), K2 with the checksum
#: (``crc_launches``), K11 per variant; and what K2's launches walked: the
#: launch groups they decoded (``launched_groups``), their 16 KiB units of
#: output (``launched_units``) and the CTAs that walked them
#: (``launched_ctas``, each launch's grid).
launches = 0
layout_launches = [0, 0]
crc_launches = 0
grouped_launches = {3: 0, 4: 0}
launched_groups = 0
launched_units = 0
launched_ctas = 0

GROUP = 16384  # output bytes per bucket group (16 tiles of 1024)
NOMINAL_WINDOWS = (128, 256, 512)  # window rows of buckets 0, 1, 2
RUN = 128  # bytes of a unit each of the checksum's 128 threads folds
LEVELS = 7  # the tree that joins a unit's 128 runs
FIVE = 196  # words of an operator's 5-bit tables
MAX_CRC_UNITS = 8  # a row's units, a bit each in its state (csrc/flat_gather.cu kMaxUnits)
TAIL_RADIX = 128  # the zeros past declen in the last live unit, below 2**14, in base 128
MAX_LAUNCH_GROUPS = 16  # groups a decode_flat_groups launch (csrc/flat_gather.cu kMaxGroups)
STATE_WORDS = 65535  # a stream's words of checksum state, one a row of a launch


def phys_index(d, layout: int):
    """Position of output byte ``d``'s index in the ``layout`` order
    (``core.cpp`` ``stpu_flatten_idx``); ints, arrays or tensors."""
    if layout == 0:
        return d
    return (d >> 14 << 14) | ((d & 127) << 7) | (((d >> 10) & 15) << 3) | ((d >> 7) & 7)


def _reads(s: int, idx, tile_meta, declens, d_pad: int, layout: int, window=None):
    """``(p, ok)``, both ``(B, d_pad)``: the source position each output
    byte reads, and whether it reads it (``d < declen``, ``0 <= p < s`` and,
    given a per-byte ``window`` of rows, ``idx >> 7 < window``)."""
    d = torch.arange(d_pad, device=idx.device)
    rel = idx.to(torch.int64)[:, phys_index(d, layout)] & 0xFFFF
    p = tile_meta[:, :, 0].to(torch.int64).repeat_interleave(1024, dim=1) * 128 + rel
    ok = (p >= 0) & (p < s) & (d[None, :] < declens.to(torch.int64)[:, None])
    if window is not None:
        ok &= (rel >> 7) < window
    return p, ok


def decode_flat_plain(srcs, idx, tile_meta, declens, d_pad: int, layout: int):
    """The gather in PyTorch ops, on any device."""
    s = srcs.shape[1]
    p, ok = _reads(s, idx, tile_meta, declens, d_pad, layout)
    val = srcs.gather(1, p.clamp(0, s - 1))
    return torch.where(ok, val, 0).to(torch.uint8)


def _cuda_checks(tensors, b: int, s: int) -> None:
    """What the kernel takes beyond the shapes: ``tensors`` (``srcs`` and
    ``idx`` first) on the card and contiguous, ``idx`` 16-byte aligned (it
    is read 16 bytes at a time), rows below 1 GiB (32-bit positions)."""
    if tensors[0].device.type != "cuda":
        raise ValueError(f"unsupported device {tensors[0].device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("inputs must be contiguous")
    if tensors[1].data_ptr() % 16 or s >= 1 << 30:
        raise ValueError(f"idx must be 16-byte aligned and rows below 1 GiB, got {s} bytes")
    if b > 65535:
        raise ValueError(f"{b} rows exceed one launch's grid")


def _flat_checks(srcs, idx, tile_meta, declens, d_pad: int, layout: int) -> None:
    """K2's argument checks, with or without the checksum."""
    b = srcs.shape[0]
    if srcs.dtype != torch.uint8 or idx.dtype != torch.int16:
        raise TypeError(f"srcs must be uint8 and idx int16, got {srcs.dtype}, {idx.dtype}")
    if tile_meta.dtype != torch.int32 or declens.dtype != torch.int32:
        raise TypeError("tile_meta and declens must be int32")
    if d_pad % 1024 or (layout == 1 and d_pad % 16384) or layout not in (0, 1):
        raise ValueError(f"layout {layout} with d_pad {d_pad}")
    if (
        idx.shape != (b, d_pad)
        or tile_meta.shape != (b, d_pad // 1024, 2)
        or declens.shape != (b,)
    ):
        raise ValueError("idx, tile_meta and declens do not match srcs and d_pad")
    if any(t.device != srcs.device for t in (idx, tile_meta, declens)):
        raise ValueError("all inputs must be on one device")


def decode_flat(srcs, idx, tile_meta, declens, d_pad: int, layout: int):
    """Decode ``(B, S)`` uint8 bodies to ``(B, d_pad)`` uint8 bytes.

    ``idx``: ``(B, d_pad)`` int16; ``tile_meta``: ``(B, d_pad // 1024, 2)``
    int32; ``declens``: ``(B,)`` int32. A CUDA input launches the kernel
    (or raises; a stream's first launch makes the stream's walk counter, so
    it must come before any CUDA graph capture on that stream); a CPU input
    runs :func:`decode_flat_plain`.
    """
    return decode_flat_groups([(srcs, idx, tile_meta, declens, d_pad, layout)])[0][0]


def tail_counts() -> list[int]:
    """The zero counts whose inverses the tables hold: ``lo`` and ``128 hi``
    for ``lo, hi`` in ``1..127``, so that the zeros past ``declen`` in the
    last live unit, ``128 hi + lo < 2**14``, go back in two steps."""
    return [lo for lo in range(1, TAIL_RADIX)] + [TAIL_RADIX * hi for hi in range(1, TAIL_RADIX)]


@functools.cache
def flat_crc_tables() -> np.ndarray:
    """The checksum instance's tables, one uint32 array in the kernel's
    order (``csrc/flat_gather.cu``): M_4 (four bytes a step) and the tree's
    levels M_{128 2^k}, ``k < 7``, as :func:`five_bit_tables`; then as
    eight nibble tables (:func:`nibble_tables`, 128 words) the units'
    M_{16384 k}, ``k = 1..7``, and the inverses of M_n for every ``n`` of
    :func:`tail_counts`. M_n advances a register past ``n`` zero bytes
    (``ops/crc32c.py``)."""
    ops = ([five_bit_tables(4)] + [five_bit_tables(RUN << k) for k in range(LEVELS)]
           + [nibble_tables(GROUP * k) for k in range(1, MAX_CRC_UNITS)]
           + [inverse_nibble_tables(n) for n in tail_counts()])
    return np.concatenate([op.reshape(-1) for op in ops]).astype(np.uint32)


_tables_lock = threading.Lock()
_crc_tables: dict[int, torch.Tensor] = {}


def _crc_scratch(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The checksum's tables on card ``device`` and the rows' words of state
    of its current stream, made by the first launch on each: the state
    zeroed once, and left zeroed by every launch.

    A CUDA graph capture would record the copy and the zeroing instead of
    running them, so a launch inside a capture needs both made before: it
    raises otherwise. A captured launch keeps the words of the stream it was
    captured on; replay it while no launch of that stream runs."""
    with _tables_lock:
        tabs = _crc_tables.get(device.index)
        if tabs is None:
            _build.not_capturing(device, "flat_gather_crc")
            tabs = torch.from_numpy(flat_crc_tables().view(np.int32)).to(device)
            torch.cuda.synchronize(device)  # copied in before any stream of any thread reads them
            _crc_tables[device.index] = tabs
    state = _build.stream_state(device, "flat_gather_crc",
                                lambda: torch.zeros(STATE_WORDS, dtype=torch.int64, device=device))
    return tabs, state


def decode_flat_crc(srcs, idx, tile_meta, declens, d_pad: int, layout: int):
    """:func:`decode_flat` and the masked CRC32C of each row's first
    ``declen`` bytes (clamped to ``[0, d_pad]``), as ``(out, crc)``: ``crc``
    ``(B,)`` int64, as ``crc32c_masked_blocks(out, declens)`` gives it.

    On the card one launch does both (counted in :data:`launches` and
    :data:`crc_launches`); rows wider than :data:`MAX_CRC_UNITS` units take
    K2 and then K1. A CPU input runs :func:`decode_flat_plain` and
    ``crc32c_plain``. A card's and a stream's first launch must come
    before any CUDA graph capture on them (:func:`_crc_scratch`)."""
    return decode_flat_groups([(srcs, idx, tile_meta, declens, d_pad, layout)], True)[0]


def _walk_counter(device) -> torch.Tensor:
    """The two words with which K2's launches on card ``device``'s current
    stream hand out units to their CTAs: zeroed once, made by the first
    launch on the stream (not inside a CUDA graph capture), left zeroed by
    every launch."""
    return _build.stream_state(device, "flat_gather_walk",
                               lambda: torch.zeros(2, dtype=torch.int32, device=device))


class _FlatGroup(ctypes.Structure):
    """One launch group of a ``stpu_cuda_flat_gather_groups`` launch
    (``csrc/flat_gather.cu`` ``FlatGroup``): its tensors' addresses, ``crc``
    0 without the checksum, then its rows and widths."""

    _fields_ = [*((f, ctypes.c_void_p) for f in ("srcs", "idx", "tile_meta", "declens", "out",
                                                  "crc")),
                *((f, ctypes.c_int64) for f in ("rows", "s_width", "d_pad"))]


@functools.cache
def _groups_kernel():
    fn = _build.kernel_lib("flat_gather").stpu_cuda_flat_gather_groups
    p = ctypes.c_void_p
    fn.argtypes = [ctypes.POINTER(_FlatGroup), ctypes.c_int, ctypes.c_int, p, p, p,
                   ctypes.POINTER(ctypes.c_int64), p]
    fn.restype = ctypes.c_int
    return fn


def _launch_sets(members: list[int], rows: list[int], crc: bool) -> list[list[int]]:
    """``members`` in order, cut into launches of at most
    :data:`MAX_LAUNCH_GROUPS` groups and, with the checksum, at most
    :data:`STATE_WORDS` rows (``rows[i]``: group ``i``'s)."""
    sets: list[list[int]] = []
    held = 0
    for i in members:
        if (not sets or len(sets[-1]) == MAX_LAUNCH_GROUPS
                or (crc and held + rows[i] > STATE_WORDS)):
            sets.append([])
            held = 0
        sets[-1].append(i)
        held += rows[i]
    return sets


def decode_flat_groups(groups, with_crc: bool = False):
    """Decode launch groups, each ``(srcs, idx, tile_meta, declens, d_pad,
    layout)`` as :func:`decode_flat` takes them, in as few launches as
    their kinds allow. Returns each group's ``(out, crc)``: ``crc`` as
    :func:`decode_flat_crc` gives it when ``with_crc``, else ``None``.

    Groups of one layout and one kernel instance share a launch (K2 with the
    checksum for rows of at most :data:`MAX_CRC_UNITS` units when
    ``with_crc``; K2 alone, then K1 on each group, for wider ones), up to
    :data:`MAX_LAUNCH_GROUPS` groups and, with the checksum, a stream's
    :data:`STATE_WORDS` rows a launch. Each launch counts
    in :data:`launches` (and ``layout_launches``, ``crc_launches``), its
    groups in :data:`launched_groups`, its units in :data:`launched_units`
    and its grid in :data:`launched_ctas`. CPU inputs run
    :func:`decode_flat_plain` on each group (and ``crc32c_plain``)."""
    for srcs, idx, tile_meta, declens, d_pad, layout in groups:
        _flat_checks(srcs, idx, tile_meta, declens, d_pad, layout)
    if not groups:
        return []
    dev = groups[0][0].device
    if any(g[0].device != dev for g in groups):
        raise ValueError("all groups must be on one device")
    if dev.type == "cpu":
        outs = [decode_flat_plain(*g) for g in groups]
        return [(out, crc32c_plain(out, g[3], masked=True) if with_crc else None)
                for out, g in zip(outs, groups)]
    results, kinds = [], {}
    for i, (srcs, idx, tile_meta, declens, d_pad, layout) in enumerate(groups):
        b, s = srcs.shape
        _cuda_checks((srcs, idx, tile_meta, declens), b, s)
        fused = with_crc and 0 < d_pad and -(-d_pad // GROUP) <= MAX_CRC_UNITS
        out = torch.empty((b, d_pad), dtype=torch.uint8, device=dev)
        results.append((out, torch.empty(b, dtype=torch.int64, device=dev) if fused else None))
        if b and d_pad:
            kinds.setdefault((layout, fused), []).append(i)
    rows = [g[0].shape[0] for g in groups]
    counter = _walk_counter(dev) if kinds else None
    for (layout, fused), members in kinds.items():
        tabs, state = _crc_scratch(dev) if fused else (None, None)
        for part in _launch_sets(members, rows, fused):
            table = (_FlatGroup * len(part))()
            for t, i in zip(table, part):
                srcs, idx, tile_meta, declens, d_pad, _ = groups[i]
                out, crc = results[i]
                t.srcs, t.idx, t.tile_meta, t.declens = (
                    srcs.data_ptr(), idx.data_ptr(), tile_meta.data_ptr(), declens.data_ptr())
                t.out, t.crc = out.data_ptr(), crc.data_ptr() if fused else 0
                t.rows, t.s_width, t.d_pad = rows[i], srcs.shape[1], d_pad
            _build.count(globals(), "launches")
            _build.count(layout_launches, layout)
            if fused:
                _build.count(globals(), "crc_launches")
            _build.count(globals(), "launched_groups", len(part))
            walked = (ctypes.c_int64 * 2)()
            _build.launch(dev, "flat_gather_groups", _groups_kernel(), table, len(part), layout,
                          tabs.data_ptr() if fused else None,
                          state.data_ptr() if fused else None, counter.data_ptr(), walked)
            _build.count(globals(), "launched_units", walked[0])
            _build.count(globals(), "launched_ctas", walked[1])
    if with_crc:
        results = [(out, crc32c_masked_blocks(out, g[3]) if crc is None else crc)
                   for (out, crc), g in zip(results, groups)]
    return results


def group_buckets(tile_meta, declens, d_pad: int):
    """Each 16 KiB group's window bucket: the widest of its 16 tiles'
    (``tile_meta[..., 1]``), or -1 for a group wholly past ``declen``.

    ``tile_meta``: ``(B, d_pad // 1024, 2)`` int32; ``declens``: ``(B,)``.
    Returns ``(B, d_pad // 16384)`` int32 on their device (the JAX
    package's ``group_buckets``, ``ops/pallas/decode.py:1228``)."""
    b, t, _ = tile_meta.shape
    if d_pad % GROUP or t != d_pad // 1024:
        raise ValueError(f"tile_meta of {t} tiles with d_pad {d_pad}")
    g = t // 16
    gb = tile_meta[:, :, 1].reshape(b, g, 16).amax(dim=2)
    n_active = (declens.to(torch.int64) + GROUP - 1) // GROUP
    dead = torch.arange(g, device=tile_meta.device)[None, :] >= n_active[:, None]
    return torch.where(dead, -1, gb).to(torch.int32)


def window_rows(s_rows: int) -> list[int]:
    """Window rows of buckets 0, 1, 2 for source rows of ``s_rows`` lines
    of 128 bytes: the nominal width, at most ``s_rows``, rounded up to 128
    (``_make_flat_v3_kernel``, ``_make_flat_v4_kernel``)."""
    return [-(-min(w, s_rows) // 128) * 128 for w in NOMINAL_WINDOWS]


def _group_window(gbuck, s_rows: int, variant: int):
    """Window rows of every output byte under K11's buckets, ``(B, d_pad)``:
    0 in a dead group."""
    gb = gbuck.to(torch.int64)
    live = (gb >= 0) & (gb <= 2) if variant == 3 else gb >= 0
    widths = torch.tensor(window_rows(s_rows), device=gbuck.device)
    return torch.where(live, widths[gb.clamp(0, 2)], 0).repeat_interleave(GROUP, dim=1)


def decode_flat_grouped_plain(srcs, idx, tile_meta, gbuck, declens, d_pad: int, variant: int):
    """K11's gather in PyTorch ops, on any device."""
    s = srcs.shape[1]
    window = _group_window(gbuck, s // 128, variant)
    p, ok = _reads(s, idx, tile_meta, declens, d_pad, 1, window)
    val = srcs.gather(1, p.clamp(0, s - 1))
    return torch.where(ok, val, 0).to(torch.uint8)


@functools.cache
def _grouped_kernel():
    fn = _build.kernel_lib("flat_gather").stpu_cuda_flat_grouped
    p, i64, cint = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [p, i64, i64, p, p, p, p, i64, cint, cint, cint, cint, p, p]
    fn.restype = ctypes.c_int
    return fn


def decode_flat_grouped(srcs, idx, tile_meta, gbuck, declens, d_pad: int, variant: int):
    """Decode ``(B, S)`` uint8 bodies to ``(B, d_pad)`` uint8 bytes with a
    window bucket per 16 KiB group: K11, the JAX package's
    ``decode_flat_pallas_v3`` (``variant=3``) or ``_v4`` (``variant=4``).

    ``idx``: ``(B, d_pad)`` int16 in the ``layout=1`` order;
    ``tile_meta``: ``(B, d_pad // 1024, 2)`` int32; ``gbuck``:
    ``(B, d_pad // 16384)`` int32; ``declens``: ``(B,)`` int32. ``S`` is
    whole 128-byte lines and ``d_pad`` whole 16 KiB groups. A CUDA input
    launches the kernel (or raises); a CPU input runs
    :func:`decode_flat_grouped_plain`.
    """
    b, s = srcs.shape
    if variant not in (3, 4):
        raise ValueError(f"variant {variant} is not 3 or 4")
    if srcs.dtype != torch.uint8 or idx.dtype != torch.int16:
        raise TypeError(f"srcs must be uint8 and idx int16, got {srcs.dtype}, {idx.dtype}")
    if any(t.dtype != torch.int32 for t in (tile_meta, gbuck, declens)):
        raise TypeError("tile_meta, gbuck and declens must be int32")
    if d_pad % GROUP or s % 128:
        raise ValueError(f"d_pad {d_pad} or row width {s} is not tiled")
    if (
        idx.shape != (b, d_pad)
        or tile_meta.shape != (b, d_pad // 1024, 2)
        or gbuck.shape != (b, d_pad // GROUP)
        or declens.shape != (b,)
    ):
        raise ValueError("idx, tile_meta, gbuck and declens do not match srcs and d_pad")
    tensors = (srcs, idx, tile_meta, gbuck, declens)
    if any(t.device != srcs.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if srcs.device.type == "cpu":
        return decode_flat_grouped_plain(srcs, idx, tile_meta, gbuck, declens, d_pad, variant)
    _cuda_checks(tensors, b, s)
    out = torch.empty((b, d_pad), dtype=torch.uint8, device=srcs.device)
    if b == 0 or d_pad == 0:
        return out
    _build.count(grouped_launches, variant)
    _build.launch(
        srcs.device, "flat_grouped", _grouped_kernel(),
        srcs.data_ptr(), b, s, idx.data_ptr(), tile_meta.data_ptr(), gbuck.data_ptr(),
        declens.data_ptr(), d_pad, variant, *window_rows(s // 128), out.data_ptr(),
    )
    return out
