"""Host-facing API over the CUDA kernels: decode and compress.

The port of the JAX package's ``ops/api.py``. :func:`compress` splits
its input into 64 KiB blocks for the exact encoder (``ops/encode.py``,
K7, the default) or the flat encoder (``ops/encode_flat.py``: prepass,
K4 segment parse, emission plan, K5 emission). For decode the
host parses the tiny framing (varint preambles, frame chunk headers),
groups rows by width, flattens copy chains with the native runtime, and
moves fixed-shape batches to and from the device, where three kernels do
the byte work:

- K2 ``decode_flat_groups`` emits every byte from its flattened source
  index, in one launch over a call's flat launch groups, and with the
  frame checksum also each row's CRC;
- K3 ``decode_replay`` decodes the groups the flatten cannot window;
- K1 ``crc32c_masked_blocks`` checks every frame chunk that another route
  decoded.

Two opt-in routes start from the host's op-record scan
(``native.scan_records_batch``) instead of the flatten, with the JAX
package's precedence and fall-through: ``Config.decode_records`` replays the
records (K10, ``ops/records.py``), and ``Config.decode_resolve`` resolves
every byte's literal origin on the card (K8, ``ops/resolve.py``) before K2.
Two more decode in tensor ops (``ops/decode.py``, the JAX package's XLA
decode): the hosted route from the host's op-start bitmap
(``native.scan_ops_batch``), where ``Config.decode_kernels`` is ``False``
or a group is wider than the replay kernel takes, and the all-device route,
op discovery included, under ``Config.pure_device``.

Exact error parity: kernels reduce validity to a device code; on any
flagged stream the host re-runs the NumPy reference codec, which raises
the identical exception the sequential loop would have (same variant,
same fields).

Entry points run on ``Config.device`` (``"cuda"`` by default) unless the
caller passes ``device``. With a CUDA device and no card they raise;
nothing falls back to the CPU. On ``device="cpu"`` the kernels' plain
PyTorch versions run instead, which is how the CPU tests hold the port
against the JAX package.

The parts of every call are timed by the port's recorder,
:mod:`snappy_tpu_torch.trace`; ``api.spans`` and ``api.records`` read and
set its two views.
"""

from __future__ import annotations

import sys
import types
from typing import NamedTuple

import numpy as np
import torch

from .. import error as err
from .. import native, trace
from ..config import get_config
from ..format import reference as ref
from ..format.constants import (
    CHUNK_TYPE_COMPRESSED,
    CHUNK_TYPE_PADDING,
    CHUNK_TYPE_STREAM,
    CHUNK_TYPE_UNCOMPRESSED,
    MAX_BLOCK_SIZE,
    MAX_COMPRESS_BLOCK_SIZE,
    MAX_INPUT_SIZE,
    STREAM_BODY,
    max_compress_len,
)
from ..format.varint import read_varu64, write_varu64
from ..trace import span
from . import packing
from .crc32c import crc32c_masked_blocks
from .decode import decode_batch, decode_batch_hosted, decode_crc_batch, decode_crc_batch_hosted
from .decode_flat import decode_flat_groups
from .encode import compress_blocks_host
from .encode_fast import compress_blocks_fast_host
from .encode_flat import compress_blocks_flat_host
from .records import decode_records
from .replay import OK, decode_replay
from .resolve import decode_resolve_batch

#: The route each decode launch group took, in order, while this is a list
#: (set it to ``[]`` to start, ``None`` to stop): ``(rows, d_pad, route,
#: width, live_in, live_out)`` with ``route`` one of ``"flat"``,
#: ``"replay"``, ``"records"``, ``"resolve"``, ``"parallel_hosted"``,
#: ``"parallel"`` and ``"host"`` (a group past ``Config.max_dpad`` that
#: :func:`decompress_streams` hands to the host codec); ``width`` is the
#: group's source row width, ``live_in`` and ``live_out`` its compressed
#: and uncompressed bytes, so that ``rows * width - live_in`` and ``rows *
#: d_pad - live_out`` are the padding the group places on the card.
routes: list[tuple[int, int, str, int, int, int]] | None = None


class _Views(types.ModuleType):
    """``api.spans`` and ``api.records`` are :mod:`..trace`'s views, which
    ``benchmark/single.py`` sets here."""

    spans = property(lambda _: trace.spans, lambda _, v: setattr(trace, "spans", v))
    records = property(lambda _: trace.records, lambda _, v: setattr(trace, "records", v))


sys.modules[__name__].__class__ = _Views


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device``, else ``Config.device``.

    A CUDA device with no card raises; nothing runs quietly on the CPU.
    """
    dev = torch.device(device if device is not None else get_config().device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "snappy_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the kernels' plain versions on the CPU"
        )
    return dev


@trace.entry
def compress(
    data: bytes, profile: str = "exact", device: str | torch.device | None = None
) -> bytes:
    """Compress one raw Snappy stream on the device.

    ``profile="exact"`` (the default) runs the reference's greedy
    automaton per block (K7): byte for byte the reference encoder's
    stream and the JAX package's ``ops.api.compress(data)``.
    ``profile="fast"`` takes the encoder ``Config.flat_encode`` selects:
    the flat encoder (K4, K5) under ``True`` or ``None``, the fast profile
    in tensor ops (``ops/encode_fast.py``) under ``False``; byte for byte
    the JAX package's ``compress(data, profile="fast")`` under the same
    setting (its ``None`` means flat on its TPU, which the card stands in
    for). Both give valid Snappy, at most the reference encoder's size on
    real data. The host splits the input into 64 KiB blocks, launches them in
    batches of ``Config.blocks_per_launch`` rows (padded to a power of
    two), and joins the varint preamble and each block's op stream.
    """
    dev = resolve_device(device)
    n = len(data)
    if max_compress_len(n) == 0:
        raise err.TooBig(given=n, max=MAX_INPUT_SIZE)
    if n == 0:
        return b"\x00"
    if profile == "exact":
        codec = compress_blocks_host
    elif profile == "fast":
        flat = get_config().flat_encode is not False
        codec = compress_blocks_flat_host if flat else compress_blocks_fast_host
    else:
        raise ValueError(f"unknown profile {profile!r}")

    with span("pack"):
        blocks, lengths = packing.blocks_of(data)
    parts = [write_varu64(n)]
    size = len(parts[0])
    bpl = get_config().blocks_per_launch
    for start in range(0, blocks.shape[0], bpl):
        with span("pack"):
            bb = blocks[start : start + bpl]
            ll = lengths[start : start + bpl]
            want = bb.shape[0]
            padded = packing.pad_to_bucket(want, 1)
            if padded != want:
                bb = np.concatenate([bb, np.zeros((padded - want, bb.shape[1]), bb.dtype)])
                ll = np.concatenate([ll, np.zeros(padded - want, ll.dtype)])
        outs, outlens = codec(bb, ll, dev)
        made = int(outlens[:want].sum())
        size += made
        with span("join", nbytes=made):
            parts.extend(outs[i, : int(outlens[i])].tobytes() for i in range(want))
    with span("join", nbytes=size):
        return b"".join(parts)


def _check_header(data: bytes) -> tuple[int, int]:
    if len(data) == 0:
        raise err.Empty()
    declen, hdr = read_varu64(data)
    if hdr == 0:
        raise err.Header()
    if declen > MAX_INPUT_SIZE:
        raise err.TooBig(given=declen, max=MAX_INPUT_SIZE)
    return declen, hdr


@trace.entry
def decompress(data: bytes, device: str | torch.device | None = None) -> bytes:
    """Decompress one raw Snappy stream on the device.

    Bit-exact output and exact error parity with the reference decoder.
    Streams past ``Config.max_device_stream``, ``max_device_output`` or
    ``max_dpad`` decode on the host engine.
    """
    dev = resolve_device(device)
    cfg = get_config()
    declen, hdr = _check_header(data)
    # Scratch-allocation guard: in any valid stream the densest op is
    # copy2/copy4 (>= 3 stream bytes per <= 64 output bytes), so declen
    # can't exceed ~22x the body. A crafted few-byte stream declaring a
    # huge declen must not get to size device buffers; the sequential
    # host engine raises the reference's exact error without that.
    if declen > (64 * max(len(data) - hdr, 0)) // 3 + 64:
        return native.decompress(data)
    if len(data) > cfg.max_device_stream or declen > cfg.max_device_output:
        return native.decompress(data)
    # decompress_streams would route a row this wide to the host anyway.
    if declen > cfg.max_dpad:
        return native.decompress(data)
    outs, errs, _ = decompress_streams([data[hdr:]], [declen], device=dev)
    if int(errs[0]) != OK:
        ref.decompress(data)  # raises the exact sequential error
        raise err.HeaderMismatch(expected_len=declen, got_len=-1)  # unreachable
    return outs[0]


def _width_bucket(n: int) -> int:
    """Static row width for a body of ``n`` bytes (bounded bucket set)."""
    b = packing.pad_to_bucket(max(n, 1), 1024)
    if 65536 < n <= 81920:
        # Frame-chunk bodies top out at max_compress_len(65536) = 76490;
        # an 81920 row beats the 128 KiB pow2 bucket by 36%.
        b = 81920
    return b


def launch_groups(bodies: list[bytes], rows_per_launch: int) -> list[list[int]]:
    """Row indices per launch: rows sorted by width bucket, each group
    one bucket and at most ``rows_per_launch`` rows."""
    order = sorted(range(len(bodies)), key=lambda i: _width_bucket(len(bodies[i])))
    groups: list[list[int]] = []
    for i in order:
        g = groups[-1] if groups else None
        if (
            g is None
            or len(g) == rows_per_launch
            or _width_bucket(len(bodies[g[0]])) != _width_bucket(len(bodies[i]))
        ):
            groups.append([])
        groups[-1].append(i)
    return groups


def _record_cap(width: int) -> int:
    """The record scan's cap for rows of ``width`` bytes (as the JAX
    package's routes size it): half the width plus one, at most 16 Ki
    records, in whole 512s."""
    return -(-min(16384, width // 2 + 1) // 512) * 512


def _scan_route(srcs, lens, declens, srcs_t, declens_t, d_pad, cfg):
    """The record-scan routes of one launch group: K10 under
    ``decode_records``, K8 then K2 under ``decode_resolve``. Returns
    ``(dst, errs)``, or ``None`` where the group falls through (a record-cap
    overflow, or a resolve fallback flag)."""
    rec_cap = _record_cap(srcs.shape[1])
    with span("scan"):
        recs, nops, herrs, _ = native.scan_records_batch(
            srcs, np.asarray(lens, np.uint64), np.asarray(declens, np.uint64), rec_cap)
    n_max = int(nops.max(initial=0))
    if n_max > rec_cap:
        return None
    r_pad = max(512, -(-n_max // 512) * 512)
    with span("h2d", nbytes=recs[:, :r_pad].nbytes + 4 * len(nops)):
        recs_t = torch.from_numpy(np.ascontiguousarray(recs[:, :r_pad])).to(srcs_t.device)
        nops_t = torch.from_numpy(nops.astype(np.int32)).to(srcs_t.device)
    if cfg.decode_records:
        with span("kernels", srcs_t.device):
            return decode_records(srcs_t, recs_t, nops_t, declens_t, d_pad), herrs
    dst, fallback = decode_resolve_batch(srcs_t, recs_t, nops_t, declens_t, d_pad)
    with span("d2h"):
        return None if bool(fallback.any()) else (dst, herrs)


def decode_routes(cfg) -> tuple[bool, bool]:
    """``(host scan, kernel routes)`` under ``cfg``, the JAX package's
    precedence: ``pure_device`` turns off the host scan and, unless
    ``decode_kernels`` is ``True``, the kernels; ``decode_kernels=False``
    turns off the kernels."""
    kernels = cfg.decode_kernels if cfg.decode_kernels is not None else not cfg.pure_device
    return not cfg.pure_device, kernels


def _tensor_route(srcs, lens, srcs_t, declens_t, d_pad, scan: bool, with_crc: bool):
    """A launch group through the tensor decode of ``ops/decode.py``: from
    the host's op-start bitmaps when ``scan``, else all on the device.
    Returns ``(dst, err tensor, crc tensor or None)``."""
    dev = srcs_t.device
    with span("h2d", nbytes=4 * len(lens)):
        lens_t = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
    args = (srcs_t, lens_t, declens_t)
    if scan:
        with span("scan"):
            bits = np.zeros((srcs.shape[0], srcs.shape[1] // 8), np.uint8)
            native.scan_ops_batch(srcs, np.asarray(lens, np.uint64), bits)
        with span("h2d", nbytes=bits.nbytes):
            args += (torch.from_numpy(bits).to(dev),)
    if scan:
        fn = decode_crc_batch_hosted if with_crc else decode_batch_hosted
    else:
        fn = decode_crc_batch if with_crc else decode_batch
    with span("tensor", dev):
        dst, errs, _total, *crc = fn(*args, d_pad)
    return dst, errs, (crc[0] if with_crc else None)


class _Flat(NamedTuple):
    """A launch group that the flatten took, its inputs on the card: the
    group as :func:`decode_flat_groups` takes it, and its host codes."""

    group: tuple
    errs: np.ndarray


def _card_bytes(rows: int, width: int, d_pad: int) -> int:
    """The card bytes of a launch group on the flat route: its sources and
    lengths, the flatten's indices and tile meta, its output and CRCs."""
    return rows * (width + 4 + 2 * d_pad + 8 * (d_pad // 1024) + d_pad + 8)


def decode_group(srcs: np.ndarray, lens: np.ndarray, declens: list[int], d_pad: int,
                 dev: torch.device, with_crc: bool = False):
    """Decode one launch group of zero-padded bodies on ``dev``, or make it
    ready for K2.

    The kernel routes, in the JAX package's order, when they are on
    (:func:`decode_routes`) and ``d_pad`` is within ``Config.max_dpad``:
    under ``Config.decode_records`` the host scans the ops into records and
    K10 replays them; else under ``Config.decode_resolve``, for a group of
    outputs in whole 16 KiB up to 64 KiB and rows up to 64 KiB, the host
    scans and the card resolves (``ops/resolve.py``); else, under
    ``Config.decode_flat`` (the default), the host flatten resolves every
    copy chain and K2 gathers the bytes (``layout=1`` when ``d_pad`` is
    whole 16 KiB groups, else 0), with the CRCs in the same launch when
    ``with_crc``: the group comes back as a :class:`_Flat`, its indices on
    the card, for the launch that :func:`decompress_streams` makes over
    every such group of the call. A group these leave (a record-cap
    overflow, a flagged resolve, a tile the flatten cannot window) takes
    K3 if its rows are at most ``Config.replay_max_body`` wide. Every other
    group decodes in tensor ops: from the host's op-start bitmap, or all
    on the device under ``Config.pure_device``. Returns, but on the flat
    route, ``(dst (B, d_pad) uint8 on dev, errs (B,) int32 numpy, crcs (B,)
    int64 on dev or None)``; the CRCs when ``with_crc`` (K1's, but on the
    tensor routes, which take their own). A group wider than
    ``Config.max_dpad`` never gets here while the host scan is on:
    :func:`decompress_streams` decodes it with the host codec, the
    ``"host"`` entry of :data:`routes`.
    """
    with span("pack"):
        cfg = get_config()
        scan, kernels = decode_routes(cfg)
        kernels = kernels and d_pad <= cfg.max_dpad
        scanned = kernels and scan  # the kernel routes that start from a host scan
        use_records = scanned and cfg.decode_records
        resolve_ok = d_pad % 16384 == 0 and d_pad <= 65536 and srcs.shape[1] <= 65536
        layout = 1 if d_pad % 16384 == 0 else 0
    with span("h2d", nbytes=srcs.nbytes + 4 * len(declens)):
        srcs_t = torch.from_numpy(srcs).to(dev)
        declens_t = torch.from_numpy(np.asarray(declens, np.int32)).to(dev)
    got, crc = None, None
    if use_records or (scanned and cfg.decode_resolve and resolve_ok):
        got = _scan_route(srcs, lens, declens, srcs_t, declens_t, d_pad, cfg)
        route = "records" if use_records else "resolve"
    if got is None and scanned and cfg.decode_flat and not use_records:
        # idx (rows, d_pad) uint16 and tmeta (rows, d_pad // 1024, 2) int32
        with span("flatten", nbytes=srcs.shape[0] * (2 * d_pad + 8 * (d_pad // 1024))):
            idx, tmeta, fallb, herrs, _ = native.flatten_idx_batch(
                srcs, np.asarray(lens, np.uint64), np.asarray(declens, np.uint64), d_pad,
                layout=layout,
            )
            fell = fallb.any()
        if not fell:
            with span("h2d", nbytes=idx.nbytes + tmeta.nbytes):
                idx_t = torch.from_numpy(idx.view(np.int16)).to(dev)
                tmeta_t = torch.from_numpy(tmeta).to(dev)
                del idx, tmeta  # the copies' sources go here, not as the group returns
            if routes is not None:
                with span("pack"):
                    _note_route("flat", d_pad, srcs, lens, declens)
            return _Flat((srcs_t, idx_t, tmeta_t, declens_t, d_pad, layout), herrs)
    if got is None and kernels and srcs.shape[1] <= cfg.replay_max_body:
        with span("h2d", nbytes=4 * len(lens)):
            lens_t = torch.from_numpy(np.asarray(lens, np.int32)).to(dev)
        with span("kernels", dev):
            dst, gerrs = decode_replay(srcs_t, lens_t, declens_t, d_pad)
        with span("d2h", nbytes=gerrs.nbytes):
            got = dst, gerrs.cpu().numpy()
        route = "replay"
    if got is None:
        dst, gerrs, crc = _tensor_route(srcs, lens, srcs_t, declens_t, d_pad, scan, with_crc)
        with span("d2h", nbytes=gerrs.nbytes):
            got = dst, gerrs.cpu().numpy()
        route = "parallel_hosted" if scan else "parallel"
    elif with_crc and crc is None:
        with span("kernels", dev):
            crc = crc32c_masked_blocks(got[0], declens_t)
    if routes is not None:
        with span("pack"):
            _note_route(route, d_pad, srcs, lens, declens)
    return (*got, crc)


def _note_route(route: str, d_pad: int, srcs: np.ndarray, lens, declens: list[int]) -> None:
    """Append one launch group's entry to :data:`routes`, which is on."""
    routes.append((len(declens), d_pad, route, srcs.shape[1], int(np.sum(lens)), sum(declens)))


@trace.entry
def decompress_streams(
    bodies: list[bytes],
    declens: list[int],
    with_crc: bool = False,
    device: str | torch.device | None = None,
) -> tuple[list[bytes], np.ndarray, np.ndarray | None]:
    """Batched device decode of raw op streams (no varint headers).

    Returns ``(outputs, err_codes, crcs-or-None)`` in input order. Rows
    are packed into launch groups by width bucket, so small chunks don't
    pay the widest row's traffic, of at most
    ``Config.decode_rows_per_launch`` rows each. Every group the flat route
    takes (:func:`decode_group`) decodes in one launch of K2 after all are
    ready (one a layout and checksum kind, ``decode_flat_groups``), so
    groups that are each under one wave fill the card together; a group
    joins that launch only while the groups it holds stay within the card
    bytes of one group of ``decode_rows_per_launch`` rows at ``max_dpad``
    (:func:`_card_bytes`), else the groups held launch first. Other routes
    decode their group as they meet it. ``with_crc=True`` also returns each
    output's masked CRC32C, computed on the device before the bytes leave
    it.

    A group's ``d_pad`` is its widest output rounded up to a power of two;
    past ``Config.max_dpad`` (streams just past 1 MiB already) the group
    decodes with the multithreaded host codec, unless ``pure_device`` is
    set, and enters :data:`routes` with the route ``"host"``. Every stream
    is validated: a bad one gets a nonzero code in ``err_codes`` (its
    output is then not defined), and the other streams of the call decode
    as they would without it.
    """
    with span("pack"):
        dev = resolve_device(device)
        cfg = get_config()
    if not bodies:
        return [], np.zeros(0, np.int32), (np.zeros(0, np.uint32) if with_crc else None)

    scan, _ = decode_routes(cfg)
    with span("pack"):
        outs: list[bytes] = [b""] * len(bodies)
        errs = np.zeros(len(bodies), np.int32)
        crcs = np.zeros(len(bodies), np.uint32) if with_crc else None
        groups = launch_groups(bodies, cfg.decode_rows_per_launch)
        budget = _card_bytes(cfg.decode_rows_per_launch, cfg.max_dpad, cfg.max_dpad)

    def take(idxs, group, gdecl, dst, gerrs, gcrc):
        """Copy one group's rows back and unpack them."""
        with span("d2h", nbytes=dst.nbytes + (gcrc.nbytes if with_crc else 0)):
            gcrc = gcrc.cpu().numpy() if with_crc else None
            dst = dst.cpu().numpy()
        with span("unpack", nbytes=sum(gdecl)):
            for j, i in enumerate(idxs):
                outs[i] = dst[j, : gdecl[j]].tobytes()
                if gcrc is not None:
                    crcs[i] = gcrc[j]
            errs[idxs] = gerrs
        if cfg.debug:
            _debug_check_streams(group, gdecl, [outs[i] for i in idxs], gerrs)

    def launch(flat):
        """K2 over the flat route's groups held, then each group taken back
        in input order."""
        with span("kernels", dev):
            got = decode_flat_groups([f.group for *_, f in flat], with_crc)
        for (idxs, group, gdecl, f), (dst, gcrc) in zip(flat, got):
            take(idxs, group, gdecl, dst, f.errs, gcrc)

    flat, held = [], 0  # the flat route's groups, and their card bytes
    for idxs in groups:
        with span("pack"):
            group = [bodies[i] for i in idxs]
            gdecl = [declens[i] for i in idxs]
            d_pad = packing.pad_to_bucket(max(max(gdecl), 1), 1024)
            srcs, lens = packing.batch_streams(group, _width_bucket(len(group[0])))
        if d_pad > cfg.max_dpad and scan:
            # Oversized rows (multi-MB raw streams; frame chunks never get
            # here): the multithreaded host codec. Error codes come from
            # the host op scan, a lockstep mirror of device validation.
            # Under pure_device they decode on the device, in tensor ops.
            with span("host_decode", nbytes=sum(gdecl)):
                _, _, gerrs, _ = native.scan_records_batch(
                    srcs, np.asarray(lens, np.uint64), np.asarray(gdecl, np.uint64), 512
                )
                ok_rows = [j for j in range(len(group)) if int(gerrs[j]) == 0]
                decoded = native.decompress_batch(
                    [write_varu64(gdecl[j]) + group[j] for j in ok_rows]
                )
                for k, j in enumerate(ok_rows):
                    outs[idxs[j]] = decoded[k]
                    if with_crc:
                        crcs[idxs[j]] = native.crc32c_masked(decoded[k])
                errs[idxs] = gerrs
            if routes is not None:
                _note_route("host", d_pad, srcs, lens, gdecl)
            if cfg.debug:
                _debug_check_streams(group, gdecl, [outs[i] for i in idxs], gerrs)
            continue
        need = _card_bytes(len(idxs), srcs.shape[1], d_pad)
        if flat and held + need > budget:
            launch(flat)
            flat, held = [], 0
        got = decode_group(srcs, lens, gdecl, d_pad, dev, with_crc)
        if isinstance(got, _Flat):
            flat.append((idxs, group, gdecl, got))
            held += need
        else:
            take(idxs, group, gdecl, *got)
    if flat:
        launch(flat)
    return outs, errs, crcs


def _debug_check_streams(bodies, declens, outs, errcodes) -> None:
    """Sanitizer mode (``Config.debug``): cross-check every device decode
    against the NumPy oracle (output bytes and error/no-error agreement)
    and fail loudly on divergence."""
    for body, declen, out, code in zip(bodies, declens, outs, errcodes):
        try:
            want = ref.decompress(write_varu64(declen) + body)
        except err.SnappyError:
            if int(code) == OK:
                raise AssertionError(
                    "snappy_tpu_torch debug: device decode accepted a stream "
                    "the oracle rejects"
                )
            continue
        if int(code) != OK:
            raise AssertionError(
                "snappy_tpu_torch debug: device decode flagged a stream the "
                f"oracle accepts (code {int(code)})"
            )
        if out != want:
            raise AssertionError(
                "snappy_tpu_torch debug: device decode output mismatch vs oracle"
            )


@trace.entry
def decompress_frame(data: bytes, device: str | torch.device | None = None) -> bytes:
    """Decode a whole frame-format buffer with batched device kernels.

    The host walks the chunk structure (a few bytes per 64 KiB chunk);
    all compressed chunk payloads decode in one device batch with their
    masked CRC32C. Error semantics match the streaming reader (reference
    ``src/read.rs:105-238``) exactly: the walk stops at the first
    structural error, data chunks before it are checked in stream order
    (decode errors precede the chunk's checksum check), and the earliest
    failure wins.
    """
    with span("pack"):
        dev = resolve_device(device)
    pos = 0
    n = len(data)
    read_ident = False
    # (kind 0=compressed/1=uncompressed, body, expected_crc, declen,
    #  known_error or None) in stream order.
    datachunks = []
    pending: Exception | None = None  # first structural error, if any
    stored = 0  # bytes of the uncompressed chunks' bodies

    def _need(k: int) -> bytes:
        nonlocal pos
        if pos + k > n:
            raise EOFError("snappy: unexpected EOF while reading frame chunk")
        out = data[pos : pos + k]
        pos += k
        return out

    with span("walk", nbytes=n):
        try:
            while pos < n:
                header = _need(4)
                ty = header[0]
                if not read_ident:
                    if ty != CHUNK_TYPE_STREAM:
                        raise err.StreamHeader(byte=ty)
                    read_ident = True
                length = header[1] | (header[2] << 8) | (header[3] << 16)
                if length > MAX_COMPRESS_BLOCK_SIZE:
                    raise err.UnsupportedChunkLength(len=length, header=False)
                if 0x02 <= ty <= 0x7F:
                    raise err.UnsupportedChunkType(byte=ty)
                if 0x80 <= ty <= 0xFD or ty == CHUNK_TYPE_PADDING:
                    _need(length)
                    continue
                if ty == CHUNK_TYPE_STREAM:
                    if length != len(STREAM_BODY):
                        raise err.UnsupportedChunkLength(len=length, header=True)
                    body = _need(length)
                    if body != STREAM_BODY:
                        raise err.StreamHeaderMismatch(bytes=body)
                    continue
                if length < 4:
                    raise err.UnsupportedChunkLength(len=length, header=False)
                payload = _need(length)
                crc = int.from_bytes(payload[:4], "little")
                body = payload[4:]
                if ty == CHUNK_TYPE_UNCOMPRESSED:
                    if len(body) > MAX_BLOCK_SIZE:
                        raise err.UnsupportedChunkLength(len=len(body), header=False)
                    datachunks.append((1, body, crc, len(body), None))
                    stored += len(body)
                else:
                    assert ty == CHUNK_TYPE_COMPRESSED
                    # Mirror the sequential reader: decompress_len, the
                    # MAX_BLOCK_SIZE bound, then decode (src/read.rs:200-235).
                    known = None
                    declen = 0
                    if len(body) == 0:
                        known = err.Empty()
                    else:
                        try:
                            declen, hdr = _check_header(body)
                            body = body[hdr:]
                        except err.SnappyError as e:
                            known = e
                        else:
                            if declen > MAX_BLOCK_SIZE:
                                raise err.UnsupportedChunkLength(
                                    len=declen, header=False
                                )
                    datachunks.append((0, body, crc, declen, known))
                    if known is not None:
                        break  # sequential reader stops at this chunk
        except (err.SnappyError, EOFError) as e:
            pending = e

    with span("pack"):
        comp_idx = [i for i, c in enumerate(datachunks) if c[0] == 0 and c[4] is None]
        # Uncompressed chunks pass through; known-error chunks contribute no
        # bytes (their error is raised before their checksum would be read).
        outputs = [c[1] if c[0] == 1 else b"" for c in datachunks]
        errcodes = np.zeros(len(comp_idx), np.int32)
        got_crc = np.zeros(len(datachunks), np.uint32)
        bodies = [datachunks[i][1] for i in comp_idx]
        declens = [datachunks[i][3] for i in comp_idx]
    if comp_idx:
        outs, errcodes, comp_crc = decompress_streams(bodies, declens, with_crc=True, device=dev)
        with span("unpack"):
            for j, i in enumerate(comp_idx):
                outputs[i] = outs[j]
                got_crc[i] = comp_crc[j]
            del outs

    if datachunks:
        # Uncompressed chunks: checksum their host-resident payloads with
        # the host engine's hardware CRC; then every chunk's check.
        with span("stored_crc", nbytes=stored):
            for i, c in enumerate(datachunks):
                if c[0] == 1:
                    got_crc[i] = native.crc32c_masked(c[1])
            exp_crc = np.array([c[2] for c in datachunks], np.uint32)
            bad_dec = {i: int(e) for i, e in zip(comp_idx, errcodes) if int(e) != OK}
            bad_crc = set(np.nonzero(got_crc != exp_crc)[0].tolist())
            for i, chunk in enumerate(datachunks):
                if chunk[4] is not None:
                    raise chunk[4]
                if i in bad_dec:
                    ref.decompress(write_varu64(chunk[3]) + chunk[1])
                    raise err.HeaderMismatch(expected_len=chunk[3], got_len=-1)
                if i in bad_crc:
                    raise err.Checksum(expected=int(exp_crc[i]), got=int(got_crc[i]))

    if pending is not None:
        raise pending
    with span("join", nbytes=stored + sum(declens)):
        out = b"".join(outputs)
        del outputs, bodies, datachunks  # the chunks' buffers go here, not as the call returns
        return out
