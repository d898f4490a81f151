"""The codec entries sharded over a 1-D block mesh.

The port of ``snappy_tpu/parallel/sharded.py``. Each JAX entry is one
``shard_map`` whose ``out_specs`` keep every shard's output on its own
device; here each entry cuts the batch axis into ``mesh.size`` equal
shards and runs the port's batched function on shard ``i`` on
``mesh.devices[i]``, every shard at once, one host thread an entry of the
mesh (:func:`map_shards`; the threads are kept for the process and
reused). Each thread makes its entry's card current,
runs on that card's current stream (the caller's, as the caller's thread
sees it), copies its own rows in from host memory, and leaves its output
on its card. The entry returns a :class:`Sharded` (a tuple of them for
several outputs): one tensor a mesh entry, in block order. Nothing is
concatenated: ``Sharded.numpy()`` and ``Sharded.cpu()`` copy each shard to
the host from its own card, and ``Sharded.gather()`` (the only move from
card to card, made only when a caller asks for it) joins the shards on one
device. A ``Sharded`` input that lies on the entry's mesh is used in place,
so a chain of entries stays on the cards.

Blocks are independent (no shared dictionary, no cross-block offsets), so
no entry calls ``torch.distributed``, as the JAX entries compile without
collectives; the per-block output lengths are all a stream's assembly
needs (:func:`stream_offsets`). A mesh of one is one call, in the caller's
thread, whose output is the one shard. If a shard raises, the entry raises
that exception (the first by mesh order) once every shard has ended;
nothing is run again elsewhere.

Port entry -> JAX entry, and what each shard runs:

- :func:`pad_batch` -> ``pad_batch`` (numpy);
- :func:`sharded_compress_blocks` -> ``sharded_compress_blocks``:
  ``ops.encode.compress_blocks`` (K7), or with ``fast=True``
  ``ops.encode_fast.compress_blocks_fast`` (tensor ops);
- :func:`sharded_compress_blocks_flat` -> ``sharded_compress_blocks_flat``:
  ``ops.encode_flat.compress_blocks_flat_fast`` (K4, K5; the JAX
  package's ``_compress_blocks_flat_fused``);
- :func:`sharded_decode_streams` -> ``sharded_decode_streams``:
  ``ops.decode.decode_batch`` (tensor ops);
- :func:`sharded_decode_streams_hosted` -> ``sharded_decode_streams_hosted``:
  ``ops.decode.decode_batch_hosted`` (tensor ops);
- :func:`sharded_decode_flat_host` -> ``sharded_decode_flat_host``: the host
  flatten (``native.flatten_idx_batch(layout=1)``), then
  :func:`sharded_decode_streams_flat`;
- :func:`sharded_decode_resolve` -> ``sharded_decode_resolve``:
  ``ops.resolve.decode_resolve_batch`` (K8, K2);
- :func:`sharded_decode_streams_replay` -> ``sharded_decode_streams_pallas``
  (the port's name says what runs; the JAX name is kept as a second name
  of the same function): ``ops.replay.decode_replay`` (K3);
- :func:`sharded_decode_streams_flat` -> ``sharded_decode_streams_flat``:
  ``ops.decode_flat.decode_flat(layout=1)`` (K2);
- :func:`sharded_encode_frame_chunks` -> ``sharded_encode_frame_chunks``:
  ``ops.frame.encode_frame_chunks`` (K1, K7);
- :func:`stream_offsets` -> ``stream_offsets`` (``torch.cumsum``);
- :func:`map_shards` -> ``shard_map`` itself, for any batched function.

Each entry shards over the mesh's :data:`BLOCK_AXIS` and raises
``ValueError`` on a mesh of another axis name, as the JAX entries' specs
do. Inputs are numpy arrays, tensors (on the CPU or a card; a shard of one on
another device than its entry's is copied there) or :class:`Sharded`;
lengths of any integer type are taken as the port's functions take them
(int32).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from .. import native
from ..ops.decode import decode_batch, decode_batch_hosted
from ..ops.decode_flat import decode_flat
from ..ops.encode import compress_blocks
from ..ops.encode_fast import compress_blocks_fast
from ..ops.encode_flat import compress_blocks_flat_fast
from ..ops.frame import encode_frame_chunks
from ..ops.replay import decode_replay
from ..ops.resolve import decode_resolve_batch
from .mesh import BLOCK_AXIS


def pad_batch(arrs: np.ndarray, lengths: np.ndarray, multiple: int):
    """Pad the batch axis to a multiple of the mesh size (zero rows)."""
    b = arrs.shape[0]
    pb = -(-b // multiple) * multiple
    if pb != b:
        arrs = np.concatenate(
            [arrs, np.zeros((pb - b,) + arrs.shape[1:], arrs.dtype)], axis=0
        )
        lengths = np.concatenate([lengths, np.zeros(pb - b, lengths.dtype)])
    return arrs, lengths, b


class Sharded:
    """A batch cut along its first axis over a mesh, shard ``i`` a tensor on
    ``mesh.devices[i]``: the port's counterpart of a JAX array sharded
    ``P(BLOCK_AXIS, ...)``. Its rows are the shards' rows in block order.

    ``numpy()`` and ``cpu()`` copy every shard to the host, each from its
    own card; ``gather(device)`` joins the shards on one device."""

    __slots__ = ("mesh", "shards")

    def __init__(self, mesh, shards):
        shards = tuple(shards)
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        for i, (t, dev) in enumerate(zip(shards, mesh.devices)):
            if t.device != dev:
                raise ValueError(f"shard {i} lies on {t.device}, not on its entry's {dev}")
        self.mesh, self.shards = mesh, shards

    @property
    def shape(self) -> torch.Size:
        return torch.Size((sum(t.shape[0] for t in self.shards), *self.shards[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def __len__(self) -> int:
        return self.shape[0]

    def cpu(self) -> torch.Tensor:
        """The rows in host memory, each shard copied from its own card by a
        thread of its own."""
        parts = _on_each(self.mesh, lambda i, dev: self.shards[i].cpu())
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype, copy=False)

    def gather(self, device=None) -> torch.Tensor:
        """The rows joined on ``device`` (default the mesh's first): the one
        move from card to card, which only a caller asks for."""
        dev = self.mesh.devices[0] if device is None else torch.device(device)
        parts = [t.to(dev) for t in self.shards]
        return parts[0] if len(parts) == 1 else torch.cat(parts)


_pool_lock = threading.Lock()
_pool: tuple[int, ThreadPoolExecutor] | None = None


def _workers() -> ThreadPoolExecutor:
    """The threads that run shards: started at first use and kept for the
    process (a new thread's first calls on a card cost milliseconds;
    ``multi_card_probe.py`` times them), as many as shards have run at once,
    nested entries included. A forked child starts its own."""
    global _pool
    with _pool_lock:
        if _pool is None or _pool[0] != os.getpid():
            _pool = (os.getpid(), ThreadPoolExecutor(max_workers=1024, thread_name_prefix="shard"))
        return _pool[1]


def _on_each(mesh, work) -> list:
    """``work(i, device)`` for every entry ``i`` of ``mesh`` at once, one host
    thread an entry, each with its card current and on that card's current
    stream as the calling thread sees it (two entries on one card share it).
    A mesh of one runs in the calling thread. Returns the results in mesh
    order once every entry's work has ended; if any raised, raises the first
    by mesh order."""
    devices = mesh.devices
    streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None for d in devices]

    def run(i):
        with contextlib.ExitStack() as on:
            if streams[i] is not None:
                on.enter_context(torch.cuda.device(devices[i]))
                on.enter_context(torch.cuda.stream(streams[i]))
            return work(i, devices[i])

    if len(devices) == 1:
        return [run(0)]
    # Each entry runs in a copy of the caller's context, so that
    # ``configure`` overrides hold in the shards as in the caller.
    pool = _workers()
    futures = [pool.submit(contextvars.copy_context().run, run, i) for i in range(len(devices))]
    wait(futures)
    return [f.result() for f in futures]


def _rows(x) -> int:
    return len(x) if isinstance(x, Sharded) else x.shape[0]


def _shard(x, i: int, k: int, dev: torch.device) -> torch.Tensor:
    """Shard ``i`` (rows ``[i * k, (i + 1) * k)``) of ``x`` on ``dev``: a
    ``Sharded`` input's own shard in place, else the rows copied to ``dev``
    (no copy when they are there already)."""
    if isinstance(x, Sharded):
        return x.shards[i]
    part = x[i * k : (i + 1) * k]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(dev)


def map_shards(mesh, fn, *arrays):
    """``fn`` on each shard of ``arrays``, every shard at once on its mesh
    entry's device: the port's ``shard_map`` with every spec
    ``P(BLOCK_AXIS, ...)``. Every input holds one row a block, and the rows
    must divide over the mesh (:func:`pad_batch`). Returns a
    :class:`Sharded` of ``fn``'s outputs, or a tuple of them when ``fn``
    returns a tuple; shard ``i`` is the very tensor ``fn`` returned on
    entry ``i``. A mesh whose axis is not :data:`BLOCK_AXIS` raises
    ``ValueError``, as ``shard_map`` refuses specs that name no axis of the
    mesh."""
    if mesh.axis != BLOCK_AXIS:
        raise ValueError(f"the sharded entries shard over the axis {BLOCK_AXIS!r}; "
                         f"this mesh's axis is {mesh.axis!r}")
    b = _rows(arrays[0])
    if any(_rows(a) != b for a in arrays):
        raise ValueError("every input must have one row per block")
    if b % mesh.size:
        raise ValueError(f"{b} rows do not divide over a mesh of {mesh.size}; pad them with pad_batch")
    k = b // mesh.size
    for a in arrays:
        if isinstance(a, Sharded) and (a.mesh.devices != mesh.devices
                                       or any(t.shape[0] != k for t in a.shards)):
            raise ValueError(f"a Sharded input over {[str(d) for d in a.mesh.devices]} does not lie "
                             f"on this mesh's shards; gather it first")
    outs = _on_each(mesh, lambda i, dev: fn(*(_shard(a, i, k, dev) for a in arrays)))
    if isinstance(outs[0], torch.Tensor):
        return Sharded(mesh, outs)
    return tuple(Sharded(mesh, [o[j] for o in outs]) for j in range(len(outs[0])))


def _int16(idx):
    """The flatten's uint16 indices seen as the int16 the gather takes."""
    if isinstance(idx, Sharded):
        return idx if idx.dtype != torch.uint16 else Sharded(
            idx.mesh, [t.view(torch.int16) for t in idx.shards])
    if isinstance(idx, np.ndarray) and idx.dtype == np.uint16:
        return idx.view(np.int16)
    return idx.view(torch.int16) if idx.dtype == torch.uint16 else idx


def _int32(x):
    """Lengths as int32: converted on the host for host arrays, on each
    tensor's own device otherwise."""
    if isinstance(x, Sharded):
        return x if x.dtype == torch.int32 else Sharded(x.mesh, [t.to(torch.int32) for t in x.shards])
    if isinstance(x, torch.Tensor):
        return x.to(torch.int32)
    return np.asarray(x, np.int32)


def sharded_compress_blocks(mesh, blocks, lengths, fast: bool = False):
    """Raw-compress ``(B, 65536)`` blocks sharded over ``mesh``.

    Returns ``(out (B, OUT_W) uint8, out_len (B,) int32)``, each row the
    reference encoder's op stream for its block (no varint). ``fast=True``
    takes the fast profile in tensor ops (valid Snappy, not the
    reference's bytes)."""
    codec = compress_blocks_fast if fast else compress_blocks
    return map_shards(mesh, codec, blocks, _int32(lengths))


def sharded_compress_blocks_flat(mesh, blocks, lengths):
    """Flat-encoder compress (the fast profile of the port's card: K4, K5)
    sharded over ``mesh``. Same contract as :func:`sharded_compress_blocks`
    plus the per-block overflow flag (unreachable on any input; see
    ``ops.encode_flat.compress_blocks_flat_fast``)."""
    return map_shards(mesh, compress_blocks_flat_fast, blocks, _int32(lengths))


def sharded_decode_streams(mesh, srcs, src_lens, declens, d_pad: int):
    """Decode ``(B, S)`` independent op streams sharded over ``mesh``, op
    starts found on the device. Returns ``(dst (B, d_pad) uint8, err (B,)
    int32, total_d (B,) int32)``."""
    return map_shards(mesh, lambda s, n, d: decode_batch(s, n, d, d_pad),
                      srcs, _int32(src_lens), _int32(declens))


def sharded_decode_streams_hosted(mesh, srcs, src_lens, declens, opbits, d_pad: int):
    """:func:`sharded_decode_streams` given the host's ``(B, S // 8)`` op-start
    bitmaps (``native.scan_ops_batch``), which shard with their rows."""
    return map_shards(mesh, lambda s, n, d, m: decode_batch_hosted(s, n, d, m, d_pad),
                      srcs, _int32(src_lens), _int32(declens), opbits)


def sharded_decode_flat_host(mesh, srcs, src_lens, declens, d_pad: int):
    """Host flatten, then the sharded flat gather, in one call.

    ``native.flatten_idx_batch`` (all host cores) on the host arrays
    ``srcs``, ``src_lens`` and ``declens``, and
    :func:`sharded_decode_streams_flat`. Returns ``(dst (B, d_pad) uint8,
    err (B,) int32 numpy, fallback (B,) int64 numpy)``; rows with fallback
    set were NOT decoded (a source spread beyond the widest window: route
    them to the replay kernel)."""
    srcs = np.ascontiguousarray(srcs, np.uint8)
    idx_rel, tmeta, fallb, errs, _dt = native.flatten_idx_batch(
        srcs, np.asarray(src_lens, np.uint64), np.asarray(declens, np.uint64), d_pad, layout=1,
    )
    dst = sharded_decode_streams_flat(mesh, srcs, idx_rel, tmeta, declens, d_pad)
    return dst, errs, fallb


def sharded_decode_resolve(mesh, srcs, recs, nops, declens, d_pad: int):
    """Chain-resolution decode sharded over ``mesh``: the host gives only
    the op records (``native.scan_records_batch``), each device resolves
    and gathers its own rows (K8, then K2). ``d_pad`` is whole 16 KiB up to
    64 KiB. Returns ``(dst (B, d_pad) uint8, fallback (B,) int32)``."""
    return map_shards(mesh, lambda s, r, no, d: decode_resolve_batch(s, r, no, d, d_pad),
                      srcs, _int32(recs), _int32(nops), _int32(declens))


def sharded_decode_streams_replay(mesh, srcs, src_lens, declens, d_pad: int):
    """Replay-kernel decode (K3) sharded over ``mesh``; the JAX package's
    ``sharded_decode_streams_pallas``. Returns ``(dst (B, d_pad) uint8,
    err (B,) int32)``."""
    return map_shards(mesh, lambda s, n, d: decode_replay(s, n, d, d_pad),
                      srcs, _int32(src_lens), _int32(declens))


#: The JAX package's name of :func:`sharded_decode_streams_replay`.
sharded_decode_streams_pallas = sharded_decode_streams_replay


def sharded_decode_streams_flat(mesh, srcs, idx_phys, tile_meta, declens, d_pad: int):
    """Flat-gather decode (K2, ``layout=1``) sharded over ``mesh``: the
    host flatten's indices (``native.flatten_idx_batch(..., layout=1)``,
    uint16 or int16) and tile meta shard with their rows. Error codes come
    from the host flatten, so this returns only ``dst (B, d_pad) uint8``.
    Needs ``d_pad % 16384 == 0``."""
    return map_shards(mesh, lambda s, i, m, d: decode_flat(s, i, m, d, d_pad, 1),
                      srcs, _int16(idx_phys), _int32(tile_meta), _int32(declens))


def sharded_encode_frame_chunks(mesh, chunks, lengths):
    """Frame-encode chunks sharded over ``mesh``; returns the wire rows
    ``(rows (B, CHUNK_W) uint8, row_len (B,) int32)`` in batch order.
    Offsets for writing shard-local segments come from ``row_len``
    (:func:`stream_offsets`)."""
    return map_shards(mesh, encode_frame_chunks, chunks, _int32(lengths))


def stream_offsets(row_lens):
    """Exclusive prefix sum of per-row lengths -> ``(output byte offsets,
    total)``: the only coordination the format needs between shards. A
    :class:`Sharded` of lengths has only those lengths copied to the host
    (4 bytes a block), where the sum runs."""
    row_lens = row_lens.cpu() if isinstance(row_lens, Sharded) else row_lens
    if not isinstance(row_lens, torch.Tensor):
        row_lens = torch.from_numpy(np.ascontiguousarray(row_lens))
    ends = torch.cumsum(row_lens, 0)
    return ends - row_lens, ends[-1]
