"""The codec entries sharded over a 1-D block mesh.

The port of ``snappy_tpu/parallel/sharded.py``. Each entry cuts the
batch axis into ``mesh.size`` equal shards, runs the port's batched
function on shard ``i`` on ``mesh.devices[i]``, and concatenates the
outputs in block order on ``mesh.devices[0]``. Blocks are independent
(no shared dictionary, no cross-block offsets), so no entry calls
``torch.distributed``, as the JAX entries compile without collectives;
the per-block output lengths are all a stream's assembly needs
(:func:`stream_offsets`). Shards run in turn from one host thread: the
entries make no claim of overlap across cards. With a one-device mesh an
entry is one call, and inputs already on that device are not copied.

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
  (the name would mislead here): ``ops.replay.decode_replay`` (K3);
- :func:`sharded_decode_streams_flat` -> ``sharded_decode_streams_flat``:
  ``ops.decode_flat.decode_flat(layout=1)`` (K2);
- :func:`sharded_encode_frame_chunks` -> ``sharded_encode_frame_chunks``:
  ``ops.frame.encode_frame_chunks`` (K1, K7);
- :func:`stream_offsets` -> ``stream_offsets`` (``torch.cumsum``).

Inputs are numpy arrays or tensors; lengths of any integer type are
taken as the port's functions take them (int32).
"""

from __future__ import annotations

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

I32 = torch.int32


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


def _tensor(x, dtype=None) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(dtype)


def _sharded(mesh, fn, *arrays):
    """``fn`` on each shard of ``arrays`` on its device, the outputs in block
    order on ``mesh.devices[0]``."""
    b = arrays[0].shape[0]
    if any(a.shape[0] != b for a in arrays):
        raise ValueError("every input must have one row per block")
    if b % mesh.size:
        raise ValueError(f"{b} rows do not divide over a mesh of {mesh.size}; pad them with pad_batch")
    k = b // mesh.size
    outs = [fn(*(a[i * k : (i + 1) * k].to(dev) for a in arrays))
            for i, dev in enumerate(mesh.devices)]
    if mesh.size == 1:
        return outs[0]
    home = mesh.devices[0]
    if isinstance(outs[0], torch.Tensor):
        return torch.cat([o.to(home) for o in outs])
    return tuple(torch.cat([o[j].to(home) for o in outs]) for j in range(len(outs[0])))


def sharded_compress_blocks(mesh, blocks, lengths, fast: bool = False):
    """Raw-compress ``(B, 65536)`` blocks sharded over ``mesh``.

    Returns ``(out (B, OUT_W) uint8, out_len (B,) int32)``, each row the
    reference encoder's op stream for its block (no varint). ``fast=True``
    takes the fast profile in tensor ops (valid Snappy, not the
    reference's bytes)."""
    codec = compress_blocks_fast if fast else compress_blocks
    return _sharded(mesh, codec, _tensor(blocks), _tensor(lengths, I32))


def sharded_compress_blocks_flat(mesh, blocks, lengths):
    """Flat-encoder compress (the fast profile of the port's card: K4, K5)
    sharded over ``mesh``. Same contract as :func:`sharded_compress_blocks`
    plus the per-block overflow flag (unreachable on any input; see
    ``ops.encode_flat.compress_blocks_flat_fast``)."""
    return _sharded(mesh, compress_blocks_flat_fast, _tensor(blocks), _tensor(lengths, I32))


def sharded_decode_streams(mesh, srcs, src_lens, declens, d_pad: int):
    """Decode ``(B, S)`` independent op streams sharded over ``mesh``, op
    starts found on the device. Returns ``(dst (B, d_pad) uint8, err (B,)
    int32, total_d (B,) int32)``."""
    return _sharded(mesh, lambda s, n, d: decode_batch(s, n, d, d_pad),
                    _tensor(srcs), _tensor(src_lens, I32), _tensor(declens, I32))


def sharded_decode_streams_hosted(mesh, srcs, src_lens, declens, opbits, d_pad: int):
    """:func:`sharded_decode_streams` given the host's ``(B, S // 8)`` op-start
    bitmaps (``native.scan_ops_batch``), which shard with their rows."""
    return _sharded(mesh, lambda s, n, d, m: decode_batch_hosted(s, n, d, m, d_pad),
                    _tensor(srcs), _tensor(src_lens, I32), _tensor(declens, I32), _tensor(opbits))


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
    return _sharded(mesh, lambda s, r, no, d: decode_resolve_batch(s, r, no, d, d_pad),
                    _tensor(srcs), _tensor(recs, I32), _tensor(nops, I32), _tensor(declens, I32))


def sharded_decode_streams_replay(mesh, srcs, src_lens, declens, d_pad: int):
    """Replay-kernel decode (K3) sharded over ``mesh``; the JAX package's
    ``sharded_decode_streams_pallas``. Returns ``(dst (B, d_pad) uint8,
    err (B,) int32)``."""
    return _sharded(mesh, lambda s, n, d: decode_replay(s, n, d, d_pad),
                    _tensor(srcs), _tensor(src_lens, I32), _tensor(declens, I32))


def sharded_decode_streams_flat(mesh, srcs, idx_phys, tile_meta, declens, d_pad: int):
    """Flat-gather decode (K2, ``layout=1``) sharded over ``mesh``: the
    host flatten's indices (``native.flatten_idx_batch(..., layout=1)``,
    uint16 or int16) and tile meta shard with their rows. Error codes come
    from the host flatten, so this returns only ``dst (B, d_pad) uint8``.
    Needs ``d_pad % 16384 == 0``."""
    idx = _tensor(idx_phys)
    idx = idx.view(torch.int16) if idx.dtype == torch.uint16 else idx
    return _sharded(mesh, lambda s, i, m, d: decode_flat(s, i, m, d, d_pad, 1),
                    _tensor(srcs), idx, _tensor(tile_meta, I32), _tensor(declens, I32))


def sharded_encode_frame_chunks(mesh, chunks, lengths):
    """Frame-encode chunks sharded over ``mesh``; returns the wire rows
    ``(rows (B, CHUNK_W) uint8, row_len (B,) int32)`` in batch order.
    Offsets for writing shard-local segments come from ``row_len``
    (:func:`stream_offsets`)."""
    return _sharded(mesh, encode_frame_chunks, _tensor(chunks), _tensor(lengths, I32))


def stream_offsets(row_lens):
    """Exclusive prefix sum of per-row lengths -> ``(output byte offsets,
    total)``: the only coordination the format needs between shards."""
    row_lens = _tensor(row_lens)
    ends = torch.cumsum(row_lens, 0)
    return ends - row_lens, ends[-1]
