"""Entry points for a one-card check and a dry run over a mesh.

The port of the repository's ``__graft_entry__.py``, over the port's calls.
It has no kernel of its own.

- :func:`entry` returns the flagship step with its example inputs: the fast
  frame encoder, ``ops.frame.encode_frame_chunks(c, l, fast=True)`` (K1 for
  the CRCs, the fast profile's tensor-op compressor, the chunk framing),
  on the JAX entry's 4 x 65536 input.
- :func:`dryrun_multichip` runs one step of the sharded pipeline on a mesh
  of ``n`` entries, every leg of the JAX function with its inputs and its
  checks, each leg's rows held byte for byte: frame-encode (K1, K7), the
  tensor decode, the replay decode (K3), the flat gather from the host
  flatten (K2), chain resolution from the host's record scan (K8, K2) and
  the flat encoder (K4, K5).

Two things differ from the JAX function, on purpose. Its mesh falls back to
CPU devices when there are too few chips; here asking for more cards than
there are raises, and a mesh of CPU entries (or of one card repeated) is
asked for by name with ``device``. And its legs 5 and 6 run only when the
host runtime loads; here the host runtime builds with ``g++`` on first use,
and if it cannot, the dry run fails rather than run fewer legs.

The CRCs differ too, where the JAX entry is at fault: its CRC kernel reads
each row to its full width and needs zeros past the row's length, which
these inputs (a snippet tiled over the whole row) do not have. So the JAX
``entry()`` rows 2 and 3 (lengths 40000 and 517) and every row of its dry
run carry checksums of more than their bytes. The port's CRCs are of each
row's first ``len`` bytes, and its frames verify.

Run ``python -m snappy_tpu_torch.graft_entry`` on a machine with a card:
it runs :func:`entry` and prints the output shapes, then
:func:`dryrun_multichip` over ``min(8, cards)`` cards. On the CPU, call
``dryrun_multichip(4, device="cpu")``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import native
from .format import reference as ref
from .format.varint import write_varu64
from .ops.api import resolve_device
from .ops.frame import encode_frame_chunks
from .parallel.mesh import make_mesh
from .parallel.sharded import (
    sharded_compress_blocks_flat,
    sharded_decode_resolve,
    sharded_decode_streams,
    sharded_decode_streams_flat,
    sharded_decode_streams_pallas,
    sharded_encode_frame_chunks,
    stream_offsets,
)


def entry(device=None):
    """``(fn, example_args)`` for a one-card check: ``fn(c, l)`` frame-encodes
    with the fast profile; the arguments lie on ``device`` (default the
    configured device, ``cuda``; without a card that raises)."""
    dev = resolve_device(device)
    b, s = 4, 65536
    rng = np.random.default_rng(0)
    # Compressible-ish payload: repeated snippets with noise.
    snippet = rng.integers(0, 256, 512, dtype=np.uint8)
    chunks = np.tile(snippet, (b, s // 512))
    lengths = np.array([s, s, 40000, 517], dtype=np.int32)
    fn = lambda c, l: encode_frame_chunks(c, l, fast=True)  # noqa: E731
    return fn, (torch.from_numpy(chunks).to(dev), torch.from_numpy(lengths).to(dev))


def _mesh(n_devices: int, device):
    """The dry run's mesh: ``device`` repeated ``n_devices`` times, else the
    first ``n_devices`` cards of :func:`make_mesh`."""
    if device is not None:
        return make_mesh([resolve_device(device)] * n_devices)
    have = torch.cuda.device_count()
    if have < n_devices:
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} CUDA cards and this process has "
            f"{have}; pass device='cpu' (or 'cuda:0') to run every shard on that device")
    return make_mesh(make_mesh().devices[:n_devices])


def _check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _synchronize(mesh) -> None:
    for dev in set(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run one sharded pipeline step on a mesh of ``n_devices`` entries and
    check every leg; a failed check raises ``RuntimeError``. The mesh is the
    first ``n_devices`` cards, or ``device`` (``"cpu"``, ``"cuda:0"``)
    repeated."""
    mesh = _mesh(n_devices, device)

    b, s = 2 * n_devices, 65536
    rng = np.random.default_rng(1)
    snippet = rng.integers(0, 256, 256, dtype=np.uint8)
    chunks = np.tile(snippet, (b, s // 256)).astype(np.uint8)
    lengths = np.full((b,), 2048, np.int32)  # tiny per-block work

    # Full step: frame-encode (CRC + compress + framing) sharded over blocks.
    rows, row_len = sharded_encode_frame_chunks(mesh, chunks, lengths)
    _, total = stream_offsets(row_len)
    _synchronize(mesh)

    # Sharded decode roundtrip over the same mesh: strip each chunk's
    # 8-byte header + varint preamble on host (tiny), decode on device.
    rows_h, row_len_h = rows.numpy(), row_len.numpy()
    bodies = []
    for i in range(b):
        row = rows_h[i, : row_len_h[i]]
        _check(row[0] in (0x00, 0x01), "unexpected chunk type")
        payload = row[8:]
        if row[0] == 0x00:  # compressed: varint preamble then ops
            k = 1
            while payload[k - 1] & 0x80:
                k += 1
            bodies.append(payload[k:])
        else:
            bodies.append(payload)
    smax = 4096
    srcs = np.zeros((b, smax), np.uint8)
    slens = np.zeros((b,), np.int32)
    for i, body in enumerate(bodies):
        srcs[i, : len(body)] = body
        slens[i] = len(body)
    dst, errs, _ = sharded_decode_streams(mesh, srcs, slens, lengths, 2048)
    _synchronize(mesh)

    dst_h = dst.numpy()
    _check(int(errs.numpy().max()) == 0, "device decode flagged an error")
    for i in range(b):
        _check(np.array_equal(dst_h[i, : lengths[i]], chunks[i, : lengths[i]]),
               f"roundtrip mismatch in block {i}")
    _check(int(total) == int(row_len_h.sum()), "stream total is not the rows' sum")

    # The replay kernel (K3; the JAX package's Pallas route) under the same
    # mesh: must agree byte for byte.
    pdst, perrs = sharded_decode_streams_pallas(mesh, srcs, slens, lengths, 2048)
    _synchronize(mesh)
    _check(int(perrs.numpy().max()) == 0, "pallas decode flagged an error")
    _check(np.array_equal(pdst.numpy(), dst_h), "pallas route mismatch")

    # The flat gather (K2) on the host flatten's indices: the flatten
    # shards with its rows, zero collectives.
    d_pad2 = 16384  # whole 16 KiB groups
    idxp, tmeta, fallb, herrs, _dt = native.flatten_idx_batch(
        srcs, slens.astype(np.uint64), lengths.astype(np.uint64), d_pad2, layout=1)
    _check(not fallb.any() and int(herrs.max(initial=0)) == 0,
           "host flatten flagged a fallback or an error")
    fdst = sharded_decode_streams_flat(mesh, srcs, idxp, tmeta, lengths, d_pad2)
    _synchronize(mesh)
    fdst_h = fdst.numpy()
    for i in range(b):
        _check(np.array_equal(fdst_h[i, : lengths[i]], chunks[i, : lengths[i]]),
               f"flat v2 route mismatch in block {i}")

    # Chain resolution on the card (K8, then K2): the host contributes
    # only the O(records) scan; pointers, resolution and the gather all
    # shard per device, zero collectives.
    recs, nops, rerrs, _dt2 = native.scan_records_batch(
        srcs, slens.astype(np.uint64), lengths.astype(np.uint64), 2048)
    _check(int(rerrs.max(initial=0)) == 0, "host record scan flagged an error")
    rdst, rfb = sharded_decode_resolve(mesh, srcs, recs, nops, lengths.astype(np.int64), d_pad2)
    _synchronize(mesh)
    _check(not rfb.numpy().any(), "resolve route flagged fallback")
    rdst_h = rdst.numpy()
    for i in range(b):
        _check(np.array_equal(rdst_h[i, : lengths[i]], chunks[i, : lengths[i]]),
               f"resolve route mismatch in block {i}")

    # The flat encoder (K4, K5) under the same mesh: must shard and
    # round-trip through the reference decoder.
    blocks64 = np.zeros((b, 65536), np.uint8)
    blocks64[:, : chunks.shape[1]] = chunks
    fout, folen, fovf = sharded_compress_blocks_flat(mesh, blocks64, lengths)
    _synchronize(mesh)
    fout_h, folen_h = fout.numpy(), folen.numpy()
    _check(int(fovf.numpy().max()) == 0, "flat encoder overflow flagged")
    for i in range(b):
        body = fout_h[i, : folen_h[i]].tobytes()
        got = ref.decompress(write_varu64(int(lengths[i])) + body)
        _check(got == chunks[i, : lengths[i]].tobytes(),
               f"flat encoder roundtrip mismatch in block {i}")


def main() -> None:
    fn, args = entry()
    out = fn(*args)
    print("entry ok:", [tuple(o.shape) for o in out])
    dryrun_multichip(min(8, torch.cuda.device_count()))
    print("dryrun ok")


if __name__ == "__main__":
    main()
