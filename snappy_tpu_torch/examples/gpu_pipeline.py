"""GPU data pipeline: compressed storage -> card decode -> model step.

The counterpart of the JAX package's ``examples/tpu_pipeline.py``. Snappy
frame files feed a training loop with decompression running as a batched
computation on the card, not as a host preprocessing stage. Per shard:

1. read one frame-compressed shard (bytes, e.g. from blob storage);
2. walk its chunk headers on the host (a few bytes per 64 KiB chunk),
   resolve every compressed chunk's copy chains to per-byte indices (the
   host flatten, one chunk-parallel C++ call), and decode them all in one
   sharded call of the flat gather (K2): every card copies in and decodes
   its own shard of the rows at once;
3. the decoded ``(B, 65536)`` uint8 rows stay sharded over the cards, as
   the JAX example's stay sharded over its mesh: each card takes the
   masked byte histogram of its own rows, and only those 256 counts a card
   go to the first card, where the train step (a toy byte-embedding model:
   loss, backward, SGD) runs. No row takes a trip through host memory or
   to another card.

Runs on every card of the host, or, when asked, on a mesh of four CPU
entries with the hosted tensor decode (the host's op-start bitmaps)::

    python -m snappy_tpu_torch.examples.gpu_pipeline
    SNAPPY_TPU_FORCE_CPU=1 python -m snappy_tpu_torch.examples.gpu_pipeline

``PIPELINE_SHARD_BYTES`` sets the shard size (default 512 KiB). Without a
card and without ``SNAPPY_TPU_FORCE_CPU`` it exits with an error: nothing
falls back to the CPU.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from torch import nn

D_PAD = 65536  # a frame chunk decodes to at most 64 KiB
CPU_MESH = 4  # the JAX example's CPU mesh: four virtual devices


def split_frame(wire: bytes):
    """Walk a frame stream -> list of (kind, declen, body) per data chunk.

    kind: 0 = compressed (body is the raw op stream, varint stripped),
    1 = uncompressed (body is the literal bytes). This demo walk assumes a
    well-formed stream (``snappy_tpu_torch.decompress_frame`` has the full
    error semantics) and skips the masked CRC32C."""
    from ..format.constants import (
        CHUNK_TYPE_COMPRESSED,
        CHUNK_TYPE_STREAM,
        CHUNK_TYPE_UNCOMPRESSED,
    )
    from ..format.varint import read_varu64

    chunks, pos = [], 0
    while pos < len(wire):
        ty = wire[pos]
        length = int.from_bytes(wire[pos + 1 : pos + 4], "little")
        payload = wire[pos + 4 : pos + 4 + length]
        pos += 4 + length
        if ty == CHUNK_TYPE_STREAM:
            continue
        body = payload[4:]
        if ty == CHUNK_TYPE_UNCOMPRESSED:
            chunks.append((1, len(body), body))
        elif ty == CHUNK_TYPE_COMPRESSED:
            declen, hdr = read_varu64(body)
            chunks.append((0, declen, body[hdr:]))
    return chunks


def make_shards(shard_bytes: int):
    """Two shards of training text: ``(frame stream, plain bytes)`` each,
    frame-compressed by the host codec, as the JAX example makes them."""
    from .. import native

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    with open(os.path.join(root, "data", "alice29.txt"), "rb") as f:
        text = f.read()
    shards = []
    for i in range(2):
        plain = ((text[i * 251 :] + text) * (shard_bytes // len(text) + 1))[:shard_bytes]
        shards.append((native.frame_compress(plain), plain))
    return shards


def byte_counts(tokens: torch.Tensor, nbytes: torch.Tensor) -> torch.Tensor:
    """The masked histogram of ``(B, 65536)`` uint8 rows: ``(256,)`` float32,
    ``count[v]`` the positions below each row's length ``nbytes`` that hold
    ``v``, on the rows' device. Counts stay exact in float32 below 2**24 a
    value."""
    mask = (torch.arange(tokens.shape[1], device=tokens.device)[None, :]
            < nbytes[:, None]).to(torch.float32)
    return torch.bincount(tokens.flatten(), weights=mask.flatten(), minlength=256)


class ByteEmbedding(nn.Module):
    """Toy byte-embedding regression: a ``(256, 16)`` float32 table from
    ``np.random.default_rng(seed)`` times 0.01; the loss is the masked mean
    over the rows' bytes of the squared mean embedding of each byte, as the
    JAX example's ``loss_fn``."""

    def __init__(self, seed: int = 0):
        super().__init__()
        rng = np.random.default_rng(seed)
        self.table = nn.Parameter(
            torch.from_numpy(np.asarray(rng.standard_normal((256, 16)) * 0.01, np.float32)))

    def forward(self, counts: torch.Tensor) -> torch.Tensor:
        # counts: the rows' masked byte histogram (byte_counts). The masked
        # sum over positions of h[token]^2, h the table's row means, is taken
        # grouped by byte value: count[v] * h[v]^2 summed over the 256
        # values. The same sum as the JAX example's, but autograd flows
        # through 256 row means: the backward of a gather at every position
        # would accumulate millions of values into 256 table rows.
        h = self.table.mean(dim=-1)
        return torch.sum(counts * h * h) / torch.clamp(counts.sum(), min=1.0)


def _pad(a: np.ndarray, rows: int) -> np.ndarray:
    return np.pad(a, [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1))


def _sync(mesh) -> None:
    """Wait for every card of ``mesh``."""
    for dev in dict.fromkeys(mesh.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def run(device, shard_bytes: int, mesh_size: int | None = None, stats: list | None = None):
    """Decode both shards on ``device``'s mesh and take one SGD step on each.

    ``device``: ``"cuda"`` (the flat gather, K2, on the first ``mesh_size``
    cards, default all) or ``"cpu"`` (the hosted tensor decode on a mesh of
    ``mesh_size`` CPU entries, default 4). Returns ``(losses, params,
    rows)``: each step's loss, the table after the last step (on the CPU),
    and each step's decoded rows and lengths, ``((n, 65536) uint8, (n,)
    int32)`` on the CPU, fetched after its step. ``stats``, when given, gets
    one dict a step: host seconds of the walk and of the flatten or scan,
    seconds of the decode and of the step (each ending in a synchronize),
    the loss, each shard's device and each card's peak device bytes."""
    from .. import native
    from ..ops.packing import batch_streams, pad_to_bucket
    from ..parallel import make_mesh
    from ..parallel.sharded import (
        map_shards, sharded_decode_streams_flat, sharded_decode_streams_hosted,
    )

    device = torch.device(device)
    if device.type == "cuda":
        mesh = make_mesh(None if mesh_size is None else [torch.device("cuda", i)
                                                          for i in range(mesh_size)])
    elif device.type == "cpu":
        mesh = make_mesh([device] * (mesh_size or CPU_MESH))
    else:
        raise ValueError(f"unsupported device {device}")
    home = mesh.devices[0]
    cards = [d for d in dict.fromkeys(mesh.devices) if d.type == "cuda"]
    model = ByteEmbedding().to(home)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    losses, rows = [], []
    for wire, plain in make_shards(shard_bytes):
        if stats is not None:
            for dev in cards:
                torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        chunks = split_frame(wire)
        # Text shards compress; uncompressed chunks (incompressible data)
        # would already be plaintext and skip the decode.
        bodies = [(b, d) for k, d, b in chunks if k == 0]
        if len(bodies) != len(chunks):
            raise ValueError("the pipeline expects compressible shards")
        width = pad_to_bucket(max(len(b) for b, _ in bodies))
        srcs, lens = batch_streams([b for b, _ in bodies], width)
        declens = np.array([d for _, d in bodies], np.int32)
        n = len(bodies)
        t1 = time.perf_counter()
        # Host half of the decode: on the card the flatten resolves copy
        # chains to per-byte indices; on the CPU the hosted route's op-start
        # bitmaps play that role.
        if home.type == "cuda":
            idxp, tmeta, fallb, herrs, _ = native.flatten_idx_batch(
                srcs, lens.astype(np.uint64), declens.astype(np.uint64), D_PAD, layout=1)
            if fallb.any() or int(herrs.max(initial=0)):
                raise SystemExit("corrupt shard")
        else:
            bits = np.zeros((n, width // 8), np.uint8)
            native.scan_ops_batch(srcs, lens.astype(np.uint64), bits)
        t2 = time.perf_counter()
        # Pad the batch axis to the mesh size; each device copies in and
        # decodes its own shard of the rows, which stays there.
        pb = -(-n // mesh.size) * mesh.size
        if home.type == "cuda":
            out_len = _pad(declens, pb)
            out = sharded_decode_streams_flat(mesh, _pad(srcs, pb), _pad(idxp, pb),
                                              _pad(tmeta, pb), out_len, D_PAD)
        else:
            out, errc, out_len = sharded_decode_streams_hosted(
                mesh, _pad(srcs, pb), _pad(lens, pb), _pad(declens, pb), _pad(bits, pb), D_PAD)
            if errc.numpy()[:n].any():
                raise SystemExit("corrupt shard")
        _sync(mesh)
        t3 = time.perf_counter()
        # `out` is (pb, 65536) uint8, one shard a device: each device takes
        # the histogram of its own rows, and the 256 counts of each go to the
        # first device, where the step runs.
        counts = map_shards(mesh, byte_counts, out, out_len)
        loss = model(counts.gather(home).view(mesh.size, 256).sum(0))
        opt.zero_grad()
        loss.backward()
        opt.step()
        _sync(mesh)
        t4 = time.perf_counter()
        losses.append(float(loss.detach()))
        got = out.cpu()[:n]
        nbytes = torch.from_numpy(np.asarray(out_len, np.int32)[:n])
        # Demo-only verification (a real loop would skip this fetch).
        if b"".join(got[i, : int(nbytes[i])].numpy().tobytes() for i in range(n)) != plain:
            raise SystemExit("decoded bytes != stored bytes")
        rows.append((got, nbytes))
        if stats is not None:
            stats.append({
                "walk_s": t1 - t0, "host_half_s": t2 - t1, "decode_s": t3 - t2,
                "step_s": t4 - t3, "loss": losses[-1], "rows": n,
                "rows_devices": [str(t.device) for t in out.shards],
                "peak_device_bytes": {str(d): torch.cuda.max_memory_allocated(d) for d in cards},
            })
    return losses, model.table.detach().cpu(), rows


def main() -> None:
    if os.environ.get("SNAPPY_TPU_FORCE_CPU"):
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        raise SystemExit("gpu_pipeline: no CUDA device; set SNAPPY_TPU_FORCE_CPU=1 to run "
                         f"on a mesh of {CPU_MESH} CPU entries")
    shard_bytes = int(os.environ.get("PIPELINE_SHARD_BYTES", 512 * 1024))
    n_dev = CPU_MESH if device == "cpu" else torch.cuda.device_count()
    print(f"mesh: {n_dev} x {device}")
    shards = make_shards(shard_bytes)
    ratio = sum(len(c) for c, _ in shards) / sum(len(p) for _, p in shards)
    print(f"shards: {len(shards)} x {shard_bytes} B, wire ratio {ratio:.2f}")
    losses, _, _ = run(device, shard_bytes)
    for step_no, loss in enumerate(losses):
        print(f"step {step_no}: loss {loss:.6e}")
    print("pipeline ok")


if __name__ == "__main__":
    main()
