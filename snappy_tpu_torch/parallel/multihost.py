"""Multi-process scale-out over ``torch.distributed``: set-up and
segmented stream assembly.

The port of ``snappy_tpu/parallel/multihost.py``. Snappy's data path
needs no communication between processes: blocks are independent, so
several processes (one a card, under ``torchrun`` or a cluster launcher)
are plain data parallelism. The only coordination is stream assembly:
every rank must learn the compressed length of every block to know its
own output file offsets. That is one ``all_gather`` of a small int32
vector per launch; payload bytes never leave the rank that produced them.

Usage (one process a card, e.g. ``torchrun --nproc-per-node 8``)::

    from snappy_tpu_torch.parallel import multihost
    multihost.initialize()                    # torch.distributed rendezvous
    mesh = multihost.global_mesh()
    seg = multihost.compress_segments(mesh, my_blocks, my_lengths)
    # seg.offsets[i] is the absolute file offset of this rank's row i;
    # each rank pwrite()s its rows into the shared output in parallel.

A single process with no rendezvous configured stays local
(:func:`initialize` does nothing).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from ..config import get_config
from .mesh import BLOCK_AXIS, Mesh  # noqa: F401 (BLOCK_AXIS: the JAX module's export)
from .sharded import sharded_compress_blocks, sharded_decode_streams, sharded_decode_streams_hosted


def _env_int(name: str):
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return None


def _cluster_env_detected() -> bool:
    """True when the environment says this process is one of several.

    SLURM with more than one task, Open MPI (``mpirun``) with a world over
    1, and torchrun's ``WORLD_SIZE`` over 1. Single-process variants don't
    count. The JAX package also counts Cloud TPU pods and GKE podslices
    (``TPU_WORKER_HOSTNAMES``, ``MEGASCALE_COORDINATOR_ADDRESS``); those
    markers mean nothing on a GPU host and are left out.
    """
    ntasks = _env_int("SLURM_NTASKS") or _env_int("SLURM_NPROCS")
    if os.environ.get("SLURM_JOB_ID") and ntasks and ntasks > 1:
        return True
    world = _env_int("OMPI_COMM_WORLD_SIZE")
    if world and world > 1:
        return True
    world = _env_int("WORLD_SIZE")
    return bool(world and world > 1)


def local_device() -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}``, or the CPU
    when the configuration's ``device`` is ``"cpu"``. Raises without a card
    otherwise."""
    if torch.device(get_config().device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: configure device='cpu' to run the ranks on the CPU")
    return torch.device("cuda", (_env_int("LOCAL_RANK") or 0) % torch.cuda.device_count())


def initialize(**kwargs) -> None:
    """Join the ``torch.distributed`` process group when running multi-process.

    Does nothing when a group exists already (ours or the application's),
    and nothing in a single process with no rendezvous configured, so the
    same entry point serves both. Explicit ``init_process_group`` kwargs
    (``init_method``, ``world_size``, ``rank``, ``timeout``...) or torchrun's
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)
    configure the rendezvous. The backend is ``nccl`` when this rank's
    device (:func:`local_device`) is a card, ``gloo`` on the CPU; a
    ``backend`` kwarg overrides it. A rank on a card makes that card its
    current device before it joins.

    A cluster detected with no rendezvous configured raises, saying what to
    set: torch cannot configure itself from SLURM or Open MPI as
    ``jax.distributed`` does, and running every process alone would
    silently degrade a multi-process run. A configured run that cannot
    connect raises within its timeout; the error is never swallowed.
    """
    if dist.is_initialized():
        return
    from_env = all(os.environ.get(k) for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"))
    if not kwargs and not from_env:
        if _cluster_env_detected():
            raise RuntimeError(
                "a multi-process launch was detected but no rendezvous is configured: set "
                "MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK (torchrun sets them), or pass "
                "init_method, world_size and rank"
            )
        return
    if from_env:
        kwargs.setdefault("init_method", "env://")
    device = local_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = kwargs.pop("backend", None) or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend=backend, **kwargs)


def global_mesh() -> Mesh:
    """This rank's one-device mesh, with its ``rank`` and ``world_size`` in
    the process group (0 and 1 outside one). Global block order is
    rank-major: rank ``r``'s blocks follow those of every lower rank."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return Mesh((local_device(),), rank, world)


@dataclass(frozen=True)
class Segments:
    """This rank's compressed rows + absolute output offsets."""

    rows: np.ndarray  # (local_B, OUT_W) uint8
    row_lens: np.ndarray  # (local_B,) int32
    offsets: np.ndarray  # (local_B,) int64, absolute stream offsets
    total: int  # total stream length across all ranks


def _all_gather(mesh: Mesh, t: torch.Tensor) -> np.ndarray:
    """``t`` of every rank, concatenated in rank order: gathered on the card
    under NCCL, on CPU tensors under gloo."""
    t = t.to(mesh.devices[0] if dist.get_backend() == "nccl" else torch.device("cpu"))
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy()


def compress_segments(mesh: Mesh, blocks, lengths, fast: bool = False) -> Segments:
    """Compress this rank's blocks; compute global stream offsets.

    ``blocks``/``lengths`` are this rank's shard: ``(local_B, 65536)`` uint8
    and ``(local_B,)``. The global batch is the concatenation over ranks,
    and every rank must hold the same number of blocks: every rank raises
    ``ValueError`` when they differ. The returned offsets account for every
    rank's rows in global block order: an ``all_gather`` of the block counts
    and one of the per-block lengths (on the card under NCCL, on CPU
    tensors under gloo; none in a world of one) is the whole protocol.

    Exact (the reference encoder's bytes) by default; ``fast=True`` takes
    the fast profile in tensor ops (valid Snappy, not byte-identical).
    """
    b = blocks.shape[0]
    if mesh.world_size > 1:
        counts = _all_gather(mesh, torch.tensor([b], dtype=torch.int64))
        if (counts != b).any():
            raise ValueError(f"every rank must hold the same number of blocks; the ranks hold "
                             f"{counts.tolist()}")
    out, out_len = sharded_compress_blocks(mesh, blocks, lengths, fast=fast)
    lens_all = row_lens = out_len.numpy()
    if mesh.world_size > 1:
        lens_all = _all_gather(mesh, out_len.gather())
    ends = np.cumsum(lens_all.astype(np.int64))
    my_start = mesh.rank * b
    return Segments(
        rows=out.numpy(),
        row_lens=row_lens,
        offsets=(ends - lens_all)[my_start : my_start + b],
        total=int(ends[-1]),
    )


def decode_segments(mesh: Mesh, bodies, src_lens, declens, d_pad: int = 65536):
    """Decode this rank's shard of raw op streams.

    ``bodies``: ``(local_B, S)`` uint8 zero-padded per-block op streams (no
    varint headers), e.g. the rows a :func:`compress_segments` peer
    produced. Returns ``(dst (local_B, d_pad) uint8, errs (local_B,)
    int32)`` as numpy arrays. Payload bytes never cross ranks, and no
    collective runs. The op starts come from the host's bitmaps
    (``native.scan_ops_batch``) when the host runtime loads, else from the
    device; a failing scan raises.
    """
    bodies = np.ascontiguousarray(bodies, dtype=np.uint8)
    if bodies.shape[1] % 8:  # whole bitmap bytes; zero padding decodes alike
        bodies = np.pad(bodies, ((0, 0), (0, 8 - bodies.shape[1] % 8)))
    src_lens = np.asarray(src_lens, np.int32)
    declens = np.asarray(declens, np.int32)
    if native.available():
        bits = np.zeros((bodies.shape[0], bodies.shape[1] // 8), np.uint8)
        native.scan_ops_batch(bodies, src_lens.astype(np.uint64), bits)
        dst, errs, _ = sharded_decode_streams_hosted(mesh, bodies, src_lens, declens, bits, d_pad)
    else:
        dst, errs, _ = sharded_decode_streams(mesh, bodies, src_lens, declens, d_pad)
    return dst.numpy(), errs.numpy()
