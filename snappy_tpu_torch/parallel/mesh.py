"""Device meshes for the sharded entries.

The port of ``snappy_tpu/parallel/mesh.py``. A JAX mesh names the
devices that hold the shards of an array; here a :class:`Mesh` is the
same list of ``torch.device``, in block order, and each sharded entry
runs one shard on each. The mesh has one axis, the independent blocks:
Snappy has no tensor or pipeline dimension to shard. ``auto_mesh`` and
``ParallelConfig`` are the JAX module's: a second name for
:func:`make_mesh`, and its batching policy, which no entry of either
package reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

#: The single mesh axis: independent blocks/chunks. Data-parallel only:
#: Snappy has no tensor or pipeline dimension to shard.
BLOCK_AXIS = "blocks"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: shard ``i`` of the block axis runs on ``devices[i]``.

    A device may repeat, as the CPU tests' ``[torch.device("cpu")] * 4``
    stands for four devices (the JAX tests' virtual CPU devices), or two
    shards share one card. ``rank`` and ``world_size`` place this process's
    mesh in a ``torch.distributed`` world (``multihost.global_mesh``); a
    local mesh is rank 0 of 1. ``axis`` is the axis's name, as a JAX mesh
    keeps it: the sharded entries shard over :data:`BLOCK_AXIS` and raise
    ``ValueError`` on a mesh of another axis, as the JAX entries do."""

    devices: tuple[torch.device, ...]
    rank: int = 0
    world_size: int = 1
    axis: str = BLOCK_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(devices=None, axis: str = BLOCK_AXIS) -> Mesh:
    """1-D mesh named ``axis`` over ``devices`` (default: every CUDA device
    of this process). Raises when no devices are given and there is no
    card: there is no CPU fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass the mesh's devices, e.g. [torch.device('cpu')] * 4")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(_indexed(torch.device(d)) for d in devices)
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devices, axis=axis)


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` named with no index is the current card, as a tensor placed
    there reports its device."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def auto_mesh() -> Mesh:
    """:func:`make_mesh` over every card of this process."""
    return make_mesh()


@dataclass(frozen=True)
class ParallelConfig:
    """Host-side batching policy for the device codec paths (the JAX
    package's, field for field)."""

    #: Blocks per device per launch (trades device memory vs. launch count).
    blocks_per_device: int = 64
    #: Streams below this stay on the host fast path (launch-latency bound).
    min_device_bytes: int = 1 << 18
