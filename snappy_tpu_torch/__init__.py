"""snappy_tpu_torch: the PyTorch/CUDA port of snappy_tpu's device codec.

A second package beside ``snappy_tpu`` (the JAX/TPU reference, which it
imports nothing of). Snappy frame streams and raw streams decode on an
NVIDIA H100 through three hand-written CUDA kernels: a flat gather over
host-flattened copy chains, a replay decoder for the rows the flatten
cannot window, and a batched CRC32C. Output bytes and exceptions are
identical to the reference codec's. Raw streams compress exactly (the
reference encoder's bytes) through a fourth, the greedy automaton one
warp per block, or with the fast profile through two more: a
segment-parallel greedy parse and an emission from a breakpoint plan,
byte for byte as the JAX package's flat encoder. The streaming adapters
``raw``, ``read`` and ``write`` take the same engine names as the JAX
package's; on ``device`` the frame writer compresses and checksums whole
launches of chunks on the card.

    import snappy_tpu_torch
    data = snappy_tpu_torch.decompress_frame(stream)            # on the card
    data = snappy_tpu_torch.decompress(raw, device="cpu")        # plain versions
    raw = snappy_tpu_torch.compress(data)                       # exact, on the card
    snappy_tpu_torch.write.FrameEncoder(f, engine="device").write(data)
"""

from . import engine, error, raw, read, write
from .config import Config, configure, get_config, set_config
from .error import SnappyError
from .ops.api import compress, decompress, decompress_frame

# The JAX package's version: the port mirrors its surface and its bytes.
__version__ = "0.4.0"

__all__ = [
    "compress",
    "decompress",
    "decompress_frame",
    "engine",
    "error",
    "SnappyError",
    "raw",
    "read",
    "write",
    "Config",
    "configure",
    "get_config",
    "set_config",
    "__version__",
]

#: Submodules loaded on first access, as the JAX package loads its own.
_LAZY = ("frame", "format", "ops", "parallel")


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
