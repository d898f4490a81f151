"""The JAX package's examples, on the port.

Each runs as ``python -m snappy_tpu_torch.examples.<name>``. The stream
examples take the engine the environment selects (``SNAPPY_TPU_ENGINE``),
and the card (``device``) when it names none; ``SNAPPY_TPU_ENGINE=native``
runs them on the host codec:

- ``compress``: frame-compress stdin to stdout;
- ``decompress``: frame-decompress stdin to stdout;
- ``compress_escaped``: frame-compress a command-line argument and print
  the escaped wire bytes, then the round trip;
- ``gpu_pipeline``: frame-compressed shards decoded on the card into rows
  that a training step consumes where they lie (the counterpart of
  ``examples/tpu_pipeline.py``).
"""


def engine() -> str:
    """The stream examples' engine: the one the configuration names (from
    ``SNAPPY_TPU_ENGINE``), else ``device``."""
    from ..config import get_config

    name = get_config().engine
    return "device" if name in ("", "auto") else name
