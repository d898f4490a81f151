"""Device kernels of the PyTorch/CUDA port and the host-facing API over them.

The port of ``snappy_tpu/ops``, with the same public surface:

- :func:`decode_batch` — batched parallel raw decompression;
- :func:`decode_batch_hosted` — the variant given the host's op-start
  bitmaps (``native.scan_ops_batch``);
- :func:`compress_blocks` — the reference encoder's bytes, batched (K7);
- :func:`compress_blocks_fast` — the fast profile in tensor ops;
- :func:`crc32c_blocks` / :func:`crc32c_masked_blocks` — CRC32C of rows (K1);
- :func:`encode_frame_chunks` — frame chunks of a batch (K1, K7);
- :mod:`.api` — host-facing bytes-in/bytes-out wrappers;
- :mod:`.packing` — batch marshalling helpers.

Each kernel's own module (``decode_flat``, ``replay``, ``records``,
``resolve``, ``parse``, ``emit``, ``encode_flat``) holds its wrapper and
its plain version.
"""

from . import api, packing  # noqa: F401
from .crc32c import crc32c_blocks, crc32c_masked_blocks  # noqa: F401
from .decode import decode_batch, decode_batch_hosted  # noqa: F401
from .encode import compress_blocks  # noqa: F401
from .encode_fast import compress_blocks_fast  # noqa: F401
from .frame import encode_frame_chunks  # noqa: F401
