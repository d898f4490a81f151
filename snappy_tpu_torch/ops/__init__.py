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
its plain version, and counts its kernel's launches;
:func:`launch_counts` reads every count and :func:`reset_launch_counts`
sets them to 0.
"""

from . import api, packing  # noqa: F401
from .crc32c import crc32c_blocks, crc32c_masked_blocks  # noqa: F401
from .decode import decode_batch, decode_batch_hosted  # noqa: F401
from .encode import compress_blocks  # noqa: F401
from .encode_fast import compress_blocks_fast  # noqa: F401
from .frame import encode_frame_chunks  # noqa: F401


def launch_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count, by kernel (a wrapper counts where
    it launches its kernel, never where it runs its plain version). K2's
    launches with the frame checksum count under their layout and again
    under ``flat_gather_crc``."""
    from . import crc32c, decode_flat, emit, encode, parse, records, replay, resolve

    return {"crc32c": crc32c.launches, "replay": replay.launches,
            "flat_gather[layout=0]": decode_flat.layout_launches[0],
            "flat_gather[layout=1]": decode_flat.layout_launches[1],
            "flat_gather_crc": decode_flat.crc_launches,
            "flat_grouped[v3]": decode_flat.grouped_launches[3],
            "flat_grouped[v4]": decode_flat.grouped_launches[4],
            "parse": parse.launches, "encode": encode.launches, **emit.entry_launches,
            **resolve.launches, "records": records.launches}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0, and K2's counts of what
    its launches walked (``decode_flat.launched_groups``, ``launched_units``,
    ``launched_ctas``)."""
    from . import crc32c, decode_flat, emit, encode, parse, records, replay, resolve

    for m in (crc32c, decode_flat, replay, parse, encode, records):
        m.launches = 0
    decode_flat.crc_launches = decode_flat.launched_groups = 0
    decode_flat.launched_units = decode_flat.launched_ctas = 0
    decode_flat.layout_launches[:] = [0, 0]
    for d in (emit.entry_launches, resolve.launches, decode_flat.grouped_launches):
        for k in d:
            d[k] = 0
