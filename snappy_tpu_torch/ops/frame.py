"""Device frame-chunk pipeline: CRC, compression and chunk framing.

The port of the JAX package's ``ops/frame.py``: every 64 KiB frame chunk
is a row; the masked CRC32C of the uncompressed bytes (K1), the raw
compression (K7, or :func:`.encode_fast.compress_blocks_fast` with
``fast=True``), the "compression must save at least 1/8" decision and the
8-byte chunk header all run on the chunks' device, which emits finished
wire bytes per chunk. The host only concatenates row prefixes (and writes
the stream identifier once).
"""

from __future__ import annotations

import numpy as np
import torch

from ..format.constants import CHUNK_TYPE_COMPRESSED, CHUNK_TYPE_UNCOMPRESSED
from ..trace import span
from . import encode
from .crc32c import crc32c_masked_blocks
from .encode import OUT_W

#: Row width of an emitted frame chunk: 8-byte header + worst-case
#: payload (3-byte varint + OUT_W), 16-aligned.
CHUNK_W = 8 + 3 + OUT_W + 5

#: Chunks per launch of the device writer (device scratch is a few hundred
#: KB per chunk).
CHUNKS_PER_LAUNCH = 1024

I32 = torch.int32


def _varint_u17(n):
    """LE base-128 varint of a length <= 65536: ``((B, 3) bytes, length)``."""
    b0 = (n & 0x7F) | torch.where(n >= 0x80, 0x80, 0)
    b1 = ((n >> 7) & 0x7F) | torch.where(n >= 0x4000, 0x80, 0)
    b2 = (n >> 14) & 0x7F
    vlen = torch.where(n >= 0x4000, 3, torch.where(n >= 0x80, 2, 1))
    return torch.stack([b0, b1, b2], 1), vlen


def encode_frame_chunks(chunks, lengths, fast: bool = False):
    """Frame-encode a batch of uncompressed chunks into wire bytes.

    ``chunks``: ``(B, W)`` uint8 zero-padded, ``W % 128 == 0`` and ``W <=
    65536``; ``lengths``: ``(B,)`` int32. Returns ``(rows (B, CHUNK_W)
    uint8, row_len (B,) int32)``, each row's prefix one complete frame
    chunk, header included, zero after; byte for byte the JAX package's
    ``encode_frame_chunks``. ``fast=True`` compresses with
    :func:`.encode_fast.compress_blocks_fast` (valid frames, not the
    reference's bytes; ``W`` must be 65536).
    """
    bsz, w = chunks.shape
    dev = chunks.device
    n = lengths.to(I32)
    with span("kernels", dev):
        crc = crc32c_masked_blocks(chunks, n)  # CRC of the uncompressed bytes
        if fast:
            from .encode_fast import compress_blocks_fast

            comp, comp_len = compress_blocks_fast(chunks, n)
        else:
            comp, comp_len = encode.compress_blocks(chunks, n)
    with span("assemble", dev):
        vbytes, vlen = _varint_u17(n)
        payload_comp = vlen + comp_len
        # Keep the compressed payload only if it saves at least 1/8
        # (reference src/frame.rs:83-89); a poisoned comp_len never does.
        use_comp = payload_comp < n - n // 8
        payload_len = torch.where(use_comp, payload_comp, n).to(I32)
        chunk_type = torch.where(use_comp, CHUNK_TYPE_COMPRESSED, CHUNK_TYPE_UNCOMPRESSED)
        body_len = payload_len + 4  # the CRC, then the payload
        hdr = torch.stack(
            [t.to(torch.int64) for t in (
                chunk_type, body_len & 0xFF, (body_len >> 8) & 0xFF, (body_len >> 16) & 0xFF)]
            + [(crc >> (8 * k)) & 0xFF for k in range(4)], 1,
        )

        rows = torch.zeros((bsz, CHUNK_W), dtype=torch.uint8, device=dev)
        for v in (1, 2, 3):  # compressed payload after a varint of v bytes
            sel = (use_comp & (vlen == v))[:, None]
            dst = rows[:, 8 + v : 8 + v + OUT_W]
            dst.copy_(torch.where(sel, comp, dst))
        raw = rows[:, 8 : 8 + w]
        raw.copy_(torch.where(~use_comp[:, None], chunks, raw))
        head = rows[:, 8:11]
        vsel = use_comp[:, None] & (torch.arange(3, device=dev)[None, :] < vlen[:, None])
        head.copy_(torch.where(vsel, vbytes.to(torch.uint8), head))
        rows[:, :8] = hdr.to(torch.uint8)
        row_len = 8 + payload_len
        rows.masked_fill_(torch.arange(CHUNK_W, device=dev)[None, :] >= row_len[:, None], 0)
    return rows, row_len


def encode_frame_host(buf: bytes, device, fast: bool = False) -> list[bytes]:
    """Frame chunks of ``buf`` (every 64 KiB of it, header included), in
    launches of :data:`CHUNKS_PER_LAUNCH` chunks on ``device``: one
    ``bytes`` per launch."""
    from .packing import blocks_of, concat_rows

    dev = torch.device(device)
    with span("pack"):
        blocks, lens = blocks_of(buf)
    parts = []
    for start in range(0, blocks.shape[0], CHUNKS_PER_LAUNCH):
        with span("h2d"):
            bt = torch.from_numpy(blocks[start : start + CHUNKS_PER_LAUNCH]).to(dev)
            lt = torch.from_numpy(np.ascontiguousarray(lens[start : start + CHUNKS_PER_LAUNCH])).to(dev)
        rows, row_len = encode_frame_chunks(bt, lt, fast=fast)
        with span("d2h"):
            rows, row_len = rows.cpu().numpy(), row_len.cpu().numpy()
        with span("join"):
            parts.append(concat_rows(rows, row_len))
    return parts
