"""Batched parallel decode of raw op streams in tensor ops, on any device.

The port of the JAX package's XLA decode (``snappy_tpu/ops/decode.py``),
batch-first with no ``vmap``: every function takes ``(B, S)`` bodies and
``(B,)`` lengths and runs the same on the CPU and on the card. The
sequential tag walk is broken with log-depth recurrences:

1. **Speculative parse** (:func:`parse_positions`): the op that would start
   at every source position, all positions at once.
2. **Op discovery** (:func:`discover_ops`): ``next[i] = i + consumed[i]``
   chains; the op starts are the orbit of position 0, marked by pointer
   doubling (``mark[jump] |= mark``, ``jump = jump[jump]``) until the batch
   converges or ``ceil(log2 S)`` rounds pass. The hosted variants take the
   host's op-start bitmap instead (``native.scan_ops_batch``).
3. **Validation** (:func:`first_error`): per-op flags reduced to the first
   bad op in stream order, with the device error codes below.
4. **Copy resolution** (:func:`resolve`): each output byte's covering op
   (a scatter of op indices at their output starts and a running max),
   then parent pointers chased to their literal roots by pointer jumping.

Exactness with the JAX package, which computes in ``int32`` and
``uint32``: the arithmetic here runs in ``int64`` and wraps to ``int32``
(:func:`_wrap32`) wherever JAX's can overflow, so that adversarial lengths
(clamped at ``_CAP``) give the same ``total_d``, codes and bytes. JAX
clamps gather indices and, under ``mode="drop"``, wraps negative scatter
indices once and drops the rest; every gather and scatter here bounds its
indices the same way. Rows are not zeroed past ``declen``: the bytes there
are the JAX package's, whatever they are.
"""

from __future__ import annotations

import torch

from .crc32c import crc32c_masked_blocks

#: Device error codes (``snappy_tpu/ops/decode.py:44-49``).
OK = 0
E_LITERAL = 1
E_COPYREAD = 2
E_OFFSET = 3
E_COPYWRITE = 4
E_HEADER_MISMATCH = 5

_CAP = 1 << 30  # clamp for lengths that provably overrun
_I64 = torch.int64


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """``int64`` values reduced to ``int32``'s range, as ``int32`` sums
    and differences wrap."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def parse_positions(srcs: torch.Tensor, src_lens: torch.Tensor) -> dict[str, torch.Tensor]:
    """The op that would start at every position of ``(B, S)`` uint8 rows.

    Returns ``(B, S)`` tensors (``int64``, or ``bool`` flags), meaningful
    only where a position turns out to start an op: ``is_lit``,
    ``consumed``, ``produced``, ``lit_content``, ``lit_err_src``,
    ``copy_off`` (a ``uint32`` value) and ``copy_err_read``.
    """
    b, s = srcs.shape
    i = torch.arange(s, device=srcs.device, dtype=_I64)[None, :]
    n = src_lens.to(_I64)[:, None]
    ext = torch.cat([srcs, srcs.new_zeros((b, 4))], dim=1).to(_I64)
    b0, u1, u2, u3, u4 = (ext[:, k : k + s] for k in range(5))
    trail32 = u1 | (u2 << 8) | (u3 << 16) | (u4 << 24)

    tag = b0 & 3
    lenm1 = b0 >> 2
    is_lit = tag == 0

    # Literal: 1-byte tag, then 0-4 length bytes, then the content.
    long_lit = lenm1 >= 60
    bytecount = (lenm1 - 59).clamp(1, 4)
    lit_trailing = trail32 & (0xFFFFFFFF >> (8 * (4 - bytecount)))
    lit_l = torch.where(long_lit, lit_trailing.clamp(max=_CAP), lenm1) + 1
    lit_extra = torch.where(long_lit, bytecount, 0)
    lit_content = i + 1 + lit_extra
    # A long length needs 4 readable bytes; the content must fit the source.
    lit_err_src = (long_lit & (i + 5 > n)) | (n - lit_content < lit_l)

    # Copy: 1-byte tag + 1/2/4 trailing offset bytes.
    ntb = torch.where(tag == 1, 1, torch.where(tag == 2, 2, 4))
    copy_len = torch.where(tag == 1, 4 + (lenm1 & 7), lenm1 + 1)
    off1 = ((b0 >> 5) << 8) | u1
    off2 = u1 | (u2 << 8)
    copy_off = torch.where(tag == 1, off1, torch.where(tag == 2, off2, trail32))
    return dict(
        is_lit=is_lit,
        consumed=torch.where(is_lit, 1 + lit_extra + lit_l, 1 + ntb),
        produced=torch.where(is_lit, lit_l, copy_len),
        lit_content=lit_content,
        lit_err_src=lit_err_src,
        copy_off=copy_off,
        copy_err_read=i + 1 + ntb > n,
    )


def _starts(op_mask: torch.Tensor, produced: torch.Tensor):
    """Exclusive prefix sums of ``produced`` over op starts (each op's
    output offset) and their totals, with ``int32`` wrap."""
    contrib = torch.where(op_mask, produced, 0)
    ends = contrib.cumsum(dim=1)
    return _wrap32(ends - contrib), _wrap32(ends[:, -1])


def discover_ops(consumed: torch.Tensor, produced: torch.Tensor, src_lens: torch.Tensor):
    """Op starts as the orbit of position 0, by pointer doubling.

    Returns ``(op_mask (B, S) bool, dst_start (B, S) int64, total_d (B,)
    int64)``.
    """
    b, s = consumed.shape
    dev = consumed.device
    i = torch.arange(s, device=dev, dtype=_I64)[None, :]
    live = i < src_lens.to(_I64)[:, None]
    # Positions at/after src_len are absorbing self-loops producing 0;
    # column s is the sentinel every chain ends in.
    jump = torch.where(live, (i + consumed).clamp(max=s), i)
    jump = torch.cat([jump, torch.full((b, 1), s, device=dev, dtype=_I64)], dim=1)
    # Column s + 1 takes the writes of unmarked positions.
    mark = torch.zeros((b, s + 2), device=dev, dtype=torch.uint8)
    mark[:, 0] = 1
    rounds = max(1, (s - 1).bit_length())
    for _ in range(rounds):
        # mark[jump[i]] |= mark[i], every write a 1.
        mark.scatter_(1, torch.where(mark[:, : s + 1] == 1, jump, s + 1), 1)
        jump2 = jump.gather(1, jump)
        converged = bool((jump2 == jump).all())
        jump = jump2
        if converged:
            break
    op_mask = (mark[:, :s] == 1) & live
    dst_start, total = _starts(op_mask, produced)
    return op_mask, dst_start, total


def first_error(op_mask, dst_start, declens, total_d, fields):
    """The first bad op's code in stream order, per row: ``(B,)`` int32
    (``E_HEADER_MISMATCH`` when every op is good but the lengths differ)."""
    s = op_mask.shape[1]
    i = torch.arange(s, device=op_mask.device, dtype=_I64)[None, :]
    decl = declens.to(_I64)[:, None]
    d = dst_start
    produced = fields["produced"]
    lit_err = fields["lit_err_src"] | (_wrap32(decl - d) < produced)
    off_u = fields["copy_off"]
    copy_code = torch.where(
        fields["copy_err_read"],
        E_COPYREAD,
        torch.where(
            (off_u == 0) | (d.clamp(min=0) < off_u),
            E_OFFSET,
            torch.where(_wrap32(d + produced) > decl, E_COPYWRITE, OK),
        ),
    )
    code = torch.where(fields["is_lit"], torch.where(lit_err, E_LITERAL, OK), copy_code)
    code = torch.where(op_mask, code, OK)
    first = torch.where(code != OK, i, s).amin(dim=1)
    err = torch.where(first < s, code.gather(1, first.clamp(max=s - 1)[:, None])[:, 0], OK)
    err = torch.where((err == OK) & (total_d != declens.to(_I64)), E_HEADER_MISMATCH, err)
    return err.to(torch.int32)


def resolve(srcs, fields, op_mask, dst_start, d_pad: int) -> torch.Tensor:
    """Output bytes ``(B, d_pad)`` uint8: each byte's covering op, then
    parents chased to literal roots by pointer jumping."""
    b, s = srcs.shape
    dev = srcs.device
    i = torch.arange(s, device=dev, dtype=_I64)[None, :]
    d = torch.arange(d_pad, device=dev, dtype=_I64)[None, :]

    # One int32 per op: literals store (lit_content - dst_start) biased by
    # +d_pad (>= 0), copies -(offset + 1) (< 0).
    off_clip = fields["copy_off"].clamp(max=d_pad)
    packed = torch.where(
        fields["is_lit"], _wrap32(fields["lit_content"] - dst_start + d_pad), -(off_clip + 1)
    )

    # Covering op of every output byte: each op's index scattered at its
    # output start, then a running max. JAX wraps a start in [-d_pad, 0)
    # once and drops any other outside [0, d_pad); column d_pad takes those.
    ds = torch.where(op_mask, dst_start, d_pad)
    ds = torch.where(ds < 0, ds + d_pad, ds)
    keep = (ds >= 0) & (ds < d_pad)
    cover = torch.full((b, d_pad + 1), -1, device=dev, dtype=_I64)
    cover.scatter_reduce_(
        1, torch.where(keep, ds, d_pad), torch.where(op_mask & keep, i, -1), "amax"
    )
    cover = cover[:, :d_pad].cummax(dim=1).values
    pg = packed.gather(1, cover.clamp(0, s - 1))
    c_is_lit = pg >= 0
    lit_src = _wrap32(pg - d_pad + d).clamp(0, s - 1)
    parent = torch.where(c_is_lit, d, (d + pg + 1).clamp(min=0))
    val = srcs.gather(1, lit_src)

    # Chase parents to their literal roots, stopping at the fixpoint.
    for _ in range(max(1, (d_pad - 1).bit_length())):
        parent2 = parent.gather(1, parent)
        converged = bool((parent2 == parent).all())
        parent = parent2
        if converged:
            break
    return val.gather(1, parent)


def _decode(srcs, src_lens, declens, d_pad, op_mask=None):
    fields = parse_positions(srcs, src_lens)
    if op_mask is None:
        op_mask, dst_start, total = discover_ops(fields["consumed"], fields["produced"], src_lens)
    else:
        dst_start, total = _starts(op_mask, fields["produced"])
    err = first_error(op_mask, dst_start, declens, total, fields)
    dst = resolve(srcs, fields, op_mask, dst_start, d_pad)
    return dst, err, total.to(torch.int32)


def hosted_op_mask(opbits: torch.Tensor, src_lens: torch.Tensor, s: int) -> torch.Tensor:
    """``(B, S)`` op starts from ``(B, S // 8)`` little-endian bitmaps,
    cut at each row's length."""
    i = torch.arange(s, device=opbits.device, dtype=_I64)[None, :]
    bits = opbits.to(_I64).repeat_interleave(8, dim=1)[:, :s]
    return (((bits >> (i & 7)) & 1) == 1) & (i < src_lens.to(_I64)[:, None])


def decode_block(src, src_len, declen, d_pad: int):
    """Decode one raw op stream (the bytes after the varint header), the JAX
    package's ``decode_block``: :func:`decode_batch` of a batch of one.

    ``src``: ``(S,)`` uint8, zero-padded; ``src_len``, ``declen``: ints or
    0-d tensors. Returns ``(dst (d_pad,) uint8, err int32, total_d int32)``,
    the last two 0-d tensors.
    """
    n = torch.as_tensor(src_len, dtype=torch.int32, device=src.device).reshape(1)
    d = torch.as_tensor(declen, dtype=torch.int32, device=src.device).reshape(1)
    dst, err, total = decode_batch(src[None], n, d, d_pad)
    return dst[0], err[0], total[0]


def decode_batch(srcs, src_lens, declens, d_pad: int):
    """Decode ``(B, S)`` uint8 bodies, finding the ops on the device.

    ``src_lens``, ``declens``: ``(B,)`` int32. Returns ``(dst (B, d_pad)
    uint8, err (B,) int32, total_d (B,) int32)``, the JAX package's
    ``decode_batch``.
    """
    return _decode(srcs, src_lens, declens, d_pad)


def decode_batch_hosted(srcs, src_lens, declens, opbits, d_pad: int):
    """:func:`decode_batch` given the host's ``(B, S // 8)`` uint8 op-start
    bitmaps (``native.scan_ops_batch``): the JAX package's
    ``decode_batch_hosted``. A wrong bitmap gives a flagged row, not
    silent corruption: every op is still validated."""
    op_mask = hosted_op_mask(opbits, src_lens, srcs.shape[1])
    return _decode(srcs, src_lens, declens, d_pad, op_mask)


def decode_crc_batch(srcs, src_lens, declens, d_pad: int):
    """:func:`decode_batch` and each row's masked CRC32C over its first
    ``declen`` bytes (K1): ``(dst, err, total_d, crc (B,) int64)``."""
    dst, err, total = decode_batch(srcs, src_lens, declens, d_pad)
    return dst, err, total, crc32c_masked_blocks(dst, declens)


def decode_crc_batch_hosted(srcs, src_lens, declens, opbits, d_pad: int):
    """:func:`decode_batch_hosted` with each row's masked CRC32C (K1)."""
    dst, err, total = decode_batch_hosted(srcs, src_lens, declens, opbits, d_pad)
    return dst, err, total, crc32c_masked_blocks(dst, declens)
