"""Streaming writer: ``write.FrameEncoder``.

The port of the JAX package's ``write.py`` (reference ``src/write.rs``):
a file-object adapter that compresses what is written to it into the
Snappy frame format. Writes are buffered to 64 KiB blocks, large writes
bypass the buffer, the stream identifier precedes the first chunk, and
the encoder flushes on close. ``into_inner`` returns the underlying
writer, packaging a failed flush as :class:`snappy_tpu_torch.error.IntoInnerError`.

On the ``device`` engines a write of more than 64 KiB goes to the card
whole: CRC (K1), exact compression (K7) and framing in launches of 1,024
chunks (``ops/frame.py``), the same bytes as the host codec's. With
``device-fast`` the chunks compress with ``ops/encode_fast.py`` instead.
"""

from __future__ import annotations

import io

from .engine import get_engine
from .error import IntoInnerError
from .format.constants import MAX_BLOCK_SIZE, STREAM_IDENTIFIER
from .frame import compress_frame

__all__ = ["FrameEncoder"]


class FrameEncoder(io.RawIOBase):
    def __init__(self, writer, engine: str = "auto"):
        super().__init__()
        self._w = writer
        self._engine = get_engine(engine)
        self._src = bytearray()
        self._wrote_stream_ident = False

    def writable(self) -> bool:
        return True

    def get_ref(self):
        return self._w

    def __repr__(self) -> str:
        # Buffer-redacting repr (reference src/write.rs:195-213).
        return (
            f"FrameEncoder(inner=Inner(w={self._w!r}, "
            f"wrote_stream_ident={self._wrote_stream_ident}), src=[...])"
        )

    def write(self, buf) -> int:
        if type(buf) is not bytes:
            buf = bytes(memoryview(buf).cast("B"))
        total = 0
        # The reference's buffering policy (src/write.rs:123-152): fill the
        # 64 KiB buffer and flush it; once the buffer is empty, write
        # oversized inputs straight through.
        while len(buf) > MAX_BLOCK_SIZE - len(self._src):
            if not self._src:
                n = self._write_chunks(buf)
            else:
                free = MAX_BLOCK_SIZE - len(self._src)
                self._src += buf[:free]
                self.flush()
                n = free
            buf = buf[n:]
            total += n
        self._src += buf
        total += len(buf)
        return total

    def flush(self) -> None:
        if self._src:
            self._write_chunks(bytes(self._src))
            self._src.clear()
        if hasattr(self._w, "flush"):
            self._w.flush()

    def _write_chunks(self, buf: bytes) -> int:
        """Frame ``buf`` and write it: one call of ``ops.api``'s recorder."""
        from .ops import api

        return api._as_call("write.FrameEncoder", self._frame_chunks, buf)

    def _frame_chunks(self, buf: bytes) -> int:
        if not self._wrote_stream_ident:
            self._wrote_stream_ident = True
            self._w.write(STREAM_IDENTIFIER)
        if self._engine.name.startswith("device") and len(buf) > MAX_BLOCK_SIZE:
            return self._write_chunks_device(buf)
        if self._engine.name == "native" and len(buf) > MAX_BLOCK_SIZE:
            # Multithreaded native framing (identical wire bytes).
            from . import native

            self._w.write(native.frame_compress(buf)[len(STREAM_IDENTIFIER) :])
            return len(buf)
        total = 0
        for start in range(0, len(buf), MAX_BLOCK_SIZE):
            src = buf[start : start + MAX_BLOCK_SIZE]
            header, payload = compress_frame(self._engine, src)
            self._w.write(header)
            self._w.write(payload)
            total += len(src)
        return total

    def _write_chunks_device(self, buf: bytes) -> int:
        """Every chunk of ``buf`` framed on the device, one write per
        launch of :data:`ops.frame.CHUNKS_PER_LAUNCH` chunks."""
        from .ops import api
        from .ops.frame import encode_frame_host

        dev = api.resolve_device()
        fast = self._engine.name == "device-fast"
        for part in encode_frame_host(buf, dev, fast=fast, span=api._span):
            self._w.write(part)
        return len(buf)

    def into_inner(self):
        """Flush and return the underlying writer.

        Raises :class:`IntoInnerError` (carrying ``self`` for recovery) if
        the flush fails.
        """
        try:
            self.flush()
        except Exception as e:  # noqa: BLE001 - the reference's recovery
            raise IntoInnerError(self, e) from e
        w = self._w
        self._w = None
        super().close()
        return w

    def close(self) -> None:
        if self.closed or self._w is None:
            return
        try:
            self.flush()
        finally:
            super().close()

    def __del__(self):
        # Flush on drop, ignoring errors (reference src/write.rs:112-120).
        try:
            if not self.closed and self._w is not None:
                self.flush()
        except Exception:
            pass
