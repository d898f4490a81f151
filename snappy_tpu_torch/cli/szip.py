"""szip: gzip-like Snappy file compressor on the port's adapters.

    python -m snappy_tpu_torch.cli.szip [-d] [-k] [-f] [-r] [--engine E] [--stats]
                                        [--resume] [PATH ...]

The JAX package's ``szip`` with the same flags, files, messages and
bytes, over ``snappy_tpu_torch``'s ``raw``, ``read`` and ``write``. As in
the reference ``szip/main.rs``: files compress to ``NAME.sz`` (decompress
strips the extension), access/modification times are preserved, inputs
are deleted unless ``-k``, per-file errors are reported to stderr without
aborting the batch, and with no paths it streams stdin to stdout.

``--engine`` selects the codec engine (:mod:`snappy_tpu_torch.engine`):
``device`` and ``device-fast`` run on ``Config.device``, the card unless a
caller runs :func:`main` inside ``configure(device="cpu")``. ``--stats``
prints throughput and ratio to stderr.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

ABOUT = """\
szip compresses and decompresses data in the Snappy format.

szip works similarly to gzip. It takes files as parameters, compresses them
to a new file with a .sz extension, and removes the original. File access
and modification times are preserved.

Alternatively, data can be sent on stdin and its compressed form will be
sent to stdout.

The -d (short for --decompress) flag changes the mode from compression to
decompression.

The --raw flag can be used for compressing/decompressing the raw Snappy
format. Note that this requires reading the entire input/output into
memory. In general, you shouldn't use this flag unless you have a specific
need to.
"""


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="szip", description=ABOUT, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    p.add_argument("paths", nargs="*", help="File paths to compress (or decompress).")
    p.add_argument(
        "-d",
        "--decompress",
        action="store_true",
        help="Decompress data (default is compression).",
    )
    p.add_argument(
        "-f",
        "--force",
        action="store_true",
        help="Force (de)compression even if the corresponding output file already exists.",
    )
    p.add_argument(
        "-k",
        "--keep",
        action="store_true",
        help="Keep (don't delete) input files during (de)compression.",
    )
    p.add_argument(
        "-r",
        "--raw",
        action="store_true",
        help='Use the "raw" Snappy format (no framing).',
    )
    p.add_argument(
        "--engine",
        default="auto",
        choices=["auto", "native", "reference", "device", "device-fast"],
        help="Execution engine for the codec (default: auto).",
    )
    p.add_argument(
        "--stats",
        action="store_true",
        help="Print size/ratio/throughput statistics to stderr.",
    )
    p.add_argument(
        "--resume",
        action="store_true",
        help=(
            "Resume an interrupted frame compression: keep the existing "
            "output's valid chunk-aligned prefix and append the rest "
            "(frame streams are restartable at chunk granularity)."
        ),
    )
    return p


class _Ctx:
    def __init__(self, args):
        self.decompress_mode = args.decompress
        self.force = args.force
        self.keep = args.keep
        self.raw = args.raw
        self.engine = args.engine
        self.stats = args.stats
        self.resume = args.resume


class _WriteCounter:
    """Wraps a writer, counting bytes written."""

    def __init__(self, w):
        self.w, self.n = w, 0

    def write(self, b):
        self.n += len(b)
        return self.w.write(b)

    def flush(self):
        if hasattr(self.w, "flush"):
            self.w.flush()


class _ReadCounter:
    """Wraps a reader, counting bytes read."""

    def __init__(self, r):
        self.r, self.n = r, 0

    def read(self, n=-1):
        b = self.r.read(n)
        self.n += len(b)
        return b


def _compress_stream(ctx: _Ctx, src, dst) -> tuple[int, int]:
    from ..write import FrameEncoder

    n_in = n_out = 0
    if ctx.raw:
        data = src.read()
        n_in = len(data)
        out = _raw_compress(ctx, data)
        dst.write(out)
        n_out = len(out)
    else:
        counter = _WriteCounter(dst)
        enc = FrameEncoder(counter, engine=_host_engine(ctx))
        # 8 MiB reads: each oversized write goes straight to the
        # multithreaded native framer, so bigger spans amortize thread
        # spawn and keep every core fed (memory stays bounded).
        while True:
            chunk = src.read(1 << 23)
            if not chunk:
                break
            n_in += len(chunk)
            enc.write(chunk)
        enc.flush()
        n_out = counter.n
    return n_in, n_out


def _decompress_stream(ctx: _Ctx, src, dst) -> tuple[int, int]:
    from ..read import FrameDecoder

    n_in = n_out = 0
    if ctx.raw:
        data = src.read()
        n_in = len(data)
        out = _raw_decompress(ctx, data)
        dst.write(out)
        n_out = len(out)
    else:
        counter = _ReadCounter(src)
        wcounter = _WriteCounter(dst)
        dec = FrameDecoder(counter, engine=_host_engine(ctx))
        from ..engine import get_engine as _ge

        # Whole-file chunk-parallel decode (multithreaded native or one
        # batched device launch) — but only for a regular file of known,
        # modest size; pipes/stdin and large files fall back to bounded
        # streaming so peak memory stays ~1 MiB + one chunk, not
        # input+output (a FIFO fstats as size 0, which is "unknown", not
        # "small").
        import stat as stat_mod

        try:
            st_ = os.fstat(src.fileno())
            src_size = st_.st_size if stat_mod.S_ISREG(st_.st_mode) else None
        except (OSError, AttributeError, ValueError):
            src_size = None
        parallel_ok = src_size is not None and src_size <= (1 << 28)
        if parallel_ok and _ge(ctx.engine).name in ("native", "device", "device-fast"):
            wcounter.write(dec.read(-1))
        else:
            shutil.copyfileobj(dec, wcounter, 1 << 20)
        n_in = counter.n
        n_out = wcounter.n
    return n_in, n_out


def _host_engine(ctx: _Ctx) -> str:
    # Every registered engine (host or device) plugs into the streaming
    # adapters; the frame writer batches chunks per launch on device.
    return ctx.engine


def _raw_compress(ctx: _Ctx, data: bytes) -> bytes:
    from ..raw import Encoder

    return Encoder(engine=ctx.engine).compress_vec(data)


def _raw_decompress(ctx: _Ctx, data: bytes) -> bytes:
    from ..raw import Decoder

    return Decoder(engine=ctx.engine).decompress_vec(data)


def _new_path(ctx: _Ctx, old_path: str) -> str:
    name = os.path.basename(old_path)
    if not name:
        raise ValueError("missing file name")
    if ctx.decompress_mode:
        if len(name) <= 3 or not name.endswith(".sz"):
            raise ValueError("skipping uncompressed file")
        return os.path.join(os.path.dirname(old_path), name[:-3])
    if name.endswith(".sz"):
        raise ValueError("skipping compressed file")
    return os.path.join(os.path.dirname(old_path), name + ".sz")


def _resume_offsets(ctx: _Ctx, new_path: str) -> tuple[int, int]:
    """(valid output bytes, source bytes covered) of a partial .sz file."""
    from ..frame import scan_stream_prefix

    with open(new_path, "rb") as f:
        return scan_stream_prefix(f.read())


def _do_file(ctx: _Ctx, old_path: str) -> None:
    st = os.stat(old_path)
    if os.path.isdir(old_path):
        raise ValueError("is a directory")
    new_path = _new_path(ctx, old_path)
    resuming = (
        ctx.resume
        and not ctx.decompress_mode
        and not ctx.raw
        and os.path.exists(new_path)
    )
    if not ctx.force and not resuming and os.path.exists(new_path):
        raise ValueError(f"skipping, file already exists: {new_path}")

    t0 = time.monotonic()
    if resuming:
        keep_out, skip_src = _resume_offsets(ctx, new_path)
        with open(old_path, "rb") as src, open(new_path, "r+b") as dst:
            dst.truncate(keep_out)
            dst.seek(keep_out)
            src.seek(skip_src)
            n_in, n_out = _compress_stream(ctx, src, dst)
        n_in += skip_src
    else:
        with open(old_path, "rb") as src, open(new_path, "wb") as dst:
            if ctx.decompress_mode:
                n_in, n_out = _decompress_stream(ctx, src, dst)
            else:
                n_in, n_out = _compress_stream(ctx, src, dst)
    elapsed = time.monotonic() - t0

    os.utime(new_path, (st.st_atime, st.st_mtime))
    if not ctx.keep:
        os.remove(old_path)
    if ctx.stats:
        mb = (n_in or 1) / 1e6
        print(
            f"szip: {old_path}: {n_in} -> {n_out} bytes, "
            f"{mb / max(elapsed, 1e-9):.1f} MB/s",
            file=sys.stderr,
        )


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    ctx = _Ctx(args)
    if not args.paths:
        src = sys.stdin.buffer
        dst = sys.stdout.buffer
        if ctx.decompress_mode:
            _decompress_stream(ctx, src, dst)
        else:
            _compress_stream(ctx, src, dst)
        dst.flush()
        return 0
    for p in args.paths:
        try:
            _do_file(ctx, p)
        except Exception as e:  # per-file errors don't abort the batch
            print(f"{p}: {e}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
