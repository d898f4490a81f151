"""Frame-compress stdin to stdout (reference examples/compress.rs).

Copies in pieces of ``COPY_BYTES``: on the ``device`` engines a write of
more than one 64 KiB chunk is framed on the card in whole launches, where
the 64 KiB pieces of ``shutil``'s default would each be framed on the host.
The bytes are the same on every engine."""

import shutil
import sys

from snappy_tpu_torch import write
from snappy_tpu_torch.examples import engine

COPY_BYTES = 16 << 20  # 256 chunks


def main() -> None:
    enc = write.FrameEncoder(sys.stdout.buffer, engine())
    shutil.copyfileobj(sys.stdin.buffer, enc, COPY_BYTES)
    enc.flush()


if __name__ == "__main__":
    main()
