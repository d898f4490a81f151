"""Frame-decompress stdin to stdout (reference examples/decompress.rs)."""

import shutil
import sys

from snappy_tpu_torch import read
from snappy_tpu_torch.examples import engine


def main() -> None:
    dec = read.FrameDecoder(sys.stdin.buffer, engine())
    shutil.copyfileobj(dec, sys.stdout.buffer)


if __name__ == "__main__":
    main()
