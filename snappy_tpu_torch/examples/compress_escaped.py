"""Debug tool: frame-compress a CLI argument and print escaped bytes,
then the roundtrip (reference examples/compress-escaped.rs)."""

import io
import sys

from snappy_tpu_torch import read, write
from snappy_tpu_torch.examples import engine


def escape(data: bytes) -> str:
    out = []
    for b in data:
        c = chr(b)
        if c in ("\\", "'", '"'):
            out.append("\\" + c)
        elif 0x20 <= b < 0x7F:
            out.append(c)
        elif b == 0x09:
            out.append("\\t")
        elif b == 0x0A:
            out.append("\\n")
        elif b == 0x0D:
            out.append("\\r")
        else:
            out.append(f"\\x{b:02x}")
    return "".join(out)


def main() -> None:
    if len(sys.argv) != 2:
        print("Usage: compress_escaped.py string", file=sys.stderr)
        raise SystemExit(1)
    data = sys.argv[1].encode()
    buf = io.BytesIO()
    enc = write.FrameEncoder(buf, engine())
    enc.write(data)
    enc.flush()
    compressed = buf.getvalue()
    print(escape(compressed))
    print(escape(read.FrameDecoder(io.BytesIO(compressed), engine()).read()))


if __name__ == "__main__":
    main()
