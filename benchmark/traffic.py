"""The one traffic generator: every cell's inputs, from its data files and the seed.

A configuration names the corpus and the chunk size; a cell's
``traffic`` object names the form of its inputs and their sizes. Every
input is built from the corpus's chunks: each file cut at every
``chunk_bytes`` from its start, its last chunk shorter. The reference
(``reference/snappy.py``) compresses and checksums each chunk once, and
the result is kept in ``build/benchmark/`` inside the checkout, keyed by
the corpus, the chunk size and the reference's source, so only the first
run in a checkout pays for it.

The form of the inputs (``traffic["form"]``):

- ``frame``: each input a frame stream of blocks, each a file framed
  whole (stream identifier, then its chunks): as many whole copies of the
  corpus as fit in ``call_bytes`` of uncompressed data, then the files in
  the configuration's order until the next would pass it; with ``fill``
  the rest is made up of that next file's leading whole chunks.
  ``call_bytes`` 0 makes each input one file, in a cycle of permutations
  of the files drawn from the seed.

Every input of every seed holds the same blocks, and the seed draws only
their order, so every seed asks the same work of the program. A pool holds at least
``pool_min_calls`` inputs and ``pool_min_input_bytes`` bytes handed to the
calls, so that it can exceed the host's caches.
"""

from __future__ import annotations

import fcntl
import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .reference import snappy as ref

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / "build" / "benchmark"


@dataclass(frozen=True)
class Chunk:
    file: str
    index: int
    raw: bytes
    stream: bytes  # the reference's raw Snappy stream of ``raw``, preamble included
    crc: int  # masked CRC32C of ``raw``

    @property
    def frame(self) -> bytes:
        return ref.frame_chunk(self.raw, self.stream, self.crc)


@dataclass
class Item:
    """One input of a call, with the chunks it was made from."""

    data: bytes
    chunks: list[int]
    raw_bytes: int  # uncompressed bytes
    in_bytes: int  # bytes handed to the call


@dataclass
class Corpus:
    chunks: list[Chunk]
    files: list[str]
    #: Seconds this process spent building the cache (0 where it was found):
    #: the reference's work, which set-up does not count.
    reference_s: float = 0.0
    by_file: dict[str, list[int]] = field(default_factory=dict)

    def __post_init__(self):
        for i, c in enumerate(self.chunks):
            self.by_file.setdefault(c.file, []).append(i)


def _rng(seed: int, stream: str) -> np.random.Generator:
    """A generator for ``stream`` of the run with ``seed`` (any whole
    number, negative or past 64 bits included)."""
    key = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return np.random.default_rng(list(np.frombuffer(key, np.uint32)))


def _cycle(rng: np.random.Generator, n: int):
    while True:
        yield from rng.permutation(n).tolist()


def _cache_key(files: list[Path], chunk_bytes: int) -> str:
    h = hashlib.sha256(repr(chunk_bytes).encode())
    h.update((HERE / "reference" / "snappy.py").read_bytes())
    for f in files:
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()[:20]


def load_corpus(config: dict, cache_dir: Path = CACHE) -> Corpus:
    """The configuration's corpus cut into chunks, each with the
    reference's stream and CRC, from the cache or built into it."""
    files = [HERE / "corpus" / name for name in config["corpus"]]
    cb = int(config["chunk_bytes"])
    key = _cache_key(files, cb)
    index, blob = cache_dir / f"chunks-{key}.json", cache_dir / f"chunks-{key}.bin"
    t = time.perf_counter()
    if not index.exists():
        cache_dir.mkdir(parents=True, exist_ok=True)
        with open(cache_dir / ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not index.exists():
                _build_cache(files, cb, index, blob)
    reference_s = time.perf_counter() - t
    meta = json.loads(index.read_text())
    data = blob.read_bytes()
    raws = {f.name: f.read_bytes() for f in files}
    chunks = [Chunk(m["file"], m["index"],
                    raws[m["file"]][m["index"] * cb : (m["index"] + 1) * cb],
                    data[m["at"] : m["at"] + m["len"]], m["crc"]) for m in meta["chunks"]]
    return Corpus(chunks, [f.name for f in files], reference_s)


def _build_cache(files: list[Path], cb: int, index: Path, blob: Path) -> None:
    raws, meta = [], []
    for f in files:
        d = f.read_bytes()
        for i, at in enumerate(range(0, len(d), cb)):
            raws.append(d[at : at + cb])
            meta.append({"file": f.name, "index": i})
    streams = [ref.compress(r) for r in raws]
    for r, s, m in zip(raws, streams, meta):
        if ref.decompress(s) != r:  # the reference holds itself to its input
            raise AssertionError(f"the reference does not decode its own chunk {m}")
    at = 0
    for m, s, crc in zip(meta, streams, ref.crc32c_masked(raws)):
        m.update(at=at, len=len(s), crc=crc)
        at += len(s)
    tmp = f".{os.getpid()}.tmp"
    blob_tmp, index_tmp = blob.with_name(blob.name + tmp), index.with_name(index.name + tmp)
    blob_tmp.write_bytes(b"".join(streams))
    os.replace(blob_tmp, blob)
    index_tmp.write_text(json.dumps({"chunk_bytes": cb, "chunks": meta}))
    os.replace(index_tmp, index)


def _enough(items: list, t: dict) -> bool:
    return (len(items) >= int(t.get("pool_min_calls", 1))
            and sum(i.in_bytes for i in items) >= int(t.get("pool_min_input_bytes", 0)))


def _frame_blocks(corpus: Corpus, cap: int, fill: bool) -> list[list[int]]:
    """The chunk ids of each block of a ``frame`` input of ``cap`` bytes."""
    cb = len(corpus.chunks[0].raw)
    blocks: list[list[int]] = []
    size, k = 0, 0
    files = corpus.files
    whole = sum(len(c.raw) for c in corpus.chunks)
    order = files * (cap // whole) + files
    while True:
        fids = corpus.by_file[order[k % len(order)]]
        n = sum(len(corpus.chunks[i].raw) for i in fids)
        if blocks and size + n > cap:
            if fill:
                fids = [i for i in fids[: (cap - size) // cb] if len(corpus.chunks[i].raw) == cb]
                if fids:
                    blocks.append(fids)
            return blocks
        blocks.append(fids)
        size += n
        k += 1
        if size >= cap:
            return blocks


def _item(corpus: Corpus, blocks: list[list[int]]) -> Item:
    parts, ids = [], []
    for fids in blocks:
        parts += [ref.STREAM_IDENTIFIER] + [corpus.chunks[i].frame for i in fids]
        ids += fids
    data = b"".join(parts)
    return Item(data, ids, sum(len(corpus.chunks[i].raw) for i in ids), len(data))


def frame_pool(corpus: Corpus, t: dict, seed: int) -> list[Item]:
    rng = _rng(seed, "frame")
    cap = int(t["call_bytes"])
    items: list[Item] = []
    if cap == 0:
        order = _cycle(rng, len(corpus.files))
        while not _enough(items, t):
            items.append(_item(corpus, [corpus.by_file[corpus.files[next(order)]]]))
        return items
    blocks = _frame_blocks(corpus, cap, bool(t.get("fill")))
    while not _enough(items, t):
        items.append(_item(corpus, [blocks[k] for k in rng.permutation(len(blocks))]))
    return items


def expected_frame_output(corpus: Corpus, item: Item) -> bytes:
    """What a frame decoder returns for a ``frame`` input."""
    return b"".join(corpus.chunks[i].raw for i in item.chunks)

