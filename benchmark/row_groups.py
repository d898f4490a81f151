"""Row groups of Parquet pages, from the corpus and the seed: the inputs of
the page-read cells.

A configuration of this kind (``configs/parquet-snappy-pages.json``)
names the corpus, its chunk size and the page and row-group sizes. Each
corpus file is one byte column, whose values are the file's whole chunks
in turn, cycled; a file's last, shorter chunk is left out, so that every
page is byte for byte what the reference encoder makes of its bytes.
:func:`layout` lays out the row group (``reference/pages.py``
:func:`~benchmark.reference.pages.row_group`) from the lengths of the
chunks' op streams in ``traffic.load_corpus``'s cache, and checks the page
count against the one the configuration states.

The pool (:func:`pool`) holds ``pool_min_calls`` row groups and
``pool_min_input_bytes`` of pages at least, each row group its own copy of
the same pages, as a reader has them once sliced out of a column chunk:
each page's op stream without its preamble, and its
``uncompressed_page_size``. Every seed gets the same pages; the seed draws
only their order within each row group.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import traffic
from .reference import pages as ref_pages
from .reference import snappy as ref


@dataclass
class RowGroup:
    """One input of a call: a row group's pages, in the order handed over."""

    bodies: list[bytes]  # each page's op stream, no preamble
    declens: list[int]  # each page's uncompressed size
    pages: list[list[int]]  # each page's chunk ids
    raw_bytes: int  # uncompressed bytes
    in_bytes: int  # bytes handed to the call


class Pages(list):
    """A call's result: the pages' bytes in order; ``bytes()`` joins them."""

    def __bytes__(self) -> bytes:
        return b"".join(self)


def ops(chunk: traffic.Chunk) -> bytes:
    """A chunk's op stream: the reference's stream less its preamble."""
    return chunk.stream[len(ref.varint(len(chunk.raw))):]


def columns(corpus: traffic.Corpus) -> list[list[int]]:
    """Each file's whole chunks, in the configuration's order of files."""
    cb = len(corpus.chunks[0].raw)
    return [[i for i in corpus.by_file[f] if len(corpus.chunks[i].raw) == cb]
            for f in corpus.files]


def layout(corpus: traffic.Corpus, config: dict) -> list[list[int]]:
    """The chunk ids of each page of the configuration's row group, in the
    order they are written. Raises where the configuration states another
    page count (``pages``; ``None`` states none)."""
    cb = int(config["chunk_bytes"])
    op_len = [len(c.stream) - len(ref.varint(len(c.raw))) for c in corpus.chunks]
    pages = ref_pages.row_group(columns(corpus), op_len, cb, int(config["page_chunks"]),
                                int(config["row_group_bytes"]))
    want = config.get("pages")
    if want is not None and len(pages) != int(want):
        raise ValueError(f"the row group holds {len(pages)} pages, the configuration says {want}")
    return pages


def page_raw(corpus: traffic.Corpus, page: list[int]) -> bytes:
    """What a page decodes to."""
    return b"".join(corpus.chunks[i].raw for i in page)


def _row_group(corpus: traffic.Corpus, pages: list[list[int]]) -> RowGroup:
    bodies = [b"".join(ops(corpus.chunks[i]) for i in p) for p in pages]
    declens = [sum(len(corpus.chunks[i].raw) for i in p) for p in pages]
    return RowGroup(bodies, declens, pages, sum(declens), sum(map(len, bodies)))


def pool(corpus: traffic.Corpus, pages: list[list[int]], t: dict, seed: int) -> list[RowGroup]:
    """The row groups of a run: ``pages`` in a seeded order in each, each
    row group's streams a copy of their own."""
    rng = traffic._rng(seed, "pages")
    items: list[RowGroup] = []
    while not traffic._enough(items, t):
        items.append(_row_group(corpus, [pages[k] for k in rng.permutation(len(pages))]))
    return items


def expected(corpus: traffic.Corpus, item: RowGroup) -> bytes:
    """What a call on ``item`` returns, its pages joined."""
    return b"".join(page_raw(corpus, p) for p in item.pages)
