"""The generator: the same seed gives the same inputs, another seed others,
and every input is made of the corpus bytes it claims."""

from __future__ import annotations

import pytest

from benchmark import traffic
from benchmark.reference import snappy as ref

CONFIG = {"corpus": ["alice29.txt", "fireworks.jpeg", "geo.protodata", "html"],
          "chunk_bytes": 65536}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return traffic.load_corpus(CONFIG, tmp_path_factory.mktemp("cache"))


FORMS = {
    "frame": ({"call_bytes": 400000, "fill": True, "pool_min_calls": 3}, traffic.frame_pool),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_same_seed_same_inputs_other_seed_others(corpus, form):
    t, make = FORMS[form]
    a, b, c = make(corpus, t, 2**40 + 7), make(corpus, t, 2**40 + 7), make(corpus, t, -3)
    assert [i.data for i in a] == [i.data for i in b]
    assert [i.chunks for i in a] != [i.chunks for i in c]


def test_every_seed_draws_the_same_chunks_in_another_order(corpus):
    t = {"call_bytes": 1100000, "fill": True, "pool_min_calls": 3}
    a, c = traffic.frame_pool(corpus, t, 11), traffic.frame_pool(corpus, t, 2**33 + 5)
    want = sorted(a[0].chunks)
    for item in a + c:
        assert sorted(item.chunks) == want and item.raw_bytes == a[0].raw_bytes
        assert len(item.data) == len(a[0].data)
    assert len(set(tuple(i.chunks) for i in a + c)) > 1
    # two whole copies of the four files (992,340 bytes), then the first
    # file's leading whole chunk
    assert a[0].raw_bytes == 2 * 496170 + 65536


def test_frame_inputs_decode_to_their_corpus_bytes(corpus):
    files = {n: (traffic.HERE / "corpus" / n).read_bytes() for n in CONFIG["corpus"]}
    for item in traffic.frame_pool(corpus, FORMS["frame"][0], 5):
        got = ref.frame_decode(item.data)
        assert got == traffic.expected_frame_output(corpus, item)
        assert len(got) == item.raw_bytes <= 400000 and len(item.data) == item.in_bytes
        # each chunk is its file's bytes at its offset
        at = 0
        for i in item.chunks:
            c = corpus.chunks[i]
            assert got[at : at + len(c.raw)] == files[c.file][c.index * 65536:][: len(c.raw)]
            at += len(c.raw)


def test_frame_objects_are_one_file_each(corpus):
    items = traffic.frame_pool(corpus, {"call_bytes": 0, "pool_min_calls": 6}, 5)
    for item in items:
        assert len({corpus.chunks[i].file for i in item.chunks}) == 1


def test_reference_gives_the_golden_stream():
    """The frozen encoder gives the reference encoder's bytes: the golden
    raw stream of the repository's test data."""
    data = traffic.ROOT / "data"
    text = (data / "Mark.Twain-Tom.Sawyer.txt").read_bytes()
    golden = (data / "Mark.Twain-Tom.Sawyer.txt.rawsnappy").read_bytes()
    assert ref.compress(text) == golden
    assert ref.decompress(golden) == text


def test_reference_crc_is_castagnoli_masked():
    # CRC32C("123456789") = 0xE3069283 (RFC 3720), masked as Snappy masks it
    c = 0xE3069283
    assert ref.crc32c_masked([b"123456789"]) == [(((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF]


def test_reference_rejects_a_flipped_checksum(corpus):
    item = traffic.frame_pool(corpus, FORMS["frame"][0], 5)[0]
    _, at, _ = next(c for c in ref.frame_walk(item.data) if c[0] == ref.CHUNK_COMPRESSED)
    bad = item.data[:at] + bytes((item.data[at] ^ 1,)) + item.data[at + 1:]
    with pytest.raises(ValueError):
        ref.frame_decode(bad)
    assert ref.frame_decode(bad, verify=False) == ref.frame_decode(item.data)
