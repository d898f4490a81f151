"""The port's exact encoder equals the JAX package's, stage by stage.

The same numpy rows go through ``snappy_tpu.ops.encode`` (XLA on the CPU),
``snappy_tpu.ops.pallas.encode.compress_blocks_pallas`` (interpret mode,
on 4096- and 1024-byte rows as the JAX package's own tests run it) and
``snappy_tpu_torch.ops.encode`` (the plain version of K7, on CPU tensors):
the automaton's op planes, the serializer, the whole block encoder, and
each block against the reference encoder's raw stream. Outputs are bytes
and integers: tolerance 0. Contents stay at or below 16 KiB, since the
plain automaton takes one Python iteration per step.

``find_ops_rounds`` (K7's walk in scan rounds of 32 probes, on the host)
is held to the lockstep automaton and the JAX package's ``find_ops`` on
the same rows, on rows that crowd the table, on whole 64 KiB corpus blocks
against the host codec, and on the edges of its rounds.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conftest import load_corpus
from snappy_tpu.ops import encode as jenc
from snappy_tpu.ops.pallas.encode import compress_blocks_pallas
from snappy_tpu_torch import native
from snappy_tpu_torch.format.varint import read_varu64
from snappy_tpu_torch.ops import encode as enc
from torch_vectors import collision_rows, hold_jax_native, share_cores_with_workers

share_cores_with_workers()
hold_jax_native()


def _edge_rows():
    """The JAX package's edge rows (``tests/test_pallas.py:305-315``)."""
    rng = np.random.default_rng(3)
    return [
        b"hello world hello world hello world!",
        bytes(rng.integers(0, 4, 3000, dtype=np.uint8)),  # copy-heavy
        b"a" * 500,  # a run
        load_corpus("html")[:4096],
        bytes(rng.integers(0, 256, 1200, dtype=np.uint8)),  # incompressible
        b"xy",  # below MIN_NON_LITERAL_BLOCK_SIZE: one literal
        b"q" * 16,  # 16 < 17
        b"q" * 17,  # the smallest automaton input
        b"",
    ]


def _repetitive_rows(seed, count, max_len):
    """Seeded rows of a short random segment repeated (as the JAX
    package's quickcheck makes them)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(count):
        n = int(rng.integers(1, max_len))
        alphabet = int(rng.choice([2, 8, 64, 256]))
        seg = rng.integers(0, alphabet, max(n // 3, 1), dtype=np.uint8)
        rows.append(np.tile(seg, 4)[:n].tobytes())
    return rows


ROWS = _edge_rows() + _repetitive_rows(41, 4, 9000) + [
    load_corpus("alice29.txt")[:8192],
    b"abcdefgh" * 8192,  # a 64 KiB run of copies: long extensions, 64-byte peels
]


def _batch(datas, width=65536):
    rows = np.zeros((len(datas), width), np.uint8)
    lens = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        rows[i, : len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return rows, lens


def _oracle_body(data: bytes) -> bytes:
    """The reference encoder's raw stream without its varint preamble."""
    c = native.compress(data)
    return c[read_varu64(c)[1]:]


@pytest.fixture(scope="module")
def planes():
    rows, lens = _batch(ROWS)
    got = enc.find_ops_lockstep(torch.from_numpy(rows), torch.from_numpy(lens))
    want = jenc.find_ops(jnp.asarray(rows), jnp.asarray(lens))
    return rows, lens, got, [np.asarray(w) for w in want]


def test_find_ops_planes_match_jax_package(planes):
    _, _, got, want = planes
    for name, g, w in zip(("op_kind", "op_a", "op_b", "nops", "overflow"), got, want):
        assert g.dtype == (torch.bool if name == "overflow" else torch.int32), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert not got[4].any()


def test_find_ops_counts_the_kernels_steps(planes):
    """Extension steps of 128 bytes: one per started 128 bytes past the
    four that matched, for every copy op; the 64 KiB run's one copy is
    all extension."""
    _, lens, got, _ = planes
    op_kind, _, op_b, nops, _, scan_steps, extend_steps = got
    valid = torch.arange(enc.MAX_OPS)[None, :] < nops[:, None].long()
    copies = valid & (op_kind == 1)
    want = torch.where(copies, (op_b.long() - 4) // enc.QUANTUM + 1, 0).sum(1)
    assert torch.equal(extend_steps, want)
    assert int(copies[-1].sum()) == 1 and int(extend_steps[-1]) == (65536 - 8 - 4) // enc.QUANTUM + 1
    small = torch.from_numpy(lens) < 17
    assert not scan_steps[small].any() and (scan_steps[~small] > 0).all()


def test_serialize_ops_matches_jax_package(planes):
    """The serializer on the JAX package's own op planes."""
    rows, _, _, want = planes
    jout, jlen = jenc.serialize_ops(jnp.asarray(rows), *(jnp.asarray(w) for w in want[:4]))
    out, out_len = enc.serialize_ops(torch.from_numpy(rows), *(torch.tensor(w) for w in want[:4]))
    assert out.shape == (len(ROWS), enc.OUT_W) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))


def test_compress_blocks_matches_jax_package_and_the_reference(planes):
    rows, lens, _, _ = planes
    out, out_len = enc.compress_blocks(torch.from_numpy(rows), torch.from_numpy(lens))
    jout, jlen = jenc.compress_blocks(jnp.asarray(rows), jnp.asarray(lens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))
    for i, d in enumerate(ROWS):
        assert out[i, : out_len[i]].numpy().tobytes() == (_oracle_body(d) if d else b""), i
        assert not out[i, out_len[i]:].any()
    host_out, host_len = enc.compress_blocks_host(rows[:3], lens[:3], "cpu")
    np.testing.assert_array_equal(host_out, out[:3].numpy())
    np.testing.assert_array_equal(host_len, out_len[:3].numpy())


@pytest.mark.parametrize("width", [4096, 1024])
def test_compress_blocks_matches_pallas_interpret(width):
    datas = _edge_rows() if width == 4096 else _repetitive_rows(41, 6, 900)
    rows, lens = _batch(datas, width)
    jout, jlen = compress_blocks_pallas(jnp.asarray(rows), jnp.asarray(lens), interpret=True)
    out, out_len = enc.compress_blocks(torch.from_numpy(rows), torch.from_numpy(lens))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(jlen))


def test_an_overflowed_lane_is_poisoned(monkeypatch):
    rows, lens = _batch([b"hello world hello world hello world!", b"abc" * 100], 1024)
    real = enc.find_ops

    def overflowed(blocks, lengths):
        *planes, overflow = real(blocks, lengths)
        return (*planes, torch.tensor([False, True]))

    monkeypatch.setattr(enc, "find_ops", overflowed)
    _, out_len = enc.compress_blocks(torch.from_numpy(rows), torch.from_numpy(lens))
    assert int(out_len[1]) == enc.OUT_W + 1 and int(out_len[0]) <= enc.OUT_W
    with pytest.raises(RuntimeError, match="op-count overflow"):
        enc.compress_blocks_host(rows, lens, "cpu")


def test_wrapper_checks_its_inputs():
    rows = torch.zeros((2, 1024), dtype=torch.uint8)
    lens = torch.tensor([3, 1024], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 128"):
        enc.compress_blocks(torch.zeros((2, 1000), dtype=torch.uint8), lens)
    with pytest.raises(ValueError, match="multiple of 128"):
        enc.compress_blocks(torch.zeros((1, 65536 + 128), dtype=torch.uint8), lens[:1])
    with pytest.raises(ValueError, match=r"lie in \[0, 1024\]"):
        enc.compress_blocks(rows, torch.tensor([3, 1025], dtype=torch.int32))
    with pytest.raises(TypeError, match="int32"):
        enc.compress_blocks(rows, lens.long())
    with pytest.raises(TypeError, match="uint8"):
        enc.compress_blocks(rows.to(torch.int32), lens)
    with pytest.raises(ValueError, match="unsupported device"):
        enc.compress_blocks(rows.to("meta"), lens.to("meta"))


def test_find_ops_rounds_matches_lockstep_and_jax_package(planes):
    rows, lens, got, want = planes
    rounds = enc.find_ops_rounds(rows, lens)
    for name, r, g, w in zip(("op_kind", "op_a", "op_b", "nops", "overflow"), rounds, got, want):
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(r.numpy(), w, err_msg=name)
    # Its quanta are the lockstep's extension steps, its serial probes the scan steps.
    assert torch.equal(rounds[6], got[6]) and torch.equal(rounds[7], got[5])


@pytest.mark.parametrize("kind", list(collision_rows()))
def test_find_ops_rounds_on_rows_that_crowd_the_table(kind):
    datas = collision_rows()[kind]
    rows, lens = _batch(datas)
    rounds = enc.find_ops_rounds(rows, lens)
    got = enc.find_ops_lockstep(torch.from_numpy(rows), torch.from_numpy(lens))
    want = jenc.find_ops(jnp.asarray(rows), jnp.asarray(lens))
    for name, r, g, w in zip(("op_kind", "op_a", "op_b", "nops", "overflow"), rounds, got, want):
        np.testing.assert_array_equal(r.numpy(), g.numpy(), err_msg=name)
        np.testing.assert_array_equal(r.numpy(), np.asarray(w), err_msg=name)
    assert torch.equal(rounds[6], got[6]) and torch.equal(rounds[7], got[5])
    out, out_len = enc.serialize_ops(torch.from_numpy(rows), *rounds[:4])
    for i, d in enumerate(datas):
        assert out[i, : out_len[i]].numpy().tobytes() == (_oracle_body(d) if d else b""), i


@pytest.mark.parametrize("name", ["alice29.txt", "fireworks.jpeg", "kppkn.gtb", "html"])
def test_find_ops_rounds_gives_the_host_codecs_bytes_on_64k_blocks(name):
    """Whole 64 KiB corpus blocks, through ``serialize_ops``: the lockstep
    plain version would take minutes a block here."""
    data = load_corpus(name)[:65536]
    rows, lens = _batch([data])
    op_kind, op_a, op_b, nops, overflow, rounds, quanta, probes = enc.find_ops_rounds(rows, lens)
    out, out_len = enc.serialize_ops(torch.from_numpy(rows), op_kind, op_a, op_b, nops)
    assert out[0, : out_len[0]].numpy().tobytes() == _oracle_body(data)
    assert not overflow.any() and int(rounds[0]) > 0


@pytest.mark.parametrize("kind", ["no_match", "after_a_copy"])
def test_rounds_end_exactly_at_s_limit(kind):
    """Random rows of 47-50 bytes make no match: the first round's last lane
    exists only from 48 bytes on (its next position is then s_limit
    exactly), so the tail literal comes in round 1 or 2. Rows ``P + P + R``
    (``P`` 20 random bytes) copy 20 bytes at position 20, and the re-match
    probe at 40 misses. The round after it takes the run from 41 in all 32
    lanes from ``|R| = 48`` on."""
    rng = np.random.default_rng(5)
    short = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (47, 48, 49, 50)]
    p = rng.integers(0, 256, 20, dtype=np.uint8).tobytes()
    tails = [p + p + rng.integers(0, 256, r, dtype=np.uint8).tobytes() for r in (45, 46, 47, 48)]
    rows, lens = _batch(short if kind == "no_match" else tails, 1024)
    rounds = enc.find_ops_rounds(rows, lens)
    got = enc.find_ops_lockstep(torch.from_numpy(rows), torch.from_numpy(lens))
    for r, g in zip(rounds[:5], got[:5]):
        assert torch.equal(r, g)
    assert torch.equal(rounds[6], got[6]) and torch.equal(rounds[7], got[5])
    if kind == "no_match":
        assert rounds[5].tolist() == [1, 2, 2, 2] and rounds[3].tolist() == [1] * 4
    else:
        assert rounds[5].tolist() == [2, 2, 2, 3]
        assert rounds[3].tolist() == [3] * 4 and rounds[0][:, 1].tolist() == [1] * 4
        assert rounds[1][:, 1].tolist() == [20] * 4 and rounds[2][:, 1].tolist() == [20] * 4


def test_a_rematch_hit_takes_no_round():
    """After a copy the re-match probe comes on its own: ``P + P + P[5:] +
    R`` copies ``P`` at 20 (20 bytes, ending at 40), the probe at 40 finds
    position 5 in the table, so a second copy (offset 35, 15 bytes) follows
    with no round between; the probe at 55 misses, and one round takes the
    run to s_limit and the tail literal."""
    rng = np.random.default_rng(9)
    p = rng.integers(0, 256, 20, dtype=np.uint8).tobytes()
    data = p + p + p[5:] + rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
    rows, lens = _batch([data])
    rounds = enc.find_ops_rounds(rows, lens)
    got = enc.find_ops_lockstep(torch.from_numpy(rows), torch.from_numpy(lens))
    want = jenc.find_ops(jnp.asarray(rows), jnp.asarray(lens))
    for name, r, g, w in zip(("op_kind", "op_a", "op_b", "nops", "overflow"), rounds, got, want):
        np.testing.assert_array_equal(r.numpy(), g.numpy(), err_msg=name)
        np.testing.assert_array_equal(r.numpy(), np.asarray(w), err_msg=name)
    assert rounds[0][0, :4].tolist() == [0, 1, 1, 0] and int(rounds[3][0]) == 4
    assert rounds[1][0, :4].tolist() == [0, 20, 35, 55]
    assert rounds[2][0, :4].tolist() == [20, 20, 15, 95]
    assert rounds[5].tolist() == [2]
    out, out_len = enc.serialize_ops(torch.from_numpy(rows), *rounds[:4])
    assert out[0, : out_len[0]].numpy().tobytes() == _oracle_body(data)


@pytest.mark.parametrize("source", ["planes", "collision_rows"])
def test_rounds_are_never_more_than_the_table_probes(request, source):
    """A round makes one serial scan step's table probe at least. On text
    32 probes a round make the rounds far fewer than the serial scan
    steps."""
    if source == "planes":
        rows, lens, _, _ = request.getfixturevalue("planes")
    else:
        rows, lens = _batch([d for datas in collision_rows().values() for d in datas])
    *_, rounds, _, probes = enc.find_ops_rounds(rows, lens)
    assert (rounds <= probes).all()
    if source == "planes":
        text = ROWS.index(load_corpus("html")[:4096])
        assert int(rounds[text]) < int(probes[text])
