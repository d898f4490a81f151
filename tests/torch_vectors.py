"""Raw-stream vectors shared by the ``test_torch_*`` files.

Plain bytes built with numpy only, so that the card-only tests can use
them on a machine without JAX.
"""

import fcntl
import hashlib
import os
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def share_cores_with_workers() -> None:
    """Give torch's CPU ops this process's share of the cores.

    Under pytest-xdist each worker's torch would start one OpenMP thread
    per core; six workers' pools then contend for the same cores and slow
    the plain versions' tensor ops by one to two orders of magnitude."""
    import torch

    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))


def hold_jax_native(attempts: int = 8) -> None:
    """Load the JAX package's native library and extension in this process.

    ``snappy_tpu.native`` builds both next to its sources through one
    shared ``.tmp`` path per library and, when a load fails, latches
    ``_load_failed`` (or ``_ext = False``) for the life of the process.
    Several test workers loading it at once for the first time race on
    that path, and the losers keep no library: every later call in that
    worker fails. Loading under a lock in ``build/`` lets one worker build
    at a time; a lost race (with a process that takes no lock) clears the
    latches and loads again once the winner's library is in place.
    Imports the JAX package here, not at module level: the card's machine
    has no JAX. Gives up quietly after ``attempts``: a library that cannot
    build at all fails the tests that use it, not the collection."""
    from snappy_tpu import native as jnative

    lock_dir = REPO / "build"
    lock_dir.mkdir(exist_ok=True)
    with open(lock_dir / "jax_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for _ in range(attempts):
            if jnative._load() is not None and jnative._get_ext():
                return
            if jnative._lib is None:
                jnative._load_failed = False
            if jnative._ext is False:
                jnative._ext = None
            time.sleep(0.5)

# (body without varint, declen): the reference's corrupt vectors, then two
# rows that fail after a valid literal (their prefix must survive).
CORRUPT = [
    (b"\x00a\x1d\x01", 5),  # CopyWrite
    (b"\x00a\x3f\x00", 17),  # CopyRead
    (b"\x00a\x01\x00", 17),  # offset zero
    (b"\x00a\x01\xFF", 17),  # offset too big
    (b"\x61", 3),  # copy1 truncated (no record at all)
    (b"\xff\xff\xff\xff", 4),  # copy4 truncated
    (b"\xf0" + b"a" * 10, 4),  # long literal, declen short
    (b"\x00a", 4),  # ends early: header mismatch
    (b"\x0cabcd\x01\x04", 7),  # a valid literal, then a copy past declen
    (b"\x0cabcd\x01\x00", 20),  # a valid literal, then offset 0
]


def literal(b: bytes) -> bytes:
    """A literal op of 1..65536 bytes."""
    n = len(b) - 1
    if n < 60:
        return bytes([n << 2]) + b
    if n < 256:
        return bytes([60 << 2, n]) + b
    return bytes([61 << 2, n & 255, n >> 8]) + b


def copy2(offset: int, length: int) -> bytes:
    assert 1 <= length <= 64
    return bytes([((length - 1) << 2) | 2, offset & 0xFF, offset >> 8])


def fallback_row() -> tuple[bytes, int]:
    """A raw body the host flatten rejects: its 1024-byte output tile at
    64 KiB reads both the first literal (a 65535-offset copy) and a
    literal ~66 KiB later, a source spread wider than the widest window.
    Returns ``(body, declen)``."""
    rng = np.random.default_rng(11)
    lits = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (1024, 64512, 64)]
    body = literal(lits[0]) + literal(lits[1]) + copy2(65535, 64) + literal(lits[2])
    return body, 1024 + 64512 + 64 + 64


def overlap_rows(offsets=(1, 3, 31, 32, 33, 127, 128, 129), copies=5):
    """Rows of one literal of ``off`` bytes, then ``copies`` 64-byte
    copies and one 7-byte copy at that offset (overlapping whenever
    ``off < 64``). Returns ``[(body, declen)]``."""
    rng = np.random.default_rng(31)
    rows = []
    for off in offsets:
        body = literal(rng.integers(0, 256, off, np.uint8).tobytes())
        body += copy2(off, 64) * copies + copy2(off, 7)
        rows.append((body, off + 64 * copies + 7))
    return rows


def resolve_cases() -> list[bytes]:
    """The contents of the JAX package's chain-resolution tests
    (``tests/test_resolve.py``): corpus blocks with deep chains, offset-1
    and periodic overlaps, random bytes of two alphabets, one byte."""
    rng = np.random.default_rng(11)
    data = REPO / "data"
    return [
        (data / "html").read_bytes()[:65536],
        (data / "kppkn.gtb").read_bytes()[:65536],  # the deepest chains
        bytes(65536),  # offset-1 runs
        bytes([1, 2, 3]) * 21845,  # a periodic overlap
        rng.integers(0, 4, 65536, dtype=np.uint8).tobytes(),
        rng.integers(0, 256, 777, dtype=np.uint8).tobytes(),
        b"x",
    ]


def scan_batch(rows, rec_cap: int = 1 << 14):
    """``[(body, declen)]`` zero-padded to whole 128-byte rows and scanned
    into op records by the port's host runtime. Returns ``(srcs, lens,
    declens, recs, nops, errs)`` as numpy arrays (``lens``/``declens``
    int32)."""
    from snappy_tpu_torch import native

    width = -(-max(len(b) for b, _ in rows) // 128) * 128
    srcs = np.zeros((len(rows), width), np.uint8)
    for i, (b, _) in enumerate(rows):
        srcs[i, : len(b)] = np.frombuffer(b, np.uint8)
    lens = np.asarray([len(b) for b, _ in rows], np.int32)
    declens = np.asarray([d for _, d in rows], np.int32)
    recs, nops, errs, _ = native.scan_records_batch(
        srcs, lens.astype(np.uint64), declens.astype(np.uint64), rec_cap
    )
    return srcs, lens, declens, recs, nops, errs


def raw_body(data: bytes) -> tuple[bytes, int]:
    """``(body without its varint, len(data))`` of the host codec's stream."""
    from snappy_tpu_torch import native
    from snappy_tpu_torch.format.varint import read_varu64

    c = native.compress(data)
    return c[read_varu64(c)[1]:], len(data)


def wide_stream(n_blocks: int, seed: int = 5) -> tuple[bytes, int]:
    """A raw body past 64 KiB (``n_blocks`` of 64 KiB of output) whose 16
    KiB output units read source bytes 60 KiB apart: per block, a literal of
    60 KiB of random bytes, 32 copies of 64 bytes that reach back 60 KiB,
    and a literal of 2 KiB. Returns ``(body, declen)``."""
    rng = np.random.default_rng(seed)
    body = b""
    for _ in range(n_blocks):
        body += literal(rng.integers(0, 256, 61440, dtype=np.uint8).tobytes())
        body += copy2(61440, 64) * 32 + literal(rng.integers(0, 256, 2048, dtype=np.uint8).tobytes())
    return body, n_blocks * 65536


def collision_rows() -> dict[str, list[bytes]]:
    """Rows that crowd the exact encoder's table, four of each kind, made
    from seeds: short alphabets, 4-byte periods with a mutation now and
    then, rows of at most 257 bytes (a 256-entry table), and the edges:
    blocks of 16 and 17 bytes, an empty block and a 2 KiB block."""
    rng = np.random.default_rng(71)

    def period4(n):
        row = np.tile(rng.integers(0, 256, 4, dtype=np.uint8), n // 4 + 1)[:n]
        row[rng.integers(0, n, n // 50)] = rng.integers(0, 256, n // 50, dtype=np.uint8)
        return row.tobytes()

    return {
        "alphabets": [rng.integers(0, k, n, dtype=np.uint8).tobytes()
                      for k, n in ((2, 3000), (3, 2500), (4, 4000), (16, 1500))],
        "period4": [period4(n) for n in (1000, 2048, 3001, 4096)],
        "small_table": [rng.integers(0, k, n, dtype=np.uint8).tobytes()
                        for k, n in ((8, 257), (16, 200), (64, 100), (4, 120))],
        "edges": [rng.integers(0, 4, 16, dtype=np.uint8).tobytes(), b"abcd" * 4 + b"a",
                  b"", rng.integers(0, 8, 2048, dtype=np.uint8).tobytes()],
    }


def _corpus(name: str) -> bytes:
    return (REPO / "data" / name).read_bytes()


def copy1(offset: int, length: int) -> bytes:
    """A 2-byte copy: length 4-11, offset below 2048."""
    return bytes([(offset >> 8) << 5 | (length - 4) << 2 | 1, offset & 0xFF])


def copy4(offset: int, length: int) -> bytes:
    return bytes([(length - 1) << 2 | 3]) + offset.to_bytes(4, "little")


def random_ops(seed: int, declen: int) -> tuple[bytes, int]:
    """A valid stream of random ops of every kind (literals with 0-2 length
    bytes, copies with 1, 2 and 4 offset bytes, overlapping or not), so
    that headers fall on every phase of a window's end."""
    rng = np.random.default_rng(seed)
    body, d = b"", 0
    while d < declen:
        k = rng.integers(0, 5) if d else 0
        left = declen - d
        if k == 0:
            n = int(min(left, rng.choice([rng.integers(1, 61), rng.integers(61, 300)])))
            payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            body += (bytes([(n - 1) << 2]) + payload) if n <= 60 else literal(payload)
        elif k == 1 and left >= 4:
            n = int(rng.integers(4, min(11, left) + 1))
            body += copy1(int(rng.integers(1, min(d, 2047) + 1)), n)
        elif k in (2, 3) and left >= 1:
            n = int(rng.integers(1, min(64, left) + 1))
            off = int(rng.integers(1, min(d, 65535) + 1))
            body += copy2(off, n) if k == 2 else copy4(off, n)
        else:
            n = 1
            body += bytes([0]) + bytes([int(rng.integers(0, 256))])
        d += n
    return body, declen


def edge_rows() -> list[tuple[bytes, int]]:
    """Rows whose ops sit on a window's edges at the kernel's window."""
    rng = np.random.default_rng(5)
    # A literal of 4,091 bytes (header 3) puts the next op at 4,094: a
    # copy-2 header across the first window's end, then a copy-4.
    straddle = literal(rng.integers(0, 256, 4091, dtype=np.uint8).tobytes())
    straddle += copy2(100, 64) + copy4(4000, 40) + bytes([3 << 2]) + b"wxyz"
    straddle_decl = 4091 + 64 + 40 + 4
    # A literal longer than two windows, then copies reaching back into it.
    long_lit = rng.integers(0, 256, 10000, dtype=np.uint8).tobytes()
    multi = literal(long_lit) + copy2(9000, 64) * 30 + copy1(1, 11)
    # An offset-1 run of 2-byte ops across three windows.
    run = bytes([0]) + b"a" + copy1(1, 11) * 5000
    return [
        (straddle, straddle_decl),
        (multi, 10000 + 64 * 30 + 11),
        (run, 1 + 11 * 5000),
        (b"", 0),                                   # n = 0, clean
        (b"", 5),                                   # n = 0, short of declen
        raw_body(_corpus("alice29.txt")[:65536]),   # declen exactly 65536
        raw_body(bytes(65536)),
        # a run that turns bad in its third window: offset past the output
        (bytes([0]) + b"a" + copy1(1, 11) * 4500 + copy2(60000, 5), 1 + 11 * 4500 + 5),
    ]


def k9_planes(d_pad: int, seed: int):
    """First-hop planes: random backward pointers and roots, a chain through
    the whole row, pointers below 0 (read at position 0, itself a root or
    below 0), self pointers, and position 0 pointing to itself."""
    import torch

    from snappy_tpu_torch.ops.resolve import FLAG

    rng = np.random.default_rng(seed)
    p = np.arange(d_pad)
    a = np.where(rng.random((7, d_pad)) < 0.2, FLAG + rng.integers(0, 5000, (7, d_pad)),
                 (p[None] * rng.random((7, d_pad))).astype(np.int64))
    a[:, 0] = FLAG + 3
    a[1] = p - 1
    a[1, 0] = FLAG + 9                         # one chain through the row
    a[2, 100:300] = -7                         # below 0: position 0's value
    a[3, 0] = -2
    a[3, 4000:4200] = -1                       # ... which is itself below 0
    a[4, 5000] = 5000
    a[4, 5001:5100] = 5000                     # a self pointer and its chain
    a[5, 0] = 0                                # position 0 points to itself
    a[6] = np.where(p % 4096 == 0, FLAG + p, p - 1)  # a chain of 4,095 in each window
    return torch.tensor(a, dtype=torch.int32)


def _jax_package_hash(h) -> None:
    """Feed every source of the JAX package into the hash ``h``."""
    for src in sorted((REPO / "snappy_tpu").rglob("*")):
        if src.suffix in (".py", ".cpp"):
            h.update(str(src.relative_to(REPO)).encode())
            h.update(src.read_bytes())


def _computed_once(path: Path, compute, save, load):
    """``load(path)`` if an earlier asker left it, else ``compute()`` saved
    there by ``save(tmp, value)``; a lock of its own makes a second asker
    wait for the first one's result."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return load(path)
        value = compute()
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp{path.suffix}")
        save(tmp, value)
        os.replace(tmp, path)
        return value


def jax_entry_outputs(entry, mesh, *args, **kwargs) -> list[np.ndarray]:
    """``entry(mesh, *args, **kwargs)``'s outputs as numpy arrays: a JAX
    sharded entry's, computed once for every test file and worker that asks.

    The JAX entries whose Pallas kernels compile in interpret mode take
    15-20 s each on the CPU, and several ``test_torch_sharded*`` files hold
    the port to the same outputs. They are kept in
    ``build/jax_outputs/<entry>-<key>.npz``, the key a hash of the mesh's
    size, every argument (an array's dtype, shape and bytes, else its
    ``repr``), JAX's version and the JAX package's sources, so a changed
    input or package computes them anew."""
    return _jax_outputs(f"{entry.__name__} {mesh.devices.size}", entry.__name__,
                        lambda: entry(mesh, *args, **kwargs), args, kwargs)


def jax_call_outputs(fn, *args, **kwargs) -> list[np.ndarray]:
    """``fn(*args, **kwargs)``'s outputs as numpy arrays, computed once for
    every test file and worker that asks, as :func:`jax_entry_outputs` keeps
    them: for a JAX call that runs a Pallas kernel in interpret mode (the
    fused resolution takes ~35 s on the CPU), which two files make."""
    name = f"{fn.__module__}.{fn.__name__}"
    return _jax_outputs(name, name, lambda: fn(*args, **kwargs), args, kwargs)


def _jax_outputs(tag: str, stem: str, call, args, kwargs) -> list[np.ndarray]:
    import jax

    h = hashlib.sha256(f"{tag} {jax.__version__}".encode())
    for a in (*args, *sorted(kwargs.items())):
        if isinstance(a, np.ndarray):
            a = np.ascontiguousarray(a)
            h.update(f"{a.dtype} {a.shape}".encode())
            h.update(a.tobytes())
        else:
            h.update(repr(a).encode())
    _jax_package_hash(h)

    def compute():
        out = call()
        return [np.asarray(x) for x in (out if isinstance(out, tuple) else (out,))]

    def load(path):
        with np.load(path) as z:
            return [z[f"a{i}"] for i in range(len(z.files))]

    return _computed_once(
        REPO / "build" / "jax_outputs" / f"{stem}-{h.hexdigest()[:16]}.npz", compute,
        lambda tmp, out: np.savez(tmp, **{f"a{i}": x for i, x in enumerate(out)}), load,
    )


def jax_campaign_leg(leg: int, n: int) -> dict:
    """Leg ``leg`` of the JAX campaign (``tools/fuzz_campaign.py``) at ``n``
    cases, computed once for every test file and worker that asks: its
    kernel legs run the Pallas kernels in interpret mode (15-30 s each on
    the CPU). Kept in ``build/jax_outputs/`` as JSON, keyed by the leg,
    ``n``, ``FUZZ_SEED_OFFSET``, JAX's version, the campaign's source and
    the JAX package's sources."""
    import importlib.util
    import json

    import jax

    campaign = REPO / "tools" / "fuzz_campaign.py"
    offset = os.environ.get("FUZZ_SEED_OFFSET", "0")
    h = hashlib.sha256(f"leg{leg} {n} {offset} {jax.__version__}".encode())
    h.update(campaign.read_bytes())
    _jax_package_hash(h)

    def compute():
        spec = importlib.util.spec_from_file_location("jax_fuzz_campaign", campaign)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return getattr(mod, f"leg{leg}")(n)

    return _computed_once(
        REPO / "build" / "jax_outputs" / f"fuzz_leg{leg}-{h.hexdigest()[:16]}.json", compute,
        lambda tmp, out: tmp.write_text(json.dumps(out)), lambda path: json.loads(path.read_text()),
    )


def cpu_mesh(n: int):
    """A mesh of ``n`` CPU devices (one device, repeated), as the JAX tests'
    virtual CPU devices."""
    import torch

    from snappy_tpu_torch.parallel import make_mesh

    return make_mesh([torch.device("cpu")] * n)


def shard_blocks(n: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """``n`` blocks of 65,536 bytes for the sharded entries: 1-4 KiB of
    text, HTML, protobuf, table data, a JPEG, zeros and random bytes of a
    short alphabet, each a different length, zero-padded. Returns
    ``(blocks (n, 65536) uint8, lengths (n,) int32)``."""
    rng = np.random.default_rng(23)
    names = ["alice29.txt", "html", "geo.protodata", "kppkn.gtb", "fireworks.jpeg"]
    blocks = np.zeros((n, 65536), np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        m = 1024 + 397 * i
        if i % 7 == 5:
            row = bytes(m)
        elif i % 7 == 6:
            row = rng.integers(0, 4, m, dtype=np.uint8).tobytes()
        else:
            name = names[i % 7 % len(names)]
            row = _corpus(name)[1000 * i : 1000 * i + m]
        blocks[i, :m] = np.frombuffer(row, np.uint8)
        lens[i] = m
    return blocks, lens


def shard_bodies(blocks: np.ndarray, lens: np.ndarray, width: int = 4096):
    """Each block's raw body (no varint) by the port's host codec, zero-padded
    to ``width``: ``(srcs (n, width) uint8, src_lens (n,) int32)``."""
    srcs = np.zeros((len(lens), width), np.uint8)
    src_lens = np.zeros(len(lens), np.int32)
    for i, n in enumerate(lens):
        body, _ = raw_body(blocks[i, :n].tobytes())
        srcs[i, : len(body)] = np.frombuffer(body, np.uint8)
        src_lens[i] = len(body)
    return srcs, src_lens


def shard_decode_batch(blocks: np.ndarray, lens: np.ndarray):
    """The blocks' bodies (:func:`shard_bodies`), then the first 8 corrupt
    vectors: ``(srcs (n + 8, 4096) uint8, src_lens, declens (int32), opbits
    (n + 8, 512) uint8)``, the op-start bitmaps by the port's host runtime."""
    from snappy_tpu_torch import native

    srcs, src_lens = shard_bodies(blocks, lens)
    bad = np.zeros((8, srcs.shape[1]), np.uint8)
    for i, (body, _) in enumerate(CORRUPT[:8]):
        bad[i, : len(body)] = np.frombuffer(body, np.uint8)
    srcs = np.concatenate([srcs, bad])
    src_lens = np.concatenate([src_lens, [len(b) for b, _ in CORRUPT[:8]]]).astype(np.int32)
    declens = np.concatenate([lens, [d for _, d in CORRUPT[:8]]]).astype(np.int32)
    bits = np.zeros((len(srcs), srcs.shape[1] // 8), np.uint8)
    native.scan_ops_batch(srcs, src_lens.astype(np.uint64), bits)
    return srcs, src_lens, declens, bits


#: ``(layout, d_pad)`` of K2 with the frame checksum's tests: rows of one
#: unit under 16 KiB, of partial and whole units, up to eight.
FLAT_CRC_SHAPES = [(0, 1024), (0, 8192), (0, 16384), (0, 20480), (0, 32768), (0, 65536),
                   (1, 16384), (1, 32768), (1, 65536), (1, 131072)]


def flat_crc_rows(d_pad: int, seed: int = 13) -> list[tuple[bytes, int]]:
    """``(body, declen)`` rows for K2 with the frame checksum at ``d_pad``:
    declens 0, 1, 15, 16, 16,383, 16,384, 16,385 and ``d_pad`` where they
    fit (a short row's later units are dead), of text with copies and of
    random bytes (literals)."""
    from snappy_tpu_torch import native
    from snappy_tpu_torch.format.varint import read_varu64

    text = (REPO / "data" / "html").read_bytes()
    text = text * (-(-d_pad // len(text)))
    noise = np.random.default_rng(seed).integers(0, 256, d_pad, dtype=np.uint8).tobytes()
    rows = []
    for k, n in enumerate(n for n in (0, 1, 15, 16, 16383, 16384, 16385, d_pad) if n <= d_pad):
        data = (noise if k % 2 else text)[:n]
        c = native.compress(data)
        rows.append((c[read_varu64(c)[1]:], n))
    return rows
