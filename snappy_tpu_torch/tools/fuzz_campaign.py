"""Randomized differential campaign of the port (offline; not part of the suite).

The counterpart of the repository's ``tools/fuzz_campaign.py``: the same
twelve legs, each with that leg's case generator, seed and demands, so a
leg gives the JAX leg's cases at the same ``n``: accept/reject agreement
with the NumPy oracle (``format.reference``) and the oracle's bytes where
it accepts. On the card the device legs run the hand-written kernels on
valid and mutated streams:

==  =========================================================  ==========================
leg what it holds                                               kernels on the card
==  =========================================================  ==========================
1   round trip, libsnappy differential, divergence classes      (host)
2   mutated streams: the host codec against the oracle          (host)
3   batched decode, one mutation in three (the hosted tensor    none (tensor ops)
    route, the JAX leg's hybrid path)
4   the fast profile's validity (``compress_blocks_fast``)      none (tensor ops)
5   mutated frame streams: the reference and native readers     K2 with its checksum; K3
    and ``decompress_frame`` agree on bytes and errors          and K1 for a group the
                                                                flatten rejects
6   the segmented reader                                        (host)
7   the host batch codec                                        (host)
8   ``SNAPPY_TPU_PALLAS_DECODE=1``: the flat route              K2; K3 for a group the
                                                                flatten rejects
9   ``..._PALLAS_RECORDS=1`` too: record replay                 K10
10  64 KiB-class streams on the flat route                      K2 ``layout=1``
11  the flat encoder, split emission                            K4, K6 (both entries)
12  the fused first-hop resolve route, bytes against native     K8, K2
==  =========================================================  ==========================

Run::

    python -m snappy_tpu_torch.tools.fuzz_campaign [n1 .. n12] [--legs 3,8] [--cpu]

Each leg runs in a process of its own (a CUDA fault poisons its
process's context), all of them at once: the run prints a line as each
leg ends and one JSON object last, with each leg's counts, seconds
(``legN_s``), kernel launches (``legN_launches``) and, for the decode
legs, the route each launch group took (``legN_routes``). A leg that
diverges, faults or overruns its deadline (``LEG_DEADLINE_S``, 1800 s) is
reported with the cases it was on (``legN_cases_at_fault``, and for
the decode legs 3, 8, 9 and 10 the launch group's,
``legN_group_at_fault``); the other legs run on and the run exits
non-zero. The device legs need a card
unless ``--cpu`` is given (then they run the kernels' plain versions);
without either they fail. ``FUZZ_SEED_OFFSET`` shifts every leg's seed,
as in the JAX campaign.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[2]

# FUZZ_SEED_OFFSET shifts every leg's RNG seed so repeated campaigns
# explore fresh case space instead of replaying the last run.
SEED_OFFSET = int(os.environ.get("FUZZ_SEED_OFFSET", "0"))

#: Cases a leg, legs 1-12: the JAX campaign's host-leg counts, and for the
#: kernel legs 8-12 what its interpreter never allowed.
DEFAULT_COUNTS = (50_000, 50_000, 3_000, 512, 2_000, 2_000, 2_000, 3_000, 3_000, 512, 512, 512)
DEVICE_LEGS = frozenset({3, 4, 5, 8, 9, 10, 11, 12})
#: Seconds a leg's process may run before it is killed and reported.
LEG_DEADLINE_S = 1800


class Divergence(AssertionError):
    """The port disagrees with the oracle on a case."""


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise Divergence(what)


def _quiet(lo: int, hi: int, cases=None) -> None:
    """The default progress report: none."""


def gen_input(rng) -> bytes:
    n = int(rng.integers(0, 12_000))
    kind = int(rng.integers(0, 4))
    if kind == 0:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == 1:
        return rng.integers(0, 4, n, dtype=np.uint8).tobytes()
    if kind == 2:
        seg = rng.integers(0, 256, max(n // 8, 1), dtype=np.uint8).tobytes()
        return (seg * 9)[:n]
    return bytes(n)  # all zeros: deep RLE chains


def _ops_of(stream: bytes):
    """Parse a raw Snappy stream into (kind, dst, len[, off]) ops."""
    p = 0
    while stream[p] & 0x80:
        p += 1
    p += 1
    out = []
    d = 0
    while p < len(stream):
        tag = stream[p]
        kind = tag & 3
        lm = tag >> 2
        if kind == 0:
            if lm >= 60:
                bc = lm - 59
                ln = int.from_bytes(stream[p + 1 : p + 1 + bc], "little") + 1
                p += 1 + bc
            else:
                ln = lm + 1
                p += 1
            out.append(("lit", d, ln))
            p += ln
            d += ln
        else:
            if kind == 1:
                ln = 4 + (lm & 7)
                off = ((tag >> 5) << 8) | stream[p + 1]
                p += 2
            elif kind == 2:
                ln = lm + 1
                off = int.from_bytes(stream[p + 1 : p + 3], "little")
                p += 3
            else:
                ln = lm + 1
                off = int.from_bytes(stream[p + 1 : p + 5], "little")
                p += 5
            out.append(("copy", d, ln, off))
            d += ln
    return out


def _divergence_class(ours: bytes, theirs: bytes) -> str:
    """First-differing-op class against libsnappy (``PARITY.md``: every
    observed class is a match-discovery difference of the 1.1.9 compressor,
    never an encoding-rule difference)."""
    for x, y in zip(_ops_of(ours), _ops_of(theirs)):
        if x == y:
            continue
        if x[0] == "lit" and y[0] == "lit":
            return ("cpp-match-starts-earlier" if x[2] > y[2]
                    else "ours-match-starts-earlier")
        if x[0] == "lit" and y[0] == "copy":
            return "cpp-copy-where-ours-literal"
        if x[0] == "copy" and y[0] == "lit":
            return "ours-copy-where-cpp-literal"
        if x[0] == "copy" and y[0] == "copy":
            if x[1] == y[1] and x[2] != y[2]:
                return "different-match-len-same-pos"
            if x[1] == y[1] and x[3] != y[3]:
                return "different-offset-same-pos"
            return "copy-vs-copy-other"
        return f"other:{x[0]}-vs-{y[0]}"
    return "prefix-equal-length-differs"


def _device(cpu: bool):
    """A device leg's device: the card, or the CPU under ``--cpu``; without a
    card and without ``--cpu`` this raises (``ops.api.resolve_device``)."""
    from ..ops.api import resolve_device

    return resolve_device("cpu" if cpu else "cuda")


@contextlib.contextmanager
def _env(**values):
    """The ``SNAPPY_TPU_*`` variables a JAX leg sets, set for the ``with`` body."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _on(dev, **cfg):
    """The port's entry points on ``dev`` (and ``cfg``), recording the route
    of every decode launch group into the yielded counter."""
    from ..config import configure
    from ..ops import api

    routes: Counter = Counter()
    saved, api.routes = api.routes, []
    try:
        with configure(device=str(dev), **cfg):
            yield routes
    finally:
        routes.update(r[2] for r in api.routes)
        api.routes = saved


def _bodies(rng, n: int, make):
    """``n`` raw bodies (no varint) of ``make(rng)``'s data, one in three
    with one byte mutated, and their declared lengths."""
    from .. import raw
    from ..format.varint import read_varu64

    enc = raw.Encoder(engine="native")
    bodies, declens = [], []
    for i in range(n):
        data = make(rng)
        comp = enc.compress_vec(data)
        _, h = read_varu64(comp)
        body = bytearray(comp[h:])
        if i % 3 == 0 and len(body) > 2:
            body[int(rng.integers(0, len(body)))] ^= int(rng.integers(1, 256))
        bodies.append(bytes(body))
        declens.append(len(data))
    return bodies, declens


def _hold_to_oracle(leg: int, bodies, declens, outs, errs) -> int:
    """Each row's code and bytes against the oracle's accept/reject and
    bytes; returns the rows flagged."""
    from .. import error as err
    from ..format import reference as ref
    from ..format.varint import write_varu64
    from ..ops.api import OK

    flagged = 0
    for i in range(len(bodies)):
        try:
            want = ref.decompress(write_varu64(declens[i]) + bodies[i])
        except err.SnappyError:
            _require(int(errs[i]) != OK, f"leg{leg} case {i}: the port accepted a bad stream")
            flagged += 1
            continue
        _require(int(errs[i]) == OK, f"leg{leg} case {i}: the port flagged a valid stream")
        _require(outs[i] == want, f"leg{leg} case {i}: byte divergence")
    return flagged


def _decode_leg(leg: int, n: int, dev, progress, bodies, declens, env: dict, **cfg) -> dict:
    """``bodies`` through ``decompress_streams`` one launch group at a time:
    the groups it makes of the whole batch (``api.launch_groups``), each
    announced with its cases before it is decoded, so that a fault names
    the group it happened in."""
    from ..config import get_config
    from ..ops.api import decompress_streams, launch_groups

    outs, errs = [b""] * n, np.zeros(n, np.int32)
    with _env(**env), _on(dev, **cfg) as routes:
        for idxs in launch_groups(bodies, get_config().decode_rows_per_launch):
            progress(min(idxs), max(idxs) + 1, idxs)
            gouts, gerrs, _ = decompress_streams([bodies[i] for i in idxs],
                                                 [declens[i] for i in idxs])
            for j, i in enumerate(idxs):
                outs[i], errs[i] = gouts[j], gerrs[j]
    return {f"leg{leg}_cases": n, f"leg{leg}_flagged": _hold_to_oracle(leg, bodies, declens, outs, errs),
            f"leg{leg}_routes": dict(routes)}


def leg1(n_cases: int, dev=None, progress=_quiet) -> dict:
    from .. import raw
    from ..utils import cpp_oracle as cpp

    rng = np.random.default_rng(0xF00D + SEED_OFFSET)
    enc = raw.Encoder(engine="native")
    dec = raw.Decoder(engine="native")
    cpp_ok = cpp.available()
    ident = 0
    classes = Counter()
    progress(0, n_cases)
    for i in range(n_cases):
        data = gen_input(rng)
        comp = enc.compress_vec(data)
        _require(dec.decompress_vec(comp) == data, f"leg1 roundtrip case {i}")
        if cpp_ok:
            _require(cpp.decompress(comp) == data, f"leg1 cpp-decodes-ours case {i}")
            theirs = cpp.compress(data)
            _require(dec.decompress_vec(theirs) == data, f"leg1 ours-decodes-cpp case {i}")
            if comp == theirs:
                ident += 1
            else:
                classes[_divergence_class(comp, theirs)] += 1
    return {
        "leg1_cases": n_cases,
        "leg1_byte_identical": ident,
        "leg1_divergence_classes": dict(classes),
        "leg1_divergence_note": (
            "non-identical cases are libsnappy-1.1.9 match-discovery "
            "drift vs the reference's 1.1.8 contract — see PARITY.md"
        ),
        "cpp": cpp_ok,
    }


def leg2(n_cases: int, dev=None, progress=_quiet) -> dict:
    from .. import error as err
    from .. import raw
    from ..format import reference as ref

    rng = np.random.default_rng(0xBEEF + SEED_OFFSET)
    enc = raw.Encoder(engine="native")
    dec = raw.Decoder(engine="native")
    rejects = 0
    progress(0, n_cases)
    for i in range(n_cases):
        data = gen_input(rng)
        comp = bytearray(enc.compress_vec(data))
        nmut = int(rng.integers(1, 4))
        for _ in range(nmut):
            if len(comp) == 0:
                break
            comp[int(rng.integers(0, len(comp)))] ^= int(rng.integers(1, 256))
        comp = bytes(comp)
        try:
            got_n, n_err = dec.decompress_vec(comp), None
        except err.SnappyError as e:
            got_n, n_err = None, e
        try:
            got_r, r_err = ref.decompress(comp), None
        except err.SnappyError as e:
            got_r, r_err = None, e
        _require((n_err is None) == (r_err is None),
                 f"leg2 case {i}: native {n_err!r} vs oracle {r_err!r}")
        if n_err is None:
            _require(got_n == got_r, f"leg2 case {i}: byte divergence")
        else:
            _require(n_err == r_err, f"leg2 case {i}: {n_err!r} != {r_err!r}")
            rejects += 1
    return {"leg2_cases": n_cases, "leg2_rejected": rejects}


def leg3(n_cases: int, dev, progress=_quiet) -> dict:
    """Batched decode against the oracle on random and mutated streams.

    The JAX leg runs ``decompress_streams`` with no selector on its CPU,
    which is the hosted tensor decode (its hybrid path: the host's op-start
    bitmaps, then the XLA decode). The port's default on the card is the
    flat route (legs 8 and 10 hold it), so this leg pins the counterpart,
    ``decode_kernels=False``: the hosted tensor route of ``ops/decode.py``,
    which launches no kernel (no K1: ``with_crc=False``)."""
    rng = np.random.default_rng(0xCAFE + SEED_OFFSET)
    bodies, declens = _bodies(rng, n_cases, lambda r: gen_input(r)[:8000])
    return _decode_leg(3, n_cases, dev, progress, bodies, declens, {}, decode_kernels=False)


def leg4(n_blocks: int, dev, progress=_quiet) -> dict:
    """Fast-profile encoder: random blocks, oracle-validated output."""
    import torch

    from ..format import reference as ref
    from ..format.varint import write_varu64
    from ..ops.encode_fast import compress_blocks_fast

    rng = np.random.default_rng(0xFA57 + SEED_OFFSET)
    b, s = 64, 65536
    done = 0
    while done < n_blocks:
        take = min(b, n_blocks - done)
        rows = np.zeros((b, s), np.uint8)
        lens = np.zeros(b, np.int32)
        for i in range(take):
            data = gen_input(rng)[:s]
            rows[i, : len(data)] = np.frombuffer(data, np.uint8)
            lens[i] = len(data)
        progress(done, done + take)
        out, out_len = compress_blocks_fast(torch.from_numpy(rows).to(dev),
                                            torch.from_numpy(lens).to(dev))
        out, out_len = out.cpu().numpy(), out_len.cpu().numpy()
        for i in range(take):
            body = out[i, : out_len[i]].tobytes()
            got = ref.decompress(write_varu64(int(lens[i])) + body)
            _require(got == rows[i, : lens[i]].tobytes(), f"leg4 block {done + i}")
        done += take
    return {"leg4_blocks": n_blocks}


def leg5(n_cases: int, dev, progress=_quiet) -> dict:
    """Frame streams: three-engine output and error-value agreement."""
    from .. import error as err
    from .. import read as rmod
    from .. import write as wmod
    from ..ops.api import decompress_frame

    rng = np.random.default_rng(0xFA3E + SEED_OFFSET)
    rejects = 0
    with _on(dev) as routes:
        for i in range(n_cases):
            data = gen_input(rng)
            buf = io.BytesIO()
            w = wmod.FrameEncoder(buf)
            w.write(data)
            w.flush()
            stream = bytearray(buf.getvalue())
            if i % 2 == 0 and len(stream) > 10:
                for _ in range(int(rng.integers(1, 3))):
                    stream[int(rng.integers(0, len(stream)))] ^= int(rng.integers(1, 256))
            stream = bytes(stream)
            progress(i, i + 1)
            results = []
            for run in (
                lambda: rmod.FrameDecoder(io.BytesIO(stream), engine="reference").read(),
                lambda: rmod.FrameDecoder(io.BytesIO(stream), engine="native").read(),
                lambda: decompress_frame(stream),
            ):
                try:
                    results.append(("ok", run()))
                except (err.SnappyError, EOFError) as e:
                    results.append(("err", e))
            kinds = {k for k, _ in results}
            _require(len(kinds) == 1, f"leg5 case {i}: accept/reject split {results!r}")
            if results[0][0] == "ok":
                _require(results[0][1] == results[1][1] == results[2][1], f"leg5 case {i}")
            else:
                e0, e1, e2 = (r[1] for r in results)
                same01 = (type(e0) is type(e1)) and (
                    not isinstance(e0, err.SnappyError) or e0 == e1
                )
                same02 = (type(e0) is type(e2)) and (
                    not isinstance(e0, err.SnappyError) or e0 == e2
                )
                _require(same01 and same02, f"leg5 case {i}: {e0!r} vs {e1!r} vs {e2!r}")
                rejects += 1
    return {"leg5_cases": n_cases, "leg5_rejected": rejects, "leg5_routes": dict(routes)}


def leg6(n_cases: int, dev=None, progress=_quiet) -> dict:
    """Segmented streaming reader against the sequential reference walk:
    random frame streams (multi-chunk, concatenated, padded, mutated),
    consumed through chunked reads; delivered bytes, error values, error
    positions and post-error resume must agree."""
    from .. import error as err
    from .. import native
    from .. import read as rmod

    rng = np.random.default_rng(0x5E6 + SEED_OFFSET)
    rejects = 0
    progress(0, n_cases)
    for i in range(n_cases):
        parts = [gen_input(rng) for _ in range(int(rng.integers(1, 4)))]
        stream = bytearray()
        for p in parts:
            stream += native.frame_compress(p * int(rng.integers(1, 30)))
        if int(rng.integers(0, 3)) == 0 and len(stream) > 14:
            stream[10:10] = b"\xfe\x03\x00\x00pad"  # padding chunk
        if i % 2 == 0 and len(stream) > 10:
            for _ in range(int(rng.integers(1, 4))):
                stream[int(rng.integers(0, len(stream)))] ^= int(rng.integers(1, 256))
        if int(rng.integers(0, 4)) == 0:
            stream = stream[: int(rng.integers(0, len(stream) + 1))]  # truncate
        stream = bytes(stream)
        rs = int(rng.choice([1 << 12, 1 << 16, 1 << 20]))
        results = []
        for eng in ("native", "reference"):
            out = bytearray()
            errors = []
            dec = rmod.FrameDecoder(io.BytesIO(stream), engine=eng)
            for _ in range(4000):
                try:
                    c = dec.read(rs)
                    if not c:
                        break
                    out += c
                except (err.SnappyError, EOFError) as e:
                    errors.append((len(out), type(e).__name__, str(e)))
            results.append((bytes(out), errors))
        _require(results[0] == results[1], f"leg6 case {i}: {results[0][1]!r} vs {results[1][1]!r}")
        if results[0][1]:
            rejects += 1
    return {"leg6_cases": n_cases, "leg6_with_errors": rejects}


def leg7(n_cases: int, dev=None, progress=_quiet) -> dict:
    """Host batch codec against per-row calls: identity on valid batches and
    first-failing-row error equality on batches with corrupt rows."""
    from .. import error as err
    from .. import native, raw

    rng = np.random.default_rng(0xBA7C + SEED_OFFSET)
    enc = raw.Encoder(engine="native")
    dec = raw.Decoder(engine="native")
    with_errors = 0
    progress(0, n_cases)
    for i in range(n_cases):
        rows = [gen_input(rng) for _ in range(int(rng.integers(1, 24)))]
        comp = [enc.compress_vec(r) for r in rows]
        _require(native.compress_batch(rows, threads=2) == comp, f"leg7 case {i} z")
        if i % 2 == 1:
            j = int(rng.integers(0, len(comp)))
            mutated = bytearray(comp[j])
            if mutated:
                mutated[int(rng.integers(0, len(mutated)))] ^= int(rng.integers(1, 256))
            comp[j] = bytes(mutated)
        seq_exc = None
        seq_out = []
        for c in comp:
            try:
                seq_out.append(dec.decompress_vec(c))
            except err.SnappyError as e:
                seq_exc = e
                break
        try:
            got = native.decompress_batch(comp, threads=2)
        except err.SnappyError as e:
            _require(seq_exc is not None, f"leg7 case {i}: batch raised {e!r}, seq accepted")
            _require(type(e) is type(seq_exc) and e == seq_exc, f"leg7 case {i}: {e!r} vs {seq_exc!r}")
            with_errors += 1
            continue
        _require(seq_exc is None, f"leg7 case {i}: batch accepted, seq raised {seq_exc!r}")
        _require(got == seq_out, f"leg7 case {i}: byte divergence")
    return {"leg7_cases": n_cases, "leg7_with_errors": with_errors}


def leg8(n_cases: int, dev, progress=_quiet) -> dict:
    """The kernel decode route (``SNAPPY_TPU_PALLAS_DECODE=1``) against the
    oracle on valid and mutated streams: the flat route (host flatten, K2
    ``layout=0`` at these widths), K3 for any group the flatten rejects."""
    rng = np.random.default_rng(0x9A77A5 + SEED_OFFSET)
    bodies, declens = _bodies(rng, n_cases, lambda r: gen_input(r)[:2000])
    return _decode_leg(8, n_cases, dev, progress, bodies, declens,
                       {"SNAPPY_TPU_PALLAS_DECODE": "1"})


def leg9(n_cases: int, dev, progress=_quiet) -> dict:
    """The record-replay route (``SNAPPY_TPU_PALLAS_RECORDS=1``, K10) against
    the oracle: the host scan's codes and the replayed bytes."""
    rng = np.random.default_rng(0x9EC02D5 + SEED_OFFSET)
    bodies, declens = _bodies(rng, n_cases, lambda r: gen_input(r)[:2000])
    return _decode_leg(9, n_cases, dev, progress, bodies, declens,
                       {"SNAPPY_TPU_PALLAS_DECODE": "1", "SNAPPY_TPU_PALLAS_RECORDS": "1"})


def leg10(n_cases: int, dev, progress=_quiet) -> dict:
    """The flat route on 64 KiB-class streams, so that ``d_pad`` is whole
    16 KiB groups and K2 takes ``layout=1``: bytes and accept/reject
    against the oracle on valid and mutated streams."""
    rng = np.random.default_rng(0xF1A7 + SEED_OFFSET)

    def make(r):
        # ~64 KiB inputs of mixed compressibility.
        parts = []
        while sum(len(p_) for p_ in parts) < 60000:
            parts.append(gen_input(r))
        return (b"".join(parts))[:65536 - int(r.integers(0, 3000))]

    bodies, declens = _bodies(rng, n_cases, make)
    return _decode_leg(10, n_cases, dev, progress, bodies, declens,
                       {"SNAPPY_TPU_PALLAS_DECODE": "1"})


def leg11(n_blocks: int, dev, progress=_quiet) -> dict:
    """The flat encoder with split emission (K4, then K6's ``shift_idx`` and
    ``emit_bytes``): random blocks, oracle-validated output."""
    import torch

    from ..format import reference as ref
    from ..format.varint import write_varu64
    from ..ops.encode_flat import _compress_blocks_flat_split

    rng = np.random.default_rng(0xF1A7 + SEED_OFFSET)
    b, s = 16, 65536
    done = 0
    while done < n_blocks:
        take = min(b, n_blocks - done)
        rows = np.zeros((b, s), np.uint8)
        lens = np.zeros(b, np.int32)
        for i in range(take):
            data = gen_input(rng)[:s]
            rows[i, : len(data)] = np.frombuffer(data, np.uint8)
            lens[i] = len(data)
        progress(done, done + take)
        out, out_len, ovf = _compress_blocks_flat_split(torch.from_numpy(rows).to(dev),
                                                        torch.from_numpy(lens).to(dev))
        out, out_len, ovf = out.cpu().numpy(), out_len.cpu().numpy(), ovf.cpu().numpy()
        _require(not ovf.any(), "leg11 overflow flagged")
        for i in range(take):
            if lens[i] == 0:
                _require(out_len[i] == 0, f"leg11 block {done + i}: output for an empty block")
                continue
            body = out[i, : out_len[i]].tobytes()
            got = ref.decompress(write_varu64(int(lens[i])) + body)
            _require(got == rows[i, : lens[i]].tobytes(), f"leg11 block {done + i}")
        done += take
    return {"leg11_blocks": n_blocks}


def leg12(n_blocks: int, dev, progress=_quiet) -> dict:
    """The fused first-hop resolve route (K8, its tensor ops, K2): random
    blocks, bytes against the host codec's, no fallback flag."""
    import torch

    from .. import native
    from ..ops.resolve import decode_resolve_batch

    rng = np.random.default_rng(0x5E50 + SEED_OFFSET)
    bodies, wants = [], []
    while len(bodies) < n_blocks:
        data = gen_input(rng)[: 1 << 16]
        if not data:
            continue
        comp = native.compress(data)
        p = 0
        while comp[p] & 0x80:
            p += 1
        body = comp[p + 1 :]
        if len(body) > 512 * 128:  # route constraint: <= 512 src rows
            continue
        bodies.append(body)
        wants.append(data)
    n = len(bodies)
    stride = -(-max(len(b) for b in bodies) // 128) * 128
    srcs = np.zeros((n, stride), np.uint8)
    for i, b in enumerate(bodies):
        srcs[i, : len(b)] = np.frombuffer(b, np.uint8)
    lens = np.array([len(b) for b in bodies], np.uint64)
    decl = np.array([len(w) for w in wants], np.uint64)
    recs, nops, errs, _ = native.scan_records_batch(srcs, lens, decl, 1 << 14, threads=2)
    _require(int(errs.sum()) == 0, "leg12: the host scan flagged a valid stream")
    progress(0, n)

    def t(x, dtype=None):
        return torch.from_numpy(np.asarray(x, dtype)).to(dev)

    out, fb = decode_resolve_batch(t(srcs), t(recs), t(nops, np.int32), t(decl, np.int32), 1 << 16)
    out, fb = out.cpu().numpy(), fb.cpu().numpy()
    for i, w in enumerate(wants):
        _require(not fb[i], f"leg12 unexpected fallback at {i}")
        _require(out[i, : len(w)].tobytes() == w, f"leg12 block {i}")
    return {"leg12_blocks": n}


LEGS = {1: leg1, 2: leg2, 3: leg3, 4: leg4, 5: leg5, 6: leg6, 7: leg7, 8: leg8, 9: leg9,
        10: leg10, 11: leg11, 12: leg12}


def run_leg(k: int, n: int, cpu: bool, report=None) -> tuple[dict, bool]:
    """Leg ``k`` at ``n`` cases in this process. Returns ``(fields, ok)``: the
    leg's counts with its seconds and kernel launches, or what failed with
    the cases it was on: ``legN_cases_at_fault``, the range ``[lo, hi)``
    last announced, and for the decode legs (3, 8, 9, 10)
    ``legN_group_at_fault``, the cases of that launch group.
    ``report(lo, hi, cases)`` hears of each range of cases before the leg
    works on it (``cases``: the group's, or None)."""
    import torch

    from ..ops import launch_counts, reset_launch_counts

    at = [None, None]

    def progress(lo: int, hi: int, cases=None) -> None:
        at[:] = [lo, hi], cases
        if report is not None:
            report(lo, hi, cases)

    t0 = time.perf_counter()
    reset_launch_counts()
    try:
        dev = _device(cpu) if k in DEVICE_LEGS else None
        fields = LEGS[k](n, dev, progress)
        if dev is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
    except Exception as e:  # the leg's boundary: reported with its cases, never skipped
        return _fault(k, f"{type(e).__name__}: {e}", *at), False
    fields[f"leg{k}_s"] = time.perf_counter() - t0
    fields[f"leg{k}_launches"] = {name: c for name, c in launch_counts().items() if c}
    return fields, True


def _fault(k: int, what: str, at, group) -> dict:
    out = {f"leg{k}_failure": what, f"leg{k}_cases_at_fault": at}
    if group is not None:
        out[f"leg{k}_group_at_fault"] = group
    return out


def _leg_process(k: int, n: int, cpu: bool, deadline_s: float) -> tuple[dict, bool]:
    """Leg ``k`` in a process of its own; a leg that dies or overruns its
    deadline is reported with the last range of cases it announced."""
    cmd = [sys.executable, "-m", "snappy_tpu_torch.tools.fuzz_campaign", "--leg", str(k), str(n)]
    proc = subprocess.Popen(cmd + (["--cpu"] if cpu else []), stdout=subprocess.PIPE,
                            stderr=sys.stderr, cwd=HERE, text=True)
    try:
        out, _ = proc.communicate(timeout=deadline_s)
        died = None if proc.returncode == 0 else f"exited with code {proc.returncode}"
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        died = f"overran its {deadline_s:.0f}s deadline and was killed"
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    result = next((ln for ln in reversed(lines) if "progress" not in ln), None)
    if result is not None and (died is None or f"leg{k}_failure" in result):
        return result, died is None
    at = next((ln for ln in reversed(lines) if "progress" in ln), {})
    return _fault(k, f"leg {k} {died}", at.get("progress"), at.get("cases")), False


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m snappy_tpu_torch.tools.fuzz_campaign")
    ap.add_argument("counts", nargs="*", type=int, help="cases of legs 1, 2, ... in order")
    ap.add_argument("--legs", help="run only these legs, e.g. 3,8")
    ap.add_argument("--cpu", action="store_true", help="run the device legs on the plain versions")
    ap.add_argument("--leg", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.leg is not None:
        def report(lo, hi, cases):
            line = {"progress": [lo, hi]}
            if cases is not None:
                line["cases"] = cases
            print(json.dumps(line), flush=True)

        fields, ok = run_leg(args.leg, args.counts[0], args.cpu, report)
        print(json.dumps(fields), flush=True)
        return 0 if ok else 1
    counts = list(DEFAULT_COUNTS)
    counts[: len(args.counts)] = args.counts
    legs = [int(x) for x in args.legs.split(",")] if args.legs else list(LEGS)
    t0 = time.time()
    results = {}
    with ThreadPoolExecutor(len(legs)) as pool:
        running = {pool.submit(_leg_process, k, counts[k - 1], args.cpu, LEG_DEADLINE_S): k
                   for k in legs}
        for fut in as_completed(running):
            k = running[fut]
            results[k] = fields, ok = fut.result()
            print(json.dumps({"progress": f"leg{k} {'done' if ok else 'FAILED'}", **fields}),
                  flush=True)
    out: dict = {}
    for k in legs:
        out.update(results[k][0])
    failed = [k for k in legs if not results[k][1]]
    out["elapsed_s"] = round(time.time() - t0, 1)
    out["failed_legs"] = failed
    out["ok"] = not failed
    print(json.dumps(out), flush=True)
    return 0 if not failed else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
