"""The host codec against the card by input size: from what size the card wins.

The port of the repository's ``tools/crossover_measure.py``. For each
input size (64 KiB to 64 MiB of the corpus's ``html``, ``alice29.txt``,
``urls.10K`` and ``kppkn.gtb``, cycled) it times, in one process:

- the host codec's batch calls over the 64 KiB blocks on every thread:
  ``enc_host_GBps`` (``native.compress_batch_into``) and ``dec_host_GBps``
  (``native.decompress_batch_into``);
- the flat route's two halves: the host flatten (``dec_flatten_host_s``,
  ``native.flatten_idx_batch``, ``layout=1``) and K2 on its resident
  indices, device-only (``dec_device_GBps``: the launches of one pass
  captured in a CUDA graph, ``utils.profiling.graph_ms``), and what a
  pipelined host and card give, the size over the slower of the two
  (``dec_e2e_GBps``);
- the flat encoder on resident blocks (``enc_device_GBps``:
  ``ops.encode_flat.compress_blocks_flat_fast``, K4, the plan and K5),
  timed with CUDA events around whole passes, the host's dispatch of the
  plan's small tensor ops included (``utils.profiling.event_ms``);
- the calls a user makes, host bytes to host bytes: ``dec_call_GBps``
  (``ops.api.decompress_frame`` on the host codec's frame stream: K2 with
  its checksum, as the ``device`` engine decodes) against ``dec_frame_host_GBps``
  (``native.frame_decompress``, every thread, as the ``native`` engine
  does), and ``enc_call_GBps`` (``ops.api.compress(data,
  profile="fast")``, the ``device-fast`` engine's raw compress) against
  ``enc_call_host_GBps`` (``native.compress``, the ``native`` engine's).

Every size runs whole: the card's passes in the configuration's launches
(``decode_rows_per_launch`` rows for K2, ``blocks_per_launch`` for the
encoder, padded to a power of two as ``ops.api.compress`` pads), every
launch timed; ``dec_launches`` and ``enc_launches`` count them. Each
pass's peak device bytes are taken on one pass of its own. Every measured
call is checked: decoded rows and streams against the input, compressed
rows and streams by decoding them with the host codec, the last timed call
of a device-only pass included.

Crossovers, each the smallest size where the card wins, or ``null`` where
it never does up to the largest size: ``decode_crossover_bytes``
(``dec_e2e_GBps`` over ``dec_host_GBps``) and ``encode_crossover_bytes``
(``enc_device_GBps`` over ``enc_host_GBps``), the JAX tool's definitions;
``decode_call_crossover_bytes`` and ``encode_call_crossover_bytes``, the
user's calls against the host engine's. Run::

    python -m snappy_tpu_torch.tools.crossover_measure [--sizes 65536,1048576] [--cpu]

Host times are ``[min, median, max]`` seconds of ``ITERS`` warm calls, the
rate from the min. ``--cpu`` runs the card's part on the kernels' plain
versions, with one warm call a stage, and writes every rate as not
measured. The result is the last line of stdout and
``build/snappy_tpu_torch/crossover_measure.json``.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from . import log, run

DATA = Path(__file__).resolve().parents[2] / "data"
NAME = "crossover_measure"
D_PAD = 1 << 16
SIZES = [1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24, 1 << 26]
#: Warm calls timed a host stage or call on the card.
ITERS = 5
#: Passes of K2 captured in one CUDA graph; passes of the encoder a window.
GRAPH_CALLS = 20
EVENT_CALLS = 5


def make_input(total: int) -> bytes:
    corpus = b"".join(
        (DATA / n).read_bytes()
        for n in ("html", "alice29.txt", "urls.10K", "kppkn.gtb")
    )
    reps = -(-total // len(corpus))
    return (corpus * reps)[:total]


def _first_win(rows: list[dict], card: str, host: str):
    return next((r["bytes"] for r in rows if r[card] > r[host]), None)


def _measure_size(size: int, dev, iters: int) -> dict:
    import torch

    from .. import native
    from ..bench import (
        NOT_MEASURED, _check_compressed, _check_rows, _check_zero, _gbps, _peak, _peak_reset,
        _time_it,
    )
    from ..config import get_config
    from ..format.constants import max_compress_len
    from ..format.varint import read_varu64
    from ..ops import api, launch_counts, packing, reset_launch_counts
    from ..ops.decode_flat import decode_flat
    from ..ops.encode_flat import compress_blocks_flat_fast
    from ..utils.profiling import event_ms, graph_ms

    on_card = dev.type == "cuda"
    data = make_input(size)
    blocks, lens32 = packing.blocks_of(data)
    b = blocks.shape[0]
    lens = lens32.astype(np.uint64)
    row = {"bytes": size, "blocks": b}
    reset_launch_counts()

    def timed(field: str, fn, check) -> None:
        check(fn())
        last = [None]

        def call():
            last[0] = fn()

        ts = _time_it(call, iters)
        check(last[0])
        row[f"{field}_s"] = ts
        row[f"{field}_GBps"] = _gbps(size, ts[0])

    # -- the host codec, every thread -----------------------------------------
    dsts = np.empty((b, max_compress_len(65536)), np.uint8)
    olens = np.empty(b, np.uint64)
    errs = np.zeros((b, 4), np.uint64)

    def check_enc_host(_):
        _check_zero(errs[:, 0], "host batch compress")
        for i in range(b):
            got = native.decompress(dsts[i, : int(olens[i])].tobytes())
            if got != blocks[i, : lens32[i]].tobytes():
                raise AssertionError(f"host batch compress: row {i} does not decode to its block")

    timed("enc_host", lambda: native.compress_batch_into(blocks, lens, dsts, olens, errs),
          check_enc_host)
    bodies = [dsts[i, read_varu64(dsts[i, :10].tobytes())[1] : int(olens[i])].tobytes()
              for i in range(b)]
    stride = -(-max(len(x) for x in bodies) // 128) * 128
    srcs = np.zeros((b, stride), np.uint8)
    for i, x in enumerate(bodies):
        srcs[i, : len(x)] = np.frombuffer(x, np.uint8)
    slens = np.array([len(x) for x in bodies], np.uint64)

    ddsts = np.empty((b, 65536), np.uint8)
    dolens = np.empty(b, np.uint64)
    derrs = np.zeros((b, 4), np.uint64)

    def check_dec_host(_):
        _check_zero(derrs[:, 0], "host batch decompress")
        _check_rows(ddsts, blocks, lens32, "host batch decompress")

    timed("dec_host", lambda: native.decompress_batch_into(dsts, olens, ddsts, dolens, derrs),
          check_dec_host)

    # -- the flat route: host flatten, then K2 on resident indices --------------
    flat = {}

    def flatten():
        idx, tmeta, fallb, herrs, _ = native.flatten_idx_batch(srcs, slens, lens, D_PAD,
                                                               threads=0, layout=1)
        _check_zero(herrs, "host flatten")
        _check_zero(fallb, "host flatten (tiles past every window)")
        flat["idx"], flat["tmeta"] = idx, tmeta

    flatten()
    row["dec_flatten_host_s"] = _time_it(flatten, iters)
    cfg = get_config()
    groups = [slice(s, s + cfg.decode_rows_per_launch)
              for s in range(0, b, cfg.decode_rows_per_launch)]
    srcs_d = torch.from_numpy(srcs).to(dev)
    idx_d = torch.from_numpy(flat["idx"].view(np.int16)).to(dev)
    tmeta_d = torch.from_numpy(flat["tmeta"]).to(dev)
    lens_d = torch.from_numpy(lens32).to(dev)

    def k2_pass():
        return [decode_flat(srcs_d[g], idx_d[g], tmeta_d[g], lens_d[g], D_PAD, 1) for g in groups]

    def check_k2(dsts_d, what="flat gather (K2)"):
        _check_rows(torch.cat([d.cpu() for d in dsts_d]), blocks, lens32, what)

    row["dec_launches"] = len(groups)
    _peak_reset(dev)
    check_k2(k2_pass())
    row["dec_device_peak_bytes"] = _peak(dev)
    if on_card:
        ms = graph_ms(k2_pass, GRAPH_CALLS, turns=3,
                      check=lambda d: check_k2(d, "flat gather (K2), timed replays"))
        row["dec_device_ms"] = ms
        row["dec_device_GBps"] = _gbps(size, min(ms) / 1e3)
        row["dec_e2e_GBps"] = _gbps(size, max(row["dec_flatten_host_s"][0], min(ms) / 1e3))
    else:
        row["dec_device_GBps"] = row["dec_e2e_GBps"] = NOT_MEASURED
    del srcs_d, idx_d, tmeta_d, flat

    # -- the flat encoder on resident blocks, in the configuration's launches --
    launches = []
    for s in range(0, b, cfg.blocks_per_launch):
        bb, ll = blocks[s : s + cfg.blocks_per_launch], lens32[s : s + cfg.blocks_per_launch]
        pad = packing.pad_to_bucket(bb.shape[0], 1) - bb.shape[0]
        bb = np.concatenate([bb, np.zeros((pad, bb.shape[1]), np.uint8)])
        ll = np.concatenate([ll, np.zeros(pad, np.int32)])
        launches.append((s, torch.from_numpy(bb).to(dev), torch.from_numpy(ll).to(dev)))

    def enc_pass():
        return [compress_blocks_flat_fast(bb, ll) for _, bb, ll in launches]

    def check_enc(outs, what="flat encoder (K4, K5)"):
        for (s, _, ll), (out, out_len, ovf) in zip(launches, outs):
            n = min(b - s, len(ll))
            _check_zero(ovf[:n], f"{what} (overflow flags)")
            _check_compressed(out[:n], out_len[:n], blocks[s : s + n], lens32[s : s + n], what)

    row["enc_launches"] = len(launches)
    _peak_reset(dev)
    check_enc(enc_pass())
    row["enc_device_peak_bytes"] = _peak(dev)
    if on_card:
        ms = event_ms(enc_pass, EVENT_CALLS, turns=3,
                      check=lambda o: check_enc(o, "flat encoder (K4, K5), timed calls"))
        row["enc_device_ms"] = ms
        row["enc_device_GBps"] = _gbps(size, min(ms) / 1e3)
    else:
        row["enc_device_GBps"] = NOT_MEASURED
    del launches

    # -- the calls a user makes, host bytes to host bytes --------------------------
    frame = native.frame_compress(data)

    def same(what):
        def check(got):
            if got != data:
                raise AssertionError(f"{what}: the output differs from the input")
        return check

    _peak_reset(dev)
    timed("dec_call", lambda: api.decompress_frame(frame, device=dev),
          same("decompress_frame (K2 with its checksum)"))
    row["dec_call_peak_bytes"] = _peak(dev)
    timed("dec_frame_host", lambda: native.frame_decompress(frame), same("host frame decompress"))
    _peak_reset(dev)
    timed("enc_call", lambda: api.compress(data, profile="fast", device=dev),
          lambda c: same("compress(profile='fast') (K4, K5)")(native.decompress(c)))
    row["enc_call_peak_bytes"] = _peak(dev)
    timed("enc_call_host", lambda: native.compress(data),
          lambda c: same("host compress")(native.decompress(c)))
    row["launches"] = {k: v for k, v in launch_counts().items() if v}
    if on_card:
        torch.cuda.empty_cache()
    return row


def measure(dev, sizes: list[int]) -> dict:
    on_card = dev.type == "cuda"
    iters = ITERS if on_card else 1
    rows = []
    for size in sizes:
        row = _measure_size(size, dev, iters)
        rows.append(row)
        log(NAME, " ".join(f"{k}={row[k]}" for k in (
            "bytes", "enc_host_GBps", "dec_host_GBps", "dec_device_GBps", "dec_e2e_GBps",
            "enc_device_GBps", "dec_call_GBps", "dec_frame_host_GBps", "enc_call_GBps",
            "enc_call_host_GBps")))
    out = {"rows": rows}
    if on_card:
        out.update(
            decode_crossover_bytes=_first_win(rows, "dec_e2e_GBps", "dec_host_GBps"),
            encode_crossover_bytes=_first_win(rows, "enc_device_GBps", "enc_host_GBps"),
            decode_call_crossover_bytes=_first_win(rows, "dec_call_GBps", "dec_frame_host_GBps"),
            encode_call_crossover_bytes=_first_win(rows, "enc_call_GBps", "enc_call_host_GBps"),
        )
    else:
        out.update(dict.fromkeys(["decode_crossover_bytes", "encode_crossover_bytes",
                                  "decode_call_crossover_bytes", "encode_call_crossover_bytes"]))
    out["note"] = (
        "rates in GB/s of input (encode) or output (decode) bytes; dec_device and enc_device "
        "are device-resident (K2 device-only; the encoder with its dispatch), dec_e2e "
        "pipelines the host flatten against K2; the _call fields are host bytes to host bytes; "
        "a crossover is the smallest size where the card wins, null where it never does"
    )
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog=f"python -m snappy_tpu_torch.tools.{NAME}")
    ap.add_argument("--sizes", help="input sizes in bytes, e.g. 65536,1048576 "
                                    "(default 64 KiB to 64 MiB in steps of 4)")
    ap.add_argument("--cpu", action="store_true", help="the card's part on the plain versions")
    args = ap.parse_args(argv)
    sizes = [int(s) for s in args.sizes.split(",")] if args.sizes else SIZES
    return run(NAME, lambda dev: measure(dev, sizes), args.cpu)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
