"""K2's phases and times on one NVIDIA GPU: a probe of its groups kernel.

    python3 k2_phase_probe.py [--parent PATH] [--set NAME=VALUE ...] [--out NAME]

Needs a CUDA card and ``nvcc``. Builds ``snappy_tpu_torch/csrc/flat_gather.cu``
(``change``) and, with ``--parent``, another ``flat_gather.cu`` of the same
C entries (``parent``; its entry ``stpu_cuda_flat_gather_groups`` may lack the
``counter`` and ``walked`` arguments), each twice into ``build/k2_phase_probe/``: as it stands,
and with ``STPU_FLAT_PROBE`` defined, whose groups kernel has thread 0 of
each CTA write ``%globaltimer`` at marks of each step of its walk (0: the
step's top; 1: its slot ready; 3, with the checksum: its tile free; 2: its
gather done). A kernel of a CTA a unit marks step 0 alone: 0, 2: its gather
done, 3: its tile stored, 4: its fold done, 5: its checksum tail done.
``--variant kStages=2,kBatch=1`` and the like add a build of the change
with those ``constexpr`` values (each its own side); ``--static`` adds the
change's build launched without its walk counter.

On the frame cell's own call (``bench_frame``: the groups ``decompress_frame``
hands K2 for the first stream of the cell's pool) and on three shapes of
``chip_smoke.py``, all layout 1: the 16 MiB frame read's five launch groups
(``chip_smoke.frame_read_groups``, the frame cell's call), the largest launch
group of the 64 MiB corpus stream (455 rows, ``d_pad`` 65536, the kernel
table's K2 shape) and the page cell's 145-row group of 1 MiB pages
(``chip_smoke.page_group``), it checks each build's bytes and CRCs against
the plain versions, then times, in turns (parent, change, change, parent):
K2 with the checksum (frame, 455 rows), K2 alone (all three) and K11 v3 (455
rows): ``graph_us``, 50 calls in a CUDA graph with the host out of the
window, and ``kernel_us``, the kernel's mean device time in a
``torch.profiler`` trace of 20 calls (what ``kernel_decode_GBps`` sums).
The probe builds' marks give, on the frame read and the page group, each
phase's mean and 90th percentile over (CTA, step), the kernel's span from
the first mark to the last, the spread of the CTAs' first and last marks,
and the steps a CTA walked. The change's SASS gives, for each instance of
the groups kernel, the 8-bit global loads issued before its first 8-bit
shared store, and its ``ptxas`` lines registers and spills.

Prints one JSON object and writes it to ``chiprun_out/<NAME>.json``
(default ``k2_phase_probe``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

MARKS = ("top", "ready", "gathered", "m3", "m4", "m5")


def build(sources: dict[str, str]) -> dict[str, str]:
    """Each ``{name: source text}`` compiled with the port's flags, as it
    stands and with ``STPU_FLAT_PROBE`` (``<name>_probe``), all at once into
    ``build/k2_phase_probe/``; returns each library's path by name."""
    from pathlib import Path

    from snappy_tpu_torch.ops import _build

    out_dir = Path(HERE) / "build" / "k2_phase_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs, names = [], []
    for name, text in sources.items():
        for probe in (False, True):
            src = out_dir / f"{re.sub(r'[^A-Za-z0-9_]', '_', name)}{'_probe' if probe else ''}.cu"
            src.write_text(text)
            jobs.append((src, [_build._nvcc(), *_build.NVCC_FLAGS,
                               *(["-DSTPU_FLAT_PROBE"] if probe else [])]))
            names.append(f"{name}{'_probe' if probe else ''}")
    return dict(zip(names, map(str, _build.compile_all(jobs))))


def crc_tables(text: str, dev) -> torch.Tensor:
    """The checksum tables a source's kernel reads (``decode_flat.flat_crc_tables``
    for the run and levels of its own ``kCrcThreads`` and ``kLevels``), on ``dev``."""
    from snappy_tpu_torch.ops import crc32c, decode_flat

    def const(name):
        return re.search(rf"constexpr int {name} = (\w+);", text).group(1)

    threads = const("kCrcThreads")
    threads = int(const("kThreads") if threads == "kThreads" else threads)
    run, levels = 16384 // threads, int(const("kLevels"))
    ops = ([crc32c.five_bit_tables(4)] + [crc32c.five_bit_tables(run << k) for k in range(levels)]
           + [crc32c.nibble_tables(16384 * k) for k in range(1, decode_flat.MAX_CRC_UNITS)]
           + [crc32c.inverse_nibble_tables(n) for n in decode_flat.tail_counts()])
    tabs = np.concatenate([op.reshape(-1) for op in ops]).astype(np.uint32)
    return torch.from_numpy(tabs.view(np.int32)).to(dev)


class Lib:
    """One build's C entries: the groups entry, K11's and (probe builds)
    the timestamp buffer's; and its checksum tables."""

    def __init__(self, path: str, text: str, probe: bool, static: bool = False):
        from snappy_tpu_torch.ops import decode_flat

        self.walk_args = "unsigned* counter" in text
        self.counter = None if static else torch.zeros(2, dtype=torch.int32, device="cuda")
        self.path = path
        self.tabs = crc_tables(text, torch.device("cuda"))
        self.lib = ctypes.CDLL(path)
        p = ctypes.c_void_p
        self.groups = self.lib.stpu_cuda_flat_gather_groups
        self.groups.argtypes = [ctypes.POINTER(decode_flat._FlatGroup), ctypes.c_int,
                                ctypes.c_int, p, p, *([p, p] if self.walk_args else []), p]
        self.groups.restype = ctypes.c_int
        self.k11 = self.lib.stpu_cuda_flat_grouped
        i64, ci = ctypes.c_int64, ctypes.c_int
        self.k11.argtypes = [p, i64, i64, p, p, p, p, i64, ci, ci, ci, ci, p, p]
        self.k11.restype = ctypes.c_int
        if probe:
            self.lib.stpu_cuda_flat_probe.argtypes = [p, p, p]

    def run(self, groups, outs, crc: bool):
        """One launch of ``groups`` (``decode_flat_groups``' tuples) into
        ``outs`` (``(out, crc)`` each) on the current stream."""
        from snappy_tpu_torch.ops import decode_flat

        dev = groups[0][0].device
        state = decode_flat._crc_scratch(dev)[1] if crc else None
        tabs = self.tabs if crc else None
        table = (decode_flat._FlatGroup * len(groups))()
        for t, g, (out, c) in zip(table, groups, outs):
            srcs, idx, tmeta, dl, d_pad, _ = g
            t.srcs, t.idx, t.tile_meta, t.declens = (srcs.data_ptr(), idx.data_ptr(),
                                                     tmeta.data_ptr(), dl.data_ptr())
            t.out, t.crc = out.data_ptr(), c.data_ptr() if crc else 0
            t.rows, t.s_width, t.d_pad = srcs.shape[0], srcs.shape[1], d_pad
        counter = None if self.counter is None else self.counter.data_ptr()
        extra = [counter, None] if self.walk_args else []
        status = self.groups(table, len(groups), groups[0][5],
                             tabs.data_ptr() if crc else None,
                             state.data_ptr() if crc else None, *extra,
                             torch.cuda.current_stream().cuda_stream)
        assert status == 0, f"groups launch: CUDA error {status}"

    def run_k11(self, g, gbuck, out):
        from snappy_tpu_torch.ops import decode_flat

        srcs, idx, tmeta, dl, d_pad, _ = g
        b, s = srcs.shape
        status = self.k11(srcs.data_ptr(), b, s, idx.data_ptr(), tmeta.data_ptr(),
                          gbuck.data_ptr(), dl.data_ptr(), d_pad, 3,
                          *decode_flat.window_rows(s // 128), out.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
        assert status == 0, f"K11 launch: CUDA error {status}"


def outputs(groups, crc: bool):
    dev = groups[0][0].device
    return [(torch.empty((g[0].shape[0], g[4]), dtype=torch.uint8, device=dev),
             torch.empty(g[0].shape[0], dtype=torch.int64, device=dev) if crc else None)
            for g in groups]


def largest_group(dev):
    """The 64 MiB corpus stream's largest launch group (455 rows, layout 1,
    ``d_pad`` 65536), as ``chip_smoke.py`` times K2 on it."""
    import snappy_tpu_torch
    from chip_smoke import STREAM_BYTES, compressed_chunks, corpus_stream, native_flatten
    from snappy_tpu_torch import native
    from snappy_tpu_torch.ops import api, packing

    chunks = compressed_chunks(native.frame_compress(corpus_stream(STREAM_BYTES)))
    bodies = [c[0] for c in chunks]
    g = max(api.launch_groups(bodies, snappy_tpu_torch.get_config().decode_rows_per_launch),
            key=len)
    gd = [chunks[i][1] for i in g]
    srcs, lens = packing.batch_streams([bodies[i] for i in g], api._width_bucket(len(bodies[g[0]])))
    d_pad = packing.pad_to_bucket(max(gd), 1024)
    idx, tmeta, fallb, errs, _ = native_flatten(srcs, lens, gd, d_pad, 1)
    assert not fallb.any() and not errs.any() and d_pad == 65536
    return (*(torch.from_numpy(x).to(dev) for x in (srcs, idx.view(np.int16), tmeta,
                                                     np.asarray(gd, np.int32))), d_pad, 1)


def bench_frame_groups():
    """The frame cell's call as K2 gets it: the launch groups that
    ``decompress_frame`` hands ``decode_flat_groups`` for the first stream
    of the cell's pool (``benchmark/traffic.py``, seed 1), on the card."""
    import snappy_tpu_torch
    from benchmark import traffic
    from snappy_tpu_torch.ops import api

    with open(os.path.join(HERE, "benchmark", "cells", "frame-read.16m.json")) as f:
        cell = json.load(f)
    with open(os.path.join(HERE, "benchmark", "configs", f"{cell['config']}.json")) as f:
        config = json.load(f)
    corpus = traffic.load_corpus(config)
    item = traffic.frame_pool(corpus, {**cell["traffic"], "pool_min_calls": 1,
                                       "pool_min_input_bytes": 1}, 1)[0]
    seen, real = [], api.decode_flat_groups

    def spy(groups, with_crc=False):
        seen.append([tuple(x.clone() if torch.is_tensor(x) else x for x in g) for g in groups])
        return real(groups, with_crc)

    api.decode_flat_groups = spy
    try:
        snappy_tpu_torch.decompress_frame(item.data)
    finally:
        api.decode_flat_groups = real
    return seen[0]


def kernel_us(fn, n: int = 20) -> float:
    """Mean device time of the kernels ``fn`` launches, over ``n`` calls
    of a ``torch.profiler`` trace (one kernel a call); a trace that holds
    fewer than half of them is taken again, up to three times (NaN)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        durs = [float(e["dur"]) for e in events if e.get("cat") == "kernel" and "dur" in e]
        if n // 2 <= len(durs) <= n:
            return sum(durs) / len(durs)
    return float("nan")


def marks_summary(buf: torch.Tensor, ctas: int, steps: int) -> dict:
    """The probe build's marks of one launch, summed up (see the module's
    docstring); times in microseconds."""
    t = buf.cpu().numpy().reshape(-1, steps, len(MARKS) + 2)[:ctas, :, :len(MARKS)]
    t = t.astype(np.float64)
    t[t == 0] = np.nan
    t0 = np.nanmin(t)
    t = (t - t0) / 1e3
    stepped = ~np.isnan(t[:, :, 0])
    end = np.nanmax(t, axis=2)
    out = {"ctas": ctas, "steps_per_cta": {"mean": float(stepped.sum(1).mean()),
                                           "max": int(stepped.sum(1).max())},
           "span_us": float(np.nanmax(end)),
           "first_start_us": {"p50": float(np.nanmedian(t[:, 0, 0])),
                              "max": float(np.nanmax(t[:, 0, 0]))},
           "last_end_us": {"min": float(np.nanmin(np.nanmax(end, axis=1))),
                           "p50": float(np.nanmedian(np.nanmax(end, axis=1)))},
           "phases_us": {}}
    prev, prev_name = t[:, :, 0], MARKS[0]
    for m in range(1, len(MARKS)):
        have = ~np.isnan(t[:, :, m])
        if not have.any():
            continue
        d = (t[:, :, m] - prev)[have]
        out["phases_us"][f"{prev_name}->{MARKS[m]}"] = {
            "mean": float(np.mean(d)), "p90": float(np.percentile(d, 90)), "n": int(d.size)}
        prev, prev_name = np.where(have, t[:, :, m], prev), MARKS[m]
    nxt = t[:, 1:, 0] - end[:, :-1]
    nxt = nxt[~np.isnan(nxt)]
    if nxt.size:
        out["phases_us"]["end->next top"] = {"mean": float(nxt.mean()),
                                             "p90": float(np.percentile(nxt, 90)),
                                             "n": int(nxt.size)}
    return out


def probe_marks(lib: Lib, groups, crc: bool, units: int) -> dict:
    steps, marks = ctypes.c_int(), ctypes.c_int()
    dev = groups[0][0].device
    outs = outputs(groups, crc)
    lib.run(groups, outs, crc)  # warm
    torch.cuda.synchronize()
    lib.lib.stpu_cuda_flat_probe(None, ctypes.byref(steps), ctypes.byref(marks))
    assert marks.value == len(MARKS) + 2
    buf = torch.zeros(units * steps.value * marks.value, dtype=torch.int64, device=dev)
    assert lib.lib.stpu_cuda_flat_probe(buf.data_ptr(), ctypes.byref(steps),
                                        ctypes.byref(marks)) == 0
    lib.run(groups, outs, crc)
    torch.cuda.synchronize()
    lib.lib.stpu_cuda_flat_probe(None, ctypes.byref(steps), ctypes.byref(marks))
    per_cta = buf.view(units, -1)
    ctas = int((per_cta[:, 0] != 0).sum())
    return marks_summary(buf, ctas, steps.value)


def sass_loads_before_store(path: str) -> dict:
    """For each groups-kernel instance in the library at ``path``: the
    8-bit global loads before its first 8-bit shared store."""
    from snappy_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    try:
        text = subprocess.run([cuobjdump, "-sass", path], check=True, capture_output=True,
                              text=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        return {"error": str(e)}
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name = part.split("\n", 1)[0].strip()
        if "flat_groups_kernel" not in name:
            continue
        loads = 0
        for ln in part.splitlines():
            if re.search(r"\bSTS\.U8\b", ln):
                break
            loads += bool(re.search(r"\bLDG\.E\.U8\b", ln))
        out[name] = {"ldg_u8_before_first_sts_u8": loads,
                     "ldg_u8": len(re.findall(r"\bLDG\.E\.U8\b", part))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=VALUE,...: the change with these constexpr ints")
    ap.add_argument("--static", action="store_true",
                    help="also the change with a static walk (no counter)")
    ap.add_argument("--out", default="k2_phase_probe")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_phase_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from chip_smoke import frame_read_groups, page_group
    from snappy_tpu_torch.ops import crc32c, decode_flat
    from snappy_tpu_torch.utils.profiling import graph_ms

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    with open(os.path.join(HERE, "snappy_tpu_torch", "csrc", "flat_gather.cu")) as f:
        change_src = f.read()
    sources = {"change": change_src}
    for spec in args.variant:
        text = change_src
        for kv in spec.split(","):
            name, value = kv.split("=")
            text, n = re.subn(rf"constexpr (\w+) {name} = [^;]+;",
                              rf"constexpr \1 {name} = {value};", text)
            assert n == 1, f"--variant {spec}: {name} {n} matches"
        sources[f"change[{spec}]"] = text
    if args.parent:
        with open(args.parent) as f:
            sources["parent"] = f.read()
    paths = build(sources)
    libs, probes, report = {}, {}, {"card": card, "ptxas": {}, "sass": {}}
    for side, text in sources.items():
        libs[side] = Lib(paths[side], text, False)
        probes[side] = Lib(paths[f"{side}_probe"], text, True)
        if side == "change" and args.static:
            libs["change(static)"] = Lib(paths[side], text, False, static=True)
            probes["change(static)"] = Lib(paths[f"{side}_probe"], text, True, static=True)
        with open(paths[side][:-3] + ".log") as f:
            report["ptxas"][side] = [re.sub(r"_ZN\w+?(\d*flat_groups_kernel|\d*grouped_kernel)",
                                            r"\1", ln.strip()) for ln in f
                                     if "registers" in ln or "spill" in ln
                                     or "Function properties" in ln]
        report["sass"][side] = sass_loads_before_store(paths[side])
    print(json.dumps({"ptxas": report["ptxas"], "sass": report["sass"]}), flush=True)

    frame, _, frame_bytes, frame_out = frame_read_groups(dev)
    big = largest_group(dev)
    page, page_bytes, page_out = page_group(dev)
    shapes = {"frame": frame, "frame_layout0": frame_read_groups(dev, 0)[0], "group455": [big],
              "page145": [page], "bench_frame": bench_frame_groups()}
    units = {k: sum(g[0].shape[0] * -(-g[4] // 16384) for g in v) for k, v in shapes.items()}
    report["units"] = units
    report["out_bytes"] = {"frame": frame_out, "group455": int(big[3].sum()), "page145": page_out}
    cases = [("bench_frame", True), ("frame", True), ("frame", False), ("frame_layout0", True),
             ("frame_layout0", False), ("group455", True), ("group455", False),
             ("page145", False)]
    # Each build's bytes and CRCs against the plain versions.
    want = {k: [decode_flat.decode_flat_plain(*g) for g in v] for k, v in shapes.items()}
    want_crc = {k: [crc32c.crc32c_plain(w, g[3], masked=True) for w, g in zip(want[k], v)]
                for k, v in shapes.items() if k != "page145"}
    report["bench_frame_shape"] = [[g[0].shape[0], g[0].shape[1], g[4], g[5]]
                                   for g in shapes["bench_frame"]]
    gbuck = decode_flat.group_buckets(big[2], big[3], 65536)
    k11_want = decode_flat.decode_flat_grouped_plain(*big[:3], gbuck, big[3], 65536, 3)
    equal = {}
    for side, lib in [*libs.items(), *((f"{s}_probe", p) for s, p in probes.items())]:
        for shape, crc in cases:
            outs = outputs(shapes[shape], crc)
            lib.run(shapes[shape], outs, crc)
            torch.cuda.synchronize()
            ok = all(torch.equal(o, w) for (o, _), w in zip(outs, want[shape]))
            if crc:
                ok &= all(torch.equal(c, w) for (_, c), w in zip(outs, want_crc[shape]))
            equal[f"{side}:{shape}:{'crc' if crc else 'k2'}"] = bool(ok)
    for side, lib in libs.items():
        out = torch.empty_like(k11_want)
        lib.run_k11(big, gbuck, out)
        torch.cuda.synchronize()
        equal[f"{side}:group455:k11"] = torch.equal(out, k11_want)
    report["equal"] = equal
    print(json.dumps({"equal": equal}), flush=True)
    wrong = {k.rsplit(":", 2)[0].removesuffix("_probe") for k, ok in equal.items() if not ok}
    for side in wrong:
        print(f"k2_phase_probe: {side} differs from the plain versions", file=sys.stderr)
        del libs[side], probes[side]
    del want, want_crc, k11_want

    # Times, in turns: every side, then every side again in reverse.
    order = list(libs) + list(libs)[::-1]
    times: dict = {}
    for shape, crc in [*cases, ("group455", "k11")]:
        key = f"{shape}:{'k11' if crc == 'k11' else 'crc' if crc else 'k2'}"
        for side in order:
            lib = libs[side]
            if crc == "k11":
                out = torch.empty((big[0].shape[0], 65536), dtype=torch.uint8, device=dev)
                fn = lambda lib=lib, out=out: lib.run_k11(big, gbuck, out)  # noqa: E731
            else:
                outs = outputs(shapes[shape], crc)
                fn = lambda lib=lib, outs=outs, s=shape, c=crc: lib.run(shapes[s], outs, c)  # noqa: E731
            reps = 10 if shape == "page145" else 50
            t = times.setdefault(key, {}).setdefault(side, {"graph_us": [], "kernel_us": []})
            t["graph_us"].append(graph_ms(fn, reps)[0] * 1e3)
            t["kernel_us"].append(kernel_us(fn))
        print(json.dumps({key: times[key]}), flush=True)
    report["times"] = times
    # The marks.
    report["marks"] = {}
    for side, lib in probes.items():
        for shape, crc in [("bench_frame", True), ("frame", True), ("frame", False),
                           ("page145", False)]:
            key = f"{side}:{shape}:{'crc' if crc else 'k2'}"
            report["marks"][key] = probe_marks(lib, shapes[shape], crc, units[shape])
            print(json.dumps({key: report["marks"][key]}), flush=True)
    report["bound_bytes"] = {"frame": frame_bytes, "page145": page_bytes}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"{args.out}.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"ok": not wrong, "card": card}))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
