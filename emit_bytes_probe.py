"""What binds K6's gather (``emit_bytes``) on one NVIDIA GPU: a probe.

    python3 emit_bytes_probe.py [only=NAME ...]

Needs a CUDA card and ``nvcc``. Builds variants of the kernel from text
into ``build/emit_bytes_probe/``, each with the C entry of
``snappy_tpu_torch/csrc/emit.cu``'s ``stpu_cuda_emit_bytes``, and times
each through that entry as the replay of a CUDA graph of several calls
(``chip_smoke.device_ms``), in two turns (forward, then reverse), on
``chip_smoke.py``'s compress group: the 64 MiB + 5,000-byte stream's
1,025 blocks in 2,048 rows, 1,023 of them padding, with the indices
``emit.shift_idx`` gives. ``only=NAME`` keeps the named variants.

- ``first``: the kernel as first ported (``FIRST``, kept below as text):
  a CTA of 256 threads for each 1,024-byte group of each row (163,840
  CTAs), 4 output bytes a thread; ``first_zeros``: that grid storing
  zeros only, no loads (is the pace the CTA count's?).
- ``slab8`` and the rest (``SLABS_TEXT``; ``slab8`` is ``csrc/emit.cu``'s
  design): a CTA walks a run of 8 groups of a row, each warp 512 output
  bytes a step, a thread's 16 bytes four 4-byte words, one in each
  128-byte slab of the warp's span: four 16-byte index loads, 16 gathers
  in flight, four 4-byte stores, each a warp's 128 consecutive bytes; a
  warp's span wholly at or past ``out_len`` stores zeros 16 bytes a
  store and reads nothing. ``every_load`` variants issue every gather (an
  invalid one reads the row's first byte) and mask after, instead of
  predicating it; variants change the run (4 or 20 groups), the CTA (128
  or 512 threads), the words a thread (2 or 8 slabs), the cache hints,
  stride a persistent grid (8 CTAs an SM), cap registers for more CTAs
  an SM (``minb``), or store each index's low byte without the gather
  (``slab8_nogather``, inexact). The group's report also counts the
  distinct 32-byte source sectors the gathers read
  (``chip_smoke.gather_sectors``) and a bound with them.
- ``run8`` and the rest (``RUNS``, one text with compile-time switches):
  a CTA walks a run of groups of a row, 16 output bytes a thread (four
  16-byte index loads, 16 gathers in flight, one 16-byte store), and a
  thread wholly at or past ``out_len`` stores zeros and reads nothing.
  Variants change the run (4, 8, 20 or 80 groups), the CTA (128 or 256
  threads), the cache hints (``__ldcs`` indices, ``__stcs`` stores), the
  grid (persistent: 4 CTAs an SM striding over (row, run)), stage the
  run's source window in shared memory (32 KiB from its least block
  index; other indices read device memory), store zeros only
  (``run8_zeros``), or store each index's low byte without the gather
  (``run8_nogather``, inexact).

Every exact variant must equal ``emit_bytes_plain`` on the compress group
and on edge rows (``emit.edge_batch``: lengths 0, 1, 15,
16, 17, 1,023, 1,025, 81,920, indices -1, ``src_w`` and ``src_w - 1``,
batches of 1 and 2,049 rows); a variant that does not build is reported
and skipped, and the run then fails. The package's wrapper
(``emit.emit_bytes``) is timed the same way, device-only and over calls,
beside ``torch.gather``. Each variant's resident CTAs an SM come from
``cudaOccupancyMaxActiveBlocksPerMultiprocessor``. Prints one JSON object
and writes it to ``chiprun_out/emit_bytes_probe.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

FIRST = r"""
#include <cstdint>
#include <cuda_runtime.h>

constexpr int kThreads = 256;
constexpr int kGroup = 1024;
constexpr int kGroups = 80;

__device__ __forceinline__ uint32_t gather_byte(const uint8_t* src, int64_t src_w,
                                                int32_t idx) {
  return idx >= 0 && idx < src_w ? uint32_t{src[idx]} : 0u;
}

__global__ void __launch_bounds__(kThreads)
emit_bytes_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ out_len,
                  const uint8_t* __restrict__ src, int64_t src_w,
                  uint8_t* __restrict__ out) {
  const int64_t b = blockIdx.y;
  const int d0 = blockIdx.x * kGroup + threadIdx.x * 4;
  const int olen = out_len[b];
  uint32_t word = 0;
#ifndef ZEROS_ONLY
  if (d0 < olen) {
    const int4 v = *reinterpret_cast<const int4*>(idx + b * (kGroups * kGroup) + d0);
    const int32_t ix[4] = {v.x, v.y, v.z, v.w};
    const uint8_t* row = src + b * src_w;
#pragma unroll
    for (int k = 0; k < 4; k++) {
      if (d0 + k < olen) word |= gather_byte(row, src_w, ix[k]) << (8 * k);
    }
  }
#endif
  *reinterpret_cast<uint32_t*>(out + b * (kGroups * kGroup) + d0) = word;
}

extern "C" int stpu_cuda_emit_bytes(const int32_t* idx, const int32_t* out_len,
                                    const uint8_t* src, int64_t src_w, int64_t n_rows,
                                    uint8_t* out, void* stream) {
  emit_bytes_kernel<<<dim3(kGroups, static_cast<unsigned>(n_rows)), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(idx, out_len, src, src_w, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stpu_probe_occupancy() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, emit_bytes_kernel, kThreads, 0);
  return n;
}
"""

# The redesign, with the switches its variants set (-D on the nvcc line).
RUNS = r"""
#include <cstdint>
#include <cuda_runtime.h>

#ifndef THREADS
#define THREADS 256
#endif
#ifndef RUN_GROUPS
#define RUN_GROUPS 8
#endif
#ifndef PERSISTENT
#define PERSISTENT 0  // > 0: that many CTAs an SM stride over (row, run)
#endif
#ifndef STAGE
#define STAGE 0  // > 0: bytes of the run's block window staged in shared memory
#endif

constexpr int kGroup = 1024;
constexpr int kGroups = 80;
constexpr int kRowBytes = kGroups * kGroup;
constexpr int kRunBytes = RUN_GROUPS * kGroup;
constexpr int kRuns = (kGroups + RUN_GROUPS - 1) / RUN_GROUPS;
constexpr int kBlockW = 65536;  // src = [block | header plane]

__device__ __forceinline__ int4 load_idx(const int4* p) {
#ifdef HINTS
  return __ldcs(p);
#else
  return __ldg(p);
#endif
}

__device__ __forceinline__ void store_out(uint8_t* p, uint4 v) {
#ifdef HINTS
  __stcs(reinterpret_cast<uint4*>(p), v);
#else
  *reinterpret_cast<uint4*>(p) = v;
#endif
}

__device__ __forceinline__ uint32_t gather_byte(const uint8_t* src, int64_t src_w,
                                                int32_t idx) {
  return idx >= 0 && idx < src_w ? uint32_t{__ldg(src + idx)} : 0u;
}

__device__ __forceinline__ void load16(const int32_t* p, int32_t ix[16]) {
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; k++) {
    const int4 v = load_idx(q + k);
    ix[4 * k] = v.x;
    ix[4 * k + 1] = v.y;
    ix[4 * k + 2] = v.z;
    ix[4 * k + 3] = v.w;
  }
}

#if STAGE
constexpr int kIters = kRunBytes / (THREADS * 16);
static_assert(kIters * THREADS * 16 == kRunBytes, "a run is whole steps");

__device__ void emit_run(const int32_t* __restrict__ irow, int olen, const uint8_t* __restrict__ srow,
                         int64_t src_w, uint8_t* __restrict__ orow, int lo) {
  __shared__ __align__(16) uint8_t win[STAGE];
  __shared__ int wlo[THREADS / 32];
  int32_t ix[kIters][16];
  int least = 0x7FFFFFFF;
#pragma unroll
  for (int it = 0; it < kIters; it++) {
    const int d0 = lo + (it * THREADS + threadIdx.x) * 16;
    if (d0 < olen) {
      load16(irow + d0, ix[it]);
#pragma unroll
      for (int i = 0; i < 16; i++) {
        if (d0 + i >= olen) ix[it][i] = -1;
        if (ix[it][i] >= 0 && ix[it][i] < kBlockW) least = min(least, ix[it][i]);
      }
    }
  }
  for (int o = 16; o; o >>= 1) least = min(least, __shfl_xor_sync(0xFFFFFFFFu, least, o));
  if ((threadIdx.x & 31) == 0) wlo[threadIdx.x >> 5] = least;
  __syncthreads();
  int w0 = wlo[0];
#pragma unroll
  for (int k = 1; k < THREADS / 32; k++) w0 = min(w0, wlo[k]);
  w0 &= ~15;
  const bool staged = w0 < kBlockW;
  if (staged) {  // the window, 16 bytes a load where the row allows it
    const uint8_t* from = srow + w0;
    const bool aligned = (reinterpret_cast<uintptr_t>(from) & 15) == 0;
    for (int x = threadIdx.x * 16; x < STAGE; x += THREADS * 16) {
      if (aligned && w0 + x + 16 <= src_w) {
        *reinterpret_cast<uint4*>(win + x) = __ldg(reinterpret_cast<const uint4*>(from + x));
      } else {
        for (int i = 0; i < 16; i++) win[x + i] = w0 + x + i < src_w ? from[x + i] : 0;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kIters; it++) {
    const int d0 = lo + (it * THREADS + threadIdx.x) * 16;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (d0 < olen) {
#pragma unroll
      for (int i = 0; i < 16; i++) {
        const int32_t j = ix[it][i];
        const int32_t r = j - w0;
        const uint32_t byte = staged && r >= 0 && r < STAGE ? uint32_t{win[r]}
                                                            : gather_byte(srow, src_w, j);
        v[i >> 2] |= byte << (8 * (i & 3));
      }
    }
    store_out(orow + d0, make_uint4(v[0], v[1], v[2], v[3]));
  }
  __syncthreads();
}
#else
__device__ __forceinline__ void emit_run(const int32_t* __restrict__ irow, int olen,
                                         const uint8_t* __restrict__ srow, int64_t src_w,
                                         uint8_t* __restrict__ orow, int lo) {
  const int hi = min(lo + kRunBytes, kRowBytes);
  for (int d0 = lo + threadIdx.x * 16; d0 < hi; d0 += THREADS * 16) {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
#ifndef ZEROS_ONLY
    if (d0 < olen) {
      int32_t ix[16];
      load16(irow + d0, ix);
#pragma unroll
      for (int i = 0; i < 16; i++) {
#ifdef NO_GATHER
        v[i >> 2] |= (uint32_t(ix[i]) & 0xFFu) << (8 * (i & 3));
#else
        v[i >> 2] |= gather_byte(srow, src_w, d0 + i < olen ? ix[i] : -1) << (8 * (i & 3));
#endif
      }
    }
#endif
    store_out(orow + d0, make_uint4(v[0], v[1], v[2], v[3]));
  }
}
#endif

__global__ void __launch_bounds__(THREADS)
emit_bytes_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ out_len,
                  const uint8_t* __restrict__ src, int64_t src_w, int64_t n_rows,
                  uint8_t* __restrict__ out) {
#if PERSISTENT
  for (int64_t t = blockIdx.x; t < n_rows * kRuns; t += gridDim.x) {
    const int64_t b = t / kRuns;
    const int r = static_cast<int>(t % kRuns);
#else
  {
    const int64_t b = blockIdx.y;
    const int r = blockIdx.x;
#endif
    emit_run(idx + b * kRowBytes, out_len[b], src + b * src_w, src_w, out + b * kRowBytes,
             r * kRunBytes);
  }
}

extern "C" int stpu_cuda_emit_bytes(const int32_t* idx, const int32_t* out_len,
                                    const uint8_t* src, int64_t src_w, int64_t n_rows,
                                    uint8_t* out, void* stream) {
#if PERSISTENT
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const dim3 grid(static_cast<unsigned>(sms * PERSISTENT));
#else
  const dim3 grid(kRuns, static_cast<unsigned>(n_rows));
#endif
  emit_bytes_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, out_len, src, src_w, n_rows, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stpu_probe_occupancy() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, emit_bytes_kernel, THREADS, 0);
  return n;
}
"""

# The redesign as shipped: a thread's 16 bytes are SLABS words of 4 in the
# warp's SLABS slabs of 128 bytes, so each gather instruction of a warp
# reads the sources of 128 consecutive output bytes.
SLABS_TEXT = r"""
#include <cstdint>
#include <cuda_runtime.h>

#ifndef THREADS
#define THREADS 256
#endif
#ifndef RUN_GROUPS
#define RUN_GROUPS 8
#endif
#ifndef SLABS
#define SLABS 4
#endif
#ifndef PERSISTENT
#define PERSISTENT 0
#endif

constexpr int kGroup = 1024;
constexpr int kGroups = 80;
constexpr int kRowBytes = kGroups * kGroup;
constexpr int kRunBytes = RUN_GROUPS * kGroup;
constexpr int kRuns = (kGroups + RUN_GROUPS - 1) / RUN_GROUPS;
constexpr int kWarpSpan = 128 * SLABS;  // output bytes a warp takes a step
constexpr int kStep = THREADS / 32 * kWarpSpan;

__device__ __forceinline__ int4 load_idx(const int32_t* p) {
#ifdef HINTS
  return __ldcs(reinterpret_cast<const int4*>(p));
#else
  return __ldg(reinterpret_cast<const int4*>(p));
#endif
}

__device__ __forceinline__ void store_word(uint8_t* p, uint32_t v) {
#ifdef HINTS
  __stcs(reinterpret_cast<unsigned int*>(p), v);
#else
  *reinterpret_cast<uint32_t*>(p) = v;
#endif
}

__device__ __forceinline__ void emit_run(const int32_t* __restrict__ irow, int olen,
                                         const uint8_t* __restrict__ srow, int64_t src_w,
                                         uint8_t* __restrict__ orow, int lo) {
  const int lane = threadIdx.x & 31;
  const int hi = min(lo + kRunBytes, kRowBytes);
  for (int s0 = lo + (threadIdx.x >> 5) * kWarpSpan; s0 < hi; s0 += kStep) {
    if (s0 >= olen) {  // the warp's span is padding: zeros, 16 bytes a store
      for (int x = s0 + 16 * lane; x < s0 + kWarpSpan; x += 512)
        *reinterpret_cast<uint4*>(orow + x) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    int32_t ix[SLABS][4];
#pragma unroll
    for (int w = 0; w < SLABS; w++) {
      const int4 v = load_idx(irow + s0 + w * 128 + 4 * lane);
      ix[w][0] = v.x;
      ix[w][1] = v.y;
      ix[w][2] = v.z;
      ix[w][3] = v.w;
    }
    uint32_t byte[SLABS][4];
#pragma unroll
    for (int w = 0; w < SLABS; w++) {
#pragma unroll
      for (int j = 0; j < 4; j++) {
        const int d = s0 + w * 128 + 4 * lane + j;
        const int32_t i = ix[w][j];
        const bool ok = d < olen && i >= 0 && i < src_w;
#ifdef NO_GATHER
        byte[w][j] = ok ? (uint32_t(i) & 0xFFu) : 0u;
#elif defined(EVERY_LOAD)
        byte[w][j] = __ldg(srow + (ok ? i : 0));  // every load issued, masked below
        if (!ok) byte[w][j] = 0u;
#else
        byte[w][j] = ok ? uint32_t{__ldg(srow + i)} : 0u;
#endif
      }
    }
#pragma unroll
    for (int w = 0; w < SLABS; w++)
      store_word(orow + s0 + w * 128 + 4 * lane,
                 byte[w][0] | byte[w][1] << 8 | byte[w][2] << 16 | byte[w][3] << 24);
  }
}

#ifdef MINB
#define BOUNDS __launch_bounds__(THREADS, MINB)
#else
#define BOUNDS __launch_bounds__(THREADS)
#endif

__global__ void BOUNDS
emit_bytes_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ out_len,
                  const uint8_t* __restrict__ src, int64_t src_w, int64_t n_rows,
                  uint8_t* __restrict__ out) {
#if PERSISTENT
  for (int64_t t = blockIdx.x; t < n_rows * kRuns; t += gridDim.x) {
    const int64_t b = t / kRuns;
    const int r = static_cast<int>(t % kRuns);
#else
  {
    const int64_t b = blockIdx.y;
    const int r = blockIdx.x;
#endif
    emit_run(idx + b * kRowBytes, out_len[b], src + b * src_w, src_w, out + b * kRowBytes,
             r * kRunBytes);
  }
}

extern "C" int stpu_cuda_emit_bytes(const int32_t* idx, const int32_t* out_len,
                                    const uint8_t* src, int64_t src_w, int64_t n_rows,
                                    uint8_t* out, void* stream) {
#if PERSISTENT
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const dim3 grid(static_cast<unsigned>(sms * PERSISTENT));
#else
  const dim3 grid(kRuns, static_cast<unsigned>(n_rows));
#endif
  emit_bytes_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, out_len, src, src_w, n_rows, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stpu_probe_occupancy() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, emit_bytes_kernel, THREADS, 0);
  return n;
}
"""

#: name -> (text, -D switches, exact)
VARIANTS = {
    "first": (FIRST, [], True),
    "first_zeros": (FIRST, ["ZEROS_ONLY"], False),
    "run8": (RUNS, [], True),
    "run4": (RUNS, ["RUN_GROUPS=4"], True),
    "run20": (RUNS, ["RUN_GROUPS=20"], True),
    "row": (RUNS, ["RUN_GROUPS=80"], True),
    "run8_t128": (RUNS, ["THREADS=128"], True),
    "run8_hints": (RUNS, ["HINTS"], True),
    "persistent4": (RUNS, ["PERSISTENT=4"], True),
    "run8_stage": (RUNS, ["STAGE=32768"], True),
    "run8_zeros": (RUNS, ["ZEROS_ONLY"], False),
    "run8_nogather": (RUNS, ["NO_GATHER"], False),
    "slab8": (SLABS_TEXT, [], True),
    "slab8_every_load": (SLABS_TEXT, ["EVERY_LOAD"], True),
    "slab4_every_load": (SLABS_TEXT, ["RUN_GROUPS=4", "EVERY_LOAD"], True),
    "slab20_every_load": (SLABS_TEXT, ["RUN_GROUPS=20", "EVERY_LOAD"], True),
    "slab8_t128_every_load": (SLABS_TEXT, ["THREADS=128", "EVERY_LOAD"], True),
    "slab8_t512_every_load": (SLABS_TEXT, ["THREADS=512", "EVERY_LOAD"], True),
    "slab8_t512_minb4_every_load": (SLABS_TEXT, ["THREADS=512", "MINB=4", "EVERY_LOAD"], True),
    "slab8_w2_every_load": (SLABS_TEXT, ["SLABS=2", "EVERY_LOAD"], True),
    "slab8_w8_every_load": (SLABS_TEXT, ["SLABS=8", "EVERY_LOAD"], True),
    "slab8_hints_every_load": (SLABS_TEXT, ["HINTS", "EVERY_LOAD"], True),
    "slab_persistent8_every_load": (SLABS_TEXT, ["PERSISTENT=8", "EVERY_LOAD"], True),
    "slab8_minb8": (SLABS_TEXT, ["MINB=8"], True),
    "slab8_minb8_every_load": (SLABS_TEXT, ["MINB=8", "EVERY_LOAD"], True),
    "slab8_nogather": (SLABS_TEXT, ["NO_GATHER"], False),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("emit_bytes_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from pathlib import Path

    from snappy_tpu_torch.ops import _build, emit, encode_flat, packing, parse

    dev = torch.device("cuda")
    only = [a[len("only="):] for a in sys.argv[1:] if a.startswith("only=")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    out_dir = Path(HERE) / "build" / "emit_bytes_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    names = [n for n in VARIANTS if not only or n in only]
    jobs = []
    for n in names:
        text, defs, _ = VARIANTS[n]
        (out_dir / f"{n}.cu").write_text(text)
        jobs.append((out_dir / f"{n}.cu",
                     [_build._nvcc(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defs)]))
    failed, built = {}, {}
    try:  # all at once; after a failure one at a time, so it is reported and skipped
        built = dict(zip(names, _build.compile_all(jobs)))
    except RuntimeError:
        for (src, cmd), n in zip(jobs, names):
            try:
                built[n] = _build.compile_all([(src, cmd)])[0]
            except RuntimeError as e:
                failed[n] = str(e)[-1500:]
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    entries, occupancy, ptxas = {}, {}, {}
    for n, path in built.items():
        lib = ctypes.CDLL(str(path))
        fn = lib.stpu_cuda_emit_bytes
        fn.argtypes = [p, p, p, i64, i64, p, p]
        fn.restype = ctypes.c_int
        entries[n] = fn
        occupancy[n] = lib.stpu_probe_occupancy()
        ptxas[n] = [ln.strip() for ln in path.with_suffix(".log").read_text().splitlines()
                    if "registers" in ln or "spill" in ln]
        print(f"emit_bytes_probe: {n}: {ptxas[n][-2:]} ctas/SM {occupancy[n]}",
              file=sys.stderr, flush=True)
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_failed": failed, "ctas_per_sm": occupancy, "ptxas": ptxas, "equal": {}}

    def call(n, src, idx, out_len):
        out = torch.empty((idx.shape[0], emit.N_GROUPS * emit.GROUP), dtype=torch.uint8, device=dev)
        _build.check(entries[n](idx.data_ptr(), out_len.data_ptr(), src.data_ptr(), src.shape[1],
                                idx.shape[0], out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream), n)
        return out

    # -- the compress group -----------------------------------------------------------
    data = chip_smoke.corpus_stream(chip_smoke.STREAM_BYTES)
    cblocks, clens = packing.blocks_of(data)
    rows = packing.pad_to_bucket(len(clens), 1)
    pad = rows - len(clens)
    cb = torch.from_numpy(np.concatenate([cblocks, np.zeros((pad, cblocks.shape[1]), np.uint8)])).to(dev)
    cl = torch.from_numpy(np.concatenate([clens, np.zeros(pad, np.int32)])).to(dev)
    jw, _ = encode_flat.prepass(cb, cl)
    rec = parse.parse_blocks(cl, jw, cb)
    *plan, src, _ = encode_flat._fused_plan(cb, cl, *rec)
    out_len = plan[3]
    idx = emit.shift_idx(*plan)
    del cb, jw, rec, plan
    want = emit.emit_bytes_plain(src, idx, out_len)
    for n in entries:
        if VARIANTS[n][2]:
            report["equal"][f"{n}:group"] = torch.equal(call(n, src, idx, out_len), want)
    report["equal"]["wrapper:group"] = torch.equal(emit.emit_bytes(src, idx, out_len), want)
    sum_len = int(out_len.to(torch.int64).sum())
    out_bytes = rows * emit.N_GROUPS * emit.GROUP
    d_all = torch.arange(emit.N_GROUPS * emit.GROUP, device=dev)[None, :]
    absidx = torch.where(d_all < out_len[:, None], idx.to(torch.int64), src.shape[1])
    padded = torch.cat([src, torch.zeros_like(src[:, :1])], dim=1)
    report["equal"]["torch.gather:group"] = torch.equal(torch.gather(padded, 1, absidx), want)
    del want
    ms = {}
    for n in [*entries, *reversed(list(entries))]:
        ms.setdefault(n, []).append(chip_smoke.device_ms(lambda: call(n, src, idx, out_len), 10))
        torch.cuda.empty_cache()
    wrapper = lambda: emit.emit_bytes(src, idx, out_len)  # noqa: E731
    lib = lambda: torch.gather(padded, 1, absidx)  # noqa: E731
    sectors = chip_smoke.gather_sectors(src, idx, out_len)
    report["group"] = {
        "rows": rows, "live_rows": int((out_len > 0).sum()), "sum_out_len": sum_len,
        "src_w": src.shape[1], "src_sectors": sectors,
        "bound_ms": chip_smoke.bound_ms(5 * sum_len + out_bytes + 4 * rows)[0],
        "bound_with_sectors_ms": chip_smoke.bound_ms(
            4 * sum_len + 32 * sectors + out_bytes + 4 * rows)[0],
        "device_ms": ms,
        "wrapper_device_ms": chip_smoke.device_ms(wrapper, 10),
        "wrapper_call_ms": chip_smoke.cuda_ms(wrapper, 20),
        "torch_gather_device_ms": chip_smoke.device_ms(lib, 10),
        "torch_gather_call_ms": chip_smoke.cuda_ms(lib, 20),
    }
    del src, idx, out_len, absidx, padded
    print(f"emit_bytes_probe: group {json.dumps(report['group'])}", file=sys.stderr, flush=True)

    # -- edge rows: every exact variant and the wrapper against the plain version -------
    cases = {f"one_row_{n}": [n] for n in emit.EDGE_LENS}
    cases["rows_2049"] = [emit.EDGE_LENS[i % len(emit.EDGE_LENS)] if i % 3 else 81920 * (i % 5) // 4
                          for i in range(2049)]
    for case, lens in cases.items():
        e_src, e_idx, e_len = emit.edge_batch(lens, dev)
        e_want = emit.emit_bytes_plain(e_src, e_idx, e_len)
        for n in entries:
            if VARIANTS[n][2]:
                report["equal"][f"{n}:{case}"] = torch.equal(call(n, e_src, e_idx, e_len), e_want)
        report["equal"][f"wrapper:{case}"] = torch.equal(emit.emit_bytes(e_src, e_idx, e_len), e_want)
    torch.cuda.synchronize()

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "emit_bytes_probe.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    bad = [k for k, v in report["equal"].items() if not v]
    if bad:
        print(f"emit_bytes_probe: unequal: {bad}", file=sys.stderr)
    return 0 if not bad and not failed else 1


if __name__ == "__main__":
    sys.exit(main())
