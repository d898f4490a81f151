"""What binds the flat gather (K2) on one NVIDIA GPU: a probe.

    python3 flat_gather_probe.py

Needs a CUDA card and ``nvcc``. On the frame's largest launch group of
``chip_smoke.py`` (455 rows, ``d_pad`` 65536, the host flatten's indices in
``layout=1``) it times, each with CUDA events over 50 calls and as the
replay of a CUDA graph of 50 calls, in two turns (forward, then reverse):

- ``first``: K2 as first ported (each thread makes 4 output bytes, each
  behind its index load and its source load), kept below as text;
- ``first_no_source_load``: the same with each source load replaced by a
  byte of the position it would read: the index loads stay;
- ``first_coalesced_source``: the same with each source position replaced
  by ``d ^ (index & 1)``: the index loads stay and the source loads become
  neighbours of their output bytes, so coalesced;
- ``staged``: the design that stages each CTA's source span (up to 56 KiB)
  in shared memory and gathers from there, kept below as text;
- ``staged_no_source_read``: the same with nothing staged; as no span then
  passes the budget, no byte reads its source either (the output is not
  the gather's): the staged design's time without its source reads;
- ``current``: ``snappy_tpu_torch/csrc/flat_gather.cu`` as it stands, and
  ``current_blocks_N``, the same built for N resident CTAs per SM;
- ``current_no_source_load``: the same with each source load replaced by a
  byte of its index;
- ``torch.gather`` over int64 absolute indices, the library yardstick.

Variants are built from text into ``build/flat_gather_probe/``. ``first``,
``staged`` and ``current`` must equal the plain version. Prints one JSON
object and writes it to ``chiprun_out/flat_gather_probe.json``.
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
namespace {
__device__ __forceinline__ int64_t phys_index(int64_t d, int layout) {
  if (layout == 0) return d;
  return (d >> 14 << 14) | ((d & 127) << 7) | (((d >> 10) & 15) << 3) | ((d >> 7) & 7);
}
__global__ void __launch_bounds__(256)
flat_gather_kernel(const uint8_t* __restrict__ srcs, int64_t s_width,
                   const uint16_t* __restrict__ idx, const int32_t* __restrict__ tile_meta,
                   const int32_t* __restrict__ declens, int64_t d_pad, int layout,
                   uint8_t* __restrict__ out) {
  const int64_t b = blockIdx.y;
  const int64_t tile = blockIdx.x;
  const int64_t d0 = tile * 1024 + threadIdx.x * 4;
  const int64_t declen = declens[b];
  uint32_t word = 0;
  if (tile * 1024 < declen) {
    const uint8_t* src = srcs + b * s_width;
    const uint16_t* ix = idx + b * d_pad;
    const int64_t base = int64_t{tile_meta[(b * (d_pad / 1024) + tile) * 2]} * 128;
#pragma unroll
    for (int k = 0; k < 4; k++) {
      const int64_t d = d0 + k;
      if (d < declen) {
        const int64_t p = base + ix[phys_index(d, layout)];
        const uint32_t v = p < s_width ? src[p] : 0u;
        word |= v << (8 * k);
      }
    }
  }
  *reinterpret_cast<uint32_t*>(out + b * d_pad + d0) = word;
}
}  // namespace
extern "C" int stpu_cuda_flat_gather(const uint8_t* srcs, int64_t n_rows, int64_t s_width,
                                     const uint16_t* idx, const int32_t* tile_meta,
                                     const int32_t* declens, int64_t d_pad, int layout,
                                     uint8_t* out, void* stream) {
  const dim3 grid(static_cast<unsigned>(d_pad / 1024), static_cast<unsigned>(n_rows));
  flat_gather_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      srcs, s_width, idx, tile_meta, declens, d_pad, layout, out);
  return static_cast<int>(cudaGetLastError());
}
"""

STAGED = r"""
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr int kUnit = 16384;                         // output bytes per CTA
constexpr int kChunksPerThread = kUnit / 8 / kThreads;
constexpr int kSpan = 56 * 1024;                     // decode_flat.SPAN_BUDGET
constexpr int kSmem = kUnit + kSpan;

// Physical 16-byte chunk of output chunk q of the tile (q >> 6 is its tile).
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 6) & 7); }

__device__ __forceinline__ int index_at(const uint4& v, int k) {
  const uint32_t w = k < 2 ? v.x : (k < 4 ? v.y : (k < 6 ? v.z : v.w));
  return (w >> (16 * (k & 1))) & 0xFFFF;
}

template <int kLayout>
__global__ void __launch_bounds__(kThreads, 3)
flat_kernel(const uint8_t* __restrict__ srcs, int s_width, const uint16_t* __restrict__ idx,
            const int32_t* __restrict__ tile_meta, const int32_t* __restrict__ gbuck,
            const int32_t* __restrict__ declens, int d_pad, int variant, int w0, int w1, int w2,
            uint8_t* __restrict__ out) {
  constexpr int kStep = kLayout ? 128 : 1;  // output bytes between a chunk's indices
  extern __shared__ uint4 smem[];
  __shared__ int red[2][kThreads / 32];
  const int tid = threadIdx.x;
  const long long b = blockIdx.y;
  const int g0 = blockIdx.x * kUnit;
  const int n_chunks = min(kUnit, d_pad - g0) / 8;
  const int lim = declens[b] - g0;  // live bytes of the unit
  bool live = lim > 0;
  int wlim = 1 << 16;  // above every uint16 index: K2 takes each byte
  if (gbuck != nullptr) {
    const int gb = gbuck[b * (d_pad / kUnit) + blockIdx.x];
    live = live && (variant == 3 ? gb >= 0 && gb <= 2 : gb >= 0);
    wlim = (gb == 0 ? w0 : (gb == 1 ? w1 : w2)) * 128;
  }
  uint4* dst = reinterpret_cast<uint4*>(out + b * d_pad + g0);
  if (!live) {
    for (int q = tid; q < n_chunks / 2; q += kThreads) dst[q] = make_uint4(0, 0, 0, 0);
    return;
  }

  // Chunk j of this thread: c = tid + j * kThreads, 8 indices of output
  // bytes d0 + k * kStep, stored in the tile at a0 + k * kStep.
  const uint4* gidx = reinterpret_cast<const uint4*>(idx + b * d_pad + g0);
  const int32_t* meta = tile_meta + (b * (d_pad / kTile) + g0 / kTile) * 2;
  uint4 chunk[kChunksPerThread];
  int base[kChunksPerThread], d0[kChunksPerThread], a0[kChunksPerThread];
#pragma unroll
  for (int j = 0; j < kChunksPerThread; j++) {
    const int c = tid + j * kThreads;
    const int tile = kLayout ? c & 15 : c >> 7;
    const int col = c >> 4;
    chunk[j] = c < n_chunks ? __ldg(gidx + c) : make_uint4(0, 0, 0, 0);
    // Clamped bases give every position the same side of 0 and s_width.
    base[j] = c < n_chunks ? min(max(__ldg(meta + tile * 2), -513), s_width / 128 + 1) * 128 : 0;
    d0[j] = kLayout ? tile * kTile + col : c * 8;
    a0[j] = kLayout ? tile * kTile + ((((col >> 4) ^ tile) & 7) << 4) + (col & 15)
                    : (swz(c >> 1) << 4) + (c & 1) * 8;
  }

  // The span: positions of the unit's live bytes, clipped to the row.
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int j = 0; j < kChunksPerThread; j++) {
    const uint4 v = chunk[j];
    const int dlim = min(lim, n_chunks * 8) - d0[j];  // byte k is live iff k * kStep < dlim
    int rmin = INT_MAX, rmax = -1;
    if (dlim > 7 * kStep) {
      const unsigned mn = __vminu2(__vminu2(v.x, v.y), __vminu2(v.z, v.w));
      const unsigned mx = __vmaxu2(__vmaxu2(v.x, v.y), __vmaxu2(v.z, v.w));
      rmin = min(mn & 0xFFFF, mn >> 16);
      rmax = max(mx & 0xFFFF, mx >> 16);
    } else {
#pragma unroll
      for (int k = 0; k < 8; k++) {
        if (k * kStep < dlim) {
          rmin = min(rmin, index_at(v, k));
          rmax = max(rmax, index_at(v, k));
        }
      }
    }
    if (rmax >= 0) {
      lo = min(lo, base[j] + rmin);
      hi = max(hi, base[j] + rmax);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xFFFFFFFFu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xFFFFFFFFu, hi, o));
  }
  if ((tid & 31) == 0) {
    red[0][tid >> 5] = lo;
    red[1][tid >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kThreads / 32; i++) {
    lo = min(lo, red[0][i]);
    hi = max(hi, red[1][i]);
  }
  lo = max(lo, 0);
  hi = min(hi, s_width - 1);
  // s_width is whole 16-byte lines, so the rounded span stays in the row.
  const int s0 = lo <= hi ? lo & ~15 : 0;
  const int want = lo <= hi ? (hi - s0 + 16) & ~15 : 0;
  const int staged = min(want, kSpan);
  const uint8_t* src = srcs + b * s_width;
  uint8_t* tile = reinterpret_cast<uint8_t*>(smem);
  uint8_t* span = tile + kUnit;
  for (int q = tid * 16; q < staged; q += kThreads * 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(span + q))),
                 "l"(src + s0 + q));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // A byte reads the span at q = idx + base - s0 when q is below qlim: the
  // staged part, the row and (K11) the window; every other byte is 0, or
  // past the staged part of a span wider than kSpan, read below.
#pragma unroll
  for (int j = 0; j < kChunksPerThread; j++) {
    const uint4 v = chunk[j];
    const int off = base[j] - s0;
    const int qlim = max(0, min(staged, min(s_width - s0, wlim + off)));
    const int dlim = min(lim, n_chunks * 8) - d0[j];
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int q = index_at(v, k) + off;
      uint8_t x = 0;
      if (static_cast<unsigned>(q) < static_cast<unsigned>(qlim) && k * kStep < dlim) x = span[q];
      if (kLayout || d0[j] < n_chunks * 8) tile[a0[j] + k * kStep] = x;
    }
  }
  if (want > kSpan) {
#pragma unroll
    for (int j = 0; j < kChunksPerThread; j++) {
      const int dlim = min(lim, n_chunks * 8) - d0[j];
#pragma unroll
      for (int k = 0; k < 8; k++) {
        const int r = index_at(chunk[j], k);
        const int p = base[j] + r;
        if (k * kStep < dlim && r < wlim && p >= s0 + staged && p < s_width)
          tile[a0[j] + k * kStep] = __ldg(src + p);
      }
    }
  }
  __syncthreads();
  for (int q = tid; q < n_chunks / 2; q += kThreads) dst[q] = smem[swz(q)];
}

int launch(const uint8_t* srcs, long long n_rows, long long s_width, const uint16_t* idx,
           const int32_t* tile_meta, const int32_t* gbuck, const int32_t* declens,
           long long d_pad, int layout, int variant, int w0, int w1, int w2, uint8_t* out,
           void* stream) {
  const auto kernel = layout ? flat_kernel<1> : flat_kernel<0>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>((d_pad + kUnit - 1) / kUnit), static_cast<unsigned>(n_rows));
  kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      srcs, static_cast<int>(s_width), idx, tile_meta, gbuck, declens, static_cast<int>(d_pad),
      variant, w0, w1, w2, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stpu_cuda_flat_gather(const uint8_t* srcs, int64_t n_rows, int64_t s_width,
                                     const uint16_t* idx, const int32_t* tile_meta,
                                     const int32_t* declens, int64_t d_pad, int layout,
                                     uint8_t* out, void* stream) {
  return launch(srcs, n_rows, s_width, idx, tile_meta, nullptr, declens, d_pad, layout, 0, 0, 0,
                0, out, stream);
}
"""

FIRST_SOURCE_LOAD = "const uint32_t v = p < s_width ? src[p] : 0u;"
FIRST_POSITION = "const int64_t p = base + ix[phys_index(d, layout)];"
STAGED_SPAN = "const int staged = min(want, kSpan);"
CURRENT_SOURCE_LOAD = "x = __ldg(src + base[j] + r);"
CURRENT_BLOCKS = "constexpr int kMinBlocks = 4;"



def variants() -> dict[str, str]:
    with open(os.path.join(HERE, "snappy_tpu_torch", "csrc", "flat_gather.cu")) as f:
        current = f.read()
    for text, pattern in ((FIRST, FIRST_SOURCE_LOAD), (FIRST, FIRST_POSITION),
                          (STAGED, STAGED_SPAN), (current, CURRENT_SOURCE_LOAD),
                          (current, CURRENT_BLOCKS)):
        if pattern not in text:
            raise SystemExit(f"flat_gather_probe: {pattern!r} is not in the source")
    return {
        "first": FIRST,
        "first_no_source_load": FIRST.replace(FIRST_SOURCE_LOAD, "const uint32_t v = p & 0xFFu;"),
        "first_coalesced_source": FIRST.replace(
            FIRST_POSITION, "const int64_t p = d ^ (ix[phys_index(d, layout)] & 1);"),
        "staged": STAGED,
        "staged_no_source_read": STAGED.replace(STAGED_SPAN, "const int staged = 0;"),
        "current": current,
        **{f"current_blocks_{n}": current.replace(CURRENT_BLOCKS, f"constexpr int kMinBlocks = {n};")
           for n in (3, 5)},
        "current_no_source_load": current.replace(CURRENT_SOURCE_LOAD, "x = r;"),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("flat_gather_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from pathlib import Path

    import snappy_tpu_torch
    from snappy_tpu_torch import native
    from snappy_tpu_torch.ops import _build, api, decode_flat, packing

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    out_dir = Path(HERE) / "build" / "flat_gather_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, text in variants().items():
        (out_dir / f"{name}.cu").write_text(text)
        jobs.append((out_dir / f"{name}.cu", [_build._nvcc(), *_build.NVCC_FLAGS]))
    libs = {}
    for (src, _), path in zip(jobs, _build.compile_all(jobs)):
        fn = ctypes.CDLL(str(path)).stpu_cuda_flat_gather
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, i64, p, p, p, i64, ctypes.c_int, p, p]
        fn.restype = ctypes.c_int
        libs[src.stem] = fn

    data = chip_smoke.corpus_stream(chip_smoke.STREAM_BYTES)
    chunks = chip_smoke.compressed_chunks(native.frame_compress(data))
    bodies = [c[0] for c in chunks]
    groups = api.launch_groups(bodies, snappy_tpu_torch.get_config().decode_rows_per_launch)
    g = max(groups, key=len)
    gd = [chunks[i][1] for i in g]
    srcs, glens = packing.batch_streams([bodies[i] for i in g], api._width_bucket(len(bodies[g[0]])))
    d_pad = packing.pad_to_bucket(max(gd), 1024)
    idx, tmeta, fallb, herrs, _ = native.flatten_idx_batch(
        srcs, glens.astype(np.uint64), np.asarray(gd, np.uint64), d_pad, layout=1)
    assert not fallb.any() and not herrs.any()
    s_t, i_t, m_t, d_t = (torch.from_numpy(x).to(dev) for x in (
        srcs, idx.view(np.int16), tmeta, np.asarray(gd, np.int32)))
    b, s = s_t.shape

    def run(fn):
        def call():
            out = torch.empty((b, d_pad), dtype=torch.uint8, device=dev)
            _build.check(fn(s_t.data_ptr(), b, s, i_t.data_ptr(), m_t.data_ptr(), d_t.data_ptr(),
                            d_pad, 1, out.data_ptr(), torch.cuda.current_stream().cuda_stream),
                         "probe")
            return out
        return call

    want = decode_flat.decode_flat_plain(s_t, i_t, m_t, d_t, d_pad, 1)
    d = np.arange(d_pad)
    absidx = np.repeat(tmeta[:, :, 0].astype(np.int64), 1024, axis=1) * 128 + \
        idx[:, decode_flat.phys_index(d, 1)].astype(np.int64)
    absidx[d[None, :] >= np.asarray(gd)[:, None]] = s
    padded = torch.cat([s_t, torch.zeros_like(s_t[:, :1])], dim=1)
    absidx_t = torch.from_numpy(absidx).to(dev)
    calls = {name: run(fn) for name, fn in libs.items()}
    calls["torch.gather"] = lambda: torch.gather(padded, 1, absidx_t)
    report = {"card": card, "shape": [b, s, d_pad], "ms": {}, "device_ms": {}, "equal": {},
              "ptxas": {src.stem: [ln.strip() for ln in path.with_suffix(".log").read_text()
                                   .splitlines() if "registers" in ln or "spill" in ln]
                        for (src, _), path in zip(jobs, _build.compile_all(jobs))}}
    for name in ("first", "staged", "current", "torch.gather"):
        report["equal"][name] = bool(torch.equal(calls[name](), want))
    # Turns: every variant once, then again in reverse order.
    for name in [*calls, *reversed(calls)]:
        report["ms"].setdefault(name, []).append(chip_smoke.cuda_ms(calls[name], 50))
        report["device_ms"].setdefault(name, []).append(chip_smoke.device_ms(calls[name], 50))
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "flat_gather_probe.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if all(report["equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
