"""What binds the replay decoder (K3) and the plane resolution (K9) on one
NVIDIA GPU: a probe.

    python3 replay_resolve_probe.py [first] [current]

Needs a CUDA card and ``nvcc``. Builds variants of both kernels from text
into ``build/replay_resolve_probe/`` and times each through its C entry
with CUDA events as the replay of a CUDA graph of several calls
(``chip_smoke.device_ms``), in two turns (forward, then reverse):

- K3 on the frame's largest launch group (455 corpus chunks, ``d_pad``
  65536, as ``configure(decode_flat=False)`` gives it to K3), on 64 of
  those rows, and on the raw row the host flatten rejects (width 81,920,
  ``d_pad`` 131072): as first ported (``first_replay``, kept below as
  text: one warp a row, the output in device memory) and as it stands in
  ``snappy_tpu_torch/csrc/replay.cu`` with the designs it was measured
  against (see ``current_variants``);
- K9 on the plane ``records_to_pointers`` makes from the host's record
  scan of the same group: as first ported (``first_resolve``: 1,024-position
  tiles in turn) and as it stands, with its alternatives.

Every exact variant must equal the first kernel's rows and codes (K3;
the first kernel's are held to the host codec's bytes here) or the plain
version's plane (K9). A variant that does not build is reported and
skipped, and the run then fails. Prints one JSON object and writes it to
``chiprun_out/replay_resolve_probe.json``.
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

FIRST_REPLAY = r"""// Self-contained replay decode of raw Snappy op streams, one row per warp,
// with the first error's device code per row.
//
// Replaces: snappy_tpu/ops/pallas/decode.py decode_batch_pallas (_make_kernel
// in its "plain" and "fast" modes, _make_compose_kernel in "compose"; the
// three share one contract). It must match them bit for bit: the valid
// prefix of the output is written, every byte after it is zero, and the
// code is that of the first bad op (1 literal, 2 copy read, 3 offset,
// 4 copy write), or 5 when the walk ended clean short of or past declen.
// The checks, their order, the 1<<30 length clamp and the int32 arithmetic
// follow decode.py:278-377 (and core.cpp stpu_scan_records, the same walk).
//
// What bounds it: the op walk's sequential dependence, not bytes. Each op's
// position depends on the previous op's length, so a row is one chain of
// short steps (a few loads and compares per ~7 output bytes on the corpus).
// The TPU kernel walks on its scalar core and moves payloads as 128-lane
// vector windows; here a warp does the same: all 32 lanes parse each op
// (the same addresses, so the loads are broadcasts) and then move its
// literal or copy together, 32 bytes at a time.
//
// Overlapping copies (offset < length) take the closed form
//   out[d + k] = out[d - offset + (k % offset)],
// which reads only bytes that earlier ops already finished, so no lane waits
// on another within an op; __syncwarp() between ops orders each op's writes
// before the next op's reads. A row that fits the opt-in shared memory of one
// block (227 KB on the H100) is staged there first, so the walk's tag reads
// and literal payloads come from shared memory; a wider row is read from
// device memory.
// The kernel writes every output byte: the decoded prefix, then zeros.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr uint32_t kCap = 1u << 30;  // clamp for lengths that provably overrun

enum : int32_t {
  kOk = 0,
  kLiteral = 1,
  kCopyRead = 2,
  kOffset = 3,
  kCopyWrite = 4,
  kHeaderMismatch = 5,
};

__global__ void __launch_bounds__(kWarp)
replay_kernel(const uint8_t* __restrict__ srcs, int64_t s_width,
              const int32_t* __restrict__ src_lens,
              const int32_t* __restrict__ declens, int64_t d_pad, int stage,
              uint8_t* __restrict__ dst, int32_t* __restrict__ errs) {
  extern __shared__ uint8_t staged[];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t n = src_lens[b];
  const int32_t declen = declens[b];
  const uint8_t* src = srcs + b * s_width;
  if (stage) {
    const int64_t n16 = (static_cast<int64_t>(n) + 15) / 16;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n16 * 16 <= s_width) {
      for (int64_t i = lane; i < n16; i += kWarp)
        reinterpret_cast<uint4*>(staged)[i] = reinterpret_cast<const uint4*>(src)[i];
    } else {
      for (int64_t i = lane; i < n; i += kWarp) staged[i] = src[i];
    }
    __syncwarp();
    src = staged;
  }
  uint8_t* out = dst + b * d_pad;

  auto at = [&](int32_t p) -> uint32_t { return p < n ? src[p] : 0u; };
  auto read4 = [&](int32_t p) -> uint32_t {
    return at(p) | at(p + 1) << 8 | at(p + 2) << 16 | at(p + 3) << 24;
  };

  int32_t s = 0, d = 0, err = kOk;
  while (s < n) {
    const uint32_t tag = src[s];
    const uint32_t kind = tag & 3u;
    const int32_t lenm1 = static_cast<int32_t>(tag >> 2);
    if (kind == 0) {
      const bool long_lit = lenm1 >= 60;
      const int32_t bc = min(max(lenm1 - 59, 1), 4);
      const uint32_t raw = read4(s + 1) & (0xFFFFFFFFu >> (8 * (4 - bc)));
      const int32_t ll =
          (long_lit ? static_cast<int32_t>(min(raw, kCap)) : lenm1) + 1;
      const int32_t content = s + 1 + (long_lit ? bc : 0);
      if ((long_lit && s + 5 > n) || (n - content < ll) || (declen - d < ll)) {
        err = kLiteral;
        break;
      }
      for (int32_t k = lane; k < ll; k += kWarp) out[d + k] = src[content + k];
      s = content + ll;
      d += ll;
    } else {
      const int32_t ntb = kind == 1 ? 1 : (kind == 2 ? 2 : 4);
      const int32_t length = kind == 1 ? 4 + (lenm1 & 7) : lenm1 + 1;
      const uint32_t off = kind == 1
                               ? ((tag >> 5) << 8 | at(s + 1))
                               : read4(s + 1) & (0xFFFFFFFFu >> (8 * (4 - ntb)));
      if (s + 1 + ntb > n) {
        err = kCopyRead;
      } else if (off == 0 || static_cast<uint32_t>(d) < off) {
        err = kOffset;
      } else if (d + length > declen) {
        err = kCopyWrite;
      }
      if (err != kOk) break;
      const int32_t o = static_cast<int32_t>(off);
      for (int32_t k = lane; k < length; k += kWarp)
        out[d + k] = out[d - o + (k < o ? k : k % o)];
      s += 1 + ntb;
      d += length;
    }
    __syncwarp();
  }
  for (int64_t p = d + lane; p < d_pad; p += kWarp) out[p] = 0;
  if (lane == 0) errs[b] = (err == kOk && d != declen) ? kHeaderMismatch : err;
}

}  // namespace

extern "C" int stpu_cuda_replay(const uint8_t* srcs, int64_t n_rows,
                                int64_t s_width, const int32_t* src_lens,
                                const int32_t* declens, int64_t d_pad,
                                uint8_t* dst, int32_t* errs, void* stream) {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const bool stage = s_width <= optin;
  const size_t smem = stage ? static_cast<size_t>(s_width) : 0;
  if (stage) {
    const cudaError_t e = cudaFuncSetAttribute(
        replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  replay_kernel<<<static_cast<unsigned>(n_rows), kWarp, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      srcs, s_width, src_lens, declens, d_pad, stage ? 1 : 0, dst, errs);
  return static_cast<int>(cudaGetLastError());
}
"""

FIRST_RESOLVE = r"""// K9 as first ported: one CTA of 1,024 threads a row, a thread a position of
// a 1,024-position tile, the tiles strictly in turn; a pointer into an
// earlier tile read from the output plane, pointers inside the tile doubled
// Jacobi style over two buffers, at most max_rounds rounds a tile.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr int32_t kFlag = 1 << 17;

__device__ __forceinline__ void resolve_tile(int32_t v, int64_t d, int64_t t0,
                                             int32_t* plane, int32_t* buf,
                                             int max_rounds) {
  int32_t* cur = buf;
  int32_t* nxt = buf + kTile;
  cur[threadIdx.x] = v;
  int done = __syncthreads_and(v >= kFlag);
  for (int r = 0; !done && r < max_rounds; ++r) {
    if (v < kFlag && v >= 0 && v < d) v = v < t0 ? plane[v] : cur[v - t0];
    nxt[threadIdx.x] = v;
    done = __syncthreads_and(v >= kFlag);
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  plane[d] = v;
  __syncthreads();
}

__global__ void __launch_bounds__(kTile)
resolve_kernel(const int32_t* __restrict__ a0, int64_t d_pad, int max_rounds,
               int32_t* out) {
  __shared__ int32_t buf[2 * kTile];
  const int64_t b = blockIdx.x;
  const int32_t* row = a0 + b * d_pad;
  int32_t* plane = out + b * d_pad;
  for (int64_t t0 = 0; t0 < d_pad; t0 += kTile) {
    const int64_t d = t0 + threadIdx.x;
    resolve_tile(row[d], d, t0, plane, buf, max_rounds);
  }
}

}  // namespace

extern "C" int stpu_cuda_resolve(const int32_t* a0, int64_t n_rows, int64_t d_pad,
                                 int max_rounds, int32_t* out, void* stream) {
  resolve_kernel<<<static_cast<unsigned>(n_rows), kTile, 0,
                   static_cast<cudaStream_t>(stream)>>>(a0, d_pad, max_rounds, out);
  return static_cast<int>(cudaGetLastError());
}
"""


WINDOWS_RESOLVE = r"""// K9's first windowed design: K8's CTA and windows over the plane, each
// window's plane values loaded when the window starts (plain 16-byte loads,
// no copy ahead).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCtas = 4;
constexpr int kWin = 4096;
constexpr int kSteps = kWin / kThreads;
constexpr int32_t kFlag = 1 << 17;

// K9: the plane's chains, a window of kWin positions at a time in order, with
// K8's phases 3-4 (see the note at the top of the file).
__global__ void __launch_bounds__(kThreads, kCtas)
resolve_kernel(const int32_t* __restrict__ a0, int d_pad, int max_rounds, int32_t* out) {
  __shared__ int val[kWin];           // a root's value
  __shared__ uint16_t hop[kWin];      // a window position's pointer in the window, or itself
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int32_t* a = a0 + b * static_cast<int64_t>(d_pad);
  int32_t* row = out + b * static_cast<int64_t>(d_pad);
  for (int base = 0; base < d_pad; base += kWin) {
    const int chunks = min(kWin, d_pad - base) / 4;  // 4-position chunks, 4 a thread
    // 1: first hops. A value >= FLAG, a pointer at or past its position
    // (never chased) and position 0's value below 0 are roots; a pointer
    // below 0 reads position 0; a pointer before the window takes the final
    // value stored there at once.
    int e[kSteps], tgt[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps / 4; ++k) {
      const int c = t + k * kThreads;
      const int4 v = c < chunks ? reinterpret_cast<const int4*>(a + base)[c] : make_int4(kFlag, kFlag, kFlag, kFlag);
      const int vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = base + 4 * c + i;
        e[4 * k + i] = vs[i];
        tgt[4 * k + i] = vs[i] >= kFlag ? -1 : (vs[i] < 0 ? (p > 0 ? 0 : -1) : (vs[i] < p ? vs[i] : -1));
      }
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u)  // pointers before the window: their values
      if (tgt[u] >= 0 && tgt[u] < base) e[u] = row[tgt[u]];
    bool open[kSteps];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int q = 4 * (t + (u / 4) * kThreads) + u % 4;
      open[u] = tgt[u] >= base;
      if (q < 4 * chunks) {
        hop[q] = static_cast<uint16_t>(open[u] ? tgt[u] - base : q);
        val[q] = e[u];
      }
      tgt[u] = open[u] ? tgt[u] - base : q;
      any |= open[u];
    }
    // 2: the window's chains by pointer doubling in place, hop[q] = hop[hop[q]],
    // at most max_rounds rounds (12 settle any chain of a window).
    for (int r = 0; r < max_rounds && __syncthreads_or(any); ++r) {
      any = false;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (!open[u]) continue;
        const int h2 = hop[tgt[u]];
        if (h2 == tgt[u]) {
          open[u] = false;  // a root
        } else {
          tgt[u] = h2;
          hop[4 * (t + (u / 4) * kThreads) + u % 4] = static_cast<uint16_t>(h2);
          any = true;
        }
      }
    }
    __syncthreads();
    // 3: each position's root value (a chain still open after the budget
    // keeps its window position, below FLAG), 16 bytes a store.
#pragma unroll
    for (int k = 0; k < kSteps / 4; ++k) {
      const int c = t + k * kThreads;
      if (c >= chunks) continue;
      int v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = tgt[4 * k + i];
        v[i] = hop[h] == h ? val[h] : base + h;
      }
      reinterpret_cast<int4*>(row + base)[c] = make_int4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int stpu_cuda_resolve(const int32_t* a0, int64_t n_rows, int64_t d_pad,
                                 int max_rounds, int32_t* out, void* stream) {
  resolve_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a0, static_cast<int>(d_pad), max_rounds, out);
  return static_cast<int>(cudaGetLastError());
}
"""

def _swap(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"replay_resolve_probe: {old!r} is not in the source")
    return text.replace(old, new)


def _swaps(text: str, pairs) -> str:
    for old, new in pairs:
        text = _swap(text, old, new)
    return text


# -- the current K3's alternatives ----------------------------------------------------
REPLAY_LONG = "constexpr int kLong = 512;"
# Clock stamps of thread 0 in the CTA path, summed over the source windows:
# staging and the jumps' parse (0), the op starts (1), the scan,
# checks and records (2), the first hops (3); then the origins (4) and the
# bytes out (5). Written over each row's first 24 bytes.
REPLAY_STAMPS = [
    ("  int s0 = 0, carry = 0, err = kOk;\n",
     "  int s0 = 0, carry = 0, err = kOk;\n  long long acc[6] = {0, 0, 0, 0, 0, 0}, tp = clock64();\n"
     "#define STAMP(k) { const long long now = clock64(); acc[k] += now - tp; tp = now; }\n"),
    ("    // 2: marks pushed along", "    STAMP(0);\n    // 2: marks pushed along"),
    ("    m = *reinterpret_cast<const uint32_t*>(mark + kPer * t);\n    // 3:",
     "    STAMP(1);\n    m = *reinterpret_cast<const uint32_t*>(mark + kPer * t);\n    // 3:"),
    ("    // 4: first hops of the span", "    STAMP(2);\n    // 4: first hops of the span"),
    ("    s0 = exit_at;\n    __syncthreads();\n  }\n",
     "    s0 = exit_at;\n    __syncthreads();\n    STAMP(3);\n  }\n"),
    ("  // K10's phase 4:", "  STAMP(4);\n  // K10's phase 4:"),
    ("    out[c] = make_uint4(v[0], v[1], v[2], v[3]);\n  }\n}\n",
     "    out[c] = make_uint4(v[0], v[1], v[2], v[3]);\n  }\n  __syncthreads();\n  STAMP(5);\n"
     "  if (t == 0) {\n    out[0] = make_uint4(acc[0], acc[1], acc[2], acc[3]);\n"
     "    out[1] = make_uint4(acc[4], acc[5], 0, 0);\n  }\n}\n"),
]
REPLAY_PHASES = ("stage_and_jumps", "op_starts", "scan_checks_records", "first_hops",
                 "origins", "bytes_out")
# The design with the two passes apart: the CTA path's discovery writes the
# valid ops as K10's records to device memory (its first hops, origins and
# bytes left out), and K10 (csrc/records.cu) replays them; both in one graph.
REPLAY_TO_RECORDS = [
    ("                  uint8_t* __restrict__ dst, int32_t* __restrict__ errs) {\n"
     "  extern __shared__ __align__(16) uint8_t smem[];",
     "                  uint8_t* __restrict__ dst, int32_t* __restrict__ errs,\n"
     "                  int2* __restrict__ grecs, int r_cap, int32_t* __restrict__ gnops) {\n"
     "  extern __shared__ __align__(16) uint8_t smem[];"),
    ("  __shared__ int first_bad, bad_start, bad_code, exit_at;",
     "  __shared__ int first_bad, bad_start, bad_code, exit_at, bad_rank;"),
    ("  int s0 = 0, carry = 0, err = kOk;\n", "  int s0 = 0, carry = 0, err = kOk, ops_before = 0;\n"),
    ("        bad_code = code[u];\n", "        bad_code = code[u];\n        bad_rank = rank[u];\n"),
    ("      w1_of[rank[u]] = static_cast<int>(op[u].w1);\n",
     "      w1_of[rank[u]] = static_cast<int>(op[u].w1);\n"
     "      grecs[b * r_cap + ops_before + rank[u]] =\n"
     "          make_int2(op[u].produced | (op[u].lit ? 1 << 30 : 0), static_cast<int>(op[u].w1));\n"),
    ("    const int w_lo = carry >> 5, w_hi = (hi + 31) >> 5;",
     "    const int w_lo = 0, w_hi = 0;  // no first hops here"),
    ("    carry = hi;\n", "    carry = hi;\n"
     "    ops_before += fb < kWin ? bad_rank : static_cast<int>(total >> kCountShift);\n"),
    ("  if (t == 0) errs[b] = (err == kOk && end != declen) ? kHeaderMismatch : err;\n",
     "  if (t == 0) errs[b] = (err == kOk && end != declen) ? kHeaderMismatch : err;\n"
     "  if (t == 0) gnops[b] = ops_before;\n  return;\n"),
    ("    replay_row_kernel<<<static_cast<unsigned>(n_rows), kThreads, smem, st>>>(\n"
     "        srcs, s_width, src_lens, declens, static_cast<int>(d_pad), dst, errs);",
     "    replay_row_kernel<<<static_cast<unsigned>(n_rows), kThreads, smem, st>>>(\n"
     "        srcs, s_width, src_lens, declens, static_cast<int>(d_pad), dst, errs,\n"
     "        reinterpret_cast<int2*>(dst), 0, errs);"),
    ("}  // namespace\n",
     "}  // namespace\n\nextern \"C\" int stpu_probe_replay_records(\n"
     "    const uint8_t* srcs, int64_t n_rows, int64_t s_width, const int32_t* src_lens,\n"
     "    const int32_t* declens, int64_t d_pad, int32_t* recs, int64_t r_cap, int32_t* nops,\n"
     "    int32_t* errs, void* stream) {\n"
     "  const int smem = row_smem(static_cast<int>(d_pad));\n"
     "  const cudaError_t e = cudaFuncSetAttribute(\n"
     "      replay_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
     "  if (e != cudaSuccess) return static_cast<int>(e);\n"
     "  replay_row_kernel<<<static_cast<unsigned>(n_rows), kThreads, smem,\n"
     "                      static_cast<cudaStream_t>(stream)>>>(\n"
     "      srcs, s_width, src_lens, declens, static_cast<int>(d_pad), nullptr, errs,\n"
     "      reinterpret_cast<int2*>(recs), static_cast<int>(r_cap), nops);\n"
     "  return static_cast<int>(cudaGetLastError());\n}\n"),
]
# The next window's source not asked into L2 ahead.
REPLAY_PREFETCH = (
    "    if (t < kWin / 128 + 2 && s0 + kWin - 128 + 128 * t < n)\n"
    "      asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"(src + s0 + kWin - 128 + 128 * t));\n")
# A design measured against the mark doubling (not held): each warp takes a
# segment of 128 positions, every position's exit from it by pointer
# jumping inside the segment with __syncwarp() alone; one thread follows
# the exits from position 0 to each segment's first op start; each warp's
# first lane walks next[] through its segment, marking the op starts.
REPLAY_SEGMENTS = r"""    // 1: the jump of each of this thread's four positions (the ops are
    // parsed again once the marks are set, rather than kept in registers).
    // Its bytes and the next four: two aligned words of the window.
    const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);
    const uint64_t bytes = uint64_t{ws32[t + 1]} << 32 | ws32[t];
    uint16_t j[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = kPer * t + u;
      j[u] = static_cast<uint16_t>(
          q < n - s0 ? min(q + parse_at(bytes >> (8 * u), s0 + q, n).consumed, kWin) : kWin);
    }
    const uint2 packed = make_uint2(j[0] | uint32_t{j[1]} << 16, j[2] | uint32_t{j[3]} << 16);
    *reinterpret_cast<uint2*>(next + kPer * t) = packed;
    *reinterpret_cast<uint2*>(exit_of + kPer * t) = packed;
    *reinterpret_cast<uint32_t*>(mark + kPer * t) = 0;
    __syncwarp();
    // 2: the op starts. a) Each position's exit from its warp's segment of
    // kSeg positions (the first position of its chain at or past the
    // segment's end), by pointer jumping in place inside the segment.
    const int seg_end = (warp + 1) * kSeg;
    bool open = true;
    while (__any_sync(kAll, open)) {
      open = false;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        if (j[u] >= seg_end) continue;
        j[u] = exit_of[j[u]];
        open |= j[u] < seg_end;
      }
      *reinterpret_cast<uint2*>(exit_of + kPer * t) =
          make_uint2(j[0] | uint32_t{j[1]} << 16, j[2] | uint32_t{j[3]} << 16);
      __syncwarp();
    }
    __syncthreads();
    // b) The first op start of each segment (or none), one exit after
    // another from position 0.
    if (t == 0) {
      int e = 0;
      for (int w = 0; w < kWarps; ++w) {
        const bool here = e < (w + 1) * kSeg;
        seg_first[w] = here ? e : kWin;
        if (here) e = exit_of[e];
      }
    }
    __syncthreads();
    // c) Each segment's op starts, marked by its warp's first lane walking
    // next[] from the segment's first.
    if (lane == 0)
      for (int e = seg_first[warp]; e < seg_end; e = next[e]) mark[e] = 1;
    __syncthreads();
    const uint32_t m = *reinterpret_cast<const uint32_t*>(mark + kPer * t);
"""
REPLAY_SEGMENT_PLANES = [
    ("  uint16_t* jump_a = reinterpret_cast<uint16_t*>(ws + kStage);  // jumps, ping and pong\n"
     "  uint16_t* jump_b = jump_a + kWin;\n  uint8_t* mark = reinterpret_cast<uint8_t*>(jump_b + kWin);\n",
     "  uint16_t* next = reinterpret_cast<uint16_t*>(ws + kStage);\n  uint16_t* exit_of = next + kWin;\n"
     "  uint8_t* mark = reinterpret_cast<uint8_t*>(exit_of + kWin);\n"),
    ("  uint32_t* start_of = reinterpret_cast<uint32_t*>(jump_a);",
     "  uint32_t* start_of = reinterpret_cast<uint32_t*>(next);"),
    ("  __shared__ int first_bad, bad_start, bad_code, exit_at;\n",
     "  __shared__ int first_bad, bad_start, bad_code, exit_at;\n  __shared__ int seg_first[kWarps];\n"),
    ("constexpr int kMaxOps = kWin / 2;", "constexpr int kSeg = kPer * kWarp;\nconstexpr int kMaxOps = kWin / 2;"),
]


def _discovery(text: str) -> str:
    """The current K3's op-start block (steps 1-2)."""
    a = text.index("    // 1: the jump of each of this thread's four positions")
    return text[a : text.index("    // 3: output starts and ranks", a)]


# -- the current K9's alternatives ------------------------------------------------------
RESOLVE_CTA = "constexpr int kThreads = 256;      // K8's CTA\nconstexpr int kCtas = 4;"
RESOLVE_WIN = "constexpr int kWin = 4096;"


# Clock stamps of thread 0 in K9, summed over the windows: the wait for the
# plane's values and the first hops (0), the reads of values before the window (1), the
# doubling (2) and the values out (3). Written over each row's first four
# values.
RESOLVE_STAMPS = [
    ("  fetch(0, buf[0]);\n",
     "  fetch(0, buf[0]);\n  long long acc[4] = {0, 0, 0, 0}, tp = clock64();\n"
     "#define STAMP(k) { const long long now = clock64(); acc[k] += now - tp; tp = now; }\n"),
    ("#pragma unroll\n    for (int u = 0; u < kSteps; ++u)  // pointers before the window: their values\n",
     "    STAMP(0);\n#pragma unroll\n    for (int u = 0; u < kSteps; ++u)  // pointers before the window: their values\n"),
    ("    // 2: the window's chains by pointer doubling", "    __syncthreads();\n    STAMP(1);\n"
     "    // 2: the window's chains by pointer doubling"),
    ("    // 3: each position's root value", "    STAMP(2);\n    // 3: each position's root value"),
    ("    __syncthreads();\n  }\n}\n\n}  // namespace",
     "    __syncthreads();\n    STAMP(3);\n  }\n  if (threadIdx.x == 0) {\n"
     "    row[0] = static_cast<int>(acc[0]);\n    row[1] = static_cast<int>(acc[1]);\n"
     "    row[2] = static_cast<int>(acc[2]);\n    row[3] = static_cast<int>(acc[3]);\n  }\n}\n\n"
     "}  // namespace"),
]
RESOLVE_PHASES = ("plane_and_first_hops", "reads_before_window", "doubling", "values_out")
# In the first windowed design (WINDOWS_RESOLVE), the window's values kept in
# shared memory for the next window, so that a pointer into the window just
# before reads shared memory, not L2.
RESOLVE_PREV = [
    ("  __shared__ int val[kWin];           // a root's value\n",
     "  __shared__ int val[kWin];           // a root's value\n  __shared__ int fin[kWin];\n"),
    ("      if (tgt[u] >= 0 && tgt[u] < base) e[u] = row[tgt[u]];",
     "      if (tgt[u] >= 0 && tgt[u] < base) e[u] = tgt[u] >= base - kWin ? fin[tgt[u] - base + kWin] : row[tgt[u]];"),
    ("      reinterpret_cast<int4*>(row + base)[c] = make_int4(v[0], v[1], v[2], v[3]);\n",
     "      reinterpret_cast<int4*>(row + base)[c] = make_int4(v[0], v[1], v[2], v[3]);\n"
     "      reinterpret_cast<int4*>(fin)[c] = make_int4(v[0], v[1], v[2], v[3]);\n"),
]


def current_variants() -> dict[str, tuple[str, str]]:
    """The package's K3 and K9 as they ship, and the designs they were
    measured against: K3 with the CTA walk's long literals from 128 or
    2,048 bytes (not 512), with clock stamps per phase, with discovery and
    replay as two kernels (records through device memory into K10),
    without the next window's source asked into L2, and with the op starts
    found by segments (exits by pointer jumping in a warp, then walks); K9
    with CTAs of 512 threads (two an SM, not 256 and four), with windows
    of 2,048 positions, with eight CTAs of 256 an SM, with clock stamps per
    phase, and its first windowed design (each window's plane values
    loaded as it starts), also with each window's values kept in shared
    memory for the next window's pointers into it."""
    csrc = os.path.join(HERE, "snappy_tpu_torch", "csrc")
    with open(os.path.join(csrc, "replay.cu")) as f, open(os.path.join(csrc, "resolve.cu")) as g:
        rep, res = f.read(), g.read()
    return {
        "current_replay": ("replay", rep),
        "current_replay_long_128": ("replay", _swap(rep, REPLAY_LONG, "constexpr int kLong = 128;")),
        "current_replay_long_2048": ("replay", _swap(rep, REPLAY_LONG, "constexpr int kLong = 2048;")),
        "current_replay_phase_clocks": ("replay", _swaps(rep, REPLAY_STAMPS)),
        "current_replay_to_records": ("replay_records", _swaps(rep, REPLAY_TO_RECORDS)),
        "current_replay_no_prefetch": ("replay", _swap(rep, REPLAY_PREFETCH, "")),
        "current_replay_segments": ("replay", _swaps(rep, REPLAY_SEGMENT_PLANES + [
            (_discovery(rep), REPLAY_SEGMENTS)])),
        "current_resolve": ("resolve", res),
        "current_resolve_512_threads": ("resolve", _swap(
            res, RESOLVE_CTA, "constexpr int kThreads = 512;      // K8's CTA\nconstexpr int kCtas = 2;")),
        "current_resolve_window_2048": ("resolve", _swap(res, RESOLVE_WIN, "constexpr int kWin = 2048;")),
        "current_resolve_8_ctas": ("resolve", _swap(
            res, RESOLVE_CTA, "constexpr int kThreads = 256;      // K8's CTA\nconstexpr int kCtas = 8;")),
        "current_resolve_phase_clocks": ("resolve", _swaps(res, RESOLVE_STAMPS)),
        "current_resolve_plain_loads": ("resolve", WINDOWS_RESOLVE),
        "current_resolve_plain_loads_prev_window": ("resolve", _swaps(WINDOWS_RESOLVE, RESOLVE_PREV)),
    }


def variants(families) -> dict[str, tuple[str, str]]:
    """``name: (kernel, source text)`` of the chosen families; ``kernel`` is
    "replay", "replay_records" or "resolve"."""
    out = {}
    if "first" in families:
        out.update({"first_replay": ("replay", FIRST_REPLAY), "first_resolve": ("resolve", FIRST_RESOLVE)})
    if "current" in families:
        out.update(current_variants())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("replay_resolve_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from pathlib import Path

    import snappy_tpu_torch
    from snappy_tpu_torch import native
    from snappy_tpu_torch.format.varint import read_varu64, write_varu64
    from snappy_tpu_torch.ops import _build, api, packing, records, resolve

    dev = torch.device("cuda")

    def smi(query):
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]

    families = [a for a in sys.argv[1:] if a in ("first", "current")] or ["first", "current"]
    out_dir = Path(HERE) / "build" / "replay_resolve_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    kinds, jobs = {}, []
    for name, (kind, text) in variants(families).items():
        (out_dir / f"{name}.cu").write_text(text)
        jobs.append((out_dir / f"{name}.cu", [_build._nvcc(), *_build.NVCC_FLAGS]))
        kinds[name] = kind
    failed = {}
    try:
        paths = _build.compile_all(jobs)
    except RuntimeError:  # build one at a time; a variant that fails is reported and skipped
        paths = []
        for job in jobs:
            try:
                paths += _build.compile_all([job])
            except RuntimeError as e:
                failed[job[0].stem] = str(e)[-1500:]
                paths.append(None)
        jobs, paths = zip(*[(j, q) for j, q in zip(jobs, paths) if q is not None])
        kinds = {n: k for n, k in kinds.items() if n not in failed}
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    entries = {
        "replay": ("stpu_cuda_replay", [p, i64, i64, p, p, i64, p, p, p]),
        "replay_records": ("stpu_probe_replay_records", [p, i64, i64, p, p, i64, p, i64, p, p, p]),
        "resolve": ("stpu_cuda_resolve", [p, i64, i64, i32, p, p]),
    }
    libs = {}
    for (src, _), path in zip(jobs, paths):
        sym, argtypes = entries[kinds[src.stem]]
        fn = getattr(ctypes.CDLL(str(path)), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        libs[src.stem] = fn
    report = {"card": smi("name,power.limit"), "sm_max_mhz": int(smi("clocks.max.sm").split()[0]),
              "build_failed": failed, "equal": {},
              "ptxas": {src.stem: [ln.strip() for ln in path.with_suffix(".log").read_text()
                                   .splitlines() if "registers" in ln or "spill" in ln]
                        for (src, _), path in zip(jobs, paths)}}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def named(kind, *skip):
        return [n for n, k in kinds.items() if k in kind and not any(s in n for s in skip)]

    def timed(calls, reps):
        ms = {}
        for n in [*calls, *reversed(list(calls))]:
            ms.setdefault(n, []).append(chip_smoke.device_ms(calls[n], reps))
        return ms

    # -- the inputs: the frame's largest group, 64 of its rows, the raw row ------------
    data = chip_smoke.corpus_stream(chip_smoke.STREAM_BYTES)
    frame = native.frame_compress(data)
    chunks = chip_smoke.compressed_chunks(frame)
    fbodies = [c[0] for c in chunks]
    groups = api.launch_groups(fbodies, snappy_tpu_torch.get_config().decode_rows_per_launch)
    g = max(groups, key=len)
    gd = [chunks[i][1] for i in g]
    srcs, glens = packing.batch_streams([fbodies[i] for i in g], api._width_bucket(len(fbodies[g[0]])))
    d_pad = packing.pad_to_bucket(max(gd), 1024)
    raw_fb, plain_fb = chip_smoke.flatten_rejected_stream()
    fb_declen, fb_h = read_varu64(raw_fb)
    fb_srcs, fb_lens = packing.batch_streams([raw_fb[fb_h:]], api._width_bucket(len(raw_fb) - fb_h))
    shapes = {
        "group": (srcs, glens, np.asarray(gd, np.int32), d_pad),
        "rows_64": (srcs[:64], glens[:64], np.asarray(gd[:64], np.int32), d_pad),
        "raw_row": (fb_srcs, fb_lens, np.asarray([fb_declen], np.int32),
                    packing.pad_to_bucket(fb_declen, 1024)),
    }
    expect = native.decompress_batch([write_varu64(gd[j]) + fbodies[i] for j, i in enumerate(g)])
    r_cap = 16384
    rep = {}
    for shape, (s_np, l_np, dl_np, dp) in shapes.items():
        s_t, l_t, dl_t = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (s_np, l_np, dl_np))
        b, width = s_t.shape

        def replayer(fn, kind):
            def call():
                dst = torch.empty((b, dp), dtype=torch.uint8, device=dev)
                errs = torch.empty(b, dtype=torch.int32, device=dev)
                if kind == "replay":
                    _build.check(fn(s_t.data_ptr(), b, width, l_t.data_ptr(), dl_t.data_ptr(), dp,
                                    dst.data_ptr(), errs.data_ptr(), stream()), "probe")
                    return dst, errs
                recs = torch.empty((b, r_cap, 2), dtype=torch.int32, device=dev)
                nops = torch.empty(b, dtype=torch.int32, device=dev)
                _build.check(fn(s_t.data_ptr(), b, width, l_t.data_ptr(), dl_t.data_ptr(), dp,
                                recs.data_ptr(), r_cap, nops.data_ptr(), errs.data_ptr(), stream()),
                             "probe")
                _build.check(records._kernel()(s_t.data_ptr(), b, width, recs.data_ptr(), r_cap,
                                               nops.data_ptr(), dl_t.data_ptr(), dp, dst.data_ptr(),
                                               stream()), "probe")
                return dst, errs
            return call

        names = named(("replay", "replay_records"))
        if shape == "raw_row":
            names = [n for n in names if kinds[n] == "replay"]
        calls = {n: replayer(libs[n], kinds[n]) for n in names}
        ref_name = "first_replay" if "first_replay" in calls else "current_replay"
        want = calls[ref_name]()
        host = want[0].cpu().numpy()
        if shape == "raw_row":
            good = host[0, :fb_declen].tobytes() == plain_fb and not host[0, fb_declen:].any()
        else:
            good = all(host[j, : len(x)].tobytes() == x and not host[j, len(x):].any()
                       for j, x in enumerate(expect[: len(dl_np)]))
        report["equal"][f"{ref_name}:{shape}:host_codec"] = bool(good and not want[1].any())
        for n in named(("replay", "replay_records"), "phase_clocks"):
            if n in calls and n != ref_name:
                got = calls[n]()
                report["equal"][f"{n}:{shape}"] = bool(torch.equal(got[0], want[0])
                                                        and torch.equal(got[1], want[1]))
        entry = {"shape": [b, width, dp], "bytes": int(l_np.sum()) + 12 * b + b * dp}
        for n in calls:
            if "phase_clocks" in n and shape != "raw_row":
                stamps = calls[n]()[0][:, :24].contiguous().view(torch.int32).cpu().numpy()
                stamps = stamps.view(np.uint32).astype(np.float64)
                entry[f"{n}_mean"] = dict(zip(REPLAY_PHASES, stamps.mean(0).tolist()))
                entry[f"{n}_max"] = dict(zip(REPLAY_PHASES, stamps.max(0).tolist()))
        entry["device_ms"] = timed(calls, 5 if shape == "group" else 20)
        rep[shape] = entry
        del calls, want
    report["replay"] = rep

    # -- K9 on the group's first-hop plane ----------------------------------------------
    rec_cap = api._record_cap(srcs.shape[1])
    recs, nops, herrs, _ = native.scan_records_batch(
        srcs, glens.astype(np.uint64), np.asarray(gd, np.uint64), rec_cap)
    assert int(nops.max()) <= rec_cap and not herrs.any()
    r_pad = max(512, -(-int(nops.max()) // 512) * 512)
    r_t, n_t, d_t = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        recs[:, :r_pad], nops.astype(np.int32), np.asarray(gd, np.int32)))
    a0 = resolve.records_to_pointers(r_t, n_t, d_t, d_pad)
    want9 = resolve.resolve_reference(a0)
    b = a0.shape[0]

    def resolver(fn):
        def call():
            out = torch.empty_like(a0)
            _build.check(fn(a0.data_ptr(), b, d_pad, resolve.MAX_ROUNDS, out.data_ptr(), stream()),
                         "probe")
            return out
        return call

    calls = {n: resolver(libs[n]) for n in named(("resolve",))}
    report["resolve"] = {"shape": [b, d_pad]}
    for n in calls:
        if "phase_clocks" in n:
            stamps = calls[n]()[:, :4].cpu().numpy().view(np.uint32).astype(np.float64)
            report["resolve"][f"{n}_mean"] = dict(zip(RESOLVE_PHASES, stamps.mean(0).tolist()))
            report["resolve"][f"{n}_max"] = dict(zip(RESOLVE_PHASES, stamps.max(0).tolist()))
        else:
            report["equal"][f"{n}:group"] = bool(torch.equal(calls[n](), want9))
    report["resolve"]["device_ms"] = timed(calls, 10)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "replay_resolve_probe.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if all(report["equal"].values()) and not failed else 1


if __name__ == "__main__":
    sys.exit(main())
