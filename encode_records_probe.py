"""What binds the exact encoder (K7) and the record replay (K10) on one
NVIDIA GPU: a probe.

    python3 encode_records_probe.py [first] [current]

Needs a CUDA card and ``nvcc``. Builds variants of both kernels from text
into ``build/encode_records_probe/`` and times each with CUDA events as
the replay of a CUDA graph of several calls (``chip_smoke.device_ms``), in
two turns (forward, then reverse):

- K7 alone on single 64 KiB blocks (one row each, and an empty row):
  an incompressible block, text, a 4-byte period, and two more corpus
  blocks. With each block's serial probes, 128-byte extension quanta,
  copies and scan rounds (``ops.encode.find_ops_rounds``, the shipped
  walk's rounds; a folded variant's re-match rounds fall to the copy
  term), a least-squares fit gives the clocks (at the card's highest SM
  clock) per probe or round, per quantum and per copy (its re-match probe
  and its bytes), and the fixed cost of a block;
- K7 on ``chip_smoke.py``'s compress group (the 64 MiB + 5,000-byte
  stream's 1,025 blocks in 2,048 rows): as first ported (2 resident CTAs
  an SM) and with its shared memory padded to 1; the current kernel as it
  ships (the block read in place, 6 CTAs an SM), padded to 4 and 3 CTAs
  an SM; and the redesign with the designs it was measured against behind
  compile-time switches, kept below as text (``switched``, set as
  shipped): with the block staged in shared memory (``staged``), with the
  re-match probe folded into the next round (``folded``), and both, also
  with every round through ``__match_any_sync`` (``match_any``);
- K10 on the frame's largest launch group (455 rows, ``d_pad`` 65536, the
  host's record scan), as it is and with each literal's source load
  replaced by a constant byte; the current one also without the pointer
  doubling inside its windows (wrong bytes), with windows of 1, 2 and 8
  positions a thread (not 4), with first hops 4 words a batch (not 8), and
  with clock stamps at its phase boundaries
  (the mean and most clocks per row of the record passes' loads, scan and
  checks, their record starts' bits and counts, their first hops, the
  doubling and the bytes out; the first 20 bytes of each row are lost to
  them).

``first_*`` are the kernels as first ported (the warp-per-block K7 and the
warp-per-row K10), kept below as text; ``current_*`` are
``snappy_tpu_torch/csrc/encode.cu`` and ``records.cu`` as they stand, and
the switched K7 (the arguments pick either family; both by default). Every K7 variant must give the host codec's bytes on every block,
and every K10 variant that keeps its bytes the host codec's and its plain
version's on every row. Prints one JSON object and writes it to
``chiprun_out/encode_records_probe.json``.
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

FIRST_ENCODE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOutW = 76800;
constexpr int kMaxS = 65536;
// The block, then zeros: an extension step reads up to 131 bytes past es <= n.
constexpr int kSrcCap = kMaxS + 256;
constexpr int kTable = 1 << 14;
constexpr int kSmem = kSrcCap + kTable * 2;
constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr int kInputMargin = 15;
constexpr int kMinNonLiteral = 17;
constexpr int kQuantum = 128;  // bytes compared per extension step
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t u32_at(const uint8_t* s, int pos) {
  return uint32_t{s[pos]} | uint32_t{s[pos + 1]} << 8 | uint32_t{s[pos + 2]} << 16 |
         uint32_t{s[pos + 3]} << 24;
}

// The output row and its write position; d is the same in every lane.
struct Emitter {
  uint8_t* row;
  const uint8_t* src;
  int d;
  int lane;

  __device__ __forceinline__ void byte(int v) {
    if (lane == 0) row[d] = static_cast<uint8_t>(v);
    d++;
  }

  __device__ void literal(int start, int end) {
    const int len = end - start;
    const int m = len - 1;
    if (m < 60) {
      byte(m << 2);
    } else if (m < 256) {
      byte(60 << 2);
      byte(m);
    } else {
      byte(61 << 2);
      byte(m & 0xFF);
      byte(m >> 8);
    }
    for (int k = lane; k < len; k += 32) row[d + k] = src[start + k];
    d += len;
  }

  __device__ __forceinline__ void copy2(int offset, int len) {
    byte(((len - 1) << 2) | 2);
    byte(offset & 0xFF);
    byte(offset >> 8);
  }

  __device__ void copy(int offset, int len) {
    while (len >= 68) {
      copy2(offset, 64);
      len -= 64;
    }
    if (len > 64) {
      copy2(offset, 60);
      len -= 60;
    }
    if (len <= 11 && offset <= 2047) {
      byte(((offset >> 8) << 5) | ((len - 4) << 2) | 1);
      byte(offset & 0xFF);
    } else {
      copy2(offset, len);
    }
  }
};

// Bytes equal from es and ec on, up to kQuantum: lane i compares bytes
// [4i, 4i + 4).
__device__ __forceinline__ int first_difference(const uint8_t* src, int es, int ec, int lane) {
  const uint32_t x = u32_at(src, es + 4 * lane) ^ u32_at(src, ec + 4 * lane);
  const unsigned lanes = __ballot_sync(kFull, x != 0);
  if (lanes == 0) return kQuantum;
  const int f = __ffs(static_cast<int>(lanes)) - 1;
  const uint32_t xf = __shfl_sync(kFull, x, f);
  return 4 * f + ((__ffs(static_cast<int>(xf)) - 1) >> 3);
}

__global__ void __launch_bounds__(32)
encode_kernel(const uint8_t* __restrict__ blocks, int64_t row_w,
              const int32_t* __restrict__ lens, uint8_t* __restrict__ out,
              int32_t* __restrict__ out_len) {
  extern __shared__ uint4 smem_words[];
  uint8_t* src = reinterpret_cast<uint8_t*>(smem_words);
  uint16_t* table = reinterpret_cast<uint16_t*>(src + kSrcCap);
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = lens[b];

  // Stage the block's n bytes and zeros up to kSrcCap; zero the table.
  const uint4* g = reinterpret_cast<const uint4*>(blocks + b * row_w);
  for (int w = lane; w < kSrcCap / 16; w += 32) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (16 * w < n) {
      v = g[w];
      if (16 * w + 16 > n) {  // the last partial word: keep bytes below n
        uint8_t* vb = reinterpret_cast<uint8_t*>(&v);
        for (int k = n - 16 * w; k < 16; k++) vb[k] = 0;
      }
    }
    smem_words[w] = v;
  }
  uint4* tw = reinterpret_cast<uint4*>(table);
  for (int w = lane; w < kTable * 2 / 16; w += 32) tw[w] = make_uint4(0, 0, 0, 0);
  __syncwarp();

  Emitter e{out + b * kOutW, src, 0, lane};
  if (n < kMinNonLiteral) {
    if (n > 0) e.literal(0, n);
  } else {
    const int bits = min(max(32 - __clz(static_cast<unsigned>(max(n - 1, 1))), 8), 14);
    const unsigned shift = 32 - bits;
    auto hash = [shift](uint32_t x) { return static_cast<int>((x * kHashMul) >> shift); };
    const int s_limit = n - kInputMargin;

    bool extending = false;
    int s_next = 1, skip = 32, next_emit = 0, next_hash = hash(u32_at(src, 1));
    int base = 0, es = 0, ec = 0, cand = 0;
    while (true) {
      if (!extending) {
        const int s = s_next;
        const int bb = skip >> 5;
        s_next = s + bb;
        skip += bb;
        if (s_next > s_limit) {
          if (next_emit < n) e.literal(next_emit, n);
          break;
        }
        int c = 0;
        if (lane == 0) {
          c = table[next_hash];
          table[next_hash] = static_cast<uint16_t>(s);
        }
        c = __shfl_sync(kFull, c, 0);
        next_hash = hash(u32_at(src, s_next));
        if (u32_at(src, s) == u32_at(src, c)) {
          if (s > next_emit) e.literal(next_emit, s);
          extending = true;
          base = s;
          es = s + 4;
          ec = c + 4;
          cand = c;
        }
        continue;
      }
      const int first = first_difference(src, es, ec, lane);
      const int ext = min(first, n - es);
      es += ext;
      ec += ext;
      if (first == kQuantum && ext == first) continue;
      e.copy(base - cand, es - base);
      const int s = es;
      next_emit = s;
      if (s >= s_limit) {
        if (s < n) e.literal(s, n);
        break;
      }
      const int h1 = hash(u32_at(src, s - 1));
      const uint32_t cur = u32_at(src, s);
      const int h = hash(cur);
      int c = 0;
      if (lane == 0) {
        table[h1] = static_cast<uint16_t>(s - 1);
        c = table[h];
        table[h] = static_cast<uint16_t>(s);
      }
      c = __shfl_sync(kFull, c, 0);
      if (cur == u32_at(src, c)) {
        base = s;
        es = s + 4;
        ec = c + 4;
        cand = c;
      } else {
        extending = false;
        s_next = s + 1;
        skip = 32;
        next_hash = hash(u32_at(src, s + 1));
      }
    }
  }

  if (lane == 0) out_len[b] = e.d;
  // Zero the row past out_len: bytes up to a 16-byte boundary, then words.
  uint8_t* row = e.row;
  const int d16 = min((e.d + 15) & ~15, kOutW);
  for (int k = e.d + lane; k < d16; k += 32) row[k] = 0;
  uint4* rw = reinterpret_cast<uint4*>(row);
  for (int w = d16 / 16 + lane; w < kOutW / 16; w += 32) rw[w] = make_uint4(0, 0, 0, 0);
}

}  // namespace

// blocks: (n_rows, row_w) uint8, 16-byte aligned, row_w % 128 == 0 and
// <= 65536; lens: (n_rows,) int32 in [0, row_w]; out: (n_rows, 76800)
// uint8; out_len: (n_rows,) int32.
extern "C" int stpu_cuda_encode(const uint8_t* blocks, int64_t row_w, const int32_t* lens,
                                int64_t n_rows, uint8_t* out, int32_t* out_len,
                                void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  encode_kernel<<<static_cast<unsigned>(n_rows), 32, kSmem,
                  static_cast<cudaStream_t>(stream)>>>(blocks, row_w, lens, out, out_len);
  return static_cast<int>(cudaGetLastError());
}
"""

FIRST_RECORDS = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kWarp)
records_kernel(const uint8_t* __restrict__ srcs, int64_t s_width,
               const int2* __restrict__ recs, int64_t r_cap,
               const int32_t* __restrict__ nops,
               const int32_t* __restrict__ declens, int64_t d_pad, int stage,
               uint8_t* __restrict__ dst) {
  extern __shared__ __align__(16) uint8_t staged[];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const uint8_t* src = srcs + b * s_width;
  const int2* rec = recs + b * r_cap;
  const int64_t n = min(static_cast<int64_t>(nops[b]), r_cap);
  const int64_t lim = min(static_cast<int64_t>(declens[b]), d_pad);
  uint8_t* row = dst + b * d_pad;
  uint8_t* out = row;
  if (stage) {
    for (int64_t p = lane; p < d_pad / 16; p += kWarp)
      reinterpret_cast<uint4*>(staged)[p] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    out = staged;
  }

  int64_t d = 0;
  bool stop = false;
  for (int64_t j0 = 0; j0 < n && !stop; j0 += kWarp) {
    const int2 mine = j0 + lane < n ? rec[j0 + lane] : make_int2(0, 0);
    const int m = static_cast<int>(min(static_cast<int64_t>(kWarp), n - j0));
    for (int k = 0; k < m; ++k) {
      const int32_t w0 = __shfl_sync(kAll, mine.x, k);
      const int32_t w1 = __shfl_sync(kAll, mine.y, k);
      const int32_t len = w0 & 0x3FFFFFFF;
      const bool lit = (w0 >> 30) & 1;
      if (len > lim - d ||
          (lit ? (w1 < 0 || w1 > s_width - len) : (w1 < 1 || w1 > d))) {
        stop = true;
        break;
      }
      if (lit) {
        for (int32_t i = lane; i < len; i += kWarp) out[d + i] = src[w1 + i];
      } else {
        const uint8_t* from = out + d - w1;
        for (int32_t i = lane; i < len; i += kWarp)
          out[d + i] = from[i < w1 ? i : i % w1];
      }
      d += len;
      __syncwarp();
    }
  }

  if (stage) {
    for (int64_t p = lane; p < d_pad / 16; p += kWarp)
      reinterpret_cast<uint4*>(row)[p] = reinterpret_cast<const uint4*>(staged)[p];
  } else {
    for (int64_t p = d + lane; p < d_pad; p += kWarp) row[p] = 0;
  }
}

}  // namespace

extern "C" int stpu_cuda_records(const uint8_t* srcs, int64_t n_rows, int64_t s_width,
                                 const int32_t* recs, int64_t r_cap, const int32_t* nops,
                                 const int32_t* declens, int64_t d_pad, uint8_t* dst,
                                 void* stream) {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const bool stage = d_pad <= optin && d_pad % 16 == 0;
  const size_t smem = stage ? static_cast<size_t>(d_pad) : 0;
  if (stage) {
    const cudaError_t e = cudaFuncSetAttribute(
        records_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  records_kernel<<<static_cast<unsigned>(n_rows), kWarp, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      srcs, s_width, reinterpret_cast<const int2*>(recs), r_cap, nops, declens,
      d_pad, stage ? 1 : 0, dst);
  return static_cast<int>(cudaGetLastError());
}
"""

# K7 as redesigned, with the designs it was measured against behind three
# compile-time switches (as shipped: kSpeculate, not kStageBlock, not
# kFoldRematch).
SWITCHED_ENCODE = r"""
// The exact greedy encoder (K7): the reference encoder's hash-probe automaton
// per block of at most 64 KiB, emitting op bytes directly, byte for byte the
// reference's raw stream (without the varint preamble).
//
// Replaces: snappy_tpu/ops/pallas/encode.py compress_blocks_pallas
// (_make_kernel). The TPU kernel walks the automaton on the scalar core out of
// an int32 SMEM copy of the block, zeroes its SMEM table with a scalar loop,
// compares 128-byte rotated windows for the match extension and writes every
// header byte as a masked read-modify-write of a 128-lane output row, all
// because Mosaic has no scalar access to vector memory. None of that is
// needed here: one warp per block, the 16 Ki-entry table in shared memory as
// uint16 positions (every position is below 65,536), the block read where it
// lies, through L1.
//
// What bounds it: the automaton is a serial chain per block, so a block
// takes one step after another whatever the card's width, and each step is
// a few dependent loads; device-memory bytes (each block read once, each
// 76,800-byte output row written once) bound it only when the blocks are
// many and their chains short. So the design shortens the chain and runs
// as many chains at once as shared memory allows: with only the table
// (33 KB) in shared memory six blocks run per SM. Staging the block beside
// it (99 KB, two per SM; kStageBlock) makes each chain faster and the group
// slower (encode_records_probe.py).
//
// Design: the warp takes the scan 32 probes at a time. After every
// (re)start skip is 32 and probe k of the run advances skip >> 5, so the
// run's positions r + A[k] are known in advance (A, the cumulative
// advances, sits in shared memory). In a round lane j probes r + A[k0 + j]
// and exists while r + A[k0 + j + 1] <= s_limit; the first matching lane
// (__ballot_sync) ends it, and the lanes up to it store their positions.
// The round speculates that its lanes' hashes differ: each lane's candidate
// is its own table entry, and the storing lanes read their slots back. A
// lane that finds another's position (two lanes of one hash) sends the round
// down the exact path: the stores undone, __match_any_sync gives each lane
// the highest earlier lane of its hash, whose position is the candidate the
// serial loop would have read, and a lane stores only when no later storing
// lane shares its hash, so the table ends as the serial stores leave it.
// After a copy ending at s, the re-match probe at s is made alone, as the
// serial loop makes it (h(s - 1) <- s - 1, then the swap at h(s)), and a
// miss restarts the run from s + 1 (folding it into lane 0 of the next
// round was slower; kFoldRematch). Words are built from two aligned 32-bit
// loads and a funnel shift. The lanes share the match extension (32 lanes x
// 4 bytes a quantum, __ballot_sync and __ffs for the first difference),
// the copy of literal bytes to the output row and the zero fill past
// out_len. ops/encode.py find_ops_rounds is this walk on the host.
//
// Semantics kept bit for bit (snappy_tpu/ops/encode.py find_ops and
// serialize_ops, src/compress.rs:195-317 of the reference): table bits
// clip(ceil_log2(max(n - 1, 1)), 8, 14), hash (u32 * 0x1E35A7BD) >> (32 -
// bits) in wrapping uint32 arithmetic, a zeroed table whose 0 means
// position 0; s_limit = n - 15; skip starts at 32, each scan step advances
// skip >> 5 and stores s at the probed slot; extension clipped by n - es;
// after a copy h(s - 1) <- s - 1, then the swap at h(s) and the immediate
// re-match check; n < 17 is one literal and n == 0 emits nothing; copies
// split into 64-byte copy2s while len >= 68, one 60-byte copy2 if len > 64,
// then copy1 iff len <= 11 and offset <= 2047; literal headers of 1, 2 or 3
// bytes. The row is zero past out_len.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOutW = 76800;
constexpr int kMaxS = 65536;
// The staged block, then zeros: an extension quantum reads up to 135 bytes
// past es <= n.
constexpr int kSrcCap = kMaxS + 256;
constexpr int kTable = 1 << 14;
// A[k] for every probe a run within 64 KiB can reach, and a round of lanes more
// (ops/encode.py ADVANCE).
constexpr int kAdvance = 299;
constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr int kInputMargin = 15;
constexpr int kMinNonLiteral = 17;
constexpr int kQuantum = 128;  // bytes compared per extension step
constexpr int kLanes = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// Rounds speculate that their lanes' hashes differ, and take the exact
// __match_any_sync path only when a store says otherwise.
constexpr bool kSpeculate = true;
// The block staged in shared memory beside the table, or read in place
// through L1 with only the table (and A) in shared memory.
constexpr bool kStageBlock = false;
// After a copy, the re-match probe is lane 0 of the next scan round, or a
// probe of its own before it.
constexpr bool kFoldRematch = false;
constexpr int kSmem = (kStageBlock ? kSrcCap : 0) + kTable * 2 + kAdvance * 4;

// The little-endian word at byte p, from two aligned words. Staged, the
// block has zeros past n; read in place, words past the row's last are
// taken as that one (only an extension reads past n, and it is clipped there).
__device__ __forceinline__ uint32_t u32_at(const uint32_t* w, int last_word, int p) {
  if constexpr (kStageBlock) return __funnelshift_r(w[p >> 2], w[(p >> 2) + 1], (p & 3) * 8);
  return __funnelshift_r(__ldg(w + min(p >> 2, last_word)), __ldg(w + min((p >> 2) + 1, last_word)),
                         (p & 3) * 8);
}

// The output row and its write position; d is the same in every lane.
struct Emitter {
  uint8_t* row;
  const uint8_t* src;
  int d;
  int lane;

  __device__ __forceinline__ void byte(int v) {
    if (lane == 0) row[d] = static_cast<uint8_t>(v);
    d++;
  }

  __device__ void literal(int start, int end) {
    const int len = end - start;
    const int m = len - 1;
    if (m < 60) {
      byte(m << 2);
    } else if (m < 256) {
      byte(60 << 2);
      byte(m);
    } else {
      byte(61 << 2);
      byte(m & 0xFF);
      byte(m >> 8);
    }
    for (int k = lane; k < len; k += kLanes) row[d + k] = src[start + k];
    d += len;
  }

  __device__ __forceinline__ void copy2(int offset, int len) {
    byte(((len - 1) << 2) | 2);
    byte(offset & 0xFF);
    byte(offset >> 8);
  }

  __device__ void copy(int offset, int len) {
    while (len >= 68) {
      copy2(offset, 64);
      len -= 64;
    }
    if (len > 64) {
      copy2(offset, 60);
      len -= 60;
    }
    if (len <= 11 && offset <= 2047) {
      byte(((offset >> 8) << 5) | ((len - 4) << 2) | 1);
      byte(offset & 0xFF);
    } else {
      copy2(offset, len);
    }
  }
};

// Bytes equal from es and ec on, up to kQuantum: lane i compares bytes
// [4i, 4i + 4).
__device__ __forceinline__ int first_difference(const uint32_t* w, int last_word, int es, int ec,
                                                int lane) {
  const uint32_t x = u32_at(w, last_word, es + 4 * lane) ^ u32_at(w, last_word, ec + 4 * lane);
  const unsigned lanes = __ballot_sync(kFull, x != 0);
  if (lanes == 0) return kQuantum;
  const int f = __ffs(static_cast<int>(lanes)) - 1;
  const uint32_t xf = __shfl_sync(kFull, x, f);
  return 4 * f + ((__ffs(static_cast<int>(xf)) - 1) >> 3);
}

__global__ void __launch_bounds__(kLanes)
encode_kernel(const uint8_t* __restrict__ blocks, int64_t row_w,
              const int32_t* __restrict__ lens, uint8_t* __restrict__ out,
              int32_t* __restrict__ out_len) {
  extern __shared__ uint4 smem_words[];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = lens[b];
  const uint8_t* g = blocks + b * row_w;
  uint8_t* staged = reinterpret_cast<uint8_t*>(smem_words);
  const uint8_t* src = kStageBlock ? staged : g;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(src);
  const int last_word = static_cast<int>(row_w / 4) - 1;
  uint16_t* table = reinterpret_cast<uint16_t*>(staged + (kStageBlock ? kSrcCap : 0));
  int* advance = reinterpret_cast<int*>(table + kTable);

  Emitter e{out + b * kOutW, src, 0, lane};
  if (n < kMinNonLiteral) {
    e.src = g;
    if (n > 0) e.literal(0, n);
  } else {
    // Staged, the block's n bytes come in zero-filled up to kSrcCap while
    // the table is zeroed and lane 0 tabulates the run advances.
    for (int w = lane; kStageBlock && w < kSrcCap / 16; w += kLanes) {
      const int have = min(max(n - 16 * w, 0), 16);
      const uint8_t* from = have ? g + 16 * w : g;
      const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(smem_words + w));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(to), "l"(from), "r"(have));
    }
    asm volatile("cp.async.commit_group;\n" ::);
    uint4* tw = reinterpret_cast<uint4*>(table);
    for (int w = lane; w < kTable * 2 / 16; w += kLanes) tw[w] = make_uint4(0, 0, 0, 0);
    if (lane == 0) {
      int a = 0, skip = 32;
      for (int k = 0; k < kAdvance; ++k) {
        advance[k] = a;
        a += skip >> 5;
        skip += skip >> 5;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();

    const int bits = min(max(32 - __clz(static_cast<unsigned>(max(n - 1, 1))), 8), 14);
    const unsigned shift = 32 - bits;
    auto hash = [shift](uint32_t x) { return static_cast<int>((x * kHashMul) >> shift); };
    const int s_limit = n - kInputMargin;
    const unsigned below = (1u << lane) - 1;  // the lanes before this one

    // The scan run: lane j of a round probes run + A[k0 + j], or, in a
    // folded round (rematch > 0), lane 0 probes rematch and lane j >= 1
    // probes run + A[k0 + j - 1].
    int next_emit = 0, run = 1, k0 = 0, rematch = 0;
    int s = -1, c = 0;  // a match the re-match probe found, else s < 0
    while (true) {
      if (s < 0) {
        const int folded = kFoldRematch && rematch > 0;
        const int k = k0 + lane - folded;
        int pos, next;
        if (k0 == 0) {  // A[k] = k for k <= 32
          pos = run + k;
          next = pos + 1;
        } else {
          pos = run + advance[min(k, kAdvance - 1)];
          next = run + advance[min(k + 1, kAdvance - 1)];
        }
        bool valid = next <= s_limit;
        if (folded && lane == 0) {
          pos = rematch;
          valid = true;
        }
        pos = min(pos, n);  // a lane past the run reads inside the staged block
        const unsigned live = __ballot_sync(kFull, valid);
        const uint32_t cur = u32_at(words, last_word, pos);
        const int h = hash(cur);
        const int h_fold = folded ? hash(u32_at(words, last_word, rematch - 1)) : -1;
        const int old = table[h];
        const int old_fold = folded ? table[h_fold] : 0;
        // Speculate that no two lanes of the round share a hash: each lane's
        // candidate is then its table entry (or the folded store's s - 1).
        int cand = h == h_fold ? rematch - 1 : old;
        unsigned hits = __ballot_sync(kFull, valid && cur == u32_at(words, last_word, cand));
        int last = hits ? __ffs(static_cast<int>(hits)) - 1 : 31 - __clz(static_cast<int>(live));
        // The lanes up to the first match store, then read back: a lane that
        // finds another's position lost its slot to a lane of the same hash.
        unsigned clash = kFull;
        if (kSpeculate) {
          if (folded && lane == 0) table[h_fold] = static_cast<uint16_t>(rematch - 1);
          if (lane <= last) table[h] = static_cast<uint16_t>(pos);
          __syncwarp();
          // One storing lane shares no slot (lane 0 stores the folded slot first).
          clash = last > 0 ? __ballot_sync(kFull, lane <= last && table[h] != pos) : 0u;
        }
        if (clash) {
          // Undo the stores, then take the round exactly: lane j's candidate
          // is the position of the highest earlier live lane of its hash.
          if (lane <= last) table[h] = static_cast<uint16_t>(old);
          if (folded && lane == 0) table[h_fold] = static_cast<uint16_t>(old_fold);
          __syncwarp();
          const unsigned same = __match_any_sync(kFull, h);
          const unsigned peers = same & live & below;
          const int peer_pos = __shfl_sync(kFull, pos, peers ? 31 - __clz(static_cast<int>(peers)) : 0);
          if (peers) cand = peer_pos;
          hits = __ballot_sync(kFull, valid && cur == u32_at(words, last_word, cand));
          last = hits ? __ffs(static_cast<int>(hits)) - 1 : kLanes - 1;
          // A lane stores only when no later storing lane shares its hash.
          const unsigned storing = (2u << last) - 1;
          const bool fold_kept = !__any_sync(kFull, lane <= last && h == h_fold);
          if (lane <= last && ((same & storing) >> lane) == 1u) table[h] = static_cast<uint16_t>(pos);
          if (folded && lane == 0 && fold_kept) table[h_fold] = static_cast<uint16_t>(rematch - 1);
          __syncwarp();
        }
        if (hits == 0 && live != kFull) {  // the run passes s_limit first
          if (next_emit < n) e.literal(next_emit, n);
          break;
        }
        if (hits == 0) {
          k0 += kLanes - folded;
          rematch = 0;
          continue;
        }
        s = __shfl_sync(kFull, pos, last);
        c = __shfl_sync(kFull, cand, last);
        if (s > next_emit) e.literal(next_emit, s);
      }
      int es = s + 4, ec = c + 4;
      while (true) {
        const int first = first_difference(words, last_word, es, ec, lane);
        const int ext = min(first, n - es);
        es += ext;
        ec += ext;
        if (first < kQuantum || ext < first) break;
      }
      e.copy(s - c, es - s);
      next_emit = es;
      if (es >= s_limit) {
        if (es < n) e.literal(es, n);
        break;
      }
      s = -1;
      run = es + 1;
      k0 = 0;
      if (kFoldRematch) {
        rematch = es;
        continue;
      }
      // The re-match probe alone, as the serial loop makes it: every lane
      // reads the slot, then lane 0 stores h(es - 1) <- es - 1 and h(es) <- es.
      const int h1 = hash(u32_at(words, last_word, es - 1));
      const uint32_t cur = u32_at(words, last_word, es);
      const int h = hash(cur);
      const int c2 = h == h1 ? es - 1 : table[h];
      __syncwarp();
      if (lane == 0) {
        table[h1] = static_cast<uint16_t>(es - 1);
        table[h] = static_cast<uint16_t>(es);
      }
      __syncwarp();
      if (cur == u32_at(words, last_word, c2)) {
        s = es;
        c = c2;
      }
      rematch = 0;
    }
  }

  if (lane == 0) out_len[b] = e.d;
  // Zero the row past out_len: bytes up to a 16-byte boundary, then words.
  uint8_t* row = e.row;
  const int d16 = min((e.d + 15) & ~15, kOutW);
  for (int k = e.d + lane; k < d16; k += kLanes) row[k] = 0;
  uint4* rw = reinterpret_cast<uint4*>(row);
  for (int w = d16 / 16 + lane; w < kOutW / 16; w += kLanes) rw[w] = make_uint4(0, 0, 0, 0);
}

}  // namespace

// blocks: (n_rows, row_w) uint8, 16-byte aligned, row_w % 128 == 0 and
// <= 65536; lens: (n_rows,) int32 in [0, row_w]; out: (n_rows, 76800)
// uint8; out_len: (n_rows,) int32.
extern "C" int stpu_cuda_encode(const uint8_t* blocks, int64_t row_w, const int32_t* lens,
                                int64_t n_rows, uint8_t* out, int32_t* out_len,
                                void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  encode_kernel<<<static_cast<unsigned>(n_rows), kLanes, kSmem,
                  static_cast<cudaStream_t>(stream)>>>(blocks, row_w, lens, out, out_len);
  return static_cast<int>(cudaGetLastError());
}
"""

ENCODE_SMEM = "constexpr int kSmem = "
FIRST_LITERAL_LOAD = "out[d + i] = src[w1 + i];"
CURRENT_LITERAL_LOAD = "lit_byte[u] ? src[w1 + j] : 0;"
DOUBLING = "while (__syncthreads_or(any)) {"
WINDOW = "constexpr int kWindowSteps = 4;"
HOP_BATCH = "constexpr int kHopBatch = 8;"
# Clock stamps in the current K10, taken by thread 0 (whose view of the
# CTA's progress the barriers fix): each pass's record loads, scan and checks
# (a), its record starts' bits and counts (b) and its first hops (c), summed
# over the passes; then the doubling and the bytes out. Written over the
# first 20 bytes of the row at the end (the row's bytes are lost).
PHASE_STAMPS = [
    ("  bool stopped = false;\n",
     "  bool stopped = false;\n  long long acc_a = 0, acc_b = 0, acc_c = 0, tp = 0;\n"),
    ("    if (t == 0) first_bad = kPass;\n", "    if (t == 0) first_bad = kPass;\n    tp = clock64();\n"),
    ("    const int fb = first_bad;\n",
     "    acc_a += clock64() - tp;\n    tp = clock64();\n    const int fb = first_bad;\n"),
    ("    // First hops: a literal byte its own position",
     "    acc_b += clock64() - tp;\n    tp = clock64();\n    // First hops: a literal byte its own position"),
    ("    stopped = fb < kPass;\n    __syncthreads();\n",
     "    stopped = fb < kPass;\n    __syncthreads();\n    acc_c += clock64() - tp;\n"),
    ("  const int end = carry;\n", "  const long long t1 = clock64();\n  const int end = carry;\n"),
    ("  // 4: the bytes, zero from end on, 16 a store.\n",
     "  const long long t2 = clock64();\n  // 4: the bytes, zero from end on, 16 a store.\n"),
    ("    out[c] = make_uint4(v[0], v[1], v[2], v[3]);\n  }\n}\n",
     "    out[c] = make_uint4(v[0], v[1], v[2], v[3]);\n  }\n  __syncthreads();\n"
     "  if (t == 0) {\n    const long long t3 = clock64();\n"
     "    out[0] = make_uint4(static_cast<uint32_t>(acc_a), static_cast<uint32_t>(acc_b),\n"
     "                        static_cast<uint32_t>(acc_c), static_cast<uint32_t>(t2 - t1));\n"
     "    out[1] = make_uint4(static_cast<uint32_t>(t3 - t2), 0u, 0u, 0u);\n  }\n}\n"),
]
PHASES = ("records_scan_checks", "start_bits_and_counts", "first_hops", "doubling", "bytes_out")

SINGLE_BLOCKS = {
    "empty": lambda load: b"",
    "fireworks.jpeg": lambda load: load("fireworks.jpeg")[:65536],
    "alice29.txt": lambda load: load("alice29.txt")[:65536],
    "abcdefgh": lambda load: b"abcdefgh" * 8192,
    "html": lambda load: load("html")[:65536],
    "kppkn.gtb": lambda load: load("kppkn.gtb")[:65536],
}


def _set(text: str, switch: str, value: bool) -> str:
    """``text`` with ``constexpr bool <switch>`` set to ``value``."""
    for v in ("true", "false"):
        line = f"constexpr bool {switch} = {v};"
        if line in text:
            return text.replace(line, f"constexpr bool {switch} = {str(value).lower()};")
    raise SystemExit(f"encode_records_probe: no {switch} switch in the source")


def _swap(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"encode_records_probe: {old!r} is not in the source")
    return text.replace(old, new)


def _stamped(rec: str) -> str:
    """The current K10 with clock stamps; only its first row-record kernel
    (the CTA path) is stamped."""
    head, tail = rec.split("records_row_kernel(", 1)
    kernel, rest = tail.split("\n}\n", 1)
    kernel += "\n}\n"
    for old, new in PHASE_STAMPS:
        kernel = _swap(kernel, old, new)
    return head + "records_row_kernel(" + kernel + rest


def variants(families) -> dict[str, tuple[str, str]]:
    """``name: (kernel, source text)`` of the chosen families, ``kernel``
    "encode" or "records"."""
    out = {}
    if "first" in families:
        out.update({
            "first_encode": ("encode", FIRST_ENCODE),
            # 40,000 bytes more leave room for one CTA an SM (228 KB a SM).
            "first_encode_1cta": ("encode", _swap(FIRST_ENCODE, ENCODE_SMEM, ENCODE_SMEM + "40000 + ")),
            "first_records": ("records", FIRST_RECORDS),
            "first_records_const_literal": ("records", _swap(
                FIRST_RECORDS, FIRST_LITERAL_LOAD, "out[d + i] = 0x61;")),
        })
    if "current" in families:
        csrc = os.path.join(HERE, "snappy_tpu_torch", "csrc")
        with open(os.path.join(csrc, "encode.cu")) as f, open(os.path.join(csrc, "records.cu")) as g:
            enc, rec = f.read(), g.read()
        switched = SWITCHED_ENCODE
        staged = _set(switched, "kStageBlock", True)
        out.update({
            "current_encode": ("encode", enc),
            "current_encode_switched": ("encode", switched),
            "current_encode_staged": ("encode", staged),
            "current_encode_folded": ("encode", _set(switched, "kFoldRematch", True)),
            "current_encode_staged_folded": ("encode", _set(staged, "kFoldRematch", True)),
            "current_encode_staged_folded_match_any": ("encode", _set(
                _set(staged, "kFoldRematch", True), "kSpeculate", False)),
            # 22,000 and 42,000 bytes more: 4 and 3 CTAs an SM, more L1 each.
            "current_encode_4cta": ("encode", _swap(enc, ENCODE_SMEM, ENCODE_SMEM + "22000 + ")),
            "current_encode_3cta": ("encode", _swap(enc, ENCODE_SMEM, ENCODE_SMEM + "42000 + ")),
            "current_records": ("records", rec),
            "current_records_const_literal": ("records", _swap(
                rec, CURRENT_LITERAL_LOAD, "lit_byte[u] ? 0x61 : 0;")),
            "current_records_phase_clocks": ("records", _stamped(rec)),
            "current_records_no_doubling": ("records", _swap(
                rec, DOUBLING, "while (false && __syncthreads_or(any)) {")),
            **{f"current_records_window_{k}": ("records", _swap(
                rec, WINDOW, f"constexpr int kWindowSteps = {k};")) for k in (1, 2, 8)},
            "current_records_hop_batch_4": ("records", _swap(
                rec, HOP_BATCH, "constexpr int kHopBatch = 4;")),
        })
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("encode_records_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from pathlib import Path

    import snappy_tpu_torch
    from snappy_tpu_torch import native
    from snappy_tpu_torch.format.varint import read_varu64, write_varu64
    from snappy_tpu_torch.ops import _build, api, encode, packing, records

    dev = torch.device("cuda")

    def smi(query):
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]

    families = [a for a in sys.argv[1:] if a in ("first", "current")] or ["first", "current"]
    card = smi("name,power.limit")
    sm_mhz = int(smi("clocks.max.sm").split()[0])
    out_dir = Path(HERE) / "build" / "encode_records_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    kinds, jobs = {}, []
    for name, (kind, text) in variants(families).items():
        (out_dir / f"{name}.cu").write_text(text)
        jobs.append((out_dir / f"{name}.cu", [_build._nvcc(), *_build.NVCC_FLAGS]))
        kinds[name] = kind
    paths = _build.compile_all(jobs)
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    libs = {}
    for (src, _), path in zip(jobs, paths):
        lib = ctypes.CDLL(str(path))
        if kinds[src.stem] == "encode":
            fn = lib.stpu_cuda_encode
            fn.argtypes = [p, i64, p, i64, p, p, p]
        else:
            fn = lib.stpu_cuda_records
            fn.argtypes = [p, i64, i64, p, i64, p, p, i64, p, p]
        fn.restype = ctypes.c_int
        libs[src.stem] = fn
    report = {"card": card, "sm_max_mhz": sm_mhz, "device_ms": {}, "equal": {},
              "ptxas": {src.stem: [ln.strip() for ln in path.with_suffix(".log").read_text()
                                   .splitlines() if "registers" in ln or "spill" in ln]
                        for (src, _), path in zip(jobs, paths)}}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def encoder(fn, bt, lt):
        def call():
            out = torch.empty((bt.shape[0], encode.OUT_W), dtype=torch.uint8, device=dev)
            out_len = torch.empty(bt.shape[0], dtype=torch.int32, device=dev)
            _build.check(fn(bt.data_ptr(), bt.shape[1], lt.data_ptr(), bt.shape[0],
                            out.data_ptr(), out_len.data_ptr(), stream()), "probe")
            return out, out_len
        return call

    def host_bodies(datas):
        bodies = []
        for d in datas:
            c = native.compress(d)
            bodies.append(c[read_varu64(c)[1]:] if d else b"")
        return bodies

    def exact(call, bodies):
        out, out_len = (x.cpu().numpy() for x in call())
        return all(out[i, : out_len[i]].tobytes() == b and not out[i, out_len[i]:].any()
                   for i, b in enumerate(bodies))

    def load(name):
        with open(os.path.join(HERE, "data", name), "rb") as f:
            return f.read()

    # -- K7 on single blocks: clocks per step kind --------------------------------
    enc_names = [n for n, k in kinds.items() if k == "encode"]
    singles = {}
    for block, make in SINGLE_BLOCKS.items():
        d = make(load)
        rows, lens = packing.batch_streams([d], 65536)
        op_kind, _, _, nops, _, rounds, quanta, probes = encode.find_ops_rounds(rows, lens)
        copies = int((op_kind[0, : int(nops[0])] == 1).sum())
        bt, lt = torch.from_numpy(rows).to(dev), torch.from_numpy(lens).to(dev)
        calls = {n: encoder(libs[n], bt, lt) for n in enc_names}
        body = host_bodies([d])
        entry = {"bytes": len(d), "probes": int(probes[0]), "quanta": int(quanta[0]),
                 "copies": copies, "rounds": int(rounds[0]), "device_ms": {}}
        for n in enc_names:
            report["equal"][f"{n}:{block}"] = exact(calls[n], body)
        for n in [*enc_names, *reversed(enc_names)]:
            entry["device_ms"].setdefault(n, []).append(chip_smoke.device_ms(calls[n], 10))
        singles[block] = entry
    report["encode_single_blocks"] = singles
    fit = {}
    for n in enc_names:
        per = "probes" if n.startswith("first") else "rounds"
        a = np.array([[1.0, e[per], e["quanta"], e["copies"]] for e in singles.values()])
        t = np.array([min(e["device_ms"][n]) for e in singles.values()]) * 1e-3 * sm_mhz * 1e6
        coef = np.linalg.lstsq(a, t, rcond=None)[0]
        fit[n] = {"clocks_per_block": coef[0], f"clocks_per_{per[:-1]}": coef[1],
                  "clocks_per_quantum": coef[2], "clocks_per_copy": coef[3]}
    report["encode_clock_fit"] = fit

    # -- K7 on the compress group -------------------------------------------------
    data = chip_smoke.corpus_stream(chip_smoke.STREAM_BYTES)
    cblocks, clens = packing.blocks_of(data)
    n_rows = packing.pad_to_bucket(len(clens), 1)
    pad = n_rows - len(clens)
    cb = torch.from_numpy(np.concatenate([cblocks, np.zeros((pad, cblocks.shape[1]), np.uint8)])).to(dev)
    cl = torch.from_numpy(np.concatenate([clens, np.zeros(pad, np.int32)])).to(dev)
    datas = [cblocks[i, : clens[i]].tobytes() for i in range(len(clens))] + [b""] * pad
    bodies = host_bodies(datas)
    calls = {n: encoder(libs[n], cb, cl) for n in enc_names}
    group = {"rows": n_rows, "live": int((clens > 0).sum()), "device_ms": {}}
    for n in enc_names:
        report["equal"][f"{n}:group"] = exact(calls[n], bodies)
    for n in [*enc_names, *reversed(enc_names)]:
        group["device_ms"].setdefault(n, []).append(chip_smoke.device_ms(calls[n], 3))
    report["encode_group"] = group
    del cb, cl, calls

    # -- K10 on the frame's largest launch group ----------------------------------
    frame = native.frame_compress(data)
    chunks = chip_smoke.compressed_chunks(frame)
    fbodies = [c[0] for c in chunks]
    groups = api.launch_groups(fbodies, snappy_tpu_torch.get_config().decode_rows_per_launch)
    g = max(groups, key=len)
    gd = [chunks[i][1] for i in g]
    srcs, glens = packing.batch_streams([fbodies[i] for i in g], api._width_bucket(len(fbodies[g[0]])))
    d_pad = packing.pad_to_bucket(max(gd), 1024)
    rec_cap = api._record_cap(srcs.shape[1])
    recs, nops, herrs, _ = native.scan_records_batch(
        srcs, glens.astype(np.uint64), np.asarray(gd, np.uint64), rec_cap)
    assert int(nops.max()) <= rec_cap and not herrs.any()
    r_pad = max(512, -(-int(nops.max()) // 512) * 512)
    s_t, r_t, n_t, d_t = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        srcs, recs[:, :r_pad], nops.astype(np.int32), np.asarray(gd, np.int32)))
    expect = np.zeros((len(g), d_pad), np.uint8)
    for j, d in enumerate(native.decompress_batch([write_varu64(gd[j]) + fbodies[i]
                                                   for j, i in enumerate(g)])):
        expect[j, : gd[j]] = np.frombuffer(d, np.uint8)
    want = records.decode_records_plain(s_t, r_t, n_t, d_t, d_pad)
    b, s = s_t.shape

    def replayer(fn):
        def call():
            out = torch.empty((b, d_pad), dtype=torch.uint8, device=dev)
            _build.check(fn(s_t.data_ptr(), b, s, r_t.data_ptr(), r_pad, n_t.data_ptr(),
                            d_t.data_ptr(), d_pad, out.data_ptr(), stream()), "probe")
            return out
        return call

    rec_names = [n for n, k in kinds.items() if k == "records"]
    calls = {n: replayer(libs[n]) for n in rec_names}
    for n in rec_names:
        if not any(a in n for a in ("const_literal", "no_doubling", "phase_clocks")):
            got = calls[n]()
            report["equal"][f"{n}:group"] = bool(torch.equal(got, want)
                                                 and (got.cpu().numpy() == expect).all())
    rgroup = {"rows": b, "d_pad": d_pad, "records": int(nops.sum()), "device_ms": {}}
    if "current_records_phase_clocks" in calls:
        stamps = calls["current_records_phase_clocks"]()[:, :20].cpu().numpy().view(np.uint32)
        rgroup["phase_clocks_mean"] = dict(zip(PHASES, stamps.mean(0).tolist()))
        rgroup["phase_clocks_max"] = dict(zip(PHASES, stamps.max(0).tolist()))
    for n in [*rec_names, *reversed(rec_names)]:
        rgroup["device_ms"].setdefault(n, []).append(chip_smoke.device_ms(calls[n], 10))
    report["records_group"] = rgroup

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "encode_records_probe.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if all(report["equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
