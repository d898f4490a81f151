"""What binds the segment parse (K4) and the fused chain resolution (K8) on
one NVIDIA GPU: a probe.

    python3 resolve_parse_probe.py [first] [current]

Needs a CUDA card and ``nvcc``. Builds variants of both kernels from text
into ``build/resolve_parse_probe/`` and times each with CUDA events as the
replay of a CUDA graph of several calls (``chip_smoke.device_ms``), in two
turns (forward, then reverse):

- K4 on ``chip_smoke.py``'s compress group (the 64 MiB + 5,000-byte
  stream's 1,025 blocks in 2,048 rows, 1,023 of them padding), as first
  ported (``first_parse``, kept below as text) and with one change each:
  its record stores dropped (only ``cnt`` written); its padding rows
  returning at once after writing their zeros with coalesced 16-byte
  stores; its block read in place through L1 instead of staged in shared
  memory (more CTAs an SM); and its walk alone, every read of the block's
  bytes replaced by a constant that ends each extension at once (the
  chain of jump-word loads);
- K8 on the frame's largest launch group (455 rows, ``d_pad`` 65536, the
  host's record scan), as first ported (``first_resolve``) and with clock
  stamps per phase (written over each row's first values): each tile's
  binary search and first hop, its rounds, its plane store, and the
  rounds a tile takes;
- ``current_*``: ``snappy_tpu_torch/csrc/parse.cu`` and ``resolve.cu`` as
  they stand, with the designs they were measured against (see
  ``current_variants``), and K8 with clock stamps per phase.

Every exact variant must equal its kernel's plain version (K4: the
records bit for bit; K8: the whole plane). A variant that does not build
is reported and skipped, and the run then fails.
Prints one JSON object and writes it to
``chiprun_out/resolve_parse_probe.json``.
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

FIRST_PARSE = r"""
// Segment parse of the flat encoder: 128 independent greedy walks per
// 64 KiB block, one per 512-byte segment, over the prepass's jump words.
//
// Replaces: snappy_tpu/ops/pallas/encode_flat.py parse_blocks_pallas
// (_make_parse_kernel). The TPU kernel runs the 128 walks in lockstep, one
// per vector sublane, reads each segment's jump word with a masked
// multiply-reduce and routes the match-extension bytes at q = p - off
// through one-hot matrix products against four byte-shifted bf16 planes of
// the block, because Mosaic has no gather. Here a walk is a thread and both
// reads are loads: the block's bytes are staged once in shared memory, so
// the u32 reads at p and at q are four shared-memory byte loads each, and the
// byte planes are not needed.
//
// What bounds it: device-memory bytes. Each live block reads its 256 KiB of
// jump words (each walk reads only the words it lands on, so less in
// practice) and its 64 KiB of bytes; every row writes 144 KiB of records.
// The walks are serial chains of dependent loads, so the kernel's speed is
// latency: a block of 128 threads takes 64 KiB of shared memory, three fit
// an SM, and the grid has one block per row.
//
// Semantics kept bit for bit (ops/pallas/encode_flat.py:129-190): a found
// candidate starts its extension in the same step; offc starts at 1; the
// u32 read at p clips its column to the segment, the read at q clips its row
// to [0, 511] over the block with zeros past byte 65535; adv =
// min(tz_bytes(x), max(rem, 0)); a record is written only while k < MAX_REC,
// and a segment that is full when a copy ends parks at hi; unused slots are
// zero; cnt[..., 1] = k >= MAX_REC.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kS = 65536;
constexpr int kSeg = 512;
constexpr int kNSeg = 128;
constexpr int kMaxRec = 144;
constexpr int32_t kJwCand = 1 << 27;
constexpr int kSmem = kS + 16;  // the block, then zeros for reads past its end

__device__ __forceinline__ uint32_t u32_at(const uint8_t* s, int pos) {
  return uint32_t{s[pos]} | uint32_t{s[pos + 1]} << 8 | uint32_t{s[pos + 2]} << 16 |
         uint32_t{s[pos + 3]} << 24;
}

__device__ __forceinline__ int tz_bytes(uint32_t x) {
  return x ? (__ffs(static_cast<int>(x)) - 1) >> 3 : 4;
}

__global__ void __launch_bounds__(kNSeg)
parse_kernel(const int32_t* __restrict__ lens, const int32_t* __restrict__ jw,
             const uint8_t* __restrict__ blocks, int32_t* __restrict__ rec0,
             int32_t* __restrict__ rec1, int32_t* __restrict__ cnt) {
  extern __shared__ uint4 smem_words[];
  uint8_t* blk = reinterpret_cast<uint8_t*>(smem_words);
  const int64_t b = blockIdx.x;
  const int s = threadIdx.x;

  const uint4* src = reinterpret_cast<const uint4*>(blocks + b * kS);
  for (int i = s; i < kS / 16; i += kNSeg) smem_words[i] = src[i];
  if (s == 0) smem_words[kS / 16] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int n = lens[b];
  const int lo = s * kSeg;
  const int hi = min(lo + kSeg, n);
  const int32_t* jrow = jw + (b * kNSeg + s) * kSeg;
  int32_t* r0 = rec0 + (b * kNSeg + s) * kMaxRec;
  int32_t* r1 = rec1 + (b * kNSeg + s) * kMaxRec;

  int p = lo, lp = 0, offc = 1, k = 0;
  bool extending = false;
  while (p < hi) {
    if (!extending) {
      const int32_t w = jrow[min(max(p - lo, 0), kSeg - 1)];
      if (!(w & kJwCand)) {  // hop to the next candidate of the segment
        p = lo + (w & 0x3FF);
        continue;
      }
      lp = (w >> 16) & 0x3FF;  // the candidate extends in this same step
      offc = w & 0xFFFF;
    }
    const int a_p = p + lp;
    const uint32_t up = u32_at(blk, lo + min(max(a_p - lo, 0), kSeg - 1));
    const int a = max(a_p - offc, 0);
    const uint32_t uq = u32_at(blk, min(a >> 7, 511) * 128 + (a & 127));
    const int adv = min(tz_bytes(up ^ uq), max(hi - a_p, 0));
    const int new_lp = lp + adv;
    if (adv == 4 && p + new_lp < hi) {
      extending = true;
      lp = new_lp;
      continue;
    }
    if (k < kMaxRec) {
      r0[k] = (p - lo) | (new_lp << 10);
      r1[k] = offc;
      k++;
      p += new_lp;
    } else {
      p = hi;  // overflowing segments park at the segment end
    }
    extending = false;
    lp = 0;
  }
  for (int j = k; j < kMaxRec; j++) {
    r0[j] = 0;
    r1[j] = 0;
  }
  int32_t* c = cnt + (b * kNSeg + s) * 8;
  c[0] = k;
  c[1] = k >= kMaxRec;
  for (int j = 2; j < 8; j++) c[j] = 0;
}

}  // namespace

extern "C" int stpu_cuda_parse(const int32_t* lens, const int32_t* jw,
                               const uint8_t* blocks, int64_t n_rows, int32_t* rec0,
                               int32_t* rec1, int32_t* cnt, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  parse_kernel<<<static_cast<unsigned>(n_rows), kNSeg, kSmem,
                 static_cast<cudaStream_t>(stream)>>>(lens, jw, blocks, rec0, rec1, cnt);
  return static_cast<int>(cudaGetLastError());
}
"""

FIRST_RESOLVE = r"""
// Copy-chain resolution from the host's op records: every output byte's
// literal origin, FLAG + its source index (FLAG = 1 << 17).
//
// Replaces: snappy_tpu/ops/pallas/resolve.py resolve_fh_pallas
// (_make_resolve_fh_kernel; K8 here, stpu_cuda_resolve_fh) and resolve_pallas
// (_make_resolve_kernel; K9 here, stpu_cuda_resolve). K8 builds each byte's
// first hop from the records itself; K9 reads it from the plane that
// ops/resolve.py records_to_pointers makes. A first hop is FLAG + content + j
// for the j-th byte of a literal (resolved), start - off + (j mod off) for a
// copy (an earlier output position), and exactly FLAG at and past declen.
//
// What bounds it: dependent loads. Each round of a tile reads one value per
// byte from shared memory or from the row's plane, and the rounds of a tile
// follow each other; K8 adds a binary search over the row's record starts
// per byte (about log2(records) dependent loads). The bytes it must move
// (records or the first-hop plane in, the resolved plane out) are small.
//
// Design: one CTA of 1024 threads per row, one thread per position of a
// 1024-byte tile, sweeping the tiles left to right as the TPU kernel does.
// Snappy pointers go strictly backward, so when tile t runs every position
// before it is final: a pointer into an earlier tile is resolved by one read
// of the row's plane in device memory. Pointers inside the tile jump Jacobi
// style (each round replaces a pointer by its target's value, so the hops
// covered double) over two 4 KiB buffers in shared memory, until
// __syncthreads_and says every position is >= FLAG, for at most max_rounds
// rounds (12: the TPU kernel's first round and 11 passes). Then the tile is
// stored, and a __syncthreads() makes the stores visible to the CTA's later
// reads of them; the plane is therefore read through plain loads, never the
// read-only path (no const __restrict__ on it). The TPU kernel's digit
// planes, one-hot routing matmuls, transposes and 128/256/512-row windows
// exist because Mosaic has no gather; here a gather is a load.
//
// Error rows: the scan records only the valid prefix of a corrupt row, so the
// positions past its last record extend that record; a row with no record
// (nops == 0, declen > 0) gets hop -1 everywhere, as the TPU kernel's empty
// one-hot row gives. A pointer below 0 or at or past its own position is
// never chased, and a tile over the round budget is stored as it stands, so
// such a row keeps values below FLAG and the caller flags it for fallback.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr int32_t kFlag = 1 << 17;

// Resolves position d (thread threadIdx.x of the tile starting at t0) from
// its first hop v and stores it in the row's plane.
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
resolve_fh_kernel(const int32_t* __restrict__ startsx,
                  const int32_t* __restrict__ payload, int64_t cap,
                  const int32_t* __restrict__ declens, int64_t d_pad,
                  int max_rounds, int32_t* out) {
  __shared__ int32_t buf[2 * kTile];
  const int64_t b = blockIdx.x;
  const int64_t declen = declens[b];
  const int32_t* st = startsx + b * cap;
  const int32_t* pk = payload + b * cap;
  int32_t* plane = out + b * d_pad;
  for (int64_t t0 = 0; t0 < d_pad; t0 += kTile) {
    const int64_t d = t0 + threadIdx.x;
    if (t0 >= declen) {  // the same for every thread of the row
      plane[d] = kFlag;
      continue;
    }
    int32_t v = kFlag;
    if (d < declen) {
      // The covering record: the last one whose start is at or before d
      // (records past nops carry start = declen > d).
      int64_t lo = 0, hi = cap;
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (st[mid] <= d) lo = mid + 1; else hi = mid;
      }
      int32_t start = 0, pay = 0;  // no record: a copy of offset 1 at 0
      if (lo > 0) {
        start = st[lo - 1];
        pay = pk[lo - 1];
      }
      const int32_t w1 = pay & 0x1FFFF;
      const int32_t j = static_cast<int32_t>(d) - start;
      if (pay >> 17) {
        v = kFlag + w1 + j;
      } else {
        const int32_t off = max(w1, 1);
        v = start - off + (j < off ? j : j % off);
      }
    }
    resolve_tile(v, d, t0, plane, buf, max_rounds);
  }
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

extern "C" int stpu_cuda_resolve_fh(const int32_t* startsx, const int32_t* payload,
                                    int64_t n_rows, int64_t cap,
                                    const int32_t* declens, int64_t d_pad,
                                    int max_rounds, int32_t* out, void* stream) {
  resolve_fh_kernel<<<static_cast<unsigned>(n_rows), kTile, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      startsx, payload, cap, declens, d_pad, max_rounds, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stpu_cuda_resolve(const int32_t* a0, int64_t n_rows, int64_t d_pad,
                                 int max_rounds, int32_t* out, void* stream) {
  resolve_kernel<<<static_cast<unsigned>(n_rows), kTile, 0,
                   static_cast<cudaStream_t>(stream)>>>(a0, d_pad, max_rounds, out);
  return static_cast<int>(cudaGetLastError());
}
"""

# K8 as first redesigned: the whole row in shared memory (a uint16
# plane of first hops, K10's doubling window by window, pasted in), each
# literal's value stored in the output row and every value read back from
# it; one 1024-thread CTA an SM.
ROW_VALUES_RESOLVE = r"""
// Copy-chain resolution from the host's op records: every output byte's
// literal origin, FLAG + its source index (FLAG = 1 << 17).
//
// Replaces: snappy_tpu/ops/pallas/resolve.py resolve_fh_pallas
// (_make_resolve_fh_kernel; K8 here, stpu_cuda_resolve_fh) and resolve_pallas
// (_make_resolve_kernel; K9 here, stpu_cuda_resolve). K8 builds each byte's
// first hop from the records itself; K9 reads it from the plane that
// ops/resolve.py records_to_pointers makes. A first hop is FLAG + content + j
// for the j-th byte of a literal (resolved), start - off + (j mod off) for a
// copy (an earlier output position), and exactly FLAG at and past declen.
// The TPU kernels' digit planes, one-hot routing matmuls, transposes and
// 128/256/512-row windows exist because Mosaic has no gather; here a gather
// is a load.
//
// What bounds it: the bytes are small (the records in, the resolved plane
// out), so the time is the chains of dependent reads that find each
// byte's origin, and how many of them run at once.
//
// K8 (rows of d_pad <= 65536, every row of the route): one 1024-thread CTA
// a row, as K10 (records.cu) takes a row, all in shared memory:
//  1. the records stream through in passes of 3,072 (3 a thread). A record
//     covers the bytes from its start to the next record's start, and of
//     several with one start (empty records) the last one, as the plain
//     version's searchsorted(startsx, d, right=True) - 1 picks it; records
//     at and past nops carry start = declen and cover nothing. The pass's
//     covering records are ranked by a CTA-wide scan and their starts and
//     payloads kept in order; each sets a bit at its start;
//  2. every position of the pass's span counts the start bits at or before
//     it (popc of its 32-bit word, after the warps' counts of the words
//     before) to find its record, then takes its first hop into a uint16
//     plane: a literal byte points to itself, and its final value FLAG +
//     w1 + j goes to the output row now; a copied byte gets start - off +
//     (j < off ? j : j % off), an earlier position. A first hop below 0 is
//     read at 0, as the plain version's clipped gather reads it; position 0
//     itself then stops there, keeping its first hop (< FLAG) as its value.
//     Bytes before the first record (a row with no record: all of them)
//     take start 0 and payload 0, a copy of offset 1, first hop -1;
//  3. the origins, a window of 4,096 positions at a time in order, by
//     pointer doubling in shared memory (origins.cuh, shared with K10);
//  4. out[p] = out[origin of p] (the value stored in step 2 at the root),
//     FLAG from declen on, 16,384 positions at a time in 16-byte stores, a
//     barrier between their reads and their stores.
// So the plane equals the plain version's on every row: a chain that ends
// at a literal resolves, and one that reaches below 0 takes position 0's
// value, as Jacobi doubling over a clipped gather gives (its log2(d_pad)
// rounds cover every chain, since each hop goes strictly back). The row,
// the start bits and a pass's records take 2 * d_pad + d_pad / 8 + 24 KiB
// of shared memory: one CTA an SM at d_pad 65536. Keeping each literal's
// value as its root's entry instead (roots told by a bitmask, so that the
// last step reads only shared memory) was slower on the 455-row group,
// 0.337 ms against 0.328: the bitmask's reads cost the doubling more than
// the output saved (resolve_parse_probe.py, which times the phases).
//
// K9: one CTA of 1024 threads per row, one thread per position of a
// 1024-byte tile, sweeping the tiles left to right as the TPU kernel does.
// Snappy pointers go strictly backward, so when tile t runs every position
// before it is final: a pointer into an earlier tile is resolved by one read
// of the row's plane in device memory. Pointers inside the tile jump Jacobi
// style (each round replaces a pointer by its target's value, so the hops
// covered double) over two 4 KiB buffers in shared memory, until
// __syncthreads_and says every position is >= FLAG, for at most max_rounds
// rounds (12: the TPU kernel's first round and 11 passes). Then the tile is
// stored, and a __syncthreads() makes the stores visible to the CTA's later
// reads of them; the plane is therefore read through plain loads, never the
// read-only path (no const __restrict__ on it). A pointer below 0 or at or
// past its own position is never chased, and a tile over the round budget
// is stored as it stands, so such a row keeps values below FLAG and the
// caller flags it for fallback.

#include <cstdint>
#include <cuda_runtime.h>

// Every position's origin in a hop plane held in shared memory, by pointer
// doubling window by window: the step that K8 (resolve.cu) and K10
// (records.cu) share.
//
// hop[p] (uint16: rows of at most 65536 positions) is p itself at a root
// (a literal byte, or a position whose chain stops there) and an earlier
// position otherwise. Windows of kThreads * kSteps positions are settled in
// order, so when a window starts every hop before it is a root: a first hop
// that leaves the window finds its root there at once. The chains inside
// the window are settled by pointer doubling, hop[p] = hop[hop[p]] in place
// (a read sees the old or the new value, both on p's chain), until no
// thread has one left (__syncthreads_or). On return hop[p] is p's root for
// every p < end.

#include <cstdint>

template <int kThreads, int kSteps>
__device__ __forceinline__ void settle_origins(uint16_t* hop, int end) {
  constexpr int kWindow = kSteps * kThreads;
  const int t = threadIdx.x;
  for (int base = 0; base < end; base += kWindow) {
    int h[kSteps];
    bool open[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) h[u] = base + u * kThreads + t < end ? hop[base + u * kThreads + t] : 0;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int p = base + u * kThreads + t;
      if (p < end && h[u] < base) {
        h[u] = hop[h[u]];
        hop[p] = static_cast<uint16_t>(h[u]);
      }
      open[u] = p < end && h[u] >= base && h[u] != p;  // a byte of this window, maybe copied
    }
    bool any = false;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) any |= open[u];
    while (__syncthreads_or(any)) {
      any = false;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (!open[u]) continue;
        const int h2 = hop[h[u]];
        if (h2 == h[u]) {
          open[u] = false;  // h is a root
        } else {
          h[u] = h2;
          hop[base + u * kThreads + t] = static_cast<uint16_t>(h2);
          open[u] = h2 >= base;
          any |= open[u];
        }
      }
    }
  }
}

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kTile = 1024;
constexpr int32_t kFlag = 1 << 17;
constexpr int kThreads = 1024;     // K8's CTA
constexpr int kPerThread = 3;      // records a thread takes in a pass
constexpr int kPass = kPerThread * kThreads;
constexpr int kMaxRow = 65536;     // widest row K8 takes (uint16 hops)
constexpr int kWindowSteps = 4;    // positions a thread takes in a window
constexpr int kHopBatch = 8;       // words of first hops a warp takes at once
constexpr int kOutSteps = 4;       // runs of 4 values a thread reads before a barrier

// Inclusive scan of x over the CTA (warp_sums: a word a warp); returns the
// sum of the threads before this one.
__device__ __forceinline__ int exclusive_scan(int x, int* warp_sums) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int mine = x;
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == kWarp - 1) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  return x - mine + (warp ? warp_sums[warp - 1] : 0);
}

__global__ void __launch_bounds__(kThreads, 1)
resolve_fh_kernel(const int32_t* __restrict__ startsx,
                  const int32_t* __restrict__ payload, int64_t cap,
                  const int32_t* __restrict__ declens, int d_pad, int32_t* out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* hop = reinterpret_cast<uint16_t*>(smem);  // first hops, then origins
  uint32_t* starts = reinterpret_cast<uint32_t*>(smem + 2 * d_pad);  // a bit per covering start
  int* start_of = reinterpret_cast<int*>(starts + d_pad / 32);       // a pass's covering records
  int* pay_of = start_of + kPass;
  __shared__ int warp_sums[kThreads / kWarp];

  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t % kWarp, warp = t / kWarp;
  const int32_t* st = startsx + b * cap;
  const int32_t* pk = payload + b * cap;
  int32_t* row = out + b * static_cast<int64_t>(d_pad);
  const int lim = static_cast<int>(max(min(static_cast<int64_t>(declens[b]), static_cast<int64_t>(d_pad)),
                                       int64_t{0}));
  for (int w = t; w < d_pad / 32; w += kThreads) starts[w] = 0;
  __syncthreads();

  // 1-2, a pass at a time; carry is where the pass's span starts, the same
  // in every thread.
  int carry = 0;
  for (int64_t j0 = 0; j0 < cap && carry < lim; j0 += kPass) {
    int s[kPerThread + 1], pv[kPerThread];
#pragma unroll
    for (int u = 0; u <= kPerThread; ++u) {
      const int64_t j = j0 + kPerThread * t + u;
      s[u] = j < cap ? st[j] : INT32_MAX;
      if (u < kPerThread) pv[u] = j < cap ? pk[j] : 0;
    }
    bool covers[kPerThread];
    int x = 0;
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      covers[u] = s[u] >= carry && s[u] < lim && s[u] != s[u + 1];
      x += covers[u];
    }
    int rank = exclusive_scan(x, warp_sums);
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      if (!covers[u]) continue;
      start_of[rank] = s[u];
      pay_of[rank] = pv[u];
      atomicOr(starts + (s[u] >> 5), 1u << (s[u] & 31));
      rank++;
    }
    const int64_t jn = j0 + kPass;
    const int hi = jn < cap ? min(max(st[jn], carry), lim) : lim;
    __syncthreads();
    // Each warp takes a run of the span's 32-position words. The starts at
    // or before a position, counted from the pass's first, give its record.
    const int w_lo = carry >> 5, w_hi = (hi + 31) >> 5;
    const int per_warp = (w_hi - w_lo + kWarp - 1) / kWarp;
    const int wa = w_lo + warp * per_warp, wb = min(wa + per_warp, w_hi);
    const uint32_t from_carry = ~0u << (carry & 31);  // the first word's bits from carry on
    int count = 0;
    for (int w = wa + lane; w < wb; w += kWarp)
      count += __popc(starts[w] & (w == w_lo ? from_carry : ~0u));
    count = __reduce_add_sync(kAll, count);
    int before = exclusive_scan(lane == 0 ? count : 0, warp_sums);  // the pass's starts before
    before = __shfl_sync(kAll, before, 0);
    const uint32_t upto = 0xFFFFFFFFu >> (kWarp - 1 - lane);  // bits at or below this lane
    for (int w0 = wa; w0 < wb; w0 += kHopBatch) {
      int p[kHopBatch], hv[kHopBatch], val[kHopBatch];
#pragma unroll
      for (int u = 0; u < kHopBatch; ++u) {
        const int w = w0 + u;
        const uint32_t bits = w < wb ? starts[w] & (w == w_lo ? from_carry : ~0u) : 0u;
        p[u] = w < wb && 32 * w + lane >= carry && 32 * w + lane < hi ? 32 * w + lane : -1;
        const int i = min(before + __popc(bits & upto) - 1, kPass - 1);
        before += __popc(bits);
        const int start = i >= 0 ? start_of[i] : 0;  // before the first record: a copy
        const int pay = i >= 0 ? pay_of[i] : 0;      // of offset 1 at 0
        const int w1 = pay & 0x1FFFF;
        const int j = p[u] - start;
        if ((pay >> 17) == 1) {
          hv[u] = p[u];
          val[u] = kFlag + w1 + j;
        } else {
          const int off = max(w1, 1);
          const int h = start - off + (j < off ? j : j % off);
          hv[u] = h >= 0 && h < p[u] ? h : (h < 0 && p[u] > 0 ? 0 : p[u]);
          val[u] = h;  // stored only where the chain stops here
        }
      }
#pragma unroll
      for (int u = 0; u < kHopBatch; ++u) {
        if (p[u] < 0) continue;
        hop[p[u]] = static_cast<uint16_t>(hv[u]);
        if (hv[u] == p[u]) row[p[u]] = val[u];
      }
    }
    carry = hi;
    __syncthreads();
  }

  // 3: every position's root.
  settle_origins<kThreads, kWindowSteps>(hop, lim);

  // 4: the roots' values, FLAG from lim on, kOutSteps runs of 4 positions
  // a thread a window (its loads in flight together).
  for (int base = 0; base < d_pad; base += 4 * kOutSteps * kThreads) {
    int v[kOutSteps][4];
#pragma unroll
    for (int u = 0; u < kOutSteps; ++u) {
      const int p0 = base + 4 * (u * kThreads + t);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[u][i] = p0 + i < lim ? row[hop[p0 + i]] : kFlag;
    }
    if (base < lim) __syncthreads();  // the same in every thread
#pragma unroll
    for (int u = 0; u < kOutSteps; ++u) {
      const int p0 = base + 4 * (u * kThreads + t);
      if (p0 < d_pad) reinterpret_cast<int4*>(row)[p0 / 4] = make_int4(v[u][0], v[u][1], v[u][2], v[u][3]);
    }
    if (base < lim) __syncthreads();
  }
}

// K9: resolves position d (thread threadIdx.x of the tile starting at t0)
// from its first hop v and stores it in the row's plane.
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

// startsx, payload: (n_rows, cap) int32 (ops/resolve.py
// records_to_kernel_inputs); declens: (n_rows,) int32; out: (n_rows, d_pad)
// int32, d_pad a multiple of 1024 up to 65536.
extern "C" int stpu_cuda_resolve_fh(const int32_t* startsx, const int32_t* payload,
                                    int64_t n_rows, int64_t cap,
                                    const int32_t* declens, int64_t d_pad,
                                    int32_t* out, void* stream) {
  if (d_pad <= 0 || d_pad > kMaxRow || d_pad % kTile) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * static_cast<int>(d_pad) + static_cast<int>(d_pad) / 8 + 2 * kPass * 4;
  const cudaError_t e = cudaFuncSetAttribute(
      resolve_fh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  resolve_fh_kernel<<<static_cast<unsigned>(n_rows), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      startsx, payload, cap, declens, static_cast<int>(d_pad), out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stpu_cuda_resolve(const int32_t* a0, int64_t n_rows, int64_t d_pad,
                                 int max_rounds, int32_t* out, void* stream) {
  resolve_kernel<<<static_cast<unsigned>(n_rows), kTile, 0,
                   static_cast<cudaStream_t>(stream)>>>(a0, d_pad, max_rounds, out);
  return static_cast<int>(cudaGetLastError());
}
"""

# The same with each literal's value kept as its root's uint16 entry and the roots
# told by a bitmask (so that the last step reads only shared memory; the
# output row only for a value that does not fit below 0xFFFF), with the
# doubling header it needs (roots told by a predicate) pasted in.
ROOT_BITS_RESOLVE = r"""
// Copy-chain resolution from the host's op records: every output byte's
// literal origin, FLAG + its source index (FLAG = 1 << 17).
//
// Replaces: snappy_tpu/ops/pallas/resolve.py resolve_fh_pallas
// (_make_resolve_fh_kernel; K8 here, stpu_cuda_resolve_fh) and resolve_pallas
// (_make_resolve_kernel; K9 here, stpu_cuda_resolve). K8 builds each byte's
// first hop from the records itself; K9 reads it from the plane that
// ops/resolve.py records_to_pointers makes. A first hop is FLAG + content + j
// for the j-th byte of a literal (resolved), start - off + (j mod off) for a
// copy (an earlier output position), and exactly FLAG at and past declen.
// The TPU kernels' digit planes, one-hot routing matmuls, transposes and
// 128/256/512-row windows exist because Mosaic has no gather; here a gather
// is a load.
//
// What bounds it: the bytes are small (the records in, the resolved plane
// out), so the time is the chains of dependent reads that find each
// byte's origin, and how many of them run at once.
//
// K8 (rows of d_pad <= 65536, every row of the route): one 1024-thread CTA
// a row, as K10 (records.cu) takes a row, all in shared memory:
//  1. the records stream through in passes of 3,072 (3 a thread). A record
//     covers the bytes from its start to the next record's start, and of
//     several with one start (empty records) the last one, as the plain
//     version's searchsorted(startsx, d, right=True) - 1 picks it; records
//     at and past nops carry start = declen and cover nothing. The pass's
//     covering records are ranked by a CTA-wide scan and their starts and
//     payloads kept in order; each sets a bit at its start;
//  2. every position of the pass's span counts the start bits at or before
//     it (popc of its 32-bit word, after the warps' counts of the words
//     before) to find its record, then takes its entry in a uint16 plane.
//     A copied byte gets its first hop, start - off + (j < off ? j : j %
//     off), an earlier position (always: off >= 1). A literal byte is a
//     root (a bit in a second bitmask, a warp's ballot a word) and keeps
//     its source index w1 + j as its entry. A first hop below 0 is read at
//     0, as the plain version's clipped gather reads it; position 0 itself
//     is then a root whose value is that first hop (< FLAG). Bytes before
//     the first record (a row with no record: all of them) take start 0
//     and payload 0, a copy of offset 1, first hop -1. A root whose value
//     does not fit below 0xFFFF gets the entry 0xFFFF and its value in the
//     output row (never on the route's rows but position 0 of a row with
//     no record: sources are at most 64 KiB);
//  3. the origins, a window of 4,096 positions at a time in order, by
//     pointer doubling in shared memory (origins.cuh, shared with K10);
//  4. out[p] = FLAG + the entry of p's root (from the row for 0xFFFF),
//     FLAG from declen on, in 16-byte stores. All reads are of shared
//     memory, except a 0xFFFF root's; only a row that has one reads the
//     output row, 16,384 positions at a time, with a barrier between their
//     reads and their stores.
// So the plane equals the plain version's on every row: a chain that ends
// at a literal resolves, and one that reaches below 0 takes position 0's
// value, as Jacobi doubling over a clipped gather gives (its log2(d_pad)
// rounds cover every chain, since each hop goes strictly back). The plane,
// two bitmasks and a pass's records take 2 * d_pad + d_pad / 4 + 24 KiB of
// shared memory: one CTA an SM at d_pad 65536. Storing the roots' values
// in the output row and reading every one back in step 4 took 0.33 ms on
// the 455-row group (resolve_parse_probe.py, which times the phases).
//
// K9: one CTA of 1024 threads per row, one thread per position of a
// 1024-byte tile, sweeping the tiles left to right as the TPU kernel does.
// Snappy pointers go strictly backward, so when tile t runs every position
// before it is final: a pointer into an earlier tile is resolved by one read
// of the row's plane in device memory. Pointers inside the tile jump Jacobi
// style (each round replaces a pointer by its target's value, so the hops
// covered double) over two 4 KiB buffers in shared memory, until
// __syncthreads_and says every position is >= FLAG, for at most max_rounds
// rounds (12: the TPU kernel's first round and 11 passes). Then the tile is
// stored, and a __syncthreads() makes the stores visible to the CTA's later
// reads of them; the plane is therefore read through plain loads, never the
// read-only path (no const __restrict__ on it). A pointer below 0 or at or
// past its own position is never chased, and a tile over the round budget
// is stored as it stands, so such a row keeps values below FLAG and the
// caller flags it for fallback.

#include <cstdint>
#include <cuda_runtime.h>

// Every position's origin in a hop plane held in shared memory, by pointer
// doubling window by window: the step that K8 (resolve.cu) and K10
// (records.cu) share.
//
// hop[p] (uint16: rows of at most 65536 positions) is an earlier position
// for every p that is not a root; is_root(p, hop[p]) says which p are
// roots (a literal byte, or a position whose chain stops there), whose
// entries this step neither follows nor writes. Windows of kThreads *
// kSteps positions are settled in order, so when a window starts every
// entry before it is a root or points at one: a first hop that leaves the
// window finds its root there at once. The chains inside the window are
// settled by pointer doubling, hop[p] = hop[hop[p]] in place (a read sees
// the old or the new value, both on p's chain), until no thread has one
// left (__syncthreads_or). On return hop[p] is p's root for every p < end
// that is not a root itself.

#include <cstdint>

template <int kThreads, int kSteps, typename IsRoot>
__device__ __forceinline__ void settle_origins(uint16_t* hop, int end, IsRoot is_root) {
  constexpr int kWindow = kSteps * kThreads;
  const int t = threadIdx.x;
  for (int base = 0; base < end; base += kWindow) {
    int h[kSteps];
    bool open[kSteps];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) h[u] = base + u * kThreads + t < end ? hop[base + u * kThreads + t] : 0;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int p = base + u * kThreads + t;
      open[u] = p < end && !is_root(p, h[u]);  // a byte of this window, maybe copied
      if (open[u] && h[u] < base) {
        const int h2 = hop[h[u]];
        if (!is_root(h[u], h2)) h[u] = h2;
        hop[p] = static_cast<uint16_t>(h[u]);
      }
      open[u] = open[u] && h[u] >= base;
    }
    bool any = false;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) any |= open[u];
    while (__syncthreads_or(any)) {
      any = false;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (!open[u]) continue;
        const int h2 = hop[h[u]];
        if (is_root(h[u], h2)) {
          open[u] = false;
        } else {
          h[u] = h2;
          hop[base + u * kThreads + t] = static_cast<uint16_t>(h2);
          open[u] = h2 >= base;
          any |= open[u];
        }
      }
    }
  }
}

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kTile = 1024;
constexpr int32_t kFlag = 1 << 17;
constexpr int kThreads = 1024;     // K8's CTA
constexpr int kPerThread = 3;      // records a thread takes in a pass
constexpr int kPass = kPerThread * kThreads;
constexpr int kMaxRow = 65536;     // widest row K8 takes (uint16 hops)
constexpr int kWindowSteps = 4;    // positions a thread takes in a window
constexpr int kHopBatch = 8;       // words of first hops a warp takes at once
constexpr int kOutSteps = 4;       // runs of 4 values a thread reads at a time
constexpr int kWide = 0xFFFF;      // a root's entry when its value is in the output row

// Inclusive scan of x over the CTA (warp_sums: a word a warp); returns the
// sum of the threads before this one.
__device__ __forceinline__ int exclusive_scan(int x, int* warp_sums) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int mine = x;
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == kWarp - 1) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  return x - mine + (warp ? warp_sums[warp - 1] : 0);
}

__global__ void __launch_bounds__(kThreads, 1)
resolve_fh_kernel(const int32_t* __restrict__ startsx,
                  const int32_t* __restrict__ payload, int64_t cap,
                  const int32_t* __restrict__ declens, int d_pad, int32_t* out) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* hop = reinterpret_cast<uint16_t*>(smem);  // first hops, then origins
  uint32_t* starts = reinterpret_cast<uint32_t*>(smem + 2 * d_pad);  // a bit per covering start
  uint32_t* roots = starts + d_pad / 32;                             // a bit per root
  int* start_of = reinterpret_cast<int*>(roots + d_pad / 32);        // a pass's covering records
  int* pay_of = start_of + kPass;
  __shared__ int warp_sums[kThreads / kWarp];
  __shared__ int wide;  // some root's value is in the output row

  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t % kWarp, warp = t / kWarp;
  const int32_t* st = startsx + b * cap;
  const int32_t* pk = payload + b * cap;
  int32_t* row = out + b * static_cast<int64_t>(d_pad);
  const int lim = static_cast<int>(max(min(static_cast<int64_t>(declens[b]), static_cast<int64_t>(d_pad)),
                                       int64_t{0}));
  for (int w = t; w < d_pad / 16; w += kThreads) starts[w] = 0;  // and roots
  if (t == 0) wide = 0;
  __syncthreads();
  const auto is_root = [roots](int p, int) { return (roots[p >> 5] >> (p & 31)) & 1u; };

  // 1-2, a pass at a time; carry is where the pass's span starts, the same
  // in every thread.
  int carry = 0;
  for (int64_t j0 = 0; j0 < cap && carry < lim; j0 += kPass) {
    int s[kPerThread + 1], pv[kPerThread];
#pragma unroll
    for (int u = 0; u <= kPerThread; ++u) {
      const int64_t j = j0 + kPerThread * t + u;
      s[u] = j < cap ? st[j] : INT32_MAX;
      if (u < kPerThread) pv[u] = j < cap ? pk[j] : 0;
    }
    bool covers[kPerThread];
    int x = 0;
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      covers[u] = s[u] >= carry && s[u] < lim && s[u] != s[u + 1];
      x += covers[u];
    }
    int rank = exclusive_scan(x, warp_sums);
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      if (!covers[u]) continue;
      start_of[rank] = s[u];
      pay_of[rank] = pv[u];
      atomicOr(starts + (s[u] >> 5), 1u << (s[u] & 31));
      rank++;
    }
    const int64_t jn = j0 + kPass;
    const int hi = jn < cap ? min(max(st[jn], carry), lim) : lim;
    __syncthreads();
    // Each warp takes a run of the span's 32-position words. The starts at
    // or before a position, counted from the pass's first, give its record.
    const int w_lo = carry >> 5, w_hi = (hi + 31) >> 5;
    const int per_warp = (w_hi - w_lo + kWarp - 1) / kWarp;
    const int wa = w_lo + warp * per_warp, wb = min(wa + per_warp, w_hi);
    const uint32_t from_carry = ~0u << (carry & 31);  // the first word's bits from carry on
    int count = 0;
    for (int w = wa + lane; w < wb; w += kWarp)
      count += __popc(starts[w] & (w == w_lo ? from_carry : ~0u));
    count = __reduce_add_sync(kAll, count);
    int before = exclusive_scan(lane == 0 ? count : 0, warp_sums);  // the pass's starts before
    before = __shfl_sync(kAll, before, 0);
    const uint32_t upto = 0xFFFFFFFFu >> (kWarp - 1 - lane);  // bits at or below this lane
    for (int w0 = wa; w0 < wb; w0 += kHopBatch) {
      int p[kHopBatch], hv[kHopBatch], val[kHopBatch];
      bool root[kHopBatch];
#pragma unroll
      for (int u = 0; u < kHopBatch; ++u) {
        const int w = w0 + u;
        const uint32_t bits = w < wb ? starts[w] & (w == w_lo ? from_carry : ~0u) : 0u;
        p[u] = w < wb && 32 * w + lane >= carry && 32 * w + lane < hi ? 32 * w + lane : -1;
        const int i = min(before + __popc(bits & upto) - 1, kPass - 1);
        before += __popc(bits);
        const int start = i >= 0 ? start_of[i] : 0;  // before the first record: a copy
        const int pay = i >= 0 ? pay_of[i] : 0;      // of offset 1 at 0
        const int w1 = pay & 0x1FFFF;
        const int j = p[u] - start;
        if ((pay >> 17) == 1) {
          root[u] = true;
          val[u] = kFlag + w1 + j;
          hv[u] = w1 + j >= 0 && w1 + j < kWide ? w1 + j : kWide;
        } else {
          const int off = max(w1, 1);
          const int h = start - off + (j < off ? j : j % off);
          root[u] = h < 0 && p[u] == 0;
          val[u] = h;
          hv[u] = root[u] ? kWide : max(h, 0);
        }
        const uint32_t m = __ballot_sync(kAll, p[u] >= 0 && root[u]);
        if (lane == 0 && m) atomicOr(roots + w, m);
      }
#pragma unroll
      for (int u = 0; u < kHopBatch; ++u) {
        if (p[u] < 0) continue;
        hop[p[u]] = static_cast<uint16_t>(hv[u]);
        if (root[u] && hv[u] == kWide) {
          row[p[u]] = val[u];
          wide = 1;
        }
      }
    }
    carry = hi;
    __syncthreads();
  }

  // 3: every position's root.
  settle_origins<kThreads, kWindowSteps>(hop, lim, is_root);

  // 4: the roots' values, FLAG from lim on, kOutSteps runs of 4 positions
  // a thread at a time; a row with a root's value in the output row reads
  // it before a barrier and stores after one.
  __syncthreads();
  const bool fence = wide;  // the same in every thread
  for (int base = 0; base < d_pad; base += 4 * kOutSteps * kThreads) {
    int v[kOutSteps][4];
#pragma unroll
    for (int u = 0; u < kOutSteps; ++u) {
      const int p0 = base + 4 * (u * kThreads + t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + i;
        v[u][i] = kFlag;
        if (p < lim) {
          const int r = is_root(p, 0) ? p : hop[p];
          const int e = hop[r];
          v[u][i] = e != kWide ? kFlag + e : row[r];
        }
      }
    }
    if (fence && base < lim) __syncthreads();
#pragma unroll
    for (int u = 0; u < kOutSteps; ++u) {
      const int p0 = base + 4 * (u * kThreads + t);
      if (p0 < d_pad) reinterpret_cast<int4*>(row)[p0 / 4] = make_int4(v[u][0], v[u][1], v[u][2], v[u][3]);
    }
    if (fence && base < lim) __syncthreads();
  }
}

// K9: resolves position d (thread threadIdx.x of the tile starting at t0)
// from its first hop v and stores it in the row's plane.
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

// startsx, payload: (n_rows, cap) int32 (ops/resolve.py
// records_to_kernel_inputs); declens: (n_rows,) int32; out: (n_rows, d_pad)
// int32, d_pad a multiple of 1024 up to 65536.
extern "C" int stpu_cuda_resolve_fh(const int32_t* startsx, const int32_t* payload,
                                    int64_t n_rows, int64_t cap,
                                    const int32_t* declens, int64_t d_pad,
                                    int32_t* out, void* stream) {
  if (d_pad <= 0 || d_pad > kMaxRow || d_pad % kTile) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 2 * static_cast<int>(d_pad) + static_cast<int>(d_pad) / 4 + 2 * kPass * 4;
  const cudaError_t e = cudaFuncSetAttribute(
      resolve_fh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  resolve_fh_kernel<<<static_cast<unsigned>(n_rows), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      startsx, payload, cap, declens, static_cast<int>(d_pad), out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stpu_cuda_resolve(const int32_t* a0, int64_t n_rows, int64_t d_pad,
                                 int max_rounds, int32_t* out, void* stream) {
  resolve_kernel<<<static_cast<unsigned>(n_rows), kTile, 0,
                   static_cast<cudaStream_t>(stream)>>>(a0, d_pad, max_rounds, out);
  return static_cast<int>(cudaGetLastError());
}
"""

# -- K4 as first ported, one change each ---------------------------------------
PARSE_RECORD_STORES = "      r0[k] = (p - lo) | (new_lp << 10);\n      r1[k] = offc;\n"
PARSE_ZERO_FILL = "  for (int j = k; j < kMaxRec; j++) {\n    r0[j] = 0;\n    r1[j] = 0;\n  }\n"
PARSE_ROW = "  const int64_t b = blockIdx.x;\n  const int s = threadIdx.x;\n"
PARSE_PAD_ZEROS = PARSE_ROW + """  if (lens[b] == 0) {  // a padding row: zeros, 16 bytes a store
    uint4* z0 = reinterpret_cast<uint4*>(rec0 + b * kNSeg * kMaxRec);
    uint4* z1 = reinterpret_cast<uint4*>(rec1 + b * kNSeg * kMaxRec);
    for (int i = s; i < kNSeg * kMaxRec / 4; i += kNSeg) {
      z0[i] = make_uint4(0, 0, 0, 0);
      z1[i] = make_uint4(0, 0, 0, 0);
    }
    uint4* zc = reinterpret_cast<uint4*>(cnt + b * kNSeg * 8);
    for (int i = s; i < kNSeg * 8 / 4; i += kNSeg) zc[i] = make_uint4(0, 0, 0, 0);
    return;
  }
"""
PARSE_STAGING = """  const uint4* src = reinterpret_cast<const uint4*>(blocks + b * kS);
  for (int i = s; i < kS / 16; i += kNSeg) smem_words[i] = src[i];
  if (s == 0) smem_words[kS / 16] = make_uint4(0, 0, 0, 0);
  __syncthreads();
"""
PARSE_BLK = "  uint8_t* blk = reinterpret_cast<uint8_t*>(smem_words);\n"
PARSE_U32 = """  return uint32_t{s[pos]} | uint32_t{s[pos + 1]} << 8 | uint32_t{s[pos + 2]} << 16 |
         uint32_t{s[pos + 3]} << 24;
"""
# In place: the bytes through the read-only path, zeros past the block's end.
PARSE_U32_IN_PLACE = """  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) v |= uint32_t{pos + i < kS ? __ldg(s + pos + i) : uint8_t{0}} << (8 * i);
  return v;
"""
PARSE_LAUNCH_SMEM = "kNSeg, kSmem,"
PARSE_UP = "    const uint32_t up = u32_at(blk, lo + min(max(a_p - lo, 0), kSeg - 1));\n"
PARSE_UQ = "    const uint32_t uq = u32_at(blk, min(a >> 7, 511) * 128 + (a & 127));\n"

# -- K8 as first ported, with clock stamps ------------------------------------------
# Thread 0 stamps (the barriers fix its view of the CTA): from a tile's start
# to the barrier after its first hops (acc[0], the search), the rounds
# (acc[1]), the plane store and its barrier (acc[2]), and counts the rounds
# (acc[3]), all summed over the row's live tiles; written over the row's
# first four values.
RESOLVE_STAMPS = [
    ("                                             int max_rounds) {\n",
     "                                             int max_rounds, long long* acc) {\n"),
    ("  int done = __syncthreads_and(v >= kFlag);\n",
     "  int done = __syncthreads_and(v >= kFlag);\n  acc[0] += clock64() - acc[4];\n"
     "  long long tr = clock64();\n"),
    ("  for (int r = 0; !done && r < max_rounds; ++r) {\n",
     "  for (int r = 0; !done && r < max_rounds; ++r) {\n    acc[3] += 1;\n"),
    ("  plane[d] = v;\n  __syncthreads();\n}\n",
     "  acc[1] += clock64() - tr;\n  tr = clock64();\n  plane[d] = v;\n  __syncthreads();\n"
     "  acc[2] += clock64() - tr;\n}\n"),
    ("  int32_t* plane = out + b * d_pad;\n  for (int64_t t0 = 0; t0 < d_pad; t0 += kTile) {\n"
     "    const int64_t d = t0 + threadIdx.x;\n    if (t0 >= declen) {",
     "  int32_t* plane = out + b * d_pad;\n  long long acc[5] = {0, 0, 0, 0, 0};\n"
     "  for (int64_t t0 = 0; t0 < d_pad; t0 += kTile) {\n    acc[4] = clock64();\n"
     "    const int64_t d = t0 + threadIdx.x;\n    if (t0 >= declen) {"),
    ("    resolve_tile(v, d, t0, plane, buf, max_rounds);\n  }\n}\n",
     "    resolve_tile(v, d, t0, plane, buf, max_rounds, acc);\n  }\n  __syncthreads();\n"
     "  if (threadIdx.x == 0)\n    for (int i = 0; i < 4; ++i) plane[i] = static_cast<int32_t>(acc[i]);\n}\n"),
    ("  int32_t* plane = out + b * d_pad;\n  for (int64_t t0 = 0; t0 < d_pad; t0 += kTile) {\n"
     "    const int64_t d = t0 + threadIdx.x;\n    resolve_tile(row[d], d, t0, plane, buf, max_rounds);\n",
     "  int32_t* plane = out + b * d_pad;\n  long long acc[5] = {0, 0, 0, 0, 0};\n"
     "  for (int64_t t0 = 0; t0 < d_pad; t0 += kTile) {\n"
     "    const int64_t d = t0 + threadIdx.x;\n    resolve_tile(row[d], d, t0, plane, buf, max_rounds, acc);\n"),
]
FIRST_RESOLVE_PHASES = ("search_and_first_hop", "rounds", "plane_store", "rounds_taken")


def _swap(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"resolve_parse_probe: {old!r} is not in the source")
    return text.replace(old, new)


def _swaps(text: str, pairs) -> str:
    for old, new in pairs:
        text = _swap(text, old, new)
    return text


def variants(families) -> dict[str, tuple[str, str]]:
    """``name: (kernel, source text)`` of the chosen families, ``kernel``
    "parse", "resolve_first" or "resolve"."""
    out = {}
    if "first" in families:
        out.update({
            "first_parse": ("parse", FIRST_PARSE),
            "first_parse_no_records": ("parse", _swaps(FIRST_PARSE, [
                (PARSE_RECORD_STORES, ""), (PARSE_ZERO_FILL, "")])),
            "first_parse_pad_zeros": ("parse", _swap(FIRST_PARSE, PARSE_ROW, PARSE_PAD_ZEROS)),
            "first_parse_in_place": ("parse", _swaps(FIRST_PARSE, [
                (PARSE_BLK, ""), (PARSE_STAGING, "  const uint8_t* blk = blocks + b * kS;\n"),
                (PARSE_U32, PARSE_U32_IN_PLACE), (PARSE_LAUNCH_SMEM, "kNSeg, 0,")])),
            "first_parse_const_bytes": ("parse", _swaps(FIRST_PARSE, [
                (PARSE_UP, "    const uint32_t up = 0u;\n"),
                (PARSE_UQ, "    const uint32_t uq = 1u;\n")])),
            "first_resolve": ("resolve_first", FIRST_RESOLVE),
            "first_resolve_phase_clocks": ("resolve_first", _swaps(FIRST_RESOLVE, RESOLVE_STAMPS)),
        })
    if "current" in families:
        out.update(current_variants())
    return out


# -- the current kernels' alternatives ------------------------------------------------
CUR_PARSE_STAGED = """  extern __shared__ uint4 staged[];
  const uint4* src = reinterpret_cast<const uint4*>(blocks + b * kS);
  for (int i = s; i < kS / 16; i += kNSeg) staged[i] = src[i];
  __syncthreads();
  const uint32_t* blk = reinterpret_cast<const uint32_t*>(staged);
"""
CUR_PARSE_IN_PLACE = "  const uint32_t* blk = reinterpret_cast<const uint32_t*>(blocks + b * kS);\n"
CUR_PARSE_LD = "  const uint32_t lo = words[w];\n  const uint32_t hi = w + 1 < kS / 4 ? words[w + 1] : 0u;\n"
CUR_PARSE_LDG = ("  const uint32_t lo = __ldg(words + w);\n"
                 "  const uint32_t hi = w + 1 < kS / 4 ? __ldg(words + w + 1) : 0u;\n")
CUR_PARSE_LAUNCH = "  parse_kernel<<<static_cast<unsigned>(n_rows), kNSeg, kS,"
CUR_PARSE_SECTOR_STORES = [
    ("      if (slot == kSector - 1) {\n        put_sector(r0 + k - kSector, q0);\n"
     "        put_sector(r1 + k - kSector, q1);\n      }\n", ""),
    ("    put_sector(r0 + j, q0);\n    put_sector(r1 + j, q1);\n", ""),
]
# The segment's 2 KiB of jump words asked into L2 before its walk: one bulk
# prefetch (the copy engine's), or one prefetch a 128-byte line.
CUR_PARSE_WALK = "  int32_t q0[kSector], q1[kSector];  // the pending sector: slot k % 8\n"
CUR_PARSE_PREFETCH_BULK = ("  if (lo < hi)\n    asm volatile(\"cp.async.bulk.prefetch.L2.global [%0], %1;\" "
                           ":: \"l\"(jrow), \"r\"(kSeg * 4) : \"memory\");\n" + CUR_PARSE_WALK)
CUR_PARSE_PREFETCH_LINES = ("  if (lo < hi)\n    for (int i = 0; i < kSeg; i += 32)\n"
                            "      asm volatile(\"prefetch.global.L2 [%0];\" :: \"l\"(jrow + i));\n"
                            + CUR_PARSE_WALK)
RESOLVE_CTA = "constexpr int kThreads = 256;      // K8's CTA\nconstexpr int kCtas = 4;"
RESOLVE_WIN = "constexpr int kWin = 4096;"
RESOLVE_PER_THREAD = "constexpr int kPerThread = 4;"
RESOLVE_HOP_BATCH = "constexpr int kHopBatch = 16;"
# Clock stamps in the current K8, taken by thread 0 and summed over the
# windows: each pass's record loads, covering scan, start bits and counts
# (a) and its first hops (c), then the doubling (d) and the values out (e).
# Written over the row's first four values.
CURRENT_RESOLVE_STAMPS = [
    ("  int64_t j0 = 0;  // the first record of the next pass, the same in every thread\n",
     "  int64_t j0 = 0;  // the first record of the next pass, the same in every thread\n"
     "  long long acc_a = 0, acc_c = 0, acc_d = 0, acc_e = 0, tp = 0;\n"),
    ("        int s0[kPerThread + 1], s[kPerThread + 1], pv[kPerThread];\n",
     "        tp = clock64();\n        int s0[kPerThread + 1], s[kPerThread + 1], pv[kPerThread];\n"),
    ("        const uint32_t upto = 0xFFFFFFFFu >> (kWarp - 1 - lane);",
     "        acc_a += clock64() - tp;\n        tp = clock64();\n"
     "        const uint32_t upto = 0xFFFFFFFFu >> (kWarp - 1 - lane);"),
    ("        if (carry < wend) j0 = jn;  // the window needs the next pass\n        __syncthreads();\n      }\n",
     "        if (carry < wend) j0 = jn;  // the window needs the next pass\n        __syncthreads();\n"
     "        acc_c += clock64() - tp;\n      }\n"),
    ("      // 3: the window's chains.\n", "      tp = clock64();\n      // 3: the window's chains.\n"),
    ("    // 4: the window's values, FLAG from lim on.\n",
     "    if (base < wend) acc_d += clock64() - tp;\n    tp = clock64();\n"
     "    // 4: the window's values, FLAG from lim on.\n"),
    ("    __syncthreads();\n  }\n}\n\n// K9",
     "    __syncthreads();\n    acc_e += clock64() - tp;\n  }\n  if (t == 0) {\n"
     "    row[0] = static_cast<int32_t>(acc_a);\n    row[1] = static_cast<int32_t>(acc_c);\n"
     "    row[2] = static_cast<int32_t>(acc_d);\n    row[3] = static_cast<int32_t>(acc_e);\n  }\n}\n\n// K9"),
]
CURRENT_RESOLVE_PHASES = ("record_loads_scan_bits_counts", "first_hops", "doubling", "values_out")


def current_variants() -> dict[str, tuple[str, str]]:
    """The package's K4 and K8 as they ship, and the designs they were
    measured against: K4 with the block read in place through L1 (two
    aligned words a read) instead of staged in shared memory (64 KiB, three
    CTAs an SM), without its record stores (only ``cnt``), and its walk
    alone (constant bytes), and with its segment's jump words prefetched
    into L2; K8 with CTAs of 512 threads (two an SM, not 256 and four),
    with windows of 2,048 positions (not 4,096), with passes of 8 records a
    thread (not 4), with first hops 8 words a warp at once (not 16), with
    clock stamps per phase, and the whole-row designs it was measured
    against (``ROW_VALUES_RESOLVE``, ``ROOT_BITS_RESOLVE``)."""
    csrc = os.path.join(HERE, "snappy_tpu_torch", "csrc")
    with open(os.path.join(csrc, "parse.cu")) as f, open(os.path.join(csrc, "resolve.cu")) as g:
        parse, res = f.read(), g.read()
    return {
        "current_parse": ("parse", parse),
        "current_parse_in_place": ("parse", _swaps(parse, [
            (CUR_PARSE_STAGED, CUR_PARSE_IN_PLACE), (CUR_PARSE_LD, CUR_PARSE_LDG),
            (CUR_PARSE_LAUNCH, "  parse_kernel<<<static_cast<unsigned>(n_rows), kNSeg, 0,")])),
        "current_parse_no_records": ("parse", _swaps(parse, CUR_PARSE_SECTOR_STORES)),
        "current_parse_prefetch_bulk": ("parse", _swap(parse, CUR_PARSE_WALK, CUR_PARSE_PREFETCH_BULK)),
        "current_parse_prefetch_lines": ("parse", _swap(parse, CUR_PARSE_WALK, CUR_PARSE_PREFETCH_LINES)),
        "current_parse_const_bytes": ("parse", _swaps(parse, [
            (PARSE_UP, "    const uint32_t up = 0u;\n"), (PARSE_UQ, "    const uint32_t uq = 1u;\n")])),
        "current_resolve": ("resolve", res),
        "current_resolve_512_threads": ("resolve", _swap(
            res, RESOLVE_CTA, "constexpr int kThreads = 512;      // K8's CTA\nconstexpr int kCtas = 2;")),
        "current_resolve_window_2048": ("resolve", _swap(res, RESOLVE_WIN, "constexpr int kWin = 2048;")),
        "current_resolve_8_records": ("resolve", _swap(res, RESOLVE_PER_THREAD, "constexpr int kPerThread = 8;")),
        "current_resolve_hop_batch_8": ("resolve", _swap(res, RESOLVE_HOP_BATCH, "constexpr int kHopBatch = 8;")),
        "current_resolve_phase_clocks": ("resolve", _swaps(res, CURRENT_RESOLVE_STAMPS)),
        "current_resolve_row_values": ("resolve", ROW_VALUES_RESOLVE),
        "current_resolve_root_bits": ("resolve", ROOT_BITS_RESOLVE),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("resolve_parse_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from pathlib import Path

    import snappy_tpu_torch
    from snappy_tpu_torch import native
    from snappy_tpu_torch.ops import _build, api, encode_flat, packing, parse, resolve

    dev = torch.device("cuda")

    def smi(query):
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]

    families = [a for a in sys.argv[1:] if a in ("first", "current")] or ["first", "current"]
    card = smi("name,power.limit")
    sm_mhz = int(smi("clocks.max.sm").split()[0])
    out_dir = Path(HERE) / "build" / "resolve_parse_probe"
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
        "parse": ("stpu_cuda_parse", [p, p, p, i64, p, p, p, p]),
        "resolve_first": ("stpu_cuda_resolve_fh", [p, p, i64, i64, p, i64, i32, p, p]),
        "resolve": ("stpu_cuda_resolve_fh", [p, p, i64, i64, p, i64, p, p]),
    }
    libs = {}
    for (src, _), path in zip(jobs, paths):
        sym, argtypes = entries[kinds[src.stem]]
        fn = getattr(ctypes.CDLL(str(path)), sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        libs[src.stem] = fn
    report = {"card": card, "sm_max_mhz": sm_mhz, "build_failed": failed, "equal": {},
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

    # -- K4 on the compress group -----------------------------------------------------
    data = chip_smoke.corpus_stream(chip_smoke.STREAM_BYTES)
    parse_names = named(("parse",))
    if parse_names:
        cblocks, clens = packing.blocks_of(data)
        n_rows = packing.pad_to_bucket(len(clens), 1)
        pad = n_rows - len(clens)
        cb = torch.from_numpy(np.concatenate([cblocks, np.zeros((pad, cblocks.shape[1]), np.uint8)])).to(dev)
        cl = torch.from_numpy(np.concatenate([clens, np.zeros(pad, np.int32)])).to(dev)
        jw, _ = encode_flat.prepass(cb, cl)
        *want, lane_steps, seg_steps = parse.parse_lockstep(cl, jw, cb)
        live = cl > 0
        longest = seg_steps.max(dim=1).values[live].double()

        def parser(fn):
            def call():
                r0 = torch.empty((n_rows, parse.NSEG, parse.MAX_REC), dtype=torch.int32, device=dev)
                r1 = torch.empty_like(r0)
                c = torch.empty((n_rows, parse.NSEG, 8), dtype=torch.int32, device=dev)
                _build.check(fn(cl.data_ptr(), jw.data_ptr(), cb.data_ptr(), n_rows, r0.data_ptr(),
                                r1.data_ptr(), c.data_ptr(), stream()), "probe")
                return r0, r1, c
            return call

        calls = {n: parser(libs[n]) for n in parse_names}
        for n in named(("parse",), "no_records", "const_bytes"):
            report["equal"][f"{n}:group"] = all(torch.equal(g, w) for g, w in zip(calls[n](), want))
        report["parse_group"] = {
            "rows": n_rows, "live": int(live.sum()), "lane_steps": lane_steps,
            "longest_walk_per_block": {"mean": float(longest.mean()), "max": int(longest.max())},
            "device_ms": timed(calls, 5)}
        del cb, cl, jw, want, calls

    # -- K8 on the frame's largest launch group -------------------------------------------
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
    r_t, n_t, d_t = (torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (
        recs[:, :r_pad], nops.astype(np.int32), np.asarray(gd, np.int32)))
    b = len(g)
    startsx, payload = resolve.records_to_kernel_inputs(r_t, n_t, d_t, d_pad)
    want8 = resolve.resolve_fh_plain(startsx, payload, d_t, d_pad)
    rgroup = {"rows": b, "d_pad": d_pad, "records": int(nops.sum()), "r_pad": r_pad}

    def resolver(fn, first):
        def call():
            out = torch.empty((b, d_pad), dtype=torch.int32, device=dev)
            args = [startsx.data_ptr(), payload.data_ptr(), b, r_pad, d_t.data_ptr(), d_pad]
            args += [resolve.MAX_ROUNDS] if first else []
            _build.check(fn(*args, out.data_ptr(), stream()), "probe")
            return out
        return call

    calls = {n: resolver(libs[n], kinds[n] == "resolve_first")
             for n in named(("resolve_first", "resolve"))}
    for n in named(("resolve_first", "resolve"), "phase_clocks"):
        report["equal"][f"{n}:group"] = bool(torch.equal(calls[n](), want8))
    for n in named(("resolve_first", "resolve")):
        if "phase_clocks" in n:
            phases = FIRST_RESOLVE_PHASES if n.startswith("first") else CURRENT_RESOLVE_PHASES
            stamps = calls[n]()[:, : len(phases)].cpu().numpy().view(np.uint32).astype(np.float64)
            rgroup[f"{n}_mean"] = dict(zip(phases, stamps.mean(0).tolist()))
            rgroup[f"{n}_max"] = dict(zip(phases, stamps.max(0).tolist()))
    rgroup["device_ms"] = timed(calls, 10)
    del want8, calls
    report["resolve_group"] = rgroup

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "resolve_parse_probe.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if all(report["equal"].values()) and not failed else 1


if __name__ == "__main__":
    sys.exit(main())
