"""What binds the CRC32C (K1) and the fused emission (K5) on one NVIDIA GPU:
a probe.

    python3 crc_emit_probe.py [first] [current] [only=NAME ...]

Needs a CUDA card and ``nvcc``. Builds variants of both kernels from text
into ``build/crc_emit_probe/`` and times each through its C entry as the
replay of a CUDA graph of several calls (``chip_smoke.device_ms``), in two
turns (forward, then reverse); ``only=NAME`` keeps the named variants.

- K1 at two shapes: 512 rows of 65,536 random bytes with random lengths
  (``chip_smoke.py``'s first K1 shape), and the frame's largest launch
  group (455 rows, ``d_pad`` 65536) as the flat route decodes it, with
  the chunks' lengths, as ``ops/api.py`` calls ``crc32c_masked_blocks``;
  each variant masked, held to ``crc32c_plain`` (and on rows 4,001 bytes
  apart and rows past one chunk), and the plain version on the group to
  the host codec's masked CRC of every chunk. The package's wrapper is
  also timed there device-only, over calls (``chip_smoke.cuda_ms``), and
  by the host's clock alone (calls issued back to back, no synchronize);
- K5 on ``chip_smoke.py``'s compress group (the 64 MiB + 5,000-byte
  stream's 1,025 blocks in 2,048 rows, 1,023 of them padding), each
  variant held to ``fused_emit_plain``.

``first``: the kernels as first ported (``FIRST_CRC``, ``FIRST_EMIT``,
kept below as text), and K1 as first ported with 1,024 threads a row.
``current``: ``snappy_tpu_torch/csrc/crc32c.cu`` and ``emit.cu`` as they
stand, with the designs they were measured against: K1 with byte steps
instead of slicing by 4, with its first row loaded after the tables, with
clock stamps per phase and in its prologue, and three earlier designs kept as text (a CTA a
row, ``ROW_CTA_CRC``; nibble tables, ``PERSISTENT_NIBBLE_CRC``; a tree of
operators, ``TREE_CRC``); K5 with a search for every byte, other CTA,
ring and run sizes, without the fetch of a step's rows during the step
before, and with clock stamps per phase. Every exact variant must equal
its plain version; a variant that does not build is reported and
skipped, and the run then fails. Each variant's resident CTAs an SM come
from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``. Prints one JSON
object and writes it to ``chiprun_out/crc_emit_probe.json``.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

FIRST_CRC = r"""
// CRC32C (Castagnoli) of every row of a (B, S) uint8 batch, up to each
// row's length, plain or with Snappy's frame mask.
//
// Replaces: snappy_tpu/ops/pallas/crc32c.py crc32c_blocks_pallas (_kernel)
// and the XLA matmul snappy_tpu/ops/crc32c.py crc32c_masked_blocks that the
// JAX decode path calls. The TPU computes parity(bits @ W) on its matrix
// unit because it has no fast gather; on this card a 256-entry table
// lookup in shared memory is the natural CRC step.
//
// What bounds it: device-memory bytes. Each row is read once (one byte
// in, a few integer operations per byte), so the least time is the rows'
// valid bytes over the memory rate. The byte-serial CRC recurrence is the
// obstacle: one thread alone would walk 64 KiB in sequence.
//
// Design: one block of 256 threads per row. Thread t runs the table CRC,
// from a zero register, over its own contiguous segment of the row (16-byte
// loads where aligned). A CRC register is linear over GF(2), so the raw
// register of the whole row is
//   M_len(0xFFFFFFFF) ^ XOR_t M_{after_t}(r_t)
// where M_n advances a register past n zero bytes and after_t counts the
// row's bytes after segment t. M_n is applied from the 32 operators
// M_{2^k} (columns in `shift_ops`, computed on the host), one per set bit
// of n. The segment registers are then XOR-reduced across the block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t apply_op(const uint32_t* cols, uint32_t v) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < 32; j++) acc ^= (v >> j & 1u) ? cols[j] : 0u;
  return acc;
}

// Advance a raw register past n zero bytes.
__device__ uint32_t shift_zeros(const uint32_t* ops, uint32_t r, uint32_t n) {
  for (int k = 0; n; k++, n >>= 1)
    if (n & 1u) r = apply_op(ops + 32 * k, r);
  return r;
}

__device__ __forceinline__ uint32_t step_word(const uint32_t* t, uint32_t r, uint32_t w) {
#pragma unroll
  for (int i = 0; i < 4; i++) {
    r = t[(r ^ w) & 0xFFu] ^ (r >> 8);
    w >>= 8;
  }
  return r;
}

__global__ void __launch_bounds__(kThreads)
crc32c_rows_kernel(const uint8_t* __restrict__ rows, int64_t stride,
                   const int32_t* __restrict__ lengths,
                   const uint32_t* __restrict__ table,
                   const uint32_t* __restrict__ shift_ops, int masked,
                   int64_t* __restrict__ out) {
  __shared__ uint32_t t[256];
  __shared__ uint32_t ops[32 * 32];
  __shared__ uint32_t warp_acc[kThreads / 32];
  for (int i = threadIdx.x; i < 256; i += kThreads) t[i] = table[i];
  for (int i = threadIdx.x; i < 32 * 32; i += kThreads) ops[i] = shift_ops[i];
  __syncthreads();

  const int64_t b = blockIdx.x;
  const uint8_t* row = rows + b * stride;
  int64_t len = lengths[b];
  len = len < 0 ? 0 : (len > stride ? stride : len);
  // Segments are 16-byte multiples so aligned rows take whole uint4 loads.
  const int64_t seg = ((len + kThreads - 1) / kThreads + 15) & ~int64_t{15};
  const int64_t start = threadIdx.x * seg;
  const int64_t lo = start < len ? start : len;
  const int64_t hi = lo + seg < len ? lo + seg : len;

  uint32_t r = 0;
  int64_t p = lo;
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
    for (; p + 16 <= hi; p += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + p);
      r = step_word(t, r, v.x);
      r = step_word(t, r, v.y);
      r = step_word(t, r, v.z);
      r = step_word(t, r, v.w);
    }
  }
  for (; p < hi; p++) r = t[(r ^ row[p]) & 0xFFu] ^ (r >> 8);
  r = shift_zeros(ops, r, static_cast<uint32_t>(len - hi));

  for (int o = 16; o > 0; o >>= 1) r ^= __shfl_xor_sync(0xFFFFFFFFu, r, o);
  if ((threadIdx.x & 31) == 0) warp_acc[threadIdx.x >> 5] = r;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t acc = shift_zeros(ops, 0xFFFFFFFFu, static_cast<uint32_t>(len));
    for (int w = 0; w < kThreads / 32; w++) acc ^= warp_acc[w];
    uint32_t crc = acc ^ 0xFFFFFFFFu;
    if (masked) crc = ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
    out[b] = static_cast<int64_t>(crc);
  }
}

}  // namespace

extern "C" int stpu_cuda_crc32c_rows(const uint8_t* rows, int64_t n_rows,
                                     int64_t stride, const int32_t* lengths,
                                     const uint32_t* table,
                                     const uint32_t* shift_ops, int masked,
                                     int64_t* out, void* stream) {
  crc32c_rows_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rows, stride, lengths, table, shift_ops, masked, out);
  return static_cast<int>(cudaGetLastError());
}
"""

FIRST_EMIT = r"""
// Emission of the flat encoder: compressed bytes from the breakpoint plan.
//
// For output byte d of row b, in 1024-byte group g = d >> 10:
//   idx(d) = d + base[b, g] + sum(dlt[b, j] * (d >= bp[b, j]))
//            over the window j in [lo_row[b, g] * 128, (lo_row + rows_g)[b, g] * 128)
//   out[b, d] = src[b, idx(d)] for d < out_len[b], and 0 after,
// where src is the row's [block bytes | header plane] and bp, dlt are the
// flattened step plan of ops/encode_flat.py _breakpoints.
//
// Replaces: snappy_tpu/ops/pallas/encode_flat.py fused_emit_pallas
// (_make_fused_emit_kernel; entry stpu_cuda_fused_emit) and its split form,
// shift_idx_pallas (_make_shift_kernel; stpu_cuda_shift_idx, which writes
// idx) and emit_bytes_pallas (_make_emit_kernel; stpu_cuda_emit_bytes, which
// gathers through it). The TPU kernels sum the steps in f32 on the vector
// unit and route every byte with one-hot matrix products over 128-lane
// header and content windows, whose bases the plan computes per tile
// because Mosaic has no gather. Here a gather is a load: the window bases
// (the TPU plan's hb8, cb8, cbk) do not exist, idx is summed in int32, and
// the split form takes idx in output order (no v2 permutation, no hbase).
//
// What bounds it: device-memory bytes (each output byte reads one source
// byte; each group reads its <= 14 x 128 breakpoints once) and, next to
// them, the per-byte search. Design: one block of 256 threads per (group,
// row). The block loads the group's window into shared memory and takes the
// inclusive prefix of its deltas; the plan sorts the breakpoints by
// construction, so the steps that apply at d are a prefix of the window and
// each thread finds its end by binary search. Each thread makes 4
// consecutive output bytes (one 32-bit store). A group wholly past out_len
// writes zeros and reads nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 1024;
constexpr int kGroups = 80;  // 81920 output bytes per row
constexpr int kLanes = 128;
constexpr int kWinRows = 14;
constexpr int kWin = kWinRows * kLanes;
constexpr int kChunk = kWin / kThreads;  // 7 window entries per thread
static_assert(kChunk * kThreads == kWin, "the scan splits the window evenly");

struct Plan {
  const int32_t* lo_row;  // (B, kGroups)
  const int32_t* base;    // (B, kGroups)
  const int32_t* rows_g;  // (B, kGroups)
  const int32_t* out_len; // (B,)
  const int32_t* bp;      // (B, nbp)
  const int32_t* dlt;     // (B, nbp)
  int64_t nbp;
};

struct Window {
  int32_t bp[kWin];
  int32_t pre[kWin];  // inclusive prefix of the window's deltas
  int32_t part[kThreads];
};

// Loads group (b, g)'s window into shared memory and takes the prefix of its
// deltas. Called by every thread of the block. Returns the window's length.
__device__ int load_window(const Plan& pl, int64_t b, int g, Window& w) {
  const int64_t gi = b * kGroups + g;
  const int64_t start = int64_t{pl.lo_row[gi]} * kLanes;
  const int64_t room = pl.nbp - start;  // window rows past the plan read nothing
  const int64_t want = int64_t{min(max(pl.rows_g[gi], 0), kWinRows)} * kLanes;
  const int m = static_cast<int>(room <= 0 ? 0 : (want < room ? want : room));
  const int32_t* bp = pl.bp + b * pl.nbp + start;
  const int32_t* dlt = pl.dlt + b * pl.nbp + start;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    w.bp[i] = bp[i];
    w.pre[i] = dlt[i];
  }
  __syncthreads();
  const int first = threadIdx.x * kChunk;
  int acc = 0;
  for (int i = first; i < first + kChunk && i < m; i++) {
    acc += w.pre[i];
    w.pre[i] = acc;
  }
  w.part[threadIdx.x] = acc;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {  // scan of the chunk sums
    const int v = threadIdx.x >= off ? w.part[threadIdx.x - off] : 0;
    __syncthreads();
    w.part[threadIdx.x] += v;
    __syncthreads();
  }
  const int excl = threadIdx.x ? w.part[threadIdx.x - 1] : 0;
  for (int i = first; i < first + kChunk && i < m; i++) w.pre[i] += excl;
  __syncthreads();
  return m;
}

// idx(d): the steps at or below d are a prefix of the sorted window.
__device__ __forceinline__ int32_t index_of(int d, int32_t base, const Window& w, int m) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (w.bp[mid] <= d) lo = mid + 1;
    else hi = mid;
  }
  return d + base + (lo ? w.pre[lo - 1] : 0);
}

__device__ __forceinline__ uint32_t gather_byte(const uint8_t* src, int64_t src_w,
                                                int32_t idx) {
  return idx >= 0 && idx < src_w ? uint32_t{src[idx]} : 0u;
}

__global__ void __launch_bounds__(kThreads)
fused_emit_kernel(Plan pl, const uint8_t* __restrict__ src, int64_t src_w,
                  uint8_t* __restrict__ out) {
  __shared__ Window w;
  const int64_t b = blockIdx.y;
  const int g = blockIdx.x;
  const int olen = pl.out_len[b];
  const int d0 = g * kGroup + threadIdx.x * 4;
  uint32_t word = 0;
  if (g * kGroup < olen) {  // the same for the whole block
    const int m = load_window(pl, b, g, w);
    const int32_t base = pl.base[b * kGroups + g];
    const uint8_t* row = src + b * src_w;
#pragma unroll
    for (int k = 0; k < 4; k++) {
      const int d = d0 + k;
      if (d < olen) word |= gather_byte(row, src_w, index_of(d, base, w, m)) << (8 * k);
    }
  }
  *reinterpret_cast<uint32_t*>(out + b * (kGroups * kGroup) + d0) = word;
}

__global__ void __launch_bounds__(kThreads)
shift_idx_kernel(Plan pl, int32_t* __restrict__ idx) {
  __shared__ Window w;
  const int64_t b = blockIdx.y;
  const int g = blockIdx.x;
  const int d0 = g * kGroup + threadIdx.x * 4;
  int4 v = make_int4(0, 0, 0, 0);
  if (g * kGroup < pl.out_len[b]) {  // groups past out_len stay 0
    const int m = load_window(pl, b, g, w);
    const int32_t base = pl.base[b * kGroups + g];
    v = make_int4(index_of(d0, base, w, m), index_of(d0 + 1, base, w, m),
                  index_of(d0 + 2, base, w, m), index_of(d0 + 3, base, w, m));
  }
  *reinterpret_cast<int4*>(idx + b * (kGroups * kGroup) + d0) = v;
}

__global__ void __launch_bounds__(kThreads)
emit_bytes_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ out_len,
                  const uint8_t* __restrict__ src, int64_t src_w,
                  uint8_t* __restrict__ out) {
  const int64_t b = blockIdx.y;
  const int d0 = blockIdx.x * kGroup + threadIdx.x * 4;
  const int olen = out_len[b];
  uint32_t word = 0;
  if (d0 < olen) {
    const int4 v = *reinterpret_cast<const int4*>(idx + b * (kGroups * kGroup) + d0);
    const int32_t ix[4] = {v.x, v.y, v.z, v.w};
    const uint8_t* row = src + b * src_w;
#pragma unroll
    for (int k = 0; k < 4; k++) {
      if (d0 + k < olen) word |= gather_byte(row, src_w, ix[k]) << (8 * k);
    }
  }
  *reinterpret_cast<uint32_t*>(out + b * (kGroups * kGroup) + d0) = word;
}

Plan make_plan(const int32_t* lo_row, const int32_t* base, const int32_t* rows_g,
               const int32_t* out_len, const int32_t* bp, const int32_t* dlt,
               int64_t nbp) {
  return Plan{lo_row, base, rows_g, out_len, bp, dlt, nbp};
}

dim3 grid_of(int64_t n_rows) { return dim3(kGroups, static_cast<unsigned>(n_rows)); }

}  // namespace

extern "C" int stpu_cuda_fused_emit(const int32_t* lo_row, const int32_t* base,
                                    const int32_t* rows_g, const int32_t* out_len,
                                    const int32_t* bp, const int32_t* dlt, int64_t nbp,
                                    const uint8_t* src, int64_t src_w, int64_t n_rows,
                                    uint8_t* out, void* stream) {
  fused_emit_kernel<<<grid_of(n_rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_plan(lo_row, base, rows_g, out_len, bp, dlt, nbp), src, src_w, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stpu_cuda_shift_idx(const int32_t* lo_row, const int32_t* base,
                                   const int32_t* rows_g, const int32_t* out_len,
                                   const int32_t* bp, const int32_t* dlt, int64_t nbp,
                                   int64_t n_rows, int32_t* idx, void* stream) {
  shift_idx_kernel<<<grid_of(n_rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_plan(lo_row, base, rows_g, out_len, bp, dlt, nbp), idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stpu_cuda_emit_bytes(const int32_t* idx, const int32_t* out_len,
                                    const uint8_t* src, int64_t src_w, int64_t n_rows,
                                    uint8_t* out, void* stream) {
  emit_bytes_kernel<<<grid_of(n_rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      idx, out_len, src, src_w, out);
  return static_cast<int>(cudaGetLastError());
}
"""

# K1 as measured against the current design: nibble tables, the fixed tree,
# but a CTA a row, two an SM (no persistent CTAs fetching the next row).
ROW_CTA_CRC = r"""
// CRC32C (Castagnoli) of every row of a (B, S) uint8 batch, up to each
// row's length, plain or with Snappy's frame mask.
//
// Replaces: snappy_tpu/ops/pallas/crc32c.py crc32c_blocks_pallas (_kernel)
// and the XLA matmul snappy_tpu/ops/crc32c.py crc32c_masked_blocks that the
// JAX decode path calls. The TPU computes parity(bits @ W) on its matrix
// unit because it has no fast gather; on this card table lookups in shared
// memory are the natural CRC step.
//
// What bounds it: device-memory bytes. Each row is read once (one byte
// in, a few integer operations per byte), so the least time is the rows'
// valid bytes over the memory rate. The byte-serial CRC recurrence is the
// obstacle: the first port gave each of 256 threads a 256-byte segment
// walked one dependent lookup a byte, then shifted each register by a
// data-dependent distance, so a row's critical path was thousands of
// dependent steps.
//
// Design: one CTA of kThreads = 1,024 threads a row, two CTAs an SM. A CRC
// register is linear over GF(2): the raw register of A || B from 0 is
// M_|B|(R(A)) ^ R(B), where M_n advances a register past n zero bytes, and
// zero bytes leave a register of 0 at 0. So:
// - The row's whole 16-byte words are right-aligned into chunks of
//   kThreads * kWords words, with leading zero words. Thread t takes the
//   kWords words at t * kWords of each chunk, issues all their loads first,
//   and runs slicing by 16 over them from a register of 0: per word, one
//   step that depends on the register and 16 table lookups XORed together,
//   each table split in two 16-entry nibble tables, so that a warp's reads
//   of one table never clash on a shared-memory bank (32 conflict-free reads
//   cost less than 16 that clash about 3.5-way). Its distance to the chunk's
//   end is a constant of t.
// - The registers combine in a fixed binary tree over t, warp shuffles and
//   then across warps: level k joins neighbouring runs of 2^k segments as
//   M_{seg << k}(left) ^ right, seg = 16 * kWords bytes, each operator
//   applied as 8 nibble-table lookups (`shift_ops`, computed on the host;
//   7.5 KiB of tables in all, in shared memory).
//   Chunks join in order through M_{seg * kThreads}, the last level.
// - The initial 0xFFFFFFFF is XORed into the first whole word's first four
//   bytes (a register is the next four bytes' XOR mask), so no thread
//   shifts it. The len % 16 tail bytes are byte steps by one thread, which
//   for len < 16 start from 0xFFFFFFFF.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWords = 4;  // 16-byte words a thread takes per chunk
constexpr int kMinCtas = 2048 / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkWords = kThreads * kWords;
constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }
constexpr int kTreeLevels = log2i(kThreads);  // shift_ops holds kTreeLevels + 1 levels
constexpr int kSliceEntries = 4 * 8 * 16;     // table16: 4 word lanes x 8 nibbles x 16
constexpr int kOpEntries = (kTreeLevels + 1) * 8 * 16;
constexpr bool kSlice16 = true;
static_assert((kThreads & (kThreads - 1)) == 0 && kWarps <= 32, "a power-of-two CTA");

// Eight nibble lookups: nibble q of v through the 16-entry table t + 16 q.
// Every lane reads the same table at once, so the 16 entries lie in 16
// banks and equal nibbles share an address: no bank conflict.
__device__ __forceinline__ uint32_t lookup8(const uint32_t* t, uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int q = 0; q < 8; q++) r ^= t[16 * q + ((v >> (4 * q)) & 15u)];
  return r;
}

// One byte step of the CRC: the byte table's two nibble halves.
__device__ __forceinline__ uint32_t step1(const uint32_t* nib, uint32_t r, uint32_t byte) {
  const uint32_t x = (r ^ byte) & 0xFFu;
  return nib[6 * 16 + (x & 15u)] ^ nib[7 * 16 + (x >> 4)] ^ (r >> 8);
}

// The register after one 16-byte word, from register r: slicing by 16, its
// tables split into nibbles (word lane L through nib + 128 (3 - L)).
__device__ __forceinline__ uint32_t step16(const uint32_t* nib, uint32_t r, uint4 w) {
  if (kSlice16)
    return lookup8(nib + 384, w.x ^ r) ^ lookup8(nib + 256, w.y) ^ lookup8(nib + 128, w.z) ^
           lookup8(nib, w.w);
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 16; i++) r = step1(nib, r, v[i >> 2] >> (8 * (i & 3)));
  return r;
}

// Joins the registers of runs of segments held by the warp's lanes, lane
// order = byte order, over the levels from `first_level` up to `n` lanes
// (level k's operator at ops + 128 k); the result is in lane n - 1.
__device__ __forceinline__ uint32_t warp_tree(const uint32_t* ops, int first_level, int n,
                                              uint32_t r) {
  const int lane = threadIdx.x & 31;
  for (int s = 1, k = first_level; s < n; s <<= 1, k++) {
    const uint32_t left = __shfl_up_sync(0xFFFFFFFFu, lookup8(ops + 128 * k, r), s);
    if ((lane & (2 * s - 1)) == 2 * s - 1) r ^= left;
  }
  return r;
}

// Whole word `wi` of the row, 0 outside [0, whole); the first carries the
// initial value.
__device__ __forceinline__ uint4 load_word(const uint8_t* row, bool aligned, int64_t wi,
                                           int64_t whole) {
  uint4 w = make_uint4(0, 0, 0, 0);
  if (wi >= 0 && wi < whole) {
    const uint8_t* p = row + 16 * wi;
    if (aligned) {
      w = *reinterpret_cast<const uint4*>(p);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; i++)
        v[i] = uint32_t{p[4 * i]} | uint32_t{p[4 * i + 1]} << 8 | uint32_t{p[4 * i + 2]} << 16 |
               uint32_t{p[4 * i + 3]} << 24;
      w = make_uint4(v[0], v[1], v[2], v[3]);
    }
    if (wi == 0) w.x ^= 0xFFFFFFFFu;
  }
  return w;
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
crc32c_rows_kernel(const uint8_t* __restrict__ rows, int64_t stride,
                   const int32_t* __restrict__ lengths,
                   const uint32_t* __restrict__ table16,
                   const uint32_t* __restrict__ shift_ops, int masked,
                   int64_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t nib[kSliceEntries + kOpEntries];
  __shared__ uint32_t warp_r[kWarps];
  const uint32_t* ops = nib + kSliceEntries;
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const uint8_t* row = rows + b * stride;
  int64_t len = lengths[b];
  len = len < 0 ? 0 : (len > stride ? stride : len);
  const int64_t whole = len >> 4;
  const int64_t chunks = (whole + kChunkWords - 1) / kChunkWords;
  const int64_t lead = chunks * kChunkWords - whole;  // leading zero words
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15) == 0;

  uint4 w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; i++)
    w[i] = load_word(row, aligned, int64_t{tid} * kWords + i - lead, whole);
  for (int i = tid; i < kSliceEntries + kOpEntries; i += kThreads)
    nib[i] = i < kSliceEntries ? table16[i] : shift_ops[i - kSliceEntries];
  __syncthreads();

  // The register so far, kept by thread kWarps - 1 (where the tree ends).
  uint32_t acc = whole ? 0u : 0xFFFFFFFFu;
  for (int64_t c = 0; c < chunks; c++) {
    if (c) {
#pragma unroll
      for (int i = 0; i < kWords; i++)
        w[i] = load_word(row, aligned, c * kChunkWords + int64_t{tid} * kWords + i - lead, whole);
    }
    uint32_t r = 0;
#pragma unroll
    for (int i = 0; i < kWords; i++) r = step16(nib, r, w[i]);
    r = warp_tree(ops, 0, 32, r);
    if ((tid & 31) == 31) warp_r[tid >> 5] = r;
    __syncthreads();
    if (tid < 32) {
      r = warp_tree(ops, 5, kWarps, tid < kWarps ? warp_r[tid] : 0u);
      if (tid == kWarps - 1) acc = c ? lookup8(ops + 128 * kTreeLevels, acc) ^ r : r;
    }
    __syncthreads();
  }
  if (tid == kWarps - 1) {
    const uint8_t* tail = row + 16 * whole;
    for (int i = 0; i < static_cast<int>(len & 15); i++) acc = step1(nib, acc, tail[i]);
    uint32_t crc = acc ^ 0xFFFFFFFFu;
    if (masked) crc = ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
    out[b] = static_cast<int64_t>(crc);
  }
}

}  // namespace

extern "C" int stpu_cuda_crc32c_rows(const uint8_t* rows, int64_t n_rows,
                                     int64_t stride, const int32_t* lengths,
                                     const uint32_t* table16,
                                     const uint32_t* shift_ops, int masked,
                                     int64_t* out, void* stream) {
  crc32c_rows_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rows, stride, lengths, table16, shift_ops, masked, out);
  return static_cast<int>(cudaGetLastError());
}
"""

# K1 as measured against the current design: a persistent CTA an SM that
# fetches the next row during this one, but slicing by 16 through 32 nibble
# tables (conflict-free, two lookups a byte) instead of 4 replicated byte
# tables, and a second barrier a row.
PERSISTENT_NIBBLE_CRC = r"""
// CRC32C (Castagnoli) of every row of a (B, S) uint8 batch, up to each
// row's length, plain or with Snappy's frame mask.
//
// Replaces: snappy_tpu/ops/pallas/crc32c.py crc32c_blocks_pallas (_kernel)
// and the XLA matmul snappy_tpu/ops/crc32c.py crc32c_masked_blocks that the
// JAX decode path calls. The TPU computes parity(bits @ W) on its matrix
// unit because it has no fast gather; on this card table lookups in shared
// memory are the natural CRC step.
//
// What bounds it: device-memory bytes. Each row is read once (one byte
// in, a few integer operations per byte), so the least time is the rows'
// valid bytes over the memory rate. The byte-serial CRC recurrence is the
// obstacle: the first port gave each of 256 threads a 256-byte segment
// walked one dependent lookup a byte, then shifted each register by a
// data-dependent distance, so a row's critical path was thousands of
// dependent steps.
//
// Design: one CTA of kThreads = 1,024 threads a row, two CTAs an SM. A CRC
// register is linear over GF(2): the raw register of A || B from 0 is
// M_|B|(R(A)) ^ R(B), where M_n advances a register past n zero bytes, and
// zero bytes leave a register of 0 at 0. So:
// - The row's whole 16-byte words are right-aligned into chunks of
//   kThreads * kWords words, with leading zero words. Thread t takes the
//   kWords words at t * kWords of each chunk, issues all their loads first,
//   and runs slicing by 16 over them from a register of 0: per word, one
//   step that depends on the register and 16 table lookups XORed together,
//   each table split in two 16-entry nibble tables, so that a warp's reads
//   of one table never clash on a shared-memory bank (32 conflict-free reads
//   cost less than 16 that clash about 3.5-way). Its distance to the chunk's
//   end is a constant of t.
// - The registers combine in a fixed binary tree over t, warp shuffles and
//   then across warps: level k joins neighbouring runs of 2^k segments as
//   M_{seg << k}(left) ^ right, seg = 16 * kWords bytes, each operator
//   applied as 8 nibble-table lookups (`shift_ops`, computed on the host;
//   7.5 KiB of tables in all, in shared memory).
//   Chunks join in order through M_{seg * kThreads}, the last level.
// - The initial 0xFFFFFFFF is XORed into the first whole word's first four
//   bytes (a register is the next four bytes' XOR mask), so no thread
//   shifts it. The len % 16 tail bytes are byte steps by one thread, which
//   for len < 16 start from 0xFFFFFFFF.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWords = 4;  // 16-byte words a thread takes per chunk
constexpr int kMinCtas = 1;  // CTAs an SM (a persistent grid of kMinCtas an SM)
constexpr int kWarps = kThreads / 32;
constexpr int kChunkWords = kThreads * kWords;
constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }
constexpr int kTreeLevels = log2i(kThreads);  // shift_ops holds kTreeLevels + 1 levels
constexpr int kSliceEntries = 4 * 8 * 16;     // table16: 4 word lanes x 8 nibbles x 16
constexpr int kOpEntries = (kTreeLevels + 1) * 8 * 16;
constexpr bool kSlice16 = true;
static_assert((kThreads & (kThreads - 1)) == 0 && kWarps <= 32, "a power-of-two CTA");

// Eight nibble lookups: nibble q of v through the 16-entry table t + 16 q.
// Every lane reads the same table at once, so the 16 entries lie in 16
// banks and equal nibbles share an address: no bank conflict.
__device__ __forceinline__ uint32_t lookup8(const uint32_t* t, uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int q = 0; q < 8; q++) r ^= t[16 * q + ((v >> (4 * q)) & 15u)];
  return r;
}

// One byte step of the CRC: the byte table's two nibble halves.
__device__ __forceinline__ uint32_t step1(const uint32_t* nib, uint32_t r, uint32_t byte) {
  const uint32_t x = (r ^ byte) & 0xFFu;
  return nib[6 * 16 + (x & 15u)] ^ nib[7 * 16 + (x >> 4)] ^ (r >> 8);
}

// The register after one 16-byte word, from register r: slicing by 16, its
// tables split into nibbles (word lane L through nib + 128 (3 - L)).
__device__ __forceinline__ uint32_t step16(const uint32_t* nib, uint32_t r, uint4 w) {
  if (kSlice16)
    return lookup8(nib + 384, w.x ^ r) ^ lookup8(nib + 256, w.y) ^ lookup8(nib + 128, w.z) ^
           lookup8(nib, w.w);
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 16; i++) r = step1(nib, r, v[i >> 2] >> (8 * (i & 3)));
  return r;
}

// Joins the registers of runs of segments held by the warp's lanes, lane
// order = byte order, over the levels from `first_level` up to `n` lanes
// (level k's operator at ops + 128 k); the result is in lane n - 1.
__device__ __forceinline__ uint32_t warp_tree(const uint32_t* ops, int first_level, int n,
                                              uint32_t r) {
  const int lane = threadIdx.x & 31;
  for (int s = 1, k = first_level; s < n; s <<= 1, k++) {
    const uint32_t left = __shfl_up_sync(0xFFFFFFFFu, lookup8(ops + 128 * k, r), s);
    if ((lane & (2 * s - 1)) == 2 * s - 1) r ^= left;
  }
  return r;
}

// Whole word `wi` of the row, 0 outside [0, whole); the first carries the
// initial value.
__device__ __forceinline__ uint4 load_word(const uint8_t* row, bool aligned, int64_t wi,
                                           int64_t whole) {
  uint4 w = make_uint4(0, 0, 0, 0);
  if (wi >= 0 && wi < whole) {
    const uint8_t* p = row + 16 * wi;
    if (aligned) {
      w = *reinterpret_cast<const uint4*>(p);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; i++)
        v[i] = uint32_t{p[4 * i]} | uint32_t{p[4 * i + 1]} << 8 | uint32_t{p[4 * i + 2]} << 16 |
               uint32_t{p[4 * i + 3]} << 24;
      w = make_uint4(v[0], v[1], v[2], v[3]);
    }
    if (wi == 0) w.x ^= 0xFFFFFFFFu;
  }
  return w;
}

// Loads this thread's words of chunk c of a row (see the kernel).
__device__ __forceinline__ void load_chunk(uint4 (&w)[kWords], const uint8_t* row, int64_t whole,
                                           int64_t c) {
  const int64_t chunks = (whole + kChunkWords - 1) / kChunkWords;
  const int64_t lead = chunks * kChunkWords - whole;  // leading zero words
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
#pragma unroll
  for (int i = 0; i < kWords; i++)
    w[i] = load_word(row, aligned, c * kChunkWords + int64_t{threadIdx.x} * kWords + i - lead,
                     whole);
}

__device__ __forceinline__ int64_t clamped_len(const int32_t* lengths, int64_t b, int64_t n_rows,
                                               int64_t stride) {
  if (b >= n_rows) return 0;
  const int64_t len = lengths[b];
  return len < 0 ? 0 : (len > stride ? stride : len);
}

__global__ void __launch_bounds__(kThreads, kMinCtas)
crc32c_rows_kernel(const uint8_t* __restrict__ rows, int64_t n_rows, int64_t stride,
                   const int32_t* __restrict__ lengths,
                   const uint32_t* __restrict__ table16,
                   const uint32_t* __restrict__ shift_ops, int masked,
                   int64_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t nib[kSliceEntries + kOpEntries];
  __shared__ uint32_t warp_r[kWarps];
  const uint32_t* ops = nib + kSliceEntries;
  const int tid = threadIdx.x;
  const int64_t step = gridDim.x;
  int64_t b = blockIdx.x;
  // Row b's first chunk is in w; row b + step's length is known and its
  // first chunk is fetched into w_next while row b is computed.
  int64_t len = clamped_len(lengths, b, n_rows, stride);
  int64_t len_next = clamped_len(lengths, b + step, n_rows, stride);
  uint4 w[kWords], w_next[kWords];
  load_chunk(w, rows + b * stride, len >> 4, 0);
  for (int i = tid; i < kSliceEntries + kOpEntries; i += kThreads)
    nib[i] = i < kSliceEntries ? table16[i] : shift_ops[i - kSliceEntries];
  __syncthreads();

  for (; b < n_rows; b += step) {
    const uint8_t* row = rows + b * stride;
    const int64_t whole = len >> 4;
    const int64_t chunks = (whole + kChunkWords - 1) / kChunkWords;
    const int64_t len_after = clamped_len(lengths, b + 2 * step, n_rows, stride);
    if (b + step < n_rows) load_chunk(w_next, row + step * stride, len_next >> 4, 0);
    // The register so far, kept by thread kWarps - 1 (where the tree ends).
    uint32_t acc = whole ? 0u : 0xFFFFFFFFu;
    for (int64_t c = 0; c < chunks; c++) {
      if (c) load_chunk(w, row, whole, c);  // rows past one chunk: the later chunks in turn
      uint32_t r = 0;
#pragma unroll
      for (int i = 0; i < kWords; i++) r = step16(nib, r, w[i]);
      r = warp_tree(ops, 0, 32, r);
      if ((tid & 31) == 31) warp_r[tid >> 5] = r;
      __syncthreads();
      if (tid < 32) {
        r = warp_tree(ops, 5, kWarps, tid < kWarps ? warp_r[tid] : 0u);
        if (tid == kWarps - 1) acc = c ? lookup8(ops + 128 * kTreeLevels, acc) ^ r : r;
      }
      __syncthreads();
    }
    if (tid == kWarps - 1) {
      const uint8_t* tail = row + 16 * whole;
      for (int i = 0; i < static_cast<int>(len & 15); i++) acc = step1(nib, acc, tail[i]);
      uint32_t crc = acc ^ 0xFFFFFFFFu;
      if (masked) crc = ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
      out[b] = static_cast<int64_t>(crc);
    }
#pragma unroll
    for (int i = 0; i < kWords; i++) w[i] = w_next[i];
    len = len_next;
    len_next = len_after;
  }
}

int sm_count() {
  static int count[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (!count[dev]) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

}  // namespace

extern "C" int stpu_cuda_crc32c_rows(const uint8_t* rows, int64_t n_rows,
                                     int64_t stride, const int32_t* lengths,
                                     const uint32_t* table16,
                                     const uint32_t* shift_ops, int masked,
                                     int64_t* out, void* stream) {
  const int64_t grid = n_rows < kMinCtas * sm_count() ? n_rows : kMinCtas * sm_count();
  crc32c_rows_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, stride, lengths, table16, shift_ops, masked, out);
  return static_cast<int>(cudaGetLastError());
}
"""


# K1 as measured against the current design: replicated byte tables and a
# persistent CTA as now, but the registers joined in a binary tree of 10
# levels (warp shuffles, then across warps), level k's operator M_{64 << k}.
TREE_CRC = r"""
// CRC32C (Castagnoli) of every row of a (B, S) uint8 batch, up to each
// row's length, plain or with Snappy's frame mask.
//
// Replaces: snappy_tpu/ops/pallas/crc32c.py crc32c_blocks_pallas (_kernel)
// and the XLA matmul snappy_tpu/ops/crc32c.py crc32c_masked_blocks that the
// JAX decode path calls. The TPU computes parity(bits @ W) on its matrix
// unit because it has no fast gather; on this card table lookups in shared
// memory are the natural CRC step.
//
// What bounds it: device-memory bytes. Each row is read once (one byte
// in, a few integer operations per byte), so the least time is the rows'
// valid bytes over the memory rate. Next to them: one table lookup a byte
// in shared memory, 128 bytes a clock an SM. The byte-serial CRC recurrence
// is the obstacle: the first port gave each of 256 threads a 256-byte
// segment walked one dependent lookup a byte, then shifted each register by
// a data-dependent distance.
//
// Design. A CRC register is linear over GF(2): the raw register of A || B
// from 0 is M_|B|(R(A)) ^ R(B), where M_n advances a register past n zero
// bytes, and zero bytes leave a register of 0 at 0. So:
// - One persistent CTA of kThreads = 1,024 threads an SM walks rows b,
//   b + grid, ...; while it computes a row, each thread's words of the next
//   row are already being fetched into registers.
// - A row's whole 16-byte words are right-aligned into chunks of
//   kThreads * kWords words, with leading zero words. Thread t takes the
//   kWords words at t * kWords of each chunk (all loads issued at once) and
//   runs slicing by 4 over them from a register of 0. The four byte tables
//   are replicated 32 times in shared memory, lane l reading copy l, so a
//   warp's lookups never clash on a bank (128 KiB, built once a CTA from
//   4 KiB). Its distance to the chunk's end is a constant of t.
// - The registers combine in a fixed binary tree over t, warp shuffles and
//   then across warps: level k joins neighbouring runs of 2^k segments as
//   M_{seg << k}(left) ^ right, seg = 16 * kWords bytes, each operator
//   applied as 8 nibble-table lookups (`shift_ops`, computed on the host; a
//   warp reads one 16-entry table at a time, so no bank clashes). Chunks
//   join in order through M_{seg * kThreads}, the last level. Warp 0 takes
//   the cross-warp tree of a row while the other warps go on to the next
//   (the warps' registers are double-buffered: one barrier a row).
// - The initial 0xFFFFFFFF is XORed into the first whole word's first four
//   bytes (a register is the next four bytes' XOR mask), so no thread
//   shifts it. The len % 16 tail bytes are byte steps by one thread, which
//   for len < 16 start from 0xFFFFFFFF.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWords = 4;  // 16-byte words a thread takes per chunk
constexpr int kWarps = kThreads / 32;
constexpr int kChunkWords = kThreads * kWords;
constexpr int log2i(int n) { return n > 1 ? 1 + log2i(n / 2) : 0; }
constexpr int kTreeLevels = log2i(kThreads);  // shift_ops holds kTreeLevels + 1 levels
constexpr int kRepEntries = 4 * 256 * 32;     // the byte tables, 32 copies each
constexpr int kOpEntries = (kTreeLevels + 1) * 8 * 16;
constexpr int kSmemBytes = 4 * (kRepEntries + kOpEntries + 2 * kWarps);
constexpr bool kSlice4 = true;
static_assert((kThreads & (kThreads - 1)) == 0 && kWarps <= 32, "a power-of-two CTA");

// Eight nibble lookups: nibble q of v through the 16-entry table t + 16 q.
__device__ __forceinline__ uint32_t lookup8(const uint32_t* t, uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int q = 0; q < 8; q++) r ^= t[16 * q + ((v >> (4 * q)) & 15u)];
  return r;
}

// Byte `byte` of table j, from this lane's copy (rep is offset by the lane).
__device__ __forceinline__ uint32_t table(const uint32_t* rep, int j, uint32_t byte) {
  return rep[(j * 256 + byte) * 32];
}

// One byte step of the CRC (table 0).
__device__ __forceinline__ uint32_t step1(const uint32_t* rep, uint32_t r, uint32_t byte) {
  return table(rep, 0, (r ^ byte) & 0xFFu) ^ (r >> 8);
}

// The register after 4 bytes x, from register r: slicing by 4, byte p of
// the word through table 3 - p.
__device__ __forceinline__ uint32_t step4(const uint32_t* rep, uint32_t r, uint32_t x) {
  if (!kSlice4) {
#pragma unroll
    for (int i = 0; i < 4; i++) r = step1(rep, r, x >> (8 * i));
    return r;
  }
  x ^= r;
  return table(rep, 3, x & 0xFFu) ^ table(rep, 2, (x >> 8) & 0xFFu) ^
         table(rep, 1, (x >> 16) & 0xFFu) ^ table(rep, 0, x >> 24);
}

// Joins the registers of runs of segments held by the warp's lanes, lane
// order = byte order, over the levels from `first_level` up to `n` lanes
// (level k's operator at ops + 128 k); the result is in lane n - 1.
__device__ __forceinline__ uint32_t warp_tree(const uint32_t* ops, int first_level, int n,
                                              uint32_t r) {
  const int lane = threadIdx.x & 31;
  for (int s = 1, k = first_level; s < n; s <<= 1, k++) {
    const uint32_t left = __shfl_up_sync(0xFFFFFFFFu, lookup8(ops + 128 * k, r), s);
    if ((lane & (2 * s - 1)) == 2 * s - 1) r ^= left;
  }
  return r;
}

// Whole word `wi` of the row, 0 outside [0, whole); the first carries the
// initial value.
__device__ __forceinline__ uint4 load_word(const uint8_t* row, bool aligned, int64_t wi,
                                           int64_t whole) {
  uint4 w = make_uint4(0, 0, 0, 0);
  if (wi >= 0 && wi < whole) {
    const uint8_t* p = row + 16 * wi;
    if (aligned) {
      w = *reinterpret_cast<const uint4*>(p);
    } else {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; i++)
        v[i] = uint32_t{p[4 * i]} | uint32_t{p[4 * i + 1]} << 8 | uint32_t{p[4 * i + 2]} << 16 |
               uint32_t{p[4 * i + 3]} << 24;
      w = make_uint4(v[0], v[1], v[2], v[3]);
    }
    if (wi == 0) w.x ^= 0xFFFFFFFFu;
  }
  return w;
}

// Loads this thread's words of chunk c of a row with `whole` whole words.
__device__ __forceinline__ void load_chunk(uint4 (&w)[kWords], const uint8_t* row, int64_t whole,
                                           int64_t c) {
  const int64_t chunks = (whole + kChunkWords - 1) / kChunkWords;
  const int64_t lead = chunks * kChunkWords - whole;  // leading zero words
  const bool aligned = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
#pragma unroll
  for (int i = 0; i < kWords; i++)
    w[i] = load_word(row, aligned, c * kChunkWords + int64_t{threadIdx.x} * kWords + i - lead,
                     whole);
}

__device__ __forceinline__ int64_t clamped_len(const int32_t* lengths, int64_t b, int64_t n_rows,
                                               int64_t stride) {
  if (b >= n_rows) return 0;
  const int64_t len = lengths[b];
  return len < 0 ? 0 : (len > stride ? stride : len);
}

__global__ void __launch_bounds__(kThreads, 1)
crc32c_rows_kernel(const uint8_t* __restrict__ rows, int64_t n_rows, int64_t stride,
                   const int32_t* __restrict__ lengths,
                   const uint32_t* __restrict__ table4,
                   const uint32_t* __restrict__ shift_ops, int masked,
                   int64_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* ops = smem + kRepEntries;
  uint32_t* warp_r = ops + kOpEntries;  // two rows' warp registers
  const int tid = threadIdx.x, lane = tid & 31;
  const uint32_t* rep = smem + lane;
  const int64_t step = gridDim.x;
  int64_t b = blockIdx.x;
  // Row b's first chunk is in w; row b + step's length is known and its
  // first chunk is fetched into w_next while row b is computed.
  int64_t len = clamped_len(lengths, b, n_rows, stride);
  int64_t len_next = clamped_len(lengths, b + step, n_rows, stride);
  uint4 w[kWords], w_next[kWords];
  load_chunk(w, rows + b * stride, len >> 4, 0);
  for (int i = tid; i < 4 * 256; i += kThreads) {  // copy l of entry i in bank l
    const uint32_t v = table4[i];
    for (int l = 0; l < 32; l++) smem[i * 32 + ((l + lane) & 31)] = v;
  }
  for (int i = tid; i < kOpEntries; i += kThreads) ops[i] = shift_ops[i];
  __syncthreads();

  for (int parity = 0; b < n_rows; b += step, parity ^= 1) {
    const uint8_t* row = rows + b * stride;
    const int64_t whole = len >> 4;
    const int64_t chunks = (whole + kChunkWords - 1) / kChunkWords;
    const int64_t len_after = clamped_len(lengths, b + 2 * step, n_rows, stride);
    if (b + step < n_rows) load_chunk(w_next, row + step * stride, len_next >> 4, 0);
    uint32_t* wr = warp_r + parity * kWarps;
    // The register so far, kept by thread kWarps - 1 (where the tree ends).
    uint32_t acc = whole ? 0u : 0xFFFFFFFFu;
    for (int64_t c = 0; c < chunks; c++) {
      if (c) {  // rows past one chunk: the later chunks in turn
        __syncthreads();  // warp 0 has read the last chunk's registers
        load_chunk(w, row, whole, c);
      }
      uint32_t r = 0;
#pragma unroll
      for (int i = 0; i < kWords; i++) {
        r = step4(rep, r, w[i].x);
        r = step4(rep, r, w[i].y);
        r = step4(rep, r, w[i].z);
        r = step4(rep, r, w[i].w);
      }
      r = warp_tree(ops, 0, 32, r);
      if (lane == 31) wr[tid >> 5] = r;
      __syncthreads();
      if (tid < 32) {
        r = warp_tree(ops, 5, kWarps, tid < kWarps ? wr[tid] : 0u);
        if (tid == kWarps - 1) acc = c ? lookup8(ops + 128 * kTreeLevels, acc) ^ r : r;
      }
    }
    if (tid == kWarps - 1) {
      const uint8_t* tail = row + 16 * whole;
      for (int i = 0; i < static_cast<int>(len & 15); i++) acc = step1(rep, acc, tail[i]);
      uint32_t crc = acc ^ 0xFFFFFFFFu;
      if (masked) crc = ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
      out[b] = static_cast<int64_t>(crc);
    }
#pragma unroll
    for (int i = 0; i < kWords; i++) w[i] = w_next[i];
    len = len_next;
    len_next = len_after;
  }
}

// One CTA an SM, with its shared memory granted once a device.
int grid_for(int64_t n_rows) {
  static int sms[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (!sms[dev]) {
    cudaFuncSetAttribute(crc32c_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (sms[dev] <= 0) sms[dev] = 1;
  }
  return static_cast<int>(n_rows < sms[dev] ? n_rows : sms[dev]);
}

}  // namespace

extern "C" int stpu_cuda_crc32c_rows(const uint8_t* rows, int64_t n_rows,
                                     int64_t stride, const int32_t* lengths,
                                     const uint32_t* table4,
                                     const uint32_t* shift_ops, int masked,
                                     int64_t* out, void* stream) {
  crc32c_rows_kernel<<<grid_for(n_rows), kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      rows, n_rows, stride, lengths, table4, shift_ops, masked, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def tree_tables(seg: int = 64, levels: int = 11) -> np.ndarray:
    """The tree designs' operators: level ``k`` is M_{seg << k} as eight
    nibble tables, ``(levels, 8, 16)``."""
    from snappy_tpu_torch.ops import crc32c

    return np.stack([crc32c.nibble_tables(seg << k) for k in range(levels)])


def slicing_nibbles() -> np.ndarray:
    """The nibble designs' slicing tables, ``(4, 8, 16)`` uint32:
    ``tab[j, q, n]`` is nibble ``q`` of word lane ``L = 3 - j``, i.e.
    ``table16[15 - p][n << 4 (q % 2)]`` for its byte ``p = 4 L + q // 2``."""
    from snappy_tpu_torch.format.tables import crc32c_table16

    t16 = crc32c_table16()
    n = np.arange(16)
    return np.stack([
        np.stack([t16[15 - (4 * (3 - j) + q // 2)][n << (4 * (q % 2))] for q in range(8)])
        for j in range(4)
    ]).astype(np.uint32)


# Names of variants that compute something else on purpose (timing only).
INEXACT = ("phase_clocks",)


def _swap(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"crc_emit_probe: {old!r} is not in the source")
    return text.replace(old, new)


def _swaps(text: str, pairs) -> str:
    for old, new in pairs:
        text = _swap(text, old, new)
    return text


FIRST_CRC_THREADS = "constexpr int kThreads = 256;"


def variants(families) -> dict[str, tuple[str, str]]:
    """``name: (kind, source text)`` of the chosen families; ``kind`` is
    "crc_first" (a byte table and the 32 x 32 shift columns), "crc" (the
    package's tables), "crc_nibble" (nibble slicing tables and the tree's
    nibble tables) or "emit"."""
    out = {}
    if "first" in families:
        out.update({
            "first_crc": ("crc_first", FIRST_CRC),
            "first_crc_1024_threads": ("crc_first", _swap(
                FIRST_CRC, FIRST_CRC_THREADS, "constexpr int kThreads = 1024;")),
            "first_emit": ("emit", FIRST_EMIT),
        })
    if "current" in families:
        out.update(current_variants())
    return out


# The current K1's alternatives: byte steps instead of slicing by 16, and
# the design it was measured against, kept below as text (ROW_CTA_CRC).
CUR_CRC_SLICE = ("  x ^= r;\n  return table(rep, 3, x & 0xFFu) ^ table(rep, 2, (x >> 8) & 0xFFu) ^\n"
                 "         table(rep, 1, (x >> 16) & 0xFFu) ^ table(rep, 0, x >> 24);\n")
CUR_CRC_BYTE_STEPS = ("#pragma unroll\n  for (int i = 0; i < 4; i++) r = step1(rep, r, x >> (8 * i));\n"
                      "  return r;\n")
# The first row's loads issued after the tables' barrier, not before it.
CUR_CRC_FIRST_ROW = (
    "  uint4 w[kWords], w_next[kWords];\n  load_chunk(w, rows + b * stride, len >> 4, 0);\n")
CUR_CRC_BARRIER = "    if (i < kOpEntries) ops[i < 32 * 128 ? (i & 127) * 32 + (i >> 7) : i] = opv[k];\n  }\n  __syncthreads();\n"
# Clock stamps in the current K1, taken by thread 0, per row: the CTA's
# prologue (the first row's loads and the tables), the slicing (with any
# wait for the row's words), the lane and warp operators with the warp's
# XOR, the barrier with the warps' XOR, and the tail with the store. Written as int64 at
# out[8 b + i].
CUR_CRC_STAMPS = [
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  long long c0 = clock64(), st[5] = {0, 0, 0, 0, 0}, tp = 0;\n"),
    ("  __syncthreads();\n\n  for (int parity = 0;",
     "  __syncthreads();\n  st[0] = clock64() - c0;\n\n  for (int parity = 0;"),
    ("      uint32_t r = 0;\n", "      tp = clock64();\n      uint32_t r = 0;\n"),
    ("        r = step4(rep, r, w[i].w);\n      }\n",
     "        r = step4(rep, r, w[i].w);\n      }\n"
     "      asm volatile(\"\" :: \"r\"(r));\n      st[1] += clock64() - tp;\n      tp = clock64();\n"),
    ("      r = lookup8(warp_ops + 128 * warp, warp_xor(lane_lookup8(ops + lane, r)));\n",
     "      r = lookup8(warp_ops + 128 * warp, warp_xor(lane_lookup8(ops + lane, r)));\n"
     "      asm volatile(\"\" :: \"r\"(r));\n      st[2] += clock64() - tp;\n      tp = clock64();\n"),
    ("        if (tid == 0) acc = c ? lookup8(chunk_op, acc) ^ r : r;\n      }\n",
     "        if (tid == 0) acc = c ? lookup8(chunk_op, acc) ^ r : r;\n      }\n"
     "      asm volatile(\"\" :: \"r\"(acc));\n      st[3] += clock64() - tp;\n"),
    ("    if (tid == 0) {\n      const uint8_t* tail",
     "    tp = clock64();\n    if (tid == 0) {\n      const uint8_t* tail"),
    ("      out[b] = static_cast<int64_t>(crc);\n",
     "      asm volatile(\"\" :: \"r\"(crc));\n      st[4] = clock64() - tp;\n"
     "      for (int i = 0; i < 5; i++) out[b * 8 + i] = st[i];\n"),
    ("    len = len_next;\n", "    len = len_next;\n    st[1] = st[2] = st[3] = st[4] = 0;\n"),
]
# Clock stamps of the current K1's prologue, thread 0 of each CTA: the
# tables' loads, the row's length and first loads issued, the tables' stores,
# and the barrier. Written as int64 at out[n_rows + 4 CTA + i].
CUR_CRC_PROLOGUE_STAMPS = [
    ("  int64_t b = blockIdx.x;\n", "  int64_t b = blockIdx.x;\n  const long long q0 = clock64();\n"),
    ("  // Row b's first chunk is in w;",
     "  asm volatile(\"\" :: \"r\"(tab[0]), \"r\"(opv[0]), \"r\"(opv[kOpLoads - 1]));\n"
     "  const long long q1 = clock64();\n  // Row b's first chunk is in w;"),
    ("#pragma unroll\n  for (int k = 0; k < kTabLoads; k++) {  // copy l",
     "  const long long q2 = clock64();\n#pragma unroll\n  for (int k = 0; k < kTabLoads; k++) {  // copy l"),
    ("  __syncthreads();\n\n  for (int parity = 0;",
     "  const long long q3 = clock64();\n  __syncthreads();\n  const long long q4 = clock64();\n"
     "  if (tid == 0) {\n    out[n_rows + 4 * blockIdx.x] = q1 - q0;\n    out[n_rows + 4 * blockIdx.x + 1] = q2 - q1;\n"
     "    out[n_rows + 4 * blockIdx.x + 2] = q3 - q2;\n    out[n_rows + 4 * blockIdx.x + 3] = q4 - q3;\n  }\n\n"
     "  for (int parity = 0;"),
]
CUR_CRC_PROLOGUE_PHASES = ("table_loads", "length_and_row_loads_issued", "table_stores", "barrier")
CUR_CRC_PHASES = ("prologue", "slicing", "fixed_operators", "barrier_and_warps_xor", "tail_and_store")
# Clock stamps in the current K5, taken by thread 0 and summed over a row's
# steps: plan loads with their prefix, the index search and merge, the
# gathers with the store, and the step's closing barrier. Written over the
# row's first 16 bytes (live rows only).
CUR_EMIT_STAMPS = [
    ("  int r0 = 0, r1 = 0;", "  long long acc_a = 0, acc_b = 0, acc_c = 0, acc_d = 0, tp = 0;\n  int r0 = 0, r1 = 0;"),
    ("  while (st.g < live) {\n", "  while (st.g < live) {\n    tp = clock64();\n"),
    ("    const int lim = r1 * kLanes;  // ex at lim is carry\n",
     "    const int lim = r1 * kLanes;  // ex at lim is carry\n    acc_a += clock64() - tp;\n    tp = clock64();\n"),
    ("#pragma unroll\n        for (int i = 0; i < 16; i++)\n          v[i >> 2] |=",
     "        if (t == 0) {\n          asm volatile(\"\" :: \"r\"(ix[0]), \"r\"(ix[15]));\n"
     "          acc_b += clock64() - tp;\n          tp = clock64();\n        }\n"
     "#pragma unroll\n        for (int i = 0; i < 16; i++)\n          v[i >> 2] |="),
    ("      *reinterpret_cast<uint4*>(orow + d0) = make_uint4(v[0], v[1], v[2], v[3]);\n",
     "      *reinterpret_cast<uint4*>(orow + d0) = make_uint4(v[0], v[1], v[2], v[3]);\n"
     "      if (t == 0) {\n        asm volatile(\"\" :: \"r\"(v[0]), \"r\"(v[1]), \"r\"(v[2]), \"r\"(v[3]));\n        acc_c += clock64() - tp;\n        tp = clock64();\n      }\n"),
    ("    __syncthreads();\n    st = nx;\n", "    __syncthreads();\n    acc_d += clock64() - tp;\n    st = nx;\n"),
    ("    *reinterpret_cast<uint4*>(orow + x) = zero;\n}",
     "    *reinterpret_cast<uint4*>(orow + x) = zero;\n  if (t == 0 && live)\n"
     "    *reinterpret_cast<uint4*>(orow) = make_uint4(acc_a, acc_b, acc_c, acc_d);\n}"),
]
CUR_EMIT_PHASES = ("plan_loads_and_prefix", "search_and_merge", "gathers_and_store", "closing_barrier")
# The current K5's alternatives: a binary search for every byte instead of
# the counted steps; CTAs of 128 threads (2 groups a step, a ring of 16
# rows) instead of 256 (4 groups, 32 rows), with runs of 8 or 16 groups;
# runs of 16 groups or whole rows (not 8) a CTA; a ring of 16 rows; and
# each step's first pass fetched in its own step (not during the step
# before).
CUR_EMIT_COUNT = "        if (k1 < k0 + 255) {"
CUR_EMIT_SHAPE = "constexpr int kWalkThreads = 256;"
CUR_EMIT_RING = "constexpr int kRing = 32;"
CUR_EMIT_RUN = "constexpr int kRunGroups = 8;"
CUR_EMIT_PREFETCH = [
    ("      if (p0) next = fetch(bp_row, dlt_row, st.from, m, p0);\n",
     "      next = fetch(bp_row, dlt_row, st.from, m, p0);\n"),
    ("    next = fetch(bp_row, dlt_row, nx.from, max(nx.u1 - nx.from, 0) * kLanes, 0);\n", ""),
]


def current_variants() -> dict[str, tuple[str, str]]:
    """The package's K1 and K5 as they ship, and the designs they were
    measured against (see the swaps above)."""
    csrc = os.path.join(HERE, "snappy_tpu_torch", "csrc")
    with open(os.path.join(csrc, "crc32c.cu")) as f, open(os.path.join(csrc, "emit.cu")) as g:
        crc, emit = f.read(), g.read()
    return {
        "current_crc": ("crc", crc),
        "current_crc_byte_steps": ("crc", _swap(crc, CUR_CRC_SLICE, CUR_CRC_BYTE_STEPS)),
        "current_crc_rows_after_tables": ("crc", _swaps(crc, [
            (CUR_CRC_FIRST_ROW, "  uint4 w[kWords], w_next[kWords];\n"),
            (CUR_CRC_BARRIER, CUR_CRC_BARRIER + "  load_chunk(w, rows + b * stride, len >> 4, 0);\n")])),
        "row_cta_crc": ("crc_nibble", ROW_CTA_CRC),
        "persistent_nibble_crc": ("crc_nibble", PERSISTENT_NIBBLE_CRC),
        "tree_crc": ("crc_tree", TREE_CRC),
        "current_crc_phase_clocks": ("crc", _swaps(crc, CUR_CRC_STAMPS)),
        "current_crc_prologue_phase_clocks": ("crc", _swaps(crc, CUR_CRC_PROLOGUE_STAMPS)),
        "current_emit": ("emit", emit),
        "current_emit_search_each_byte": ("emit", _swap(emit, CUR_EMIT_COUNT, "        if (false) {")),
        "current_emit_128_threads": ("emit", _swaps(emit, [
            (CUR_EMIT_SHAPE, "constexpr int kWalkThreads = 128;"),
            (CUR_EMIT_RING, "constexpr int kRing = 16;")])),
        "current_emit_128_threads_run_16": ("emit", _swaps(emit, [
            (CUR_EMIT_SHAPE, "constexpr int kWalkThreads = 128;"),
            (CUR_EMIT_RING, "constexpr int kRing = 16;"),
            (CUR_EMIT_RUN, "constexpr int kRunGroups = 16;")])),
        "current_emit_run_16": ("emit", _swap(emit, CUR_EMIT_RUN, "constexpr int kRunGroups = 16;")),
        "current_emit_whole_rows": ("emit", _swap(emit, CUR_EMIT_RUN, "constexpr int kRunGroups = 80;")),
        "current_emit_ring_16": ("emit", _swap(emit, CUR_EMIT_RING, "constexpr int kRing = 16;")),
        "current_emit_no_prefetch": ("emit", _swaps(emit, CUR_EMIT_PREFETCH)),
        "current_emit_phase_clocks": ("emit", _swaps(emit, CUR_EMIT_STAMPS)),
    }


OCCUPANCY = """
extern "C" int stpu_probe_occupancy() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, %s, %s, 0);
  return n;
}
"""


def main() -> int:
    if not torch.cuda.is_available():
        print("crc_emit_probe: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    from pathlib import Path

    import snappy_tpu_torch
    from snappy_tpu_torch import native
    from snappy_tpu_torch.format.tables import crc32c_table
    from snappy_tpu_torch.format.varint import write_varu64
    from snappy_tpu_torch.ops import _build, api, crc32c, emit, encode_flat, packing, parse

    dev = torch.device("cuda")

    def smi(query):
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]

    families = [a for a in sys.argv[1:] if a in ("first", "current")] or ["first", "current"]
    only = [a[len("only="):] for a in sys.argv[1:] if a.startswith("only=")]
    card = smi("name,power.limit")
    out_dir = Path(HERE) / "build" / "crc_emit_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    kinds, jobs = {}, []
    for name, (kind, text) in variants(families).items():
        if only and name not in only:
            continue
        first = name.startswith("first")
        kernel, threads = (("fused_emit_kernel", "kThreads" if first else "kWalkThreads")
                           if kind == "emit" else ("crc32c_rows_kernel", "kThreads"))
        (out_dir / f"{name}.cu").write_text(text + OCCUPANCY % (kernel, threads))
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
        kept = [(j, q) for j, q in zip(jobs, paths) if q is not None]
        jobs, paths = [j for j, _ in kept], [q for _, q in kept]
        kinds = {n: k for n, k in kinds.items() if n not in failed}
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    entries = {
        "crc_first": ("stpu_cuda_crc32c_rows", [p, i64, i64, p, p, p, i32, p, p]),
        "crc": ("stpu_cuda_crc32c_rows", [p, i64, i64, p, p, p, i32, p, p]),
        "crc_nibble": ("stpu_cuda_crc32c_rows", [p, i64, i64, p, p, p, i32, p, p]),
        "crc_tree": ("stpu_cuda_crc32c_rows", [p, i64, i64, p, p, p, i32, p, p]),
        "emit": ("stpu_cuda_fused_emit", [p, p, p, p, p, p, i64, p, i64, i64, p, p]),
    }
    libs, occupancy = {}, {}
    for (src, _), path in zip(jobs, paths):
        lib = ctypes.CDLL(str(path))
        sym, argtypes = entries[kinds[src.stem]]
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        libs[src.stem] = fn
        occupancy[src.stem] = lib.stpu_probe_occupancy()
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "build_failed": failed, "equal": {}, "ctas_per_sm": occupancy,
              "ptxas": {src.stem: [ln.strip() for ln in path.with_suffix(".log").read_text()
                                   .splitlines() if "registers" in ln or "spill" in ln]
                        for (src, _), path in zip(jobs, paths)}}
    for name, lines in report["ptxas"].items():
        print(f"crc_emit_probe: {name}: {lines[-2:]}", file=sys.stderr, flush=True)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def named(kind, *skip):
        return [n for n, k in kinds.items() if k in kind and not any(s in n for s in skip)]

    def timed(calls, reps):
        ms = {}
        for n in [*calls, *reversed(list(calls))]:
            ms.setdefault(n, []).append(chip_smoke.device_ms(calls[n], reps))
        return ms

    def tables(name):
        """The variant's two table arguments, as int32 bit patterns on the card."""
        if kinds[name] == "crc_first":
            t, ops = crc32c_table(), crc32c.shift_operators()
        elif kinds[name] == "crc_nibble":
            t, ops = slicing_nibbles(), tree_tables()
        elif kinds[name] == "crc_tree":
            t, ops = crc32c.kernel_tables()[0], tree_tables()
        else:
            t, ops = crc32c.kernel_tables()
        return [torch.from_numpy(np.ascontiguousarray(x).view(np.int32).reshape(-1)).to(dev)
                for x in (t, ops)]

    # -- K1 at both shapes ----------------------------------------------------------------
    data = chip_smoke.corpus_stream(chip_smoke.STREAM_BYTES)
    frame = native.frame_compress(data)
    chunks = chip_smoke.compressed_chunks(frame)
    fbodies = [c[0] for c in chunks]
    groups = api.launch_groups(fbodies, snappy_tpu_torch.get_config().decode_rows_per_launch)
    g = max(groups, key=len)
    gd = [chunks[i][1] for i in g]
    d_pad = packing.pad_to_bucket(max(gd), 1024)
    decoded = native.decompress_batch([write_varu64(gd[j]) + fbodies[i] for j, i in enumerate(g)])
    grows = np.zeros((len(g), d_pad), np.uint8)
    for j, x in enumerate(decoded):
        grows[j, : gd[j]] = np.frombuffer(x, np.uint8)
    host_crc = torch.tensor([native.crc32c_masked(x) for x in decoded], dtype=torch.int64)
    rng = np.random.default_rng(7)
    rlens = rng.integers(0, 65537, 512).astype(np.int32)
    rlens[:2] = (0, 65536)
    shapes = {
        "random_512x65536": (torch.from_numpy(rng.integers(0, 256, (512, 65536), dtype=np.uint8)),
                             torch.from_numpy(rlens)),
        "group_455x65536": (torch.from_numpy(grows), torch.tensor(gd, dtype=torch.int32)),
    }
    crc_names = named(("crc_first", "crc", "crc_nibble", "crc_tree"))
    tabs = {n: tables(n) for n in crc_names}
    report["crc"] = {}
    for shape, (rows, lens) in shapes.items() if crc_names else ():
        rows, lens = rows.to(dev), lens.to(dev)
        b, s = rows.shape
        want = crc32c.crc32c_plain(rows, lens, True)
        if shape.startswith("group"):
            report["equal"]["crc_plain:group:host_codec"] = torch.equal(want.cpu(), host_crc)

        def entry(fn, name):
            def call():
                out = torch.empty(b * (8 if "phase_clocks" in name else 1), dtype=torch.int64, device=dev)
                t, ops = tabs[name]
                _build.check(fn(rows.data_ptr(), b, s, lens.data_ptr(), t.data_ptr(), ops.data_ptr(),
                                1, out.data_ptr(), stream()), "probe")
                return out
            return call

        calls = {n: entry(libs[n], n) for n in crc_names}
        for n in crc_names:
            if not any(s in n for s in INEXACT):
                report["equal"][f"{n}:{shape}"] = torch.equal(calls[n](), want)
        stamps = {}
        for n in crc_names:
            if "prologue_phase_clocks" in n:
                ctas = min(b, torch.cuda.get_device_properties(dev).multi_processor_count)
                st = calls[n]()[b : b + 4 * ctas].view(ctas, 4).double().cpu()
                stamps[n] = {"mean": dict(zip(CUR_CRC_PROLOGUE_PHASES, st.mean(0).tolist())),
                             "max": dict(zip(CUR_CRC_PROLOGUE_PHASES, st.max(0).values.tolist()))}
            elif "phase_clocks" in n:
                st = calls[n]().view(b, 8)[:, :5].double().cpu()
                stamps[n] = {"mean": dict(zip(CUR_CRC_PHASES, st.mean(0).tolist())),
                             "max": dict(zip(CUR_CRC_PHASES, st.max(0).values.tolist()))}
        wrapper = lambda: crc32c.crc32c_masked_blocks(rows, lens)  # noqa: E731
        report["equal"][f"wrapper:{shape}"] = torch.equal(wrapper(), want)
        for _ in range(20):
            wrapper()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            wrapper()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        n_bytes = int(lens.clamp(0, s).sum())
        report["crc"][shape] = {
            "rows": b, "width": s, "bytes": n_bytes,
            "bound_ms": chip_smoke.bound_ms(n_bytes + 4 * b + 8 * b)[0],
            "device_ms": timed(calls, 50),
            "wrapper_device_ms": chip_smoke.device_ms(wrapper, 50),
            "wrapper_call_ms": chip_smoke.cuda_ms(wrapper, 50),
            "wrapper_host_us_per_call": host_us, "phase_clocks": stamps,
        }
        del rows, lens, calls, want

    # Every exact variant on rows that are not 16-byte aligned (width 4,001)
    # with lengths 0-17, and on rows past one chunk (width 131,077).
    for shape, (b, s) in {"odd_64x4001": (64, 4001), "wide_8x131077": (8, 131077)}.items() if crc_names else ():
        rows = torch.from_numpy(rng.integers(0, 256, (b, s), dtype=np.uint8)).to(dev)
        lens_np = rng.integers(0, s + 1, b).astype(np.int32)
        lens_np[:18] = np.arange(18)[:b]
        lens = torch.from_numpy(lens_np).to(dev)
        want = crc32c.crc32c_plain(rows, lens, True)
        for n in crc_names:
            if not any(x in n for x in INEXACT):
                out = torch.empty(b, dtype=torch.int64, device=dev)
                t, ops = tabs[n]
                _build.check(libs[n](rows.data_ptr(), b, s, lens.data_ptr(), t.data_ptr(),
                                     ops.data_ptr(), 1, out.data_ptr(), stream()), "probe")
                report["equal"][f"{n}:{shape}"] = torch.equal(out, want)
        report["equal"][f"wrapper:{shape}"] = torch.equal(crc32c.crc32c_masked_blocks(rows, lens), want)

    # -- K5 on the compress group ---------------------------------------------------------
    emit_names = named(("emit",))
    if emit_names:
        cblocks, clens = packing.blocks_of(data)
        n_rows = packing.pad_to_bucket(len(clens), 1)
        pad = n_rows - len(clens)
        cb = torch.from_numpy(np.concatenate([cblocks, np.zeros((pad, cblocks.shape[1]), np.uint8)])).to(dev)
        cl = torch.from_numpy(np.concatenate([clens, np.zeros(pad, np.int32)])).to(dev)
        jw, _ = encode_flat.prepass(cb, cl)
        rec = parse.parse_blocks(cl, jw, cb)
        lo_row, base, rows_g, out_len, bp_rows, dlt_rows, src, _ = encode_flat._fused_plan(cb, cl, *rec)
        plan = (lo_row, base, rows_g, out_len, bp_rows, dlt_rows)
        want5 = emit.fused_emit_plain(*plan, src)
        del cb, jw, rec

        def emitter(fn):
            def call():
                out = torch.empty((n_rows, emit.N_GROUPS * emit.GROUP), dtype=torch.uint8, device=dev)
                _build.check(fn(*(t.data_ptr() for t in plan), bp_rows.shape[1] * emit.LANES,
                                src.data_ptr(), src.shape[1], n_rows, out.data_ptr(), stream()), "probe")
                return out
            return call

        calls = {n: emitter(libs[n]) for n in emit_names}
        for n in emit_names:
            if not any(s in n for s in INEXACT):
                print(f"crc_emit_probe: {n}", file=sys.stderr, flush=True)
                report["equal"][f"{n}:group"] = torch.equal(calls[n](), want5)
        live = out_len > 0
        stamps = {}
        for n in emit_names:
            if "phase_clocks" in n:
                st = calls[n]()[live][:, :16].contiguous().view(torch.int32).double().cpu()
                stamps[n] = {"mean": dict(zip(CUR_EMIT_PHASES, st.mean(0).tolist())),
                             "max": dict(zip(CUR_EMIT_PHASES, st.max(0).values.tolist()))}
        wrapper = lambda: emit.fused_emit(*plan, src)  # noqa: E731
        report["equal"]["emit_wrapper:group"] = torch.equal(wrapper(), want5)
        report["emit"] = {
            "rows": n_rows, "live": int((out_len > 0).sum()),
            "device_ms": timed(calls, 10),
            "wrapper_device_ms": chip_smoke.device_ms(wrapper, 10),
            "wrapper_call_ms": chip_smoke.cuda_ms(wrapper, 10), "phase_clocks": stamps,
        }
        del want5, calls

    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "crc_emit_probe.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    return 0 if all(report["equal"].values()) and not failed else 1


if __name__ == "__main__":
    sys.exit(main())
