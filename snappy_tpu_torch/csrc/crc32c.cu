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
// - Thread t = 32 w + l of a chunk ends (31 - l) seg + (kWarps - 1 - w) 32 seg
//   bytes before the chunk's end, seg = 16 * kWords. So each lane advances
//   its register by its lane's fixed operator M_{(31 - l) seg}, the warp
//   XORs its lanes together (shuffles), advances the sum by the warp's
//   operator M_{(kWarps - 1 - w) 32 seg}, and warp 0 XORs the warps' sums.
//   Chunks join in order through M_{seg * kThreads}. Each operator is 8
//   nibble-table lookups (`shift_ops`, computed on the host): a lane reads
//   its own operator's tables, laid out in its own bank, and a warp's
//   operator is one address for all its lanes, so no lookup clashes on a
//   bank. Warp 0 takes the warps' XOR of a row while the other warps go on
//   to the next (the warps' sums are double-buffered: one barrier a row).
// - The initial 0xFFFFFFFF is XORed into the first whole word's first four
//   bytes (a register is the next four bytes' XOR mask), so no thread
//   shifts it. The len % 16 tail bytes are byte steps by one thread, which
//   for len < 16 start from 0xFFFFFFFF.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 1024;
constexpr int kWords = 4;  // 16-byte words a thread takes per chunk
constexpr int kWarps = kThreads / 32;
constexpr int kChunkWords = kThreads * kWords;
constexpr int kRepEntries = 4 * 256 * 32;  // the byte tables, 32 copies each
// shift_ops: 32 lane operators, kWarps warp operators, the chunk operator,
// 8 x 16 nibble entries each.
constexpr int kOpEntries = (32 + kWarps + 1) * 128;
constexpr int kSmemBytes = 4 * (kRepEntries + kOpEntries + 2 * kWarps);
static_assert(kThreads % 32 == 0 && kWarps <= 32, "whole warps, at most 32");

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
  x ^= r;
  return table(rep, 3, x & 0xFFu) ^ table(rep, 2, (x >> 8) & 0xFFu) ^
         table(rep, 1, (x >> 16) & 0xFFu) ^ table(rep, 0, x >> 24);
}

// The lane's own operator on v: its nibble tables striped, entry (q, n) of
// lane l at ops[(16 q + n) * 32 + l] (lane_ops is offset by the lane).
__device__ __forceinline__ uint32_t lane_lookup8(const uint32_t* lane_ops, uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int q = 0; q < 8; q++) r ^= lane_ops[(16 * q + ((v >> (4 * q)) & 15u)) * 32];
  return r;
}

// The XOR of the warp's 32 registers, in every lane.
__device__ __forceinline__ uint32_t warp_xor(uint32_t r) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r ^= __shfl_xor_sync(0xFFFFFFFFu, r, o);
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
  uint32_t* ops = smem + kRepEntries;  // the lane operators, striped
  const uint32_t* warp_ops = ops + 32 * 128;
  const uint32_t* chunk_op = warp_ops + kWarps * 128;
  uint32_t* warp_r = ops + kOpEntries;  // two rows' warp sums
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t* rep = smem + lane;
  const int64_t step = gridDim.x;
  int64_t b = blockIdx.x;
  // The tables' loads first (the row's would queue ahead of them), every
  // one issued before the first store.
  constexpr int kTabLoads = (4 * 256 + kThreads - 1) / kThreads;
  constexpr int kOpLoads = (kOpEntries + kThreads - 1) / kThreads;
  uint32_t tab[kTabLoads], opv[kOpLoads];
#pragma unroll
  for (int k = 0; k < kTabLoads; k++)
    tab[k] = tid + k * kThreads < 4 * 256 ? table4[tid + k * kThreads] : 0u;
#pragma unroll
  for (int k = 0; k < kOpLoads; k++)
    opv[k] = tid + k * kThreads < kOpEntries ? shift_ops[tid + k * kThreads] : 0u;
  // Row b's first chunk is in w; row b + step's length is known and its
  // first chunk is fetched into w_next while row b is computed.
  int64_t len = clamped_len(lengths, b, n_rows, stride);
  int64_t len_next = clamped_len(lengths, b + step, n_rows, stride);
  uint4 w[kWords], w_next[kWords];
  load_chunk(w, rows + b * stride, len >> 4, 0);
#pragma unroll
  for (int k = 0; k < kTabLoads; k++) {  // copy l of entry i in bank l
    const int i = tid + k * kThreads;
    if (i < 4 * 256)
      for (int l = 0; l < 32; l++) smem[i * 32 + ((l + lane) & 31)] = tab[k];
  }
#pragma unroll
  for (int k = 0; k < kOpLoads; k++) {  // lane l's entry e at e * 32 + l
    const int i = tid + k * kThreads;
    if (i < kOpEntries) ops[i < 32 * 128 ? (i & 127) * 32 + (i >> 7) : i] = opv[k];
  }
  __syncthreads();

  for (int parity = 0; b < n_rows; b += step, parity ^= 1) {
    const uint8_t* row = rows + b * stride;
    const int64_t whole = len >> 4;
    const int64_t chunks = (whole + kChunkWords - 1) / kChunkWords;
    const int64_t len_after = clamped_len(lengths, b + 2 * step, n_rows, stride);
    if (b + step < n_rows) load_chunk(w_next, row + step * stride, len_next >> 4, 0);
    uint32_t* wr = warp_r + parity * kWarps;
    // The register so far, kept by thread 0.
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
      r = lookup8(warp_ops + 128 * warp, warp_xor(lane_lookup8(ops + lane, r)));
      if (lane == 0) wr[warp] = r;
      __syncthreads();
      if (tid < 32) {
        r = warp_xor(tid < kWarps ? wr[tid] : 0u);
        if (tid == 0) acc = c ? lookup8(chunk_op, acc) ^ r : r;
      }
    }
    if (tid == 0) {
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

// One CTA an SM, with its shared memory granted once a device. The shards
// of a sharded entry launch from one host thread a card, and two entries of
// a mesh may share a card: std::call_once makes the first caller on a card
// set it up while the others wait, so no thread reads a half-written count.
int grid_for(int64_t n_rows) {
  constexpr int kMaxDevices = 64;
  static std::once_flag once[kMaxDevices];
  static int sms[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) dev = 0;
  std::call_once(once[dev], [dev] {
    cudaFuncSetAttribute(crc32c_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 1;
  });
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
