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
