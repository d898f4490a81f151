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
