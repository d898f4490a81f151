// Grouped flat-gather decode (K11): the flat gather of K2 (layout 1) with a
// window bucket per 16 KiB group. For output byte d of row b, in group
// g = d >> 14 with bucket gb = gbuck[b, g]:
//   rel = idx[b, phys(d)], row = rel >> 7, lane = rel & 127,
//   base = tile_meta[b, d >> 10, 0],
//   out[b, d] = src[b, (base + row) * 128 + lane]
// when the group is live, row < w, 0 <= base + row < s_rows and d < declen[b];
// else 0. v3 (variant 3) takes buckets 0, 1, 2 as live and every other value
// as dead; v4 (variant 4) takes gb < 0 as dead and gb >= 2 as the wide
// window. The window w of bucket k is widths[k] = round128(min((128, 256,
// 512)[k], s_rows)), computed by the wrapper.
//
// Replaces: snappy_tpu/ops/pallas/decode.py decode_flat_pallas_v3
// (_make_flat_v3_kernel: one zero-branch pass per window width) and
// decode_flat_pallas_v4 (_make_flat_v4_kernel: one pass, a width switch per
// 16 KiB group). Both exist because Mosaic pays for a per-tile switch; they
// route bytes with one-hot matrix products over the window, so a byte whose
// row lies past the window reads 0, and the window is zero-padded past
// s_rows. Here a gather is a load, and the window is a bounds test.
//
// What bounds it: device-memory bytes (2 index bytes and one source byte
// read and one byte written per output byte; no arithmetic to speak of).
//
// Design: one CTA of 256 threads per (16 KiB group, row), so the group's
// bucket is read once and the branch is uniform across the CTA. A dead
// group, or one wholly past declen, stores zeros with 16-byte stores and
// reads no index. A live group copies its 16,384 uint16 indices (32 KiB, in
// the transposed layout-1 order) into shared memory with coalesced 16-byte
// loads, then each thread makes 16 consecutive output bytes, reading each
// index at phys(d) from shared memory, and stores them with one 16-byte
// store. The 16-byte chunks of the index block are XOR-swizzled in shared
// memory (chunk c at c ^ ((c >> 8) & 7)) so that both the copy and the
// reads at phys(d), which are 256 bytes apart from one output byte to the
// next, spread over the banks.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16384;
constexpr int kTile = 1024;
constexpr int kChunks = kGroup * 2 / 16;  // 16-byte chunks of one group's indices

__device__ __forceinline__ int swizzle(int chunk) { return chunk ^ ((chunk >> 8) & 7); }

__global__ void __launch_bounds__(kThreads)
flat_grouped_kernel(const uint8_t* __restrict__ srcs, int64_t s_width,
                    const uint16_t* __restrict__ idx,
                    const int32_t* __restrict__ tile_meta,
                    const int32_t* __restrict__ gbuck,
                    const int32_t* __restrict__ declens, int64_t d_pad,
                    int variant, int w0, int w1, int w2,
                    uint8_t* __restrict__ out) {
  __shared__ uint4 sidx[kChunks];
  const int64_t b = blockIdx.y;
  const int64_t g = blockIdx.x;
  const int64_t n_groups = d_pad / kGroup;
  const int64_t g0 = g * kGroup;
  const int64_t declen = declens[b];
  const int gb = gbuck[b * n_groups + g];
  const bool live = (variant == 3 ? (gb >= 0 && gb <= 2) : gb >= 0) && g0 < declen;
  uint4* dst = reinterpret_cast<uint4*>(out + b * d_pad + g0);
  if (!live) {
    for (int c = threadIdx.x; c < kGroup / 16; c += kThreads) dst[c] = make_uint4(0, 0, 0, 0);
    return;
  }
  const int w = gb == 0 ? w0 : (gb == 1 ? w1 : w2);
  const uint4* gidx = reinterpret_cast<const uint4*>(idx + b * d_pad + g0);
  for (int c = threadIdx.x; c < kChunks; c += kThreads) sidx[swizzle(c)] = gidx[c];
  __syncthreads();

  const uint16_t* sx = reinterpret_cast<const uint16_t*>(sidx);
  const uint8_t* src = srcs + b * s_width;
  const int64_t s_rows = s_width / 128;
  const int32_t* meta = tile_meta + (b * (d_pad / kTile) + g0 / kTile) * 2;
  for (int dl = threadIdx.x * 16; dl < kGroup; dl += kThreads * 16) {
    const int64_t base = meta[(dl / kTile) * 2];
    uint32_t words[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 16; k++) {
      const int d = dl + k;
      // phys(d) within the group: (d & 127) << 7 | tile << 3 | (d >> 7) & 7
      const int phys = ((d & 127) << 7) | (((d >> 10) & 15) << 3) | ((d >> 7) & 7);
      const int rel = sx[(swizzle(phys >> 3) << 3) | (phys & 7)];
      const int row = rel >> 7;
      const int64_t r = base + row;
      uint32_t v = 0;
      if (row < w && r >= 0 && r < s_rows && g0 + d < declen) v = src[r * 128 + (rel & 127)];
      words[k >> 2] |= v << (8 * (k & 3));
    }
    dst[dl / 16] = make_uint4(words[0], words[1], words[2], words[3]);
  }
}

}  // namespace

extern "C" int stpu_cuda_flat_grouped(const uint8_t* srcs, int64_t n_rows,
                                      int64_t s_width, const uint16_t* idx,
                                      const int32_t* tile_meta,
                                      const int32_t* gbuck,
                                      const int32_t* declens, int64_t d_pad,
                                      int variant, int w0, int w1, int w2,
                                      uint8_t* out, void* stream) {
  const dim3 grid(static_cast<unsigned>(d_pad / kGroup), static_cast<unsigned>(n_rows));
  flat_grouped_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      srcs, s_width, idx, tile_meta, gbuck, declens, d_pad, variant, w0, w1, w2, out);
  return static_cast<int>(cudaGetLastError());
}
