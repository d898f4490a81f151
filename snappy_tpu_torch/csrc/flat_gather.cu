// Flat-gather decode: out[b, d] = src[b, base(b, d >> 10) * 128 + idx[b, phys(d)]]
// for d < declen[b], and 0 for declen[b] <= d < d_pad.
//
// Replaces: snappy_tpu/ops/pallas/decode.py decode_flat_pallas_v2
// (_make_flat_v2_kernel; layout 1) and decode_flat_pallas (_make_flat_kernel;
// layout 0). The host flatten (native core.cpp stpu_flatten_idx) has already
// resolved every copy chain to the literal byte it reads, so decode is one
// gather. Mosaic has no general gather, so the TPU kernels route bytes with
// one-hot matrix products over 128/256/512-row source windows; here a gather
// is a plain load, and the window bucket (tile_meta[..., 1]) is ignored.
//
// What bounds it: device-memory bytes. Per output byte it reads 2 index
// bytes and one source byte and writes one byte; there is no arithmetic to
// speak of. Source rows are at most 80 KiB, so the scattered source reads
// hit L1/L2 after their first touch.
//
// Design: grid (d_pad / 1024 tiles, B rows) of 256 threads; each thread
// makes 4 consecutive output bytes and writes them with one 32-bit store.
// A tile wholly past declen writes zeros without reading anything.
// layout 1 is the transposed block order of the TPU v2 kernel, where each
// 16 KiB group is a 128 x 128 block (core.cpp:547):
//   phys(d) = (d >> 14 << 14) | ((d & 127) << 7) | (((d >> 10) & 15) << 3)
//             | ((d >> 7) & 7)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;

__device__ __forceinline__ int64_t phys_index(int64_t d, int layout) {
  if (layout == 0) return d;
  return (d >> 14 << 14) | ((d & 127) << 7) | (((d >> 10) & 15) << 3) |
         ((d >> 7) & 7);
}

__global__ void __launch_bounds__(kThreads)
flat_gather_kernel(const uint8_t* __restrict__ srcs, int64_t s_width,
                   const uint16_t* __restrict__ idx,
                   const int32_t* __restrict__ tile_meta,
                   const int32_t* __restrict__ declens, int64_t d_pad,
                   int layout, uint8_t* __restrict__ out) {
  const int64_t b = blockIdx.y;
  const int64_t tile = blockIdx.x;
  const int64_t d0 = tile * kTile + threadIdx.x * 4;
  const int64_t declen = declens[b];
  uint32_t word = 0;
  if (tile * kTile < declen) {
    const uint8_t* src = srcs + b * s_width;
    const uint16_t* ix = idx + b * d_pad;
    const int64_t base = int64_t{tile_meta[(b * (d_pad / kTile) + tile) * 2]} * 128;
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

extern "C" int stpu_cuda_flat_gather(const uint8_t* srcs, int64_t n_rows,
                                     int64_t s_width, const uint16_t* idx,
                                     const int32_t* tile_meta,
                                     const int32_t* declens, int64_t d_pad,
                                     int layout, uint8_t* out, void* stream) {
  const dim3 grid(static_cast<unsigned>(d_pad / kTile), static_cast<unsigned>(n_rows));
  flat_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      srcs, s_width, idx, tile_meta, declens, d_pad, layout, out);
  return static_cast<int>(cudaGetLastError());
}
