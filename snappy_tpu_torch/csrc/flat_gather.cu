// Flat-gather decode, K2 and K11 in one kernel.
//
// K2:  out[b, d] = src[b, base(b, d >> 10) * 128 + idx[b, phys(d)]] for
//      d < declen[b] and a position inside the row; every other byte is 0.
// K11: the same in layout 1 with a window bucket gb per 16 KiB group: a byte
//      also needs its window-relative row idx >> 7 below the bucket's window
//      w (widths[gb], computed by the wrapper), and a dead group (v3: gb
//      outside 0..2; v4: gb < 0) is zeros.
// layout 0 keeps idx in output order (phys(d) = d); layout 1 is the TPU v2
// kernel's transposed block order, each 16 KiB group a 128 x 128 block:
//   phys(d) = (d >> 14 << 14) | ((d & 127) << 7) | (((d >> 10) & 15) << 3)
//             | ((d >> 7) & 7)
//
// Replaces: snappy_tpu/ops/pallas/decode.py decode_flat_pallas_v2 (layout 1),
// decode_flat_pallas (layout 0), decode_flat_pallas_v3 and _v4 (K11). Mosaic
// has no gather, so the TPU kernels route bytes with one-hot matrix products
// over 128/256/512-row source windows; here a window is a bounds test.
//
// What bounds it: device-memory bytes (per output byte, 2 index bytes and a
// source byte read and a byte written). The first design ran at nearly five
// times that bound, not for its scattered source loads as such (dropping
// them saved a fifth of its time) but for its chains of dependent loads:
// each thread made 4 bytes, each behind its index load, in 64-bit
// arithmetic. With the loads issued together this design runs at 1.75
// times the bound, and at 1.0 without its source reads. Staging each CTA's
// source span in shared memory and gathering from there took 0.94 of this
// design's time, at 80 registers with spills and 72 KB of shared memory a
// CTA; this one keeps 64 registers, 16 KB and no span machinery
// (flat_gather_probe.py, PERF.md §6).
//
// Design: one CTA of 256 threads per (16 KiB unit of output, row).
// 1. A unit wholly past declen, or dead under K11, stores zeros, reads nothing.
// 2. Each thread loads 8 chunks of 8 indices, 16 bytes each, coalesced,
//    into registers, with their tiles' bases. In layout 1 a chunk holds
//    output bytes d, d+128, ..., d+896 of one tile; in layout 0, 8
//    consecutive ones.
// 3. It then issues its 64 source loads, independent of each other, in
//    32-bit arithmetic (L1 caches the rows), and stores each byte into an
//    output tile in shared memory, whose 16-byte chunks are XOR-swizzled by
//    tile so that layout 1's column stores spread over the banks.
// 4. The tile goes out with 16-byte stores.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;                        // CTAs per SM the registers allow
constexpr int kTile = 1024;
constexpr int kUnit = 16384;                         // output bytes per CTA
constexpr int kChunksPerThread = kUnit / 8 / kThreads;

// Physical 16-byte chunk of output chunk q of the unit (q >> 6 is its tile).
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 6) & 7); }

template <int kLayout>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flat_kernel(const uint8_t* __restrict__ srcs, int s_width, const uint16_t* __restrict__ idx,
            const int32_t* __restrict__ tile_meta, const int32_t* __restrict__ gbuck,
            const int32_t* __restrict__ declens, int d_pad, int variant, int w0, int w1, int w2,
            uint8_t* __restrict__ out) {
  constexpr int kStep = kLayout ? 128 : 1;  // output bytes between a chunk's indices
  __shared__ uint4 tile4[kUnit / 16];
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

  const uint8_t* src = srcs + b * s_width;
  const int32_t* meta = tile_meta + (b * (d_pad / kTile) + g0 / kTile) * 2;
  // Chunk j of this thread: c = tid + j * kThreads, the indices of output
  // bytes d0 + k * kStep, stored in the tile at a0 + k * kStep.
  const uint4* gidx = reinterpret_cast<const uint4*>(idx + b * d_pad + g0);
  uint4 chunk[kChunksPerThread];
  int base[kChunksPerThread];
#pragma unroll
  for (int j = 0; j < kChunksPerThread; j++) {
    const int c = tid + j * kThreads;
    chunk[j] = c < n_chunks ? __ldg(gidx + c) : make_uint4(0, 0, 0, 0);
    // Clamped, a base leaves every position on the same side of 0 and s_width.
    const int m = c < n_chunks ? __ldg(meta + (kLayout ? c & 15 : c >> 7) * 2) : 0;
    base[j] = min(max(m, -513), s_width / 128 + 1) * 128;
  }
  uint8_t* tile = reinterpret_cast<uint8_t*>(tile4);
#pragma unroll
  for (int j = 0; j < kChunksPerThread; j++) {
    const int c = tid + j * kThreads, t = c & 15, col = c >> 4;
    const int d0 = kLayout ? t * kTile + col : c * 8;
    const int a0 = kLayout ? t * kTile + (((col >> 4) ^ (t & 7)) << 4) + (col & 15)
                           : (swz(c >> 1) << 4) + (c & 1) * 8;
    // Index r is read when rlo <= r < rlo + rn: inside the row and the window.
    const int rlo = max(0, -base[j]);
    const unsigned rn = max(0, min(s_width - base[j], wlim) - rlo);
    const int dlim = min(lim, n_chunks * 8) - d0;  // byte k is live iff k * kStep < dlim
    const uint32_t w[4] = {chunk[j].x, chunk[j].y, chunk[j].z, chunk[j].w};
    if (c < n_chunks) {
#pragma unroll
      for (int k = 0; k < 8; k++) {
        const int r = (w[k >> 1] >> (16 * (k & 1))) & 0xFFFF;
        uint8_t x = 0;
        if (static_cast<unsigned>(r - rlo) < rn && k * kStep < dlim) x = __ldg(src + base[j] + r);
        tile[a0 + k * kStep] = x;
      }
    }
  }
  __syncthreads();
  for (int q = tid; q < n_chunks / 2; q += kThreads) dst[q] = tile4[swz(q)];
}

int launch(const uint8_t* srcs, long long n_rows, long long s_width, const uint16_t* idx,
           const int32_t* tile_meta, const int32_t* gbuck, const int32_t* declens,
           long long d_pad, int layout, int variant, int w0, int w1, int w2, uint8_t* out,
           void* stream) {
  const auto kernel = layout ? flat_kernel<1> : flat_kernel<0>;
  const dim3 grid(static_cast<unsigned>((d_pad + kUnit - 1) / kUnit), static_cast<unsigned>(n_rows));
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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

extern "C" int stpu_cuda_flat_grouped(const uint8_t* srcs, int64_t n_rows, int64_t s_width,
                                      const uint16_t* idx, const int32_t* tile_meta,
                                      const int32_t* gbuck, const int32_t* declens,
                                      int64_t d_pad, int variant, int w0, int w1, int w2,
                                      uint8_t* out, void* stream) {
  return launch(srcs, n_rows, s_width, idx, tile_meta, gbuck, declens, d_pad, 1, variant, w0, w1,
                w2, out, stream);
}
