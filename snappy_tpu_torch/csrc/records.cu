// Record replay: decode rows from the host's validated op records.
//
// Replaces: snappy_tpu/ops/pallas/decode.py decode_records_pallas
// (_make_records_kernel, and _make_records_compose_kernel, a TPU move
// machinery with the same bytes). The host scan (native core.cpp
// stpu_scan_records) has parsed and validated every op in lockstep with the
// replay kernel, and packed each valid op into 8 bytes:
//   w0 = len | 1 << 30 for a literal (len bytes from src[w1]),
//   w0 = len           for a copy    (len bytes from out[d - w1]).
// The output holds the records' bytes, then zeros up to d_pad: the valid
// prefix of a corrupt row, as the TPU kernel writes it (the scan's error
// code goes with it).
//
// What bounds it: the replay's sequential dependence. Each op starts where
// the last one ended, so a row is a chain of short steps (about 5 output
// bytes an op on the corpus's 64 KiB frame chunks, chip_smoke.py), as in K3
// (csrc/replay.cu), minus the parsing and the checks.
//
// Design: one warp per row, as K3 walks a row. The lanes load 32 records at
// once (8 bytes each, coalesced) and take them one at a time by shuffles,
// so no lane waits on a record load per op. The lanes then move the op
// together, 32 bytes a step: a literal from the source row, a copy by the
// closed form out[d + k] = out[d - off + (k % off)] (k < off needs no
// modulo), which reads only bytes of earlier ops; __syncwarp() between ops
// orders each op's stores before the next op's loads. A row whose output
// fits one block's opt-in shared memory (227 KB on the H100) is staged
// there, zeroed first, so copies read shared memory and the row leaves in
// 16-byte stores; a wider row (the records route takes groups up to 1 MiB)
// is worked in device memory and zeroed past its records at the end.
// A record that would leave its row or pass declen (impossible for the
// scan's records) ends the replay.

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
