// Self-contained replay decode of raw Snappy op streams, one row per warp,
// with the first error's device code per row.
//
// Replaces: snappy_tpu/ops/pallas/decode.py decode_batch_pallas (_make_kernel
// in its "plain" and "fast" modes, _make_compose_kernel in "compose"; the
// three share one contract). It must match them bit for bit: the valid
// prefix of the output is written, every byte after it is zero, and the
// code is that of the first bad op (1 literal, 2 copy read, 3 offset,
// 4 copy write), or 5 when the walk ended clean short of or past declen.
// The checks, their order, the 1<<30 length clamp and the int32 arithmetic
// follow decode.py:278-377 (and core.cpp stpu_scan_records, the same walk).
//
// What bounds it: the op walk's sequential dependence, not bytes. Each op's
// position depends on the previous op's length, so a row is one chain of
// short steps (a few loads and compares per ~7 output bytes on the corpus).
// The TPU kernel walks on its scalar core and moves payloads as 128-lane
// vector windows; here a warp does the same: all 32 lanes parse each op
// (the same addresses, so the loads are broadcasts) and then move its
// literal or copy together, 32 bytes at a time.
//
// Overlapping copies (offset < length) take the closed form
//   out[d + k] = out[d - offset + (k % offset)],
// which reads only bytes that earlier ops already finished, so no lane waits
// on another within an op; __syncwarp() between ops orders each op's writes
// before the next op's reads. A row that fits the opt-in shared memory of one
// block (227 KB on the H100) is staged there first, so the walk's tag reads
// and literal payloads come from shared memory; a wider row is read from
// device memory.
// The kernel writes every output byte: the decoded prefix, then zeros.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr uint32_t kCap = 1u << 30;  // clamp for lengths that provably overrun

enum : int32_t {
  kOk = 0,
  kLiteral = 1,
  kCopyRead = 2,
  kOffset = 3,
  kCopyWrite = 4,
  kHeaderMismatch = 5,
};

__global__ void __launch_bounds__(kWarp)
replay_kernel(const uint8_t* __restrict__ srcs, int64_t s_width,
              const int32_t* __restrict__ src_lens,
              const int32_t* __restrict__ declens, int64_t d_pad, int stage,
              uint8_t* __restrict__ dst, int32_t* __restrict__ errs) {
  extern __shared__ uint8_t staged[];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t n = src_lens[b];
  const int32_t declen = declens[b];
  const uint8_t* src = srcs + b * s_width;
  if (stage) {
    const int64_t n16 = (static_cast<int64_t>(n) + 15) / 16;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n16 * 16 <= s_width) {
      for (int64_t i = lane; i < n16; i += kWarp)
        reinterpret_cast<uint4*>(staged)[i] = reinterpret_cast<const uint4*>(src)[i];
    } else {
      for (int64_t i = lane; i < n; i += kWarp) staged[i] = src[i];
    }
    __syncwarp();
    src = staged;
  }
  uint8_t* out = dst + b * d_pad;

  auto at = [&](int32_t p) -> uint32_t { return p < n ? src[p] : 0u; };
  auto read4 = [&](int32_t p) -> uint32_t {
    return at(p) | at(p + 1) << 8 | at(p + 2) << 16 | at(p + 3) << 24;
  };

  int32_t s = 0, d = 0, err = kOk;
  while (s < n) {
    const uint32_t tag = src[s];
    const uint32_t kind = tag & 3u;
    const int32_t lenm1 = static_cast<int32_t>(tag >> 2);
    if (kind == 0) {
      const bool long_lit = lenm1 >= 60;
      const int32_t bc = min(max(lenm1 - 59, 1), 4);
      const uint32_t raw = read4(s + 1) & (0xFFFFFFFFu >> (8 * (4 - bc)));
      const int32_t ll =
          (long_lit ? static_cast<int32_t>(min(raw, kCap)) : lenm1) + 1;
      const int32_t content = s + 1 + (long_lit ? bc : 0);
      if ((long_lit && s + 5 > n) || (n - content < ll) || (declen - d < ll)) {
        err = kLiteral;
        break;
      }
      for (int32_t k = lane; k < ll; k += kWarp) out[d + k] = src[content + k];
      s = content + ll;
      d += ll;
    } else {
      const int32_t ntb = kind == 1 ? 1 : (kind == 2 ? 2 : 4);
      const int32_t length = kind == 1 ? 4 + (lenm1 & 7) : lenm1 + 1;
      const uint32_t off = kind == 1
                               ? ((tag >> 5) << 8 | at(s + 1))
                               : read4(s + 1) & (0xFFFFFFFFu >> (8 * (4 - ntb)));
      if (s + 1 + ntb > n) {
        err = kCopyRead;
      } else if (off == 0 || static_cast<uint32_t>(d) < off) {
        err = kOffset;
      } else if (d + length > declen) {
        err = kCopyWrite;
      }
      if (err != kOk) break;
      const int32_t o = static_cast<int32_t>(off);
      for (int32_t k = lane; k < length; k += kWarp)
        out[d + k] = out[d - o + (k < o ? k : k % o)];
      s += 1 + ntb;
      d += length;
    }
    __syncwarp();
  }
  for (int64_t p = d + lane; p < d_pad; p += kWarp) out[p] = 0;
  if (lane == 0) errs[b] = (err == kOk && d != declen) ? kHeaderMismatch : err;
}

}  // namespace

extern "C" int stpu_cuda_replay(const uint8_t* srcs, int64_t n_rows,
                                int64_t s_width, const int32_t* src_lens,
                                const int32_t* declens, int64_t d_pad,
                                uint8_t* dst, int32_t* errs, void* stream) {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const bool stage = s_width <= optin;
  const size_t smem = stage ? static_cast<size_t>(s_width) : 0;
  if (stage) {
    const cudaError_t e = cudaFuncSetAttribute(
        replay_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  replay_kernel<<<static_cast<unsigned>(n_rows), kWarp, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      srcs, s_width, src_lens, declens, d_pad, stage ? 1 : 0, dst, errs);
  return static_cast<int>(cudaGetLastError());
}
