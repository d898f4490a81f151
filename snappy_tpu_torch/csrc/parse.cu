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
