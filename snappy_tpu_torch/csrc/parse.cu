// Segment parse of the flat encoder: 128 independent greedy walks per
// 64 KiB block, one per 512-byte segment, over the prepass's jump words.
//
// Replaces: snappy_tpu/ops/pallas/encode_flat.py parse_blocks_pallas
// (_make_parse_kernel). The TPU kernel runs the 128 walks in lockstep, one
// per vector sublane, reads each segment's jump word with a masked
// multiply-reduce and routes the match-extension bytes at q = p - off
// through one-hot matrix products against four byte-shifted bf16 planes of
// the block, because Mosaic has no gather. Here a walk is a thread and both
// reads are loads, so the byte planes are not needed.
//
// What bounds it: device-memory bytes. Each live block reads its 256 KiB of
// jump words (each walk reads only the words it lands on, so less in
// practice) and its 64 KiB of bytes; every row writes 144 KiB of records.
// The walks themselves are serial chains of dependent loads (a jump word
// per hop or candidate, about 65 a walk on the corpus), so the time a
// block takes is its longest walk's latency.
//
// Design, for the memory system:
//  - Records go out in whole 32-byte sectors. A thread keeps its segment's
//    pending records in registers, 8 of rec0 and 8 of rec1, and writes each
//    eight as two 16-byte stores when the eighth arrives; the partial last
//    eight and the unused slots after it go out the same way, as zeros
//    (MAX_REC = 144 is 18 sectors a segment). Single 4-byte stores 576
//    bytes apart, each sector completed by eight instructions spread over
//    the walk, were most of the first port's time.
//  - A padding row (lens == 0, half the compress group's rows) walks
//    nothing: its thread block writes the row's zeros in coalesced 16-byte
//    stores and returns.
//  - The block is staged in shared memory (64 KiB: three CTAs an SM), and
//    four bytes are two aligned words and a funnel shift, zeros past its
//    end. Read in place through L1 instead, with four times as many CTAs
//    an SM, the group took 0.68 ms against 0.445 (resolve_parse_probe.py):
//    the blocks of that many CTAs do not fit L1, and every read waits on
//    L2.
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
constexpr int kSector = 8;  // int32 a 32-byte sector
constexpr int32_t kJwCand = 1 << 27;

// Four bytes of the staged block from pos, zeros past its end.
__device__ __forceinline__ uint32_t u32_at(const uint32_t* words, int pos) {
  const int w = pos >> 2;
  const uint32_t lo = words[w];
  const uint32_t hi = w + 1 < kS / 4 ? words[w + 1] : 0u;
  return __funnelshift_r(lo, hi, 8 * (pos & 3));
}

__device__ __forceinline__ int tz_bytes(uint32_t x) {
  return x ? (__ffs(static_cast<int>(x)) - 1) >> 3 : 4;
}

// Eight int32 into one 32-byte sector, two 16-byte stores.
__device__ __forceinline__ void put_sector(int32_t* at, const int32_t (&q)[kSector]) {
  reinterpret_cast<int4*>(at)[0] = make_int4(q[0], q[1], q[2], q[3]);
  reinterpret_cast<int4*>(at)[1] = make_int4(q[4], q[5], q[6], q[7]);
}

__global__ void __launch_bounds__(kNSeg)
parse_kernel(const int32_t* __restrict__ lens, const int32_t* __restrict__ jw,
             const uint8_t* __restrict__ blocks, int32_t* __restrict__ rec0,
             int32_t* __restrict__ rec1, int32_t* __restrict__ cnt) {
  const int64_t b = blockIdx.x;
  const int s = threadIdx.x;
  const int n = lens[b];
  if (n <= 0) {  // nothing to walk: the row's zeros, coalesced
    const int4 z = make_int4(0, 0, 0, 0);
    int4* z0 = reinterpret_cast<int4*>(rec0 + b * kNSeg * kMaxRec);
    int4* z1 = reinterpret_cast<int4*>(rec1 + b * kNSeg * kMaxRec);
    for (int i = s; i < kNSeg * kMaxRec / 4; i += kNSeg) {
      z0[i] = z;
      z1[i] = z;
    }
    int4* zc = reinterpret_cast<int4*>(cnt + b * kNSeg * kSector);
    for (int i = s; i < kNSeg * kSector / 4; i += kNSeg) zc[i] = z;
    return;
  }
  extern __shared__ uint4 staged[];
  const uint4* src = reinterpret_cast<const uint4*>(blocks + b * kS);
  for (int i = s; i < kS / 16; i += kNSeg) staged[i] = src[i];
  __syncthreads();
  const uint32_t* blk = reinterpret_cast<const uint32_t*>(staged);

  const int lo = s * kSeg;
  const int hi = min(lo + kSeg, n);
  const int32_t* jrow = jw + (b * kNSeg + s) * kSeg;
  int32_t* r0 = rec0 + (b * kNSeg + s) * kMaxRec;
  int32_t* r1 = rec1 + (b * kNSeg + s) * kMaxRec;

  int32_t q0[kSector], q1[kSector];  // the pending sector: slot k % 8
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
      const int slot = k % kSector;
#pragma unroll
      for (int i = 0; i < kSector; ++i) {
        if (i == slot) {
          q0[i] = (p - lo) | (new_lp << 10);
          q1[i] = offc;
        }
      }
      k++;
      if (slot == kSector - 1) {
        put_sector(r0 + k - kSector, q0);
        put_sector(r1 + k - kSector, q1);
      }
      p += new_lp;
    } else {
      p = hi;  // overflowing segments park at the segment end
    }
    extending = false;
    lp = 0;
  }
  // The partial last sector and the unused ones, zero-filled.
  const int filled = k % kSector;
  for (int j = k - filled; j < kMaxRec; j += kSector) {
#pragma unroll
    for (int i = 0; i < kSector; ++i) {
      if (j + i >= k) {
        q0[i] = 0;
        q1[i] = 0;
      }
    }
    put_sector(r0 + j, q0);
    put_sector(r1 + j, q1);
  }
  const int32_t c[kSector] = {k, k >= kMaxRec, 0, 0, 0, 0, 0, 0};
  put_sector(cnt + (b * kNSeg + s) * kSector, c);
}

}  // namespace

extern "C" int stpu_cuda_parse(const int32_t* lens, const int32_t* jw,
                               const uint8_t* blocks, int64_t n_rows, int32_t* rec0,
                               int32_t* rec1, int32_t* cnt, void* stream) {
  const cudaError_t e =
      cudaFuncSetAttribute(parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kS);
  if (e != cudaSuccess) return static_cast<int>(e);
  parse_kernel<<<static_cast<unsigned>(n_rows), kNSeg, kS,
                 static_cast<cudaStream_t>(stream)>>>(lens, jw, blocks, rec0, rec1, cnt);
  return static_cast<int>(cudaGetLastError());
}
