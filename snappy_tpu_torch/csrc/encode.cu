// The exact greedy encoder (K7): the reference encoder's hash-probe automaton
// per block of at most 64 KiB, emitting op bytes directly, byte for byte the
// reference's raw stream (without the varint preamble).
//
// Replaces: snappy_tpu/ops/pallas/encode.py compress_blocks_pallas
// (_make_kernel). The TPU kernel walks the automaton on the scalar core out of
// an int32 SMEM copy of the block, zeroes its SMEM table with a scalar loop,
// compares 128-byte rotated windows for the match extension and writes every
// header byte as a masked read-modify-write of a 128-lane output row, all
// because Mosaic has no scalar access to vector memory. None of that is
// needed here: one warp per block, the block staged once as bytes in shared
// memory and the 16 Ki-entry table beside it as uint16 positions (every
// position is below 65,536). Every lane carries the same scalar state, so
// control flow is uniform; only lane 0 touches the table and broadcasts what
// it read, so no lane can see another's later store. The lanes share the
// match extension (32 lanes x 4 bytes per step, __ballot_sync and __ffs for
// the first difference), the copy of literal bytes to the output row and the
// zero fill past out_len.
//
// What bounds it: the automaton is a serial chain per block (each probe's
// table load decides the next position), so a block takes one step after
// another whatever the card's width; device-memory bytes (each block read
// once, each 76,800-byte output row written once) bound it only when the
// blocks are many and their chains short. One 32-thread CTA uses 98,560 bytes
// of shared memory, so two blocks run per SM.
//
// Semantics kept bit for bit (snappy_tpu/ops/encode.py find_ops and
// serialize_ops, src/compress.rs:195-317 of the reference): table bits
// clip(ceil_log2(max(n - 1, 1)), 8, 14), hash (u32 * 0x1E35A7BD) >> (32 -
// bits) in wrapping uint32 arithmetic, a zeroed table whose 0 means
// position 0; s_limit = n - 15; skip starts at 32, each scan step advances
// skip >> 5 and stores s at the probed slot; extension clipped by n - es;
// after a copy h(s - 1) <- s - 1, then the swap at h(s) and the immediate
// re-match check; n < 17 is one literal and n == 0 emits nothing; copies
// split into 64-byte copy2s while len >= 68, one 60-byte copy2 if len > 64,
// then copy1 iff len <= 11 and offset <= 2047; literal headers of 1, 2 or 3
// bytes. The row is zero past out_len.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kOutW = 76800;
constexpr int kMaxS = 65536;
// The block, then zeros: an extension step reads up to 131 bytes past es <= n.
constexpr int kSrcCap = kMaxS + 256;
constexpr int kTable = 1 << 14;
constexpr int kSmem = kSrcCap + kTable * 2;
constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr int kInputMargin = 15;
constexpr int kMinNonLiteral = 17;
constexpr int kQuantum = 128;  // bytes compared per extension step
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t u32_at(const uint8_t* s, int pos) {
  return uint32_t{s[pos]} | uint32_t{s[pos + 1]} << 8 | uint32_t{s[pos + 2]} << 16 |
         uint32_t{s[pos + 3]} << 24;
}

// The output row and its write position; d is the same in every lane.
struct Emitter {
  uint8_t* row;
  const uint8_t* src;
  int d;
  int lane;

  __device__ __forceinline__ void byte(int v) {
    if (lane == 0) row[d] = static_cast<uint8_t>(v);
    d++;
  }

  __device__ void literal(int start, int end) {
    const int len = end - start;
    const int m = len - 1;
    if (m < 60) {
      byte(m << 2);
    } else if (m < 256) {
      byte(60 << 2);
      byte(m);
    } else {
      byte(61 << 2);
      byte(m & 0xFF);
      byte(m >> 8);
    }
    for (int k = lane; k < len; k += 32) row[d + k] = src[start + k];
    d += len;
  }

  __device__ __forceinline__ void copy2(int offset, int len) {
    byte(((len - 1) << 2) | 2);
    byte(offset & 0xFF);
    byte(offset >> 8);
  }

  __device__ void copy(int offset, int len) {
    while (len >= 68) {
      copy2(offset, 64);
      len -= 64;
    }
    if (len > 64) {
      copy2(offset, 60);
      len -= 60;
    }
    if (len <= 11 && offset <= 2047) {
      byte(((offset >> 8) << 5) | ((len - 4) << 2) | 1);
      byte(offset & 0xFF);
    } else {
      copy2(offset, len);
    }
  }
};

// Bytes equal from es and ec on, up to kQuantum: lane i compares bytes
// [4i, 4i + 4).
__device__ __forceinline__ int first_difference(const uint8_t* src, int es, int ec, int lane) {
  const uint32_t x = u32_at(src, es + 4 * lane) ^ u32_at(src, ec + 4 * lane);
  const unsigned lanes = __ballot_sync(kFull, x != 0);
  if (lanes == 0) return kQuantum;
  const int f = __ffs(static_cast<int>(lanes)) - 1;
  const uint32_t xf = __shfl_sync(kFull, x, f);
  return 4 * f + ((__ffs(static_cast<int>(xf)) - 1) >> 3);
}

__global__ void __launch_bounds__(32)
encode_kernel(const uint8_t* __restrict__ blocks, int64_t row_w,
              const int32_t* __restrict__ lens, uint8_t* __restrict__ out,
              int32_t* __restrict__ out_len) {
  extern __shared__ uint4 smem_words[];
  uint8_t* src = reinterpret_cast<uint8_t*>(smem_words);
  uint16_t* table = reinterpret_cast<uint16_t*>(src + kSrcCap);
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = lens[b];

  // Stage the block's n bytes and zeros up to kSrcCap; zero the table.
  const uint4* g = reinterpret_cast<const uint4*>(blocks + b * row_w);
  for (int w = lane; w < kSrcCap / 16; w += 32) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (16 * w < n) {
      v = g[w];
      if (16 * w + 16 > n) {  // the last partial word: keep bytes below n
        uint8_t* vb = reinterpret_cast<uint8_t*>(&v);
        for (int k = n - 16 * w; k < 16; k++) vb[k] = 0;
      }
    }
    smem_words[w] = v;
  }
  uint4* tw = reinterpret_cast<uint4*>(table);
  for (int w = lane; w < kTable * 2 / 16; w += 32) tw[w] = make_uint4(0, 0, 0, 0);
  __syncwarp();

  Emitter e{out + b * kOutW, src, 0, lane};
  if (n < kMinNonLiteral) {
    if (n > 0) e.literal(0, n);
  } else {
    const int bits = min(max(32 - __clz(static_cast<unsigned>(max(n - 1, 1))), 8), 14);
    const unsigned shift = 32 - bits;
    auto hash = [shift](uint32_t x) { return static_cast<int>((x * kHashMul) >> shift); };
    const int s_limit = n - kInputMargin;

    bool extending = false;
    int s_next = 1, skip = 32, next_emit = 0, next_hash = hash(u32_at(src, 1));
    int base = 0, es = 0, ec = 0, cand = 0;
    while (true) {
      if (!extending) {
        const int s = s_next;
        const int bb = skip >> 5;
        s_next = s + bb;
        skip += bb;
        if (s_next > s_limit) {
          if (next_emit < n) e.literal(next_emit, n);
          break;
        }
        int c = 0;
        if (lane == 0) {
          c = table[next_hash];
          table[next_hash] = static_cast<uint16_t>(s);
        }
        c = __shfl_sync(kFull, c, 0);
        next_hash = hash(u32_at(src, s_next));
        if (u32_at(src, s) == u32_at(src, c)) {
          if (s > next_emit) e.literal(next_emit, s);
          extending = true;
          base = s;
          es = s + 4;
          ec = c + 4;
          cand = c;
        }
        continue;
      }
      const int first = first_difference(src, es, ec, lane);
      const int ext = min(first, n - es);
      es += ext;
      ec += ext;
      if (first == kQuantum && ext == first) continue;
      e.copy(base - cand, es - base);
      const int s = es;
      next_emit = s;
      if (s >= s_limit) {
        if (s < n) e.literal(s, n);
        break;
      }
      const int h1 = hash(u32_at(src, s - 1));
      const uint32_t cur = u32_at(src, s);
      const int h = hash(cur);
      int c = 0;
      if (lane == 0) {
        table[h1] = static_cast<uint16_t>(s - 1);
        c = table[h];
        table[h] = static_cast<uint16_t>(s);
      }
      c = __shfl_sync(kFull, c, 0);
      if (cur == u32_at(src, c)) {
        base = s;
        es = s + 4;
        ec = c + 4;
        cand = c;
      } else {
        extending = false;
        s_next = s + 1;
        skip = 32;
        next_hash = hash(u32_at(src, s + 1));
      }
    }
  }

  if (lane == 0) out_len[b] = e.d;
  // Zero the row past out_len: bytes up to a 16-byte boundary, then words.
  uint8_t* row = e.row;
  const int d16 = min((e.d + 15) & ~15, kOutW);
  for (int k = e.d + lane; k < d16; k += 32) row[k] = 0;
  uint4* rw = reinterpret_cast<uint4*>(row);
  for (int w = d16 / 16 + lane; w < kOutW / 16; w += 32) rw[w] = make_uint4(0, 0, 0, 0);
}

}  // namespace

// blocks: (n_rows, row_w) uint8, 16-byte aligned, row_w % 128 == 0 and
// <= 65536; lens: (n_rows,) int32 in [0, row_w]; out: (n_rows, 76800)
// uint8; out_len: (n_rows,) int32.
extern "C" int stpu_cuda_encode(const uint8_t* blocks, int64_t row_w, const int32_t* lens,
                                int64_t n_rows, uint8_t* out, int32_t* out_len,
                                void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  encode_kernel<<<static_cast<unsigned>(n_rows), 32, kSmem,
                  static_cast<cudaStream_t>(stream)>>>(blocks, row_w, lens, out, out_len);
  return static_cast<int>(cudaGetLastError());
}
