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
// needed here: one warp per block, the 16 Ki-entry table in shared memory as
// uint16 positions (every position is below 65,536), the block read where it
// lies, through L1.
//
// What bounds it: the automaton is a serial chain per block, so a block
// takes one step after another whatever the card's width, and each step is
// a few dependent loads; device-memory bytes (each block read once, each
// 76,800-byte output row written once) bound it only when the blocks are
// many and their chains short. So the design shortens the chain and runs
// as many chains at once as shared memory allows: with only the table
// (33 KB) in shared memory six blocks run per SM. Staging the block beside
// it (99 KB, two per SM) made each chain faster and the group slower
// (encode_records_probe.py keeps that design as text).
//
// Design: the warp takes the scan 32 probes at a time. After every
// (re)start skip is 32 and probe k of the run advances skip >> 5, so the
// run's positions r + A[k] are known in advance (A, the cumulative
// advances, sits in shared memory). In a round lane j probes r + A[k0 + j]
// and exists while r + A[k0 + j + 1] <= s_limit; the first matching lane
// (__ballot_sync) ends it, and the lanes up to it store their positions.
// The round speculates that its lanes' hashes differ: each lane's candidate
// is its own table entry, and the storing lanes read their slots back. A
// lane that finds another's position (two lanes of one hash) sends the round
// down the exact path: the stores undone, __match_any_sync gives each lane
// the highest earlier lane of its hash, whose position is the candidate the
// serial loop would have read, and a lane stores only when no later storing
// lane shares its hash, so the table ends as the serial stores leave it.
// After a copy ending at s, the re-match probe at s is made alone, as the
// serial loop makes it (h(s - 1) <- s - 1, then the swap at h(s)), and a
// miss restarts the run from s + 1 (folding it into lane 0 of the next
// round was slower, and so was taking every round down the exact path).
// Words are built from two aligned 32-bit loads and a funnel shift. The
// lanes share the match extension (32 lanes x 4 bytes a quantum,
// __ballot_sync and __ffs for the first difference), the copy of literal
// bytes to the output row and the zero fill past out_len. ops/encode.py
// find_ops_rounds is this walk on the host.
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
constexpr int kTable = 1 << 14;
// A[k] for every probe a run within 64 KiB can reach, and a round of lanes more
// (ops/encode.py ADVANCE).
constexpr int kAdvance = 299;
constexpr uint32_t kHashMul = 0x1E35A7BDu;
constexpr int kInputMargin = 15;
constexpr int kMinNonLiteral = 17;
constexpr int kQuantum = 128;  // bytes compared per extension step
constexpr int kLanes = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// The table and A; the block is read in place, through L1.
constexpr int kSmem = kTable * 2 + kAdvance * 4;

// The little-endian word at byte p, from two aligned words. Words past the
// row's last are taken as that one (only an extension reads past n, and it
// is clipped there).
__device__ __forceinline__ uint32_t u32_at(const uint32_t* w, int last_word, int p) {
  return __funnelshift_r(__ldg(w + min(p >> 2, last_word)), __ldg(w + min((p >> 2) + 1, last_word)),
                         (p & 3) * 8);
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
    for (int k = lane; k < len; k += kLanes) row[d + k] = src[start + k];
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
__device__ __forceinline__ int first_difference(const uint32_t* w, int last_word, int es, int ec,
                                                int lane) {
  const uint32_t x = u32_at(w, last_word, es + 4 * lane) ^ u32_at(w, last_word, ec + 4 * lane);
  const unsigned lanes = __ballot_sync(kFull, x != 0);
  if (lanes == 0) return kQuantum;
  const int f = __ffs(static_cast<int>(lanes)) - 1;
  const uint32_t xf = __shfl_sync(kFull, x, f);
  return 4 * f + ((__ffs(static_cast<int>(xf)) - 1) >> 3);
}

__global__ void __launch_bounds__(kLanes)
encode_kernel(const uint8_t* __restrict__ blocks, int64_t row_w,
              const int32_t* __restrict__ lens, uint8_t* __restrict__ out,
              int32_t* __restrict__ out_len) {
  extern __shared__ uint4 smem_words[];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const int n = lens[b];
  const uint8_t* g = blocks + b * row_w;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(g);
  const int last_word = static_cast<int>(row_w / 4) - 1;
  uint16_t* table = reinterpret_cast<uint16_t*>(smem_words);
  int* advance = reinterpret_cast<int*>(table + kTable);

  Emitter e{out + b * kOutW, g, 0, lane};
  if (n < kMinNonLiteral) {
    if (n > 0) e.literal(0, n);
  } else {
    // The table is zeroed while lane 0 tabulates the run advances.
    uint4* tw = reinterpret_cast<uint4*>(table);
    for (int w = lane; w < kTable * 2 / 16; w += kLanes) tw[w] = make_uint4(0, 0, 0, 0);
    if (lane == 0) {
      int a = 0, skip = 32;
      for (int k = 0; k < kAdvance; ++k) {
        advance[k] = a;
        a += skip >> 5;
        skip += skip >> 5;
      }
    }
    __syncwarp();

    const int bits = min(max(32 - __clz(static_cast<unsigned>(max(n - 1, 1))), 8), 14);
    const unsigned shift = 32 - bits;
    auto hash = [shift](uint32_t x) { return static_cast<int>((x * kHashMul) >> shift); };
    const int s_limit = n - kInputMargin;
    const unsigned below = (1u << lane) - 1;  // the lanes before this one

    // The scan run: lane j of a round probes run + A[k0 + j].
    int next_emit = 0, run = 1, k0 = 0;
    int s = -1, c = 0;  // a match the re-match probe found, else s < 0
    while (true) {
      if (s < 0) {
        const int k = k0 + lane;
        int pos, next;
        if (k0 == 0) {  // A[k] = k for k <= 32
          pos = run + k;
          next = pos + 1;
        } else {
          pos = run + advance[min(k, kAdvance - 1)];
          next = run + advance[min(k + 1, kAdvance - 1)];
        }
        const bool valid = next <= s_limit;
        pos = min(pos, n);  // a lane past the run probes inside the row
        const unsigned live = __ballot_sync(kFull, valid);
        const uint32_t cur = u32_at(words, last_word, pos);
        const int h = hash(cur);
        const int old = table[h];
        // Speculate that no two lanes of the round share a hash: each lane's
        // candidate is then its table entry.
        int cand = old;
        unsigned hits = __ballot_sync(kFull, valid && cur == u32_at(words, last_word, cand));
        int last = hits ? __ffs(static_cast<int>(hits)) - 1 : 31 - __clz(static_cast<int>(live));
        // The lanes up to the first match store, then read back: a lane that
        // finds another's position lost its slot to a lane of the same hash.
        if (lane <= last) table[h] = static_cast<uint16_t>(pos);
        __syncwarp();
        // A round with one storing lane has no clash.
        const unsigned clash = last > 0 ? __ballot_sync(kFull, lane <= last && table[h] != pos) : 0u;
        if (clash) {
          // Undo the stores, then take the round exactly: lane j's candidate
          // is the position of the highest earlier live lane of its hash.
          if (lane <= last) table[h] = static_cast<uint16_t>(old);
          __syncwarp();
          const unsigned same = __match_any_sync(kFull, h);
          const unsigned peers = same & live & below;
          const int peer_pos = __shfl_sync(kFull, pos, peers ? 31 - __clz(static_cast<int>(peers)) : 0);
          if (peers) cand = peer_pos;
          hits = __ballot_sync(kFull, valid && cur == u32_at(words, last_word, cand));
          last = hits ? __ffs(static_cast<int>(hits)) - 1 : kLanes - 1;
          // A lane stores only when no later storing lane shares its hash.
          const unsigned storing = (2u << last) - 1;
          if (lane <= last && ((same & storing) >> lane) == 1u) table[h] = static_cast<uint16_t>(pos);
          __syncwarp();
        }
        if (hits == 0 && live != kFull) {  // the run passes s_limit first
          if (next_emit < n) e.literal(next_emit, n);
          break;
        }
        if (hits == 0) {
          k0 += kLanes;
          continue;
        }
        s = __shfl_sync(kFull, pos, last);
        c = __shfl_sync(kFull, cand, last);
        if (s > next_emit) e.literal(next_emit, s);
      }
      int es = s + 4, ec = c + 4;
      while (true) {
        const int first = first_difference(words, last_word, es, ec, lane);
        const int ext = min(first, n - es);
        es += ext;
        ec += ext;
        if (first < kQuantum || ext < first) break;
      }
      e.copy(s - c, es - s);
      next_emit = es;
      if (es >= s_limit) {
        if (es < n) e.literal(es, n);
        break;
      }
      s = -1;
      run = es + 1;
      k0 = 0;
      // The re-match probe alone, as the serial loop makes it: every lane
      // reads the slot, then lane 0 stores h(es - 1) <- es - 1 and h(es) <- es.
      const int h1 = hash(u32_at(words, last_word, es - 1));
      const uint32_t cur = u32_at(words, last_word, es);
      const int h = hash(cur);
      const int c2 = h == h1 ? es - 1 : table[h];
      __syncwarp();
      if (lane == 0) {
        table[h1] = static_cast<uint16_t>(es - 1);
        table[h] = static_cast<uint16_t>(es);
      }
      __syncwarp();
      if (cur == u32_at(words, last_word, c2)) {
        s = es;
        c = c2;
      }
    }
  }

  if (lane == 0) out_len[b] = e.d;
  // Zero the row past out_len: bytes up to a 16-byte boundary, then words.
  uint8_t* row = e.row;
  const int d16 = min((e.d + 15) & ~15, kOutW);
  for (int k = e.d + lane; k < d16; k += kLanes) row[k] = 0;
  uint4* rw = reinterpret_cast<uint4*>(row);
  for (int w = d16 / 16 + lane; w < kOutW / 16; w += kLanes) rw[w] = make_uint4(0, 0, 0, 0);
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
  encode_kernel<<<static_cast<unsigned>(n_rows), kLanes, kSmem,
                  static_cast<cudaStream_t>(stream)>>>(blocks, row_w, lens, out, out_len);
  return static_cast<int>(cudaGetLastError());
}
