// Self-contained replay decode of raw Snappy op streams, with the first
// error's device code per row.
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
// position depends on the previous op's length, and a copy reads bytes of
// earlier ops. A warp that walks a row waits on both, op after op.
//
// Rows with d_pad <= 65536 (every frame-chunk row, d_pad a multiple of 16):
// one 1024-thread CTA a row breaks both dependences with the JAX package's
// passes (snappy_tpu/ops/decode.py: a parse at every position, the op
// starts by doubling, output starts by a prefix sum, the first error by a
// min) and K10's shared-memory phases (records.cu). The source goes a window of kWin positions at a
// time, in order; each window starts at the next op start, which the
// window before found:
//  1. every position of the window parses the op that would start there
//     for its length in the source (the window's bytes staged in shared
//     memory, zero past n; a thread's four positions from two aligned
//     words; the next window's bytes asked into L2 meanwhile);
//  2. the op starts are the orbit of the window's first position under
//     next[i] = i + consumed[i]: marks pushed along jumps that double each
//     round (mark[jump[i]] |= mark[i], jump = jump[jump]), until the first
//     position's jump leaves the window (every op start of the window is
//     then marked). A literal longer than the window is the window's only op;
//  3. a CTA-wide exclusive scan of the ops' output lengths (clamped to
//     declen + 1, a count of the ops packed beside them from bit 20; exact
//     up to the first bad op) gives each op its output start and its rank;
//     the checks that need it follow (the marked positions parse their ops
//     again, rather than keep them in registers), and a min-reduction finds
//     the first bad op in stream order. The ops before it become K10's
//     records in shared memory (start | literal bit, and the content index
//     or offset), each with a bit at its start; no byte from the bad op on
//     is written;
//  4. K10's phase 2 for the window's output span: each position counts the
//     start bits at or before it to find its op and writes its first hop
//     into a uint16 plane (a literal byte its own position, and the byte
//     itself into the row; a copied byte start - off + (k mod off)).
// Then K10's phases 3-4 over the whole row: origins by pointer doubling a
// window of 4,096 positions at a time, and out[i] = row[hop[i]] in 16-byte
// stores, zeros from the first byte no valid op wrote. Shared memory: the
// row, its hop plane and start bits (3 * d_pad + d_pad / 8) and the window
// (its bytes, two jump planes that then hold the records, its marks):
// 229,392 bytes at d_pad 65536, one CTA an SM. replay_resolve_probe.py
// times the phases and the designs this one was measured against (the op
// starts by segments of 128 positions, exits and walks; the two passes as
// two kernels, records through device memory into K10).
//
// Wider rows (raw streams up to max_dpad) keep the walk, with a whole CTA:
// when the source row and the output row fit one block's opt-in shared
// memory together (227 KB on the H100), both are staged there, so a copy
// reads shared memory, not L2. Every warp walks the tags (the same
// broadcast loads); an op shorter than kLong (every copy: at most 64 bytes)
// is moved by warp 0 alone, 32 bytes a step, a copy by the closed form
// out[d + k] = out[d - off + (k % off)], which reads only bytes that earlier
// ops finished (__syncwarp() between ops orders its stores before the next
// op's loads); a longer literal is moved by the whole CTA between two
// __syncthreads(), in 4-byte words. The CTA then writes the row out, zeros
// after the valid prefix, in 16-byte stores. A row too wide for that keeps
// one warp a row, its output in device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr uint32_t kCap = 1u << 30;  // clamp for lengths that provably overrun

enum : int32_t {
  kOk = 0,
  kLiteral = 1,
  kCopyRead = 2,
  kOffset = 3,
  kCopyWrite = 4,
  kHeaderMismatch = 5,
};

// ---------------------------------------------------------------------------
// Rows of d_pad <= 65536: a CTA a row.

constexpr int kThreads = 1024;     // a row's CTA
constexpr int kWarps = kThreads / kWarp;
constexpr int kMaxRow = 65536;     // widest row the CTA path takes (uint16 hops)
constexpr int kPer = 4;            // source positions a thread parses, consecutive
static_assert(kPer == 4, "a thread's jumps are one 8-byte word, its marks one 4-byte word");
constexpr int kWin = kPer * kThreads;  // source positions of a window
constexpr int kMaxOps = kWin / 2;  // an op takes at least 2 source bytes
constexpr int kStage = kWin + 16;  // the window's staged bytes (5 past the last position)
constexpr uint32_t kLitBit = 1u << 31, kStartMask = kLitBit - 1;
constexpr int kCountShift = 20;    // the scan's op count, above the output lengths
constexpr int kWindowSteps = 4;    // output positions a thread takes in a doubling window
constexpr int kOutWindow = kWindowSteps * kThreads;
constexpr int kHopBatch = 8;       // words of first hops a warp takes at once

// Shared memory of the CTA path past the row's planes.
constexpr int kWinBytes = kStage + 2 * kWin * 2 + kWin;

__host__ __device__ constexpr int row_smem(int d_pad) {
  return 3 * d_pad + (d_pad + 31) / 32 * 4 + kWinBytes;
}

// A scan of x over the CTA (warp_sums: a word a warp): returns the sum of
// the threads before this one, and the CTA's total in *total.
__device__ __forceinline__ uint32_t exclusive_scan(uint32_t x, uint32_t* warp_sums,
                                                   uint32_t* total) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const uint32_t mine = x;
  for (int o = 1; o < kWarp; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == kWarp - 1) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = warp_sums[lane];
    for (int o = 1; o < kWarp; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  return x - mine + (warp ? warp_sums[warp - 1] : 0u);
}

// The op that would start at source position i < n: its source length,
// output length, literal or not, content index (a literal) or offset (a
// copy), and its check code that needs no output position (kLiteral for a
// literal whose bytes pass n, kCopyRead for a copy whose offset bytes do);
// the output checks are added by the caller.
struct Op {
  int consumed;   // source bytes (at most 2^30 + 6)
  int produced;   // output bytes (a literal's clamped at 1 << 30, + 1)
  bool lit;
  int src_err;    // kOk, kLiteral or kCopyRead
  uint32_t w1;    // content index (literal) or offset (copy)
};

// x: the window's bytes from position i on (tag, then four trailing bytes).
__device__ __forceinline__ Op parse_at(uint64_t x, int i, int n) {
  const uint32_t tag = static_cast<uint32_t>(x) & 0xFFu;
  const uint32_t kind = tag & 3u;
  const int lenm1 = static_cast<int>(tag >> 2);
  const uint32_t trail = static_cast<uint32_t>(x >> 8);
  Op op;
  if (kind == 0) {
    const bool long_lit = lenm1 >= 60;
    const int bc = min(max(lenm1 - 59, 1), 4);
    const uint32_t raw = trail & (0xFFFFFFFFu >> (8 * (4 - bc)));
    const int ll = (long_lit ? static_cast<int>(min(raw, kCap)) : lenm1) + 1;
    const int content = i + 1 + (long_lit ? bc : 0);
    op.lit = true;
    op.produced = ll;
    op.w1 = static_cast<uint32_t>(content);
    op.consumed = content - i + ll;
    op.src_err = ((long_lit && i + 5 > n) || (n - content < ll)) ? kLiteral : kOk;
  } else {
    const int ntb = kind == 1 ? 1 : (kind == 2 ? 2 : 4);
    op.lit = false;
    op.produced = kind == 1 ? 4 + (lenm1 & 7) : lenm1 + 1;
    op.w1 = kind == 1 ? ((tag >> 5) << 8 | (trail & 0xFFu))
                      : trail & (0xFFFFFFFFu >> (8 * (4 - ntb)));
    op.consumed = 1 + ntb;
    op.src_err = i + 1 + ntb > n ? kCopyRead : kOk;
  }
  return op;
}

__global__ void __launch_bounds__(kThreads, 1)
replay_row_kernel(const uint8_t* __restrict__ srcs, int64_t s_width,
                  const int32_t* __restrict__ src_lens,
                  const int32_t* __restrict__ declens, int d_pad,
                  uint8_t* __restrict__ dst, int32_t* __restrict__ errs) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* row = smem;                                        // literal bytes
  uint16_t* hop = reinterpret_cast<uint16_t*>(smem + d_pad);  // first hops, then origins
  uint32_t* starts = reinterpret_cast<uint32_t*>(smem + 3 * d_pad);  // a bit at every op start
  uint8_t* ws = smem + 3 * d_pad + (d_pad + 31) / 32 * 4;      // the window's bytes
  uint16_t* jump_a = reinterpret_cast<uint16_t*>(ws + kStage);  // jumps, ping and pong
  uint16_t* jump_b = jump_a + kWin;
  uint8_t* mark = reinterpret_cast<uint8_t*>(jump_b + kWin);
  // The window's valid ops in order, over the jump planes once the marks are
  // set: start | literal << 31, and the content index or offset.
  uint32_t* start_of = reinterpret_cast<uint32_t*>(jump_a);
  int* w1_of = reinterpret_cast<int*>(start_of + kMaxOps);
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ int first_bad, bad_start, bad_code, exit_at;

  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t % kWarp, warp = t / kWarp;
  const uint8_t* src = srcs + b * s_width;
  const int n = src_lens[b];
  const int declen = declens[b];
  const uint32_t cap = static_cast<uint32_t>(max(declen, 0)) + 1;  // the scan's clamp
  for (int w = t; w < (d_pad + 31) / 32; w += kThreads) starts[w] = 0;

  // 1-4, a window of source positions at a time. s0 is the next op start
  // and carry the output position it writes at, the same in every thread.
  int s0 = 0, carry = 0, err = kOk;
  while (s0 < n && err == kOk) {
    for (int q = t; q < kStage; q += kThreads) ws[q] = s0 + q < n ? src[s0 + q] : 0;
    // The next window starts near s0 + kWin (past it when this one ends in
    // a long literal): its source asked into L2 now.
    if (t < kWin / 128 + 2 && s0 + kWin - 128 + 128 * t < n)
      asm volatile("prefetch.global.L2 [%0];" :: "l"(src + s0 + kWin - 128 + 128 * t));
    if (t == 0) {
      first_bad = kWin;
      exit_at = n;
    }
    __syncthreads();
    // 1: the jump of each of this thread's four positions (the ops are
    // parsed again once the marks are set, rather than kept in registers).
    // Its bytes and the next four: two aligned words of the window.
    const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);
    const uint64_t bytes = uint64_t{ws32[t + 1]} << 32 | ws32[t];
    uint16_t j[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = kPer * t + u;
      j[u] = static_cast<uint16_t>(
          q < n - s0 ? min(q + parse_at(bytes >> (8 * u), s0 + q, n).consumed, kWin) : kWin);
    }
    uint32_t m = t == 0 ? 1u : 0u;  // this thread's four marks, a byte each
    *reinterpret_cast<uint2*>(jump_a + kPer * t) =
        make_uint2(j[0] | uint32_t{j[1]} << 16, j[2] | uint32_t{j[3]} << 16);
    *reinterpret_cast<uint32_t*>(mark + kPer * t) = m;
    __syncthreads();
    // 2: marks pushed along doubling jumps until position 0's leaves.
    uint16_t* cur = jump_a;
    uint16_t* nxt = jump_b;
    while (cur[0] < kWin) {  // the same in every thread (read after a barrier)
      m = *reinterpret_cast<const uint32_t*>(mark + kPer * t);
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        if (j[u] >= kWin) continue;
        if ((m >> (8 * u)) & 0xFF) mark[j[u]] = 1;
        j[u] = cur[j[u]];
      }
      *reinterpret_cast<uint2*>(nxt + kPer * t) =
          make_uint2(j[0] | uint32_t{j[1]} << 16, j[2] | uint32_t{j[3]} << 16);
      uint16_t* tmp = cur;
      cur = nxt;
      nxt = tmp;
      __syncthreads();
    }
    m = *reinterpret_cast<const uint32_t*>(mark + kPer * t);
    // 3: output starts and ranks by a packed scan, then the checks.
    Op op[kPer];
    bool is_op[kPer];
    uint32_t x = 0, at[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = kPer * t + u;
      is_op[u] = ((m >> (8 * u)) & 0xFF) && q < n - s0;
      op[u] = parse_at(bytes >> (8 * u), s0 + q, n);
      at[u] = x;
      if (is_op[u])
        x += min(static_cast<uint32_t>(op[u].produced), cap) + (1u << kCountShift);
    }
    uint32_t total;
    const uint32_t base = exclusive_scan(x, warp_sums, &total);
    constexpr uint32_t kLenMask = (1u << kCountShift) - 1;
    int d[kPer], rank[kPer], code[kPer];
    int bad = kWin;
#pragma unroll
    for (int u = kPer - 1; u >= 0; --u) {
      rank[u] = static_cast<int>((base + at[u]) >> kCountShift);
      d[u] = carry + static_cast<int>((base + at[u]) & kLenMask);
      int c = op[u].src_err;
      if (op[u].lit) {
        if (declen - d[u] < op[u].produced) c = kLiteral;
      } else if (c == kOk) {
        if (op[u].w1 == 0 || static_cast<uint32_t>(d[u]) < op[u].w1) {
          c = kOffset;
        } else if (d[u] + op[u].produced > declen) {
          c = kCopyWrite;
        }
      }
      code[u] = c;
      if (is_op[u] && c != kOk) bad = kPer * t + u;
    }
    if (bad < kWin) atomicMin(&first_bad, bad);
    __syncthreads();
    const int fb = first_bad;
    // The valid ops, in order, and their starts' bits; the window's exit.
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = kPer * t + u;
      if (!is_op[u]) continue;
      if (q == fb) {
        bad_start = d[u];
        bad_code = code[u];
      }
      if (q >= fb) continue;
      start_of[rank[u]] = static_cast<uint32_t>(d[u]) | (op[u].lit ? kLitBit : 0u);
      w1_of[rank[u]] = static_cast<int>(op[u].w1);
      atomicOr(starts + (d[u] >> 5), 1u << (d[u] & 31));
      if (q + op[u].consumed >= kWin || q + op[u].consumed >= n - s0)
        exit_at = min(s0 + q + op[u].consumed, n);  // the window's last op
    }
    __syncthreads();
    const int hi = fb < kWin ? bad_start : carry + static_cast<int>(total & kLenMask);
    // 4: first hops of the span [carry, hi), K10's phase 2. Each warp takes
    // a run of the span's 32-position words; the starts at or before a
    // position, counted from the window's first, give its op.
    const int w_lo = carry >> 5, w_hi = (hi + 31) >> 5;
    const int per_warp = (w_hi - w_lo + kWarps - 1) / kWarps;
    const int wa = w_lo + warp * per_warp, wb = min(wa + per_warp, w_hi);
    const uint32_t from_carry = ~0u << (carry & 31);  // the first word's bits from carry on
    unsigned count = 0;
    for (int w = wa + lane; w < wb; w += kWarp)
      count += __popc(starts[w] & (w == w_lo ? from_carry : ~0u));
    count = __reduce_add_sync(kAll, count);
    uint32_t unused;
    int before = static_cast<int>(exclusive_scan(lane == 0 ? count : 0u, warp_sums, &unused));
    before = __shfl_sync(kAll, before, 0);  // the window's starts before this warp's words
    const uint32_t upto = 0xFFFFFFFFu >> (kWarp - 1 - lane);  // bits at or below this lane
    for (int w0 = wa; w0 < wb; w0 += kHopBatch) {
      int p[kHopBatch], hv[kHopBatch];
      bool lit_byte[kHopBatch];
      uint8_t v[kHopBatch];
#pragma unroll
      for (int u = 0; u < kHopBatch; ++u) {
        const int w = w0 + u;
        const uint32_t bits = w < wb ? starts[w] & (w == w_lo ? from_carry : ~0u) : 0u;
        p[u] = w < wb && 32 * w + lane >= carry && 32 * w + lane < hi ? 32 * w + lane : -1;
        const int i = max(before + __popc(bits & upto) - 1, 0);
        before += __popc(bits);
        const uint32_t sw = start_of[i];
        const int w1 = w1_of[i];
        const int st = static_cast<int>(sw & kStartMask);
        const int k = p[u] - st;
        lit_byte[u] = sw & kLitBit;
        v[u] = p[u] >= 0 && lit_byte[u] ? src[w1 + k] : 0;
        hv[u] = lit_byte[u] ? p[u] : st - w1 + (k < w1 ? k : (w1 > 0 ? k % w1 : 0));
      }
#pragma unroll
      for (int u = 0; u < kHopBatch; ++u) {
        if (p[u] < 0) continue;
        if (lit_byte[u]) row[p[u]] = v[u];
        hop[p[u]] = static_cast<uint16_t>(hv[u]);
      }
    }
    carry = hi;
    err = fb < kWin ? bad_code : kOk;
    s0 = exit_at;
    __syncthreads();
  }
  const int end = carry;
  if (t == 0) errs[b] = (err == kOk && end != declen) ? kHeaderMismatch : err;

  // K10's phase 3: each copied byte's literal origin, a window of
  // kOutWindow positions at a time in order. A first hop that reaches
  // before the window finds its origin there at once; the chains inside
  // the window are settled by pointer doubling in place until no thread
  // has one left (__syncthreads_or).
  for (int base = 0; base < end; base += kOutWindow) {
    int h[kWindowSteps];
    bool open[kWindowSteps];
#pragma unroll
    for (int u = 0; u < kWindowSteps; ++u)
      h[u] = base + u * kThreads + t < end ? hop[base + u * kThreads + t] : 0;
#pragma unroll
    for (int u = 0; u < kWindowSteps; ++u) {
      const int p = base + u * kThreads + t;
      if (p < end && h[u] < base) {
        h[u] = hop[h[u]];
        hop[p] = static_cast<uint16_t>(h[u]);
      }
      open[u] = p < end && h[u] >= base && h[u] != p;  // a byte of this window, maybe copied
    }
    bool any = false;
#pragma unroll
    for (int u = 0; u < kWindowSteps; ++u) any |= open[u];
    while (__syncthreads_or(any)) {
      any = false;
#pragma unroll
      for (int u = 0; u < kWindowSteps; ++u) {
        if (!open[u]) continue;
        const int h2 = hop[h[u]];
        if (h2 == h[u]) {
          open[u] = false;  // h is a literal byte
        } else {
          h[u] = h2;
          hop[base + u * kThreads + t] = static_cast<uint16_t>(h2);
          open[u] = h2 >= base;
          any |= open[u];
        }
      }
    }
  }

  // K10's phase 4: the bytes, zero from end on, 16 a store.
  uint4* out = reinterpret_cast<uint4*>(dst + b * static_cast<int64_t>(d_pad));
  for (int c = t; c < d_pad / 16; c += kThreads) {
    uint32_t v[4] = {0, 0, 0, 0};
    if (16 * c < end) {
      const uint4 ha = reinterpret_cast<const uint4*>(hop)[2 * c];
      const uint4 hb = reinterpret_cast<const uint4*>(hop)[2 * c + 1];
      const uint32_t hw[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const uint32_t o = (hw[i >> 1] >> (16 * (i & 1))) & 0xFFFF;
        if (16 * c + i < end) v[i >> 2] |= uint32_t{row[o]} << (8 * (i & 3));
      }
    }
    out[c] = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// ---------------------------------------------------------------------------
// Wider rows: a CTA walks a row staged in shared memory.

constexpr int kWideThreads = 1024;
constexpr int kLong = 512;  // literals at least this long move with the whole CTA

// Copies len bytes from `from` to `to` (shared memory, apart), threads tid,
// tid + nth, ...: whole 4-byte words of `to`, each from two aligned words of
// `from` by a funnel shift; bytes at the ends.
__device__ __forceinline__ void move_words(uint8_t* to, const uint8_t* from, int len,
                                           int tid, int nth) {
  const int head = min(len, static_cast<int>((4 - (reinterpret_cast<uintptr_t>(to) & 3)) & 3));
  for (int k = tid; k < head; k += nth) to[k] = from[k];
  const int words = (len - head) >> 2;
  const uint8_t* f = from + head;
  const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(f) & 3);
  const uint32_t* fw = reinterpret_cast<const uint32_t*>(f - sh);
  uint32_t* tw = reinterpret_cast<uint32_t*>(to + head);
  for (int k = tid; k < words; k += nth)
    tw[k] = sh ? __funnelshift_r(fw[k], fw[k + 1], 8 * sh) : fw[k];
  for (int k = head + 4 * words + tid; k < len; k += nth) to[k] = from[k];
}

__global__ void __launch_bounds__(kWideThreads)
replay_cta_kernel(const uint8_t* __restrict__ srcs, int64_t s_width,
                  const int32_t* __restrict__ src_lens,
                  const int32_t* __restrict__ declens, int64_t d_pad, int s_stage,
                  uint8_t* __restrict__ dst, int32_t* __restrict__ errs) {
  extern __shared__ __align__(16) uint8_t staged[];
  uint8_t* src = staged;              // the source row, s_stage bytes
  uint8_t* out = staged + s_stage;    // the output row
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int warp = t / kWarp, lane = t % kWarp;
  const int32_t n = src_lens[b];
  const int32_t declen = declens[b];
  const uint8_t* gsrc = srcs + b * s_width;
  const int64_t n16 = (static_cast<int64_t>(n) + 15) / 16;
  if ((reinterpret_cast<uintptr_t>(gsrc) & 15) == 0 && n16 * 16 <= s_width) {
    for (int64_t i = t; i < n16; i += kWideThreads)
      reinterpret_cast<uint4*>(src)[i] = reinterpret_cast<const uint4*>(gsrc)[i];
  } else {
    for (int64_t i = t; i < n; i += kWideThreads) src[i] = gsrc[i];
  }
  __syncthreads();

  auto at = [&](int32_t p) -> uint32_t { return p < n ? src[p] : 0u; };
  auto read4 = [&](int32_t p) -> uint32_t {
    return at(p) | at(p + 1) << 8 | at(p + 2) << 16 | at(p + 3) << 24;
  };

  // Every thread walks the same tags; see the note at the top of the file.
  int32_t s = 0, d = 0, err = kOk;
  while (s < n) {
    const uint32_t tag = src[s];
    const uint32_t kind = tag & 3u;
    const int32_t lenm1 = static_cast<int32_t>(tag >> 2);
    int32_t len, from;  // a literal's content index, or a copy's offset
    if (kind == 0) {
      const bool long_lit = lenm1 >= 60;
      const int32_t bc = min(max(lenm1 - 59, 1), 4);
      const uint32_t raw = read4(s + 1) & (0xFFFFFFFFu >> (8 * (4 - bc)));
      len = (long_lit ? static_cast<int32_t>(min(raw, kCap)) : lenm1) + 1;
      from = s + 1 + (long_lit ? bc : 0);
      if ((long_lit && s + 5 > n) || (n - from < len) || (declen - d < len)) {
        err = kLiteral;
        break;
      }
      s = from + len;
    } else {
      const int32_t ntb = kind == 1 ? 1 : (kind == 2 ? 2 : 4);
      len = kind == 1 ? 4 + (lenm1 & 7) : lenm1 + 1;
      const uint32_t off = kind == 1
                               ? ((tag >> 5) << 8 | at(s + 1))
                               : read4(s + 1) & (0xFFFFFFFFu >> (8 * (4 - ntb)));
      if (s + 1 + ntb > n) {
        err = kCopyRead;
      } else if (off == 0 || static_cast<uint32_t>(d) < off) {
        err = kOffset;
      } else if (d + len > declen) {
        err = kCopyWrite;
      }
      if (err != kOk) break;
      from = -static_cast<int32_t>(off);
      s += 1 + ntb;
    }
    if (len >= kLong) {  // a literal (copies are at most 64 bytes); the same in every thread
      __syncthreads();
      move_words(out + d, src + from, len, t, kWideThreads);
      __syncthreads();
    } else if (warp == 0) {
      if (from >= 0) {
        for (int32_t k = lane; k < len; k += kWarp) out[d + k] = src[from + k];
      } else {
        const int32_t o = -from;
        for (int32_t k = lane; k < len; k += kWarp)
          out[d + k] = out[d - o + (k < o ? k : k % o)];
      }
      __syncwarp();
    }
    d += len;
  }
  __syncthreads();
  // The row out, zeros from d on, 16 bytes a store.
  uint4* row = reinterpret_cast<uint4*>(dst + b * d_pad);
  for (int64_t c = t; c < d_pad / 16; c += kWideThreads) {
    uint4 v = reinterpret_cast<const uint4*>(out)[c];
    if (16 * c + 16 > d) {
      uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (16 * c + i >= d) w[i >> 2] &= ~(0xFFu << (8 * (i & 3)));
      v = make_uint4(w[0], w[1], w[2], w[3]);
    }
    row[c] = v;
  }
  if (t == 0) errs[b] = (err == kOk && d != declen) ? kHeaderMismatch : err;
}

// ---------------------------------------------------------------------------
// Rows too wide for either: one warp a row, the output in device memory (the
// source staged in shared memory when it fits). Moves are 32 bytes a step;
// __syncwarp() between ops orders each op's stores before the next op's loads.

__global__ void __launch_bounds__(kWarp)
replay_warp_kernel(const uint8_t* __restrict__ srcs, int64_t s_width,
                   const int32_t* __restrict__ src_lens,
                   const int32_t* __restrict__ declens, int64_t d_pad, int stage,
                   uint8_t* __restrict__ dst, int32_t* __restrict__ errs) {
  extern __shared__ uint8_t staged_src[];
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t n = src_lens[b];
  const int32_t declen = declens[b];
  const uint8_t* src = srcs + b * s_width;
  if (stage) {
    const int64_t n16 = (static_cast<int64_t>(n) + 15) / 16;
    if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && n16 * 16 <= s_width) {
      for (int64_t i = lane; i < n16; i += kWarp)
        reinterpret_cast<uint4*>(staged_src)[i] = reinterpret_cast<const uint4*>(src)[i];
    } else {
      for (int64_t i = lane; i < n; i += kWarp) staged_src[i] = src[i];
    }
    __syncwarp();
    src = staged_src;
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

// srcs: (n_rows, s_width) uint8; src_lens, declens: (n_rows,) int32 with
// src_lens <= s_width and declens <= d_pad; dst: (n_rows, d_pad) uint8;
// errs: (n_rows,) int32.
extern "C" int stpu_cuda_replay(const uint8_t* srcs, int64_t n_rows,
                                int64_t s_width, const int32_t* src_lens,
                                const int32_t* declens, int64_t d_pad,
                                uint8_t* dst, int32_t* errs, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d_pad <= kMaxRow && d_pad % 16 == 0) {
    const int smem = row_smem(static_cast<int>(d_pad));
    const cudaError_t e = cudaFuncSetAttribute(
        replay_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    replay_row_kernel<<<static_cast<unsigned>(n_rows), kThreads, smem, st>>>(
        srcs, s_width, src_lens, declens, static_cast<int>(d_pad), dst, errs);
    return static_cast<int>(cudaGetLastError());
  }
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  // The staged source keeps 16 bytes past the row for move_words' reads.
  const int64_t s_stage = (s_width + 15) / 16 * 16 + 16;
  if (d_pad % 16 == 0 && s_stage + d_pad <= optin) {
    const int smem = static_cast<int>(s_stage + d_pad);
    const cudaError_t e = cudaFuncSetAttribute(
        replay_cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    replay_cta_kernel<<<static_cast<unsigned>(n_rows), kWideThreads, smem, st>>>(
        srcs, s_width, src_lens, declens, d_pad, static_cast<int>(s_stage), dst, errs);
    return static_cast<int>(cudaGetLastError());
  }
  const bool stage = s_width <= optin;
  const size_t smem = stage ? static_cast<size_t>(s_width) : 0;
  if (stage) {
    const cudaError_t e = cudaFuncSetAttribute(
        replay_warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  replay_warp_kernel<<<static_cast<unsigned>(n_rows), kWarp, smem, st>>>(
      srcs, s_width, src_lens, declens, d_pad, stage ? 1 : 0, dst, errs);
  return static_cast<int>(cudaGetLastError());
}
