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
// code goes with it). A record that would leave its row or pass declen
// (impossible for the scan's records) ends the replay.
//
// What bounds it: device-memory bytes (the records, the literal bytes, the
// rows) once the replay's sequential dependence is broken. Each op starts
// where the last one ended and a copy reads bytes of earlier ops, but every
// copied byte has one literal byte as its origin, and pointer doubling finds
// it in log2(chain depth) rounds instead of a chain of ops.
//
// Rows with d_pad <= 65536 (every frame-chunk row): one 1024-thread CTA a
// row, all in shared memory, K10's plain version's algorithm:
//  1. the records stream through in passes of 3,072 (8 bytes each,
//     coalesced): a CTA-wide exclusive scan of their lengths (and, packed
//     beside them, of a count of the nonempty ones), with the carry of
//     earlier passes, gives each its start; a min-reduction finds the first
//     record that fails the checks, and nothing from its start on is
//     written; each nonempty valid record sets a bit at its start;
//  2. each position of the pass's span counts the start bits at or before
//     it (popc of its 32-bit word, after the warps' counts of the words
//     before) to find its record, then writes its first hop into a uint16
//     plane: a literal byte its own position (and the byte itself into the
//     row, neighbouring bytes from neighbouring lanes), a copied byte
//     start - off + (k < off ? k : k % off), always in an earlier record;
//  3. the origins, a window of 4,096 positions (kWindowSteps a thread) at
//     a time in order: a hop that leaves the window reads its origin there
//     (those windows are done), and pointer doubling, hop[i] = hop[hop[i]]
//     in place, settles the chains inside the window (a few rounds,
//     __syncthreads_or);
//  4. out[i] = row[hop[i]], zero from the first byte no valid record wrote,
//     in 16-byte stores.
// The row, its hop plane, a pass's records and the start bits take
// 3 * d_pad + 24 KiB + d_pad / 8 of shared memory: one CTA an SM at d_pad
// 65536. encode_records_probe.py times the phases and their variants.
//
// Wider rows (raw streams; the records route takes groups up to 1 MiB):
// one warp per row replays the records in order, as K3 walks a row. The
// lanes load 32 records at once and take them one at a time by shuffles,
// then move the op together, 32 bytes a step: a literal from the source
// row, a copy by the closed form out[d + k] = out[d - off + (k % off)];
// __syncwarp() between ops orders each op's stores before the next op's
// loads. The row is staged in shared memory when it fits one block's
// opt-in size (227 KB on the H100), and worked in device memory otherwise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kThreads = 1024;     // a row's CTA
constexpr int kPerThread = 3;      // records a thread takes in a pass
constexpr int kPass = kPerThread * kThreads;
constexpr int kMaxRow = 65536;     // widest row the CTA path takes (uint16 hops)
constexpr uint32_t kLitBit = 1u << 31, kStartMask = kLitBit - 1;
constexpr int kWindowSteps = 4;    // positions a thread takes in a window
constexpr int kWindow = kWindowSteps * kThreads;
constexpr int kHopBatch = 8;       // words of first hops a warp takes at once
// The pass's scan adds each record's length (at most lim + 1 <= 65537, so
// a thread's three fit below bit 20) and, from bit 20, a count of the
// nonempty records; the sums are exact up to the first failing record.
constexpr int kCountShift = 20;

// The checks of a record of len bytes at output position d.
__device__ __forceinline__ bool bad_record(int len, bool lit, int w1, int d, int lim,
                                           int64_t s_width) {
  return len > lim - d ||
         (lit ? (w1 < 0 || w1 > s_width - len) : (w1 < 1 || w1 > d));
}

__global__ void __launch_bounds__(kThreads, 1)
records_row_kernel(const uint8_t* __restrict__ srcs, int64_t s_width,
                   const int2* __restrict__ recs, int64_t r_cap,
                   const int32_t* __restrict__ nops,
                   const int32_t* __restrict__ declens, int d_pad,
                   uint8_t* __restrict__ dst) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* row = smem;                                        // literal bytes
  uint16_t* hop = reinterpret_cast<uint16_t*>(smem + d_pad);  // first hops, then origins
  // A pass's nonempty records in order: start | literal << 31, and w1; and
  // a bit at every record start of the row.
  uint32_t* start_of = reinterpret_cast<uint32_t*>(smem + 3 * d_pad);
  int* w1_of = reinterpret_cast<int*>(start_of + kPass);
  uint32_t* starts = reinterpret_cast<uint32_t*>(w1_of + kPass);
  __shared__ uint32_t warp_sums[kThreads / kWarp];
  __shared__ int first_bad, bad_start;

  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t % kWarp, warp = t / kWarp;
  const uint8_t* src = srcs + b * s_width;
  const int2* rec = recs + b * r_cap;
  const int n = static_cast<int>(min(static_cast<int64_t>(nops[b]), r_cap));
  const int lim = static_cast<int>(min(static_cast<int64_t>(declens[b]), static_cast<int64_t>(d_pad)));
  for (int w = t; w < (d_pad + 31) / 32; w += kThreads) starts[w] = 0;

  // 1-2: the records' starts, checks and first hops, a pass at a time.
  // carry is the end of the valid records so far, the same in every thread.
  int carry = 0;
  bool stopped = false;
  for (int j0 = 0; j0 < n && !stopped; j0 += kPass) {
    if (t == 0) first_bad = kPass;
    int len[kPerThread], w1[kPerThread], d[kPerThread];
    bool lit[kPerThread], here[kPerThread];
    uint32_t x = 0, at[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int j = j0 + kPerThread * t + u;
      here[u] = j < n;
      const int2 r = here[u] ? rec[j] : make_int2(0, 0);
      len[u] = r.x & 0x3FFFFFFF;
      lit[u] = (r.x >> 30) & 1;
      w1[u] = r.y;
      at[u] = x;
      x += static_cast<uint32_t>(min(len[u], lim + 1)) + (uint32_t{len[u] > 0} << kCountShift);
    }
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
    constexpr uint32_t kLenMask = (1u << kCountShift) - 1;
    const uint32_t base = x - mine + (warp ? warp_sums[warp - 1] : 0u);
    const int pass_end = carry + static_cast<int>(warp_sums[kThreads / kWarp - 1] & kLenMask);
    int bad = kPass;
    int rank[kPerThread];
#pragma unroll
    for (int u = kPerThread - 1; u >= 0; --u) {
      rank[u] = static_cast<int>((base + at[u]) >> kCountShift);
      d[u] = carry + static_cast<int>((base + at[u]) & kLenMask);
      if (here[u] && bad_record(len[u], lit[u], w1[u], d[u], lim, s_width)) bad = kPerThread * t + u;
    }
    if (bad < kPass) atomicMin(&first_bad, bad);
    __syncthreads();
    const int fb = first_bad;
    // The valid nonempty records, in order, and their starts' bits.
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int i = kPerThread * t + u;
      if (i == fb) bad_start = d[u];
      if (i >= fb || !here[u] || len[u] == 0) continue;
      start_of[rank[u]] = static_cast<uint32_t>(d[u]) | (lit[u] ? kLitBit : 0u);
      w1_of[rank[u]] = w1[u];
      atomicOr(starts + (d[u] >> 5), 1u << (d[u] & 31));
    }
    __syncthreads();
    const int hi = fb < kPass ? bad_start : pass_end;
    // Each warp takes a run of the span's 32-position words. The starts at
    // or before a position, counted from the pass's first, give its record.
    const int w_lo = carry >> 5, w_hi = (hi + 31) >> 5;
    const int per_warp = (w_hi - w_lo + kWarp - 1) / kWarp;
    const int wa = w_lo + warp * per_warp, wb = min(wa + per_warp, w_hi);
    const uint32_t from_carry = ~0u << (carry & 31);  // the first word's bits from carry on
    unsigned count = 0;
    for (int w = wa + lane; w < wb; w += kWarp)
      count += __popc(starts[w] & (w == w_lo ? from_carry : ~0u));
    count = __reduce_add_sync(kAll, count);
    if (lane == 0) warp_sums[warp] = count;
    __syncthreads();
    if (warp == 0) {
      uint32_t c = warp_sums[lane];
      for (int o = 1; o < kWarp; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kAll, c, o);
        if (lane >= o) c += y;
      }
      warp_sums[lane] = c;
    }
    __syncthreads();
    // First hops: a literal byte its own position (and the byte itself into
    // the row, neighbouring bytes from neighbouring lanes), a copy byte
    // start - off + (k < off ? k : k % off).
    int before = warp ? static_cast<int>(warp_sums[warp - 1]) : 0;  // the pass's starts before
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
        const int j = p[u] - st;
        lit_byte[u] = sw & kLitBit;
        v[u] = p[u] >= 0 && lit_byte[u] ? src[w1 + j] : 0;
        hv[u] = lit_byte[u] ? p[u] : st - w1 + (j < w1 ? j : (w1 > 0 ? j % w1 : 0));
      }
#pragma unroll
      for (int u = 0; u < kHopBatch; ++u) {
        if (p[u] < 0) continue;
        if (lit_byte[u]) row[p[u]] = v[u];
        hop[p[u]] = static_cast<uint16_t>(hv[u]);
      }
    }
    carry = hi;
    stopped = fb < kPass;
    __syncthreads();
  }
  const int end = carry;

  // 3: each copied byte's literal origin, a window of kWindow positions at
  // a time in order. A first hop that reaches before the window finds its
  // origin there at once (those windows are done: every hop an origin); the
  // chains inside the window are settled by pointer doubling, hop[p] =
  // hop[hop[p]] in place, until no thread has one left (__syncthreads_or).
  for (int base = 0; base < end; base += kWindow) {
    int h[kWindowSteps];
    bool open[kWindowSteps];
#pragma unroll
    for (int u = 0; u < kWindowSteps; ++u) h[u] = base + u * kThreads + t < end ? hop[base + u * kThreads + t] : 0;
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

  // 4: the bytes, zero from end on, 16 a store.
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

// srcs: (n_rows, s_width) uint8; recs: (n_rows, r_cap, 2) int32; nops,
// declens: (n_rows,) int32; dst: (n_rows, d_pad) uint8, d_pad % 16 == 0.
extern "C" int stpu_cuda_records(const uint8_t* srcs, int64_t n_rows, int64_t s_width,
                                 const int32_t* recs, int64_t r_cap, const int32_t* nops,
                                 const int32_t* declens, int64_t d_pad, uint8_t* dst,
                                 void* stream) {
  if (d_pad <= kMaxRow) {
    const int smem = 3 * static_cast<int>(d_pad) + 2 * kPass * 4 + (static_cast<int>(d_pad) + 31) / 32 * 4;
    const cudaError_t e = cudaFuncSetAttribute(
        records_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    records_row_kernel<<<static_cast<unsigned>(n_rows), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
        srcs, s_width, reinterpret_cast<const int2*>(recs), r_cap, nops, declens,
        static_cast<int>(d_pad), dst);
    return static_cast<int>(cudaGetLastError());
  }
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
