// Emission of the flat encoder: compressed bytes from the breakpoint plan.
//
// For output byte d of row b, in 1024-byte group g = d >> 10:
//   idx(d) = d + base[b, g] + sum(dlt[b, j] * (d >= bp[b, j]))
//            over the window j in [lo_row[b, g] * 128, (lo_row + rows_g)[b, g] * 128)
//   out[b, d] = src[b, idx(d)] for d < out_len[b], and 0 after,
// where src is the row's [block bytes | header plane] and bp, dlt are the
// flattened step plan of ops/encode_flat.py _breakpoints.
//
// Replaces: snappy_tpu/ops/pallas/encode_flat.py fused_emit_pallas
// (_make_fused_emit_kernel; entry stpu_cuda_fused_emit) and its split form,
// shift_idx_pallas (_make_shift_kernel; stpu_cuda_shift_idx, which writes
// idx) and emit_bytes_pallas (_make_emit_kernel; stpu_cuda_emit_bytes, which
// gathers through it). The TPU kernels sum the steps in f32 on the vector
// unit and route every byte with one-hot matrix products over 128-lane
// header and content windows, whose bases the plan computes per tile
// because Mosaic has no gather. Here a gather is a load: the window bases
// (the TPU plan's hb8, cb8, cbk) do not exist, idx is summed in int32, and
// the split form takes idx in output order (no v2 permutation, no hbase).
//
// What bounds it: device-memory bytes (each output byte reads one source
// byte; the live groups' windows cover each plan row once or twice) and,
// next to them, the per-byte search.
//
// K5's design: a CTA of kWalkThreads = 256 threads walks a run of kRunGroups
// = 8 groups of a row (a row is kRuns CTAs, so the longest rows do not set
// the time alone), kStepGroups = 4 groups a step (64 threads a group, 16
// output bytes a thread, one 16-byte store). The plan rows that the step's
// windows cover stay in a ring of kRing = 32 rows in shared memory (a slot
// is a mask away): a row that the next step's windows share is not loaded
// again, the first 16 of the next step's new rows are fetched into
// registers while this step searches and gathers, and each row's deltas are
// taken once into an exclusive prefix running from the ring's start (warp
// shuffles, two barriers a pass). So a window's sum up to entry k is ex[k] -
// ex[window start]. The plan sorts the breakpoints by construction, so the
// steps that apply at d are a prefix of the window: a thread binary-searches
// the steps at or below its first byte and its last, counts the steps
// between at their bytes (a byte counter each, in two 64-bit words) and sums
// the counters up, so that each byte's index is one shared-memory read, with
// no branch on the data. Groups at or past out_len (all 80 of a padding row)
// store zeros 16 bytes a store and read no plan. A step takes fewer groups
// where their windows would overrun the ring.
//
// K6 (the split form, on no main path): shift_idx keeps one block of 256
// threads per (group, row): the block loads the group's window into shared
// memory and takes the inclusive prefix of its deltas, each thread
// binary-searches 4 consecutive output bytes; a group wholly past out_len
// writes zeros and reads nothing. emit_bytes is bound by its gathers: each
// header byte it reads sits in its record's own 32-byte cell of the plane,
// so device memory moves a sector for it (the compress group's gathers
// touch 8.1 M sectors, 260 MB, beside 128 MB of indices and 168 MB of
// output). A CTA of kWalkThreads walks a run of kRunGroups groups of a row
// (a row is kRuns CTAs, as in K5), each warp 512 output bytes a step. A
// thread's 16 bytes are four 4-byte words, one in each 128-byte slab of its
// warp's span: four 16-byte index loads, 16 gathers in flight, four stores,
// and each gather and store instruction of a warp covers 128 consecutive
// output bytes, whose sources share sectors (16 consecutive bytes a thread
// would spread one instruction over 512 bytes: slower, emit_bytes_probe.py).
// A warp's span wholly at or past out_len (all of a padding row) stores
// zeros 16 bytes a store and reads nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 1024;
constexpr int kGroups = 80;  // 81920 output bytes per row
constexpr int kLanes = 128;
constexpr int kWinRows = 14;
constexpr int kWin = kWinRows * kLanes;
constexpr int kChunk = kWin / kThreads;  // 7 window entries per thread
static_assert(kChunk * kThreads == kWin, "the scan splits the window evenly");

struct Plan {
  const int32_t* lo_row;  // (B, kGroups)
  const int32_t* base;    // (B, kGroups)
  const int32_t* rows_g;  // (B, kGroups)
  const int32_t* out_len; // (B,)
  const int32_t* bp;      // (B, nbp)
  const int32_t* dlt;     // (B, nbp)
  int64_t nbp;
};

struct Window {
  int32_t bp[kWin];
  int32_t pre[kWin];  // inclusive prefix of the window's deltas
  int32_t part[kThreads];
};

// Loads group (b, g)'s window into shared memory and takes the prefix of its
// deltas. Called by every thread of the block. Returns the window's length.
__device__ int load_window(const Plan& pl, int64_t b, int g, Window& w) {
  const int64_t gi = b * kGroups + g;
  const int64_t start = int64_t{pl.lo_row[gi]} * kLanes;
  const int64_t room = pl.nbp - start;  // window rows past the plan read nothing
  const int64_t want = int64_t{min(max(pl.rows_g[gi], 0), kWinRows)} * kLanes;
  const int m = static_cast<int>(room <= 0 ? 0 : (want < room ? want : room));
  const int32_t* bp = pl.bp + b * pl.nbp + start;
  const int32_t* dlt = pl.dlt + b * pl.nbp + start;
  for (int i = threadIdx.x; i < m; i += kThreads) {
    w.bp[i] = bp[i];
    w.pre[i] = dlt[i];
  }
  __syncthreads();
  const int first = threadIdx.x * kChunk;
  int acc = 0;
  for (int i = first; i < first + kChunk && i < m; i++) {
    acc += w.pre[i];
    w.pre[i] = acc;
  }
  w.part[threadIdx.x] = acc;
  __syncthreads();
  for (int off = 1; off < kThreads; off <<= 1) {  // scan of the chunk sums
    const int v = threadIdx.x >= off ? w.part[threadIdx.x - off] : 0;
    __syncthreads();
    w.part[threadIdx.x] += v;
    __syncthreads();
  }
  const int excl = threadIdx.x ? w.part[threadIdx.x - 1] : 0;
  for (int i = first; i < first + kChunk && i < m; i++) w.pre[i] += excl;
  __syncthreads();
  return m;
}

// idx(d): the steps at or below d are a prefix of the sorted window.
__device__ __forceinline__ int32_t index_of(int d, int32_t base, const Window& w, int m) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (w.bp[mid] <= d) lo = mid + 1;
    else hi = mid;
  }
  return d + base + (lo ? w.pre[lo - 1] : 0);
}

__device__ __forceinline__ uint32_t gather_byte(const uint8_t* src, int64_t src_w,
                                                int32_t idx) {
  return idx >= 0 && idx < src_w ? uint32_t{src[idx]} : 0u;
}

// -- K5: a CTA walks a whole row ------------------------------------------------
constexpr int kWalkThreads = 256;
constexpr int kStepGroups = kWalkThreads / 64;  // 64 threads x 16 bytes = a group
constexpr int kRunGroups = 8;  // groups a CTA walks: a row is kRuns CTAs
constexpr int kRuns = (kGroups + kRunGroups - 1) / kRunGroups;
constexpr int kRing = 32;  // plan rows held; >= kWinRows, so one group always fits
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kPer = 8;                     // plan entries a thread takes in a pass
constexpr int kPass = kWalkThreads * kPer;  // plan entries a load pass takes
static_assert(kRing >= kWinRows && (kRing & (kRing - 1)) == 0 && kLanes == 128,
              "a window fits the ring, whose slots a mask finds");

struct Ring {
  __align__(16) int32_t bp[kRing * kLanes];
  __align__(16) uint32_t ex[kRing * kLanes];  // exclusive prefix of the deltas since the reset
  int32_t lo[kGroups], end[kGroups], base[kGroups];  // each live group's window rows [lo, end)
  uint32_t warp_sum[kWalkWarps];
};

__device__ __forceinline__ int ring_slot(int x) { return x & (kRing * kLanes - 1); }

// The first entry of the ring's sorted window [lo, hi) whose step lies above d.
__device__ __forceinline__ int first_above(const Ring& w, int lo, int hi, int d) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (w.bp[ring_slot(mid)] <= d) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The exclusive prefix at entry x of the ring's rows; `carry` at lim, the
// ring's end.
__device__ __forceinline__ uint32_t ex_at(const Ring& w, int lim, uint32_t carry, int x) {
  return x < lim ? w.ex[ring_slot(x)] : carry;
}

// A step: groups [g, g + n), whose windows span plan rows [u0, u1); the rows
// to load are [from, u1) (from = u0 where the ring starts afresh).
struct Step {
  int g, n, u0, u1, from;
  bool reset;
};

// No step: the walk is at `live`. Every member is set by hand: a braced
// Step{live} left the others unset in device code, and a dead run fetched
// rows from garbage bounds.
__device__ __forceinline__ Step no_step(int live) {
  Step st;
  st.g = live;
  st.n = st.u0 = st.u1 = st.from = 0;
  st.reset = false;
  return st;
}

__device__ __forceinline__ Step step_at(const Ring& w, int g, int live, int r0, int r1) {
  Step st = no_step(g);
  st.n = min(kStepGroups, live - g);
  for (;; st.n--) {
    st.u0 = w.lo[g];
    st.u1 = w.end[g];
    for (int i = 1; i < st.n; i++) {
      st.u0 = min(st.u0, w.lo[g + i]);
      st.u1 = max(st.u1, w.end[g + i]);
    }
    if (st.u1 - st.u0 <= kRing || st.n == 1) break;
  }
  st.reset = st.u0 < r0 || st.u0 > r1;  // no overlap with the ring
  st.from = st.reset ? st.u0 : r1;
  return st;
}

// A thread's kPer plan entries of a pass: bp and deltas.
struct Fetched {
  int4 bp[kPer / 4], dl[kPer / 4];
};

__device__ __forceinline__ Fetched fetch(const int32_t* bp_row, const int32_t* dlt_row,
                                         int from, int m, int p0) {
  Fetched f;
  const int j = p0 + kPer * threadIdx.x;
#pragma unroll
  for (int i = 0; i < kPer / 4; i++) {
    f.bp[i] = make_int4(0, 0, 0, 0);
    f.dl[i] = f.bp[i];
    if (j < m) {
      const int64_t at = int64_t{from} * kLanes + j + 4 * i;
      f.bp[i] = *reinterpret_cast<const int4*>(bp_row + at);
      f.dl[i] = *reinterpret_cast<const int4*>(dlt_row + at);
    }
  }
  return f;
}

// Stores a pass into the ring: bp as is, the deltas as the running exclusive
// prefix from `carry` (a warp scan of the threads' sums, then the warps').
// Returns the new carry; two barriers.
__device__ __forceinline__ uint32_t store_pass(Ring& w, const Fetched& f, int from, int m, int p0,
                                               uint32_t carry) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  uint32_t dl[kPer], own = 0;
#pragma unroll
  for (int i = 0; i < kPer / 4; i++) {
    dl[4 * i] = f.dl[i].x;
    dl[4 * i + 1] = f.dl[i].y;
    dl[4 * i + 2] = f.dl[i].z;
    dl[4 * i + 3] = f.dl[i].w;
  }
#pragma unroll
  for (int i = 0; i < kPer; i++) own += dl[i];
  uint32_t incl = own;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) w.warp_sum[warp] = incl;
  __syncthreads();
  uint32_t before = carry + incl - own, total = 0;
  for (int i = 0; i < kWalkWarps; i++) {
    before += i < warp ? w.warp_sum[i] : 0u;
    total += w.warp_sum[i];
  }
  const int j = p0 + kPer * t;
  if (j < m) {
    const int slot = ring_slot(from * kLanes + j);
    uint32_t ex[kPer];
#pragma unroll
    for (int i = 0; i < kPer; i++) {
      ex[i] = before;
      before += dl[i];
    }
#pragma unroll
    for (int i = 0; i < kPer / 4; i++) {
      *reinterpret_cast<int4*>(w.bp + slot + 4 * i) = f.bp[i];
      *reinterpret_cast<uint4*>(w.ex + slot + 4 * i) =
          make_uint4(ex[4 * i], ex[4 * i + 1], ex[4 * i + 2], ex[4 * i + 3]);
    }
  }
  __syncthreads();
  return carry + total;
}

__global__ void __launch_bounds__(kWalkThreads)
fused_emit_kernel(Plan pl, const uint8_t* __restrict__ src, int64_t src_w,
                  uint8_t* __restrict__ out) {
  __shared__ Ring w;
  const int t = threadIdx.x;
  const int64_t b = blockIdx.y;
  const int olen = pl.out_len[b];
  const int g_lo = blockIdx.x * kRunGroups, g_hi = min(g_lo + kRunGroups, kGroups);
  // This CTA's live groups are [g_lo, live).
  const int live = olen <= 0 ? g_lo : max(min((olen + kGroup - 1) / kGroup, g_hi), g_lo);
  uint8_t* orow = out + b * (kGroups * kGroup);
  const int nrows = static_cast<int>(pl.nbp / kLanes);
  for (int g = g_lo + t; g < live; g += kWalkThreads) {
    const int64_t gi = b * kGroups + g;
    const int lo = min(max(pl.lo_row[gi], 0), nrows);
    w.lo[g] = lo;
    w.end[g] = min(lo + min(max(pl.rows_g[gi], 0), kWinRows), nrows);
    w.base[g] = pl.base[gi];
  }
  __syncthreads();

  const int32_t* bp_row = pl.bp + b * pl.nbp;
  const int32_t* dlt_row = pl.dlt + b * pl.nbp;
  const uint8_t* srow = src + b * src_w;
  int r0 = 0, r1 = 0;  // plan rows [r0, r1) are in the ring (the same in every thread)
  uint32_t carry = 0;  // the exclusive prefix at entry r1 * 128
  Step st = g_lo < live ? step_at(w, g_lo, live, 0, 0) : no_step(live);
  // Each step's first pass is fetched during the step before it.
  Fetched next = fetch(bp_row, dlt_row, st.from, max(st.u1 - st.from, 0) * kLanes, 0);
  while (st.g < live) {
    if (st.reset) carry = 0;
    r0 = st.u0;
    const int m = max(st.u1 - st.from, 0) * kLanes;
    for (int p0 = 0; p0 < m; p0 += kPass) {
      if (p0) next = fetch(bp_row, dlt_row, st.from, m, p0);
      carry = store_pass(w, next, st.from, m, p0, carry);
    }
    r1 = max(st.reset ? st.u0 : r1, st.u1);
    const int lim = r1 * kLanes;  // ex at lim is carry
    Step nx = st.g + st.n < live ? step_at(w, st.g + st.n, live, r0, r1) : no_step(live);
    next = fetch(bp_row, dlt_row, nx.from, max(nx.u1 - nx.from, 0) * kLanes, 0);

    const int q = t >> 6;
    if (q < st.n) {
      const int gq = st.g + q;
      const int d0 = gq * kGroup + (t & 63) * 16;
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (d0 < olen) {
        const int s = w.lo[gq] * kLanes, e = w.end[gq] * kLanes;
        // o[i]: the window's sum of the steps at or below byte d0 + i, i.e.
        // ex at k(i), the first step above d0 + i.
        const int k0 = first_above(w, s, e, d0);
        const int k1 = first_above(w, k0, min(e, k0 + 255), d0 + 15);
        uint32_t o[16];
        if (k1 < k0 + 255) {
          // The steps in (d0, d0 + 15] counted at their bytes, a byte counter
          // for each of the 16 (lo: bytes 0-7, hi: 8-15), then summed up the
          // counters: counter i is k(i) - k0.
          uint64_t lo = 0, hi = 0;
          for (int j = k0; j < k1; j++) {
            const int at = w.bp[ring_slot(j)] - d0;
            const uint64_t one = uint64_t{1} << (8 * (at & 7));
            lo += at < 8 ? one : 0;
            hi += at < 8 ? 0 : one;
          }
          lo += lo << 8;
          lo += lo << 16;
          lo += lo << 32;
          hi += hi << 8;
          hi += hi << 16;
          hi += hi << 32;
          hi += (lo >> 56) * 0x0101010101010101ull;
#pragma unroll
          for (int i = 0; i < 16; i++) {
            const int count = static_cast<int>(((i < 8 ? lo : hi) >> (8 * (i & 7))) & 0xFF);
            o[i] = ex_at(w, lim, carry, k0 + count);
          }
        } else {
          o[0] = ex_at(w, lim, carry, k0);
#pragma unroll
          for (int i = 1; i < 16; i++) o[i] = ex_at(w, lim, carry, first_above(w, s, e, d0 + i));
        }
        const uint32_t off = static_cast<uint32_t>(w.base[gq]) - ex_at(w, lim, carry, s);
        int32_t ix[16];  // every index first, so the 16 gathers are in flight at once
#pragma unroll
        for (int i = 0; i < 16; i++)
          ix[i] = d0 + i < olen ? static_cast<int32_t>(static_cast<uint32_t>(d0 + i) + off + o[i])
                                : -1;  // reads 0
#pragma unroll
        for (int i = 0; i < 16; i++)
          v[i >> 2] |= gather_byte(srow, src_w, ix[i]) << (8 * (i & 3));
      }
      *reinterpret_cast<uint4*>(orow + d0) = make_uint4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    st = nx;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int x = live * kGroup + t * 16; x < g_hi * kGroup; x += kWalkThreads * 16)
    *reinterpret_cast<uint4*>(orow + x) = zero;
}

__global__ void __launch_bounds__(kThreads)
shift_idx_kernel(Plan pl, int32_t* __restrict__ idx) {
  __shared__ Window w;
  const int64_t b = blockIdx.y;
  const int g = blockIdx.x;
  const int d0 = g * kGroup + threadIdx.x * 4;
  int4 v = make_int4(0, 0, 0, 0);
  if (g * kGroup < pl.out_len[b]) {  // groups past out_len stay 0
    const int m = load_window(pl, b, g, w);
    const int32_t base = pl.base[b * kGroups + g];
    v = make_int4(index_of(d0, base, w, m), index_of(d0 + 1, base, w, m),
                  index_of(d0 + 2, base, w, m), index_of(d0 + 3, base, w, m));
  }
  *reinterpret_cast<int4*>(idx + b * (kGroups * kGroup) + d0) = v;
}

// K6's gather takes K5's CTA and run: kWalkThreads threads walk kRunGroups
// groups of a row, a row is kRuns CTAs.
constexpr int kSlabs = 4;  // 4-byte words a thread a step, one in each 128-byte slab
constexpr int kWarpSpan = 128 * kSlabs;  // output bytes a warp takes a step
constexpr int kEmitStep = kWalkThreads / 32 * kWarpSpan;
static_assert(kRuns * kRunGroups == kGroups, "a row is whole runs");
static_assert((kRunGroups * kGroup) % kEmitStep == 0, "a run is whole steps");

__global__ void __launch_bounds__(kWalkThreads)
emit_bytes_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ out_len,
                  const uint8_t* __restrict__ src, int64_t src_w,
                  uint8_t* __restrict__ out) {
  const int64_t b = blockIdx.y;
  const int olen = out_len[b];
  const int32_t* irow = idx + b * (kGroups * kGroup);
  const uint8_t* srow = src + b * src_w;
  uint8_t* orow = out + b * (kGroups * kGroup);
  const int lane = threadIdx.x & 31;
  const int lo = blockIdx.x * (kRunGroups * kGroup);
  const int hi = lo + kRunGroups * kGroup;
  for (int s0 = lo + (threadIdx.x >> 5) * kWarpSpan; s0 < hi; s0 += kEmitStep) {
    if (s0 >= olen) {  // the warp's span is padding
      *reinterpret_cast<uint4*>(orow + s0 + 16 * lane) = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    int32_t ix[kSlabs][4];  // every index first, so the 16 gathers are in flight at once
#pragma unroll
    for (int w = 0; w < kSlabs; w++) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(irow + s0 + w * 128 + 4 * lane));
      ix[w][0] = v.x;
      ix[w][1] = v.y;
      ix[w][2] = v.z;
      ix[w][3] = v.w;
    }
    uint32_t word[kSlabs] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int w = 0; w < kSlabs; w++) {
#pragma unroll
      for (int j = 0; j < 4; j++) {
        const int d = s0 + w * 128 + 4 * lane + j;
        const int32_t i = ix[w][j];
        word[w] |= (d < olen && i >= 0 && i < src_w ? uint32_t{__ldg(srow + i)} : 0u) << (8 * j);
      }
    }
#pragma unroll
    for (int w = 0; w < kSlabs; w++)
      *reinterpret_cast<uint32_t*>(orow + s0 + w * 128 + 4 * lane) = word[w];
  }
}

Plan make_plan(const int32_t* lo_row, const int32_t* base, const int32_t* rows_g,
               const int32_t* out_len, const int32_t* bp, const int32_t* dlt,
               int64_t nbp) {
  return Plan{lo_row, base, rows_g, out_len, bp, dlt, nbp};
}

dim3 grid_of(int64_t n_rows) { return dim3(kGroups, static_cast<unsigned>(n_rows)); }

}  // namespace

extern "C" int stpu_cuda_fused_emit(const int32_t* lo_row, const int32_t* base,
                                    const int32_t* rows_g, const int32_t* out_len,
                                    const int32_t* bp, const int32_t* dlt, int64_t nbp,
                                    const uint8_t* src, int64_t src_w, int64_t n_rows,
                                    uint8_t* out, void* stream) {
  fused_emit_kernel<<<dim3(kRuns, static_cast<unsigned>(n_rows)), kWalkThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      make_plan(lo_row, base, rows_g, out_len, bp, dlt, nbp), src, src_w, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stpu_cuda_shift_idx(const int32_t* lo_row, const int32_t* base,
                                   const int32_t* rows_g, const int32_t* out_len,
                                   const int32_t* bp, const int32_t* dlt, int64_t nbp,
                                   int64_t n_rows, int32_t* idx, void* stream) {
  shift_idx_kernel<<<grid_of(n_rows), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      make_plan(lo_row, base, rows_g, out_len, bp, dlt, nbp), idx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stpu_cuda_emit_bytes(const int32_t* idx, const int32_t* out_len,
                                    const uint8_t* src, int64_t src_w, int64_t n_rows,
                                    uint8_t* out, void* stream) {
  emit_bytes_kernel<<<dim3(kRuns, static_cast<unsigned>(n_rows)), kWalkThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(idx, out_len, src, src_w, out);
  return static_cast<int>(cudaGetLastError());
}
