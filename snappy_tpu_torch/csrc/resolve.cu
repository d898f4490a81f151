// Copy-chain resolution from the host's op records: every output byte's
// literal origin, FLAG + its source index (FLAG = 1 << 17).
//
// Replaces: snappy_tpu/ops/pallas/resolve.py resolve_fh_pallas
// (_make_resolve_fh_kernel; K8 here, stpu_cuda_resolve_fh) and resolve_pallas
// (_make_resolve_kernel; K9 here, stpu_cuda_resolve). K8 builds each byte's
// first hop from the records itself; K9 reads it from the plane that
// ops/resolve.py records_to_pointers makes. A first hop is FLAG + content + j
// for the j-th byte of a literal (resolved), start - off + (j mod off) for a
// copy (an earlier output position), and exactly FLAG at and past declen.
// The TPU kernels' digit planes, one-hot routing matmuls, transposes and
// 128/256/512-row windows exist because Mosaic has no gather; here a gather
// is a load.
//
// What bounds it: the bytes are small (the records in, the resolved plane
// out), so the time is the chains of dependent reads that find each
// byte's origin, and how many of them run at once.
//
// K8 (rows of d_pad <= 65536, every row of the route): one CTA of 256
// threads a row, four CTAs an SM (so the route's 455-row groups run in one
// wave), taking the row a window of 4,096 positions at a time, in order.
// When a window starts, every position before it holds its final value in
// the output row. For the window:
//  1. the records that cover it stream through in passes of 1,024 (4 a
//     thread; a window of the corpus has about 800, and needs a second
//     pass where its records average under 4 bytes; passes of 2,048 took
//     0.248 ms on the 455-row group against 0.228). A record covers the
//     bytes from its start to the next record's start, and of several with
//     one start (empty records) the last one, as the plain version's
//     searchsorted(startsx, d, right=True) - 1 picks it; records at and
//     past nops carry start = declen and cover nothing. The record that
//     covers the window's first byte but starts before it counts as
//     starting there. The pass's covering records are ranked by a CTA-wide
//     scan and their starts and payloads kept in order; each sets a bit at
//     its (window-relative) start;
//  2. every position counts the start bits at or before it (popc of its
//     32-bit word, after the warps' counts of the words before; a warp
//     takes 16 words at once, so that its loads of earlier values are in
//     flight together) to find its record, then takes its entry in the
//     window: a literal byte its final value FLAG + w1 + j; a copied byte
//     its first hop start - off + (j < off ? j : j % off), an earlier
//     position (always: off >= 1), which is replaced at once by that
//     position's final value when it lies before the window (a load of the
//     output row). A first hop below 0 is read at 0, as the plain version's
//     clipped gather reads it; position 0 itself then takes that first hop
//     (< FLAG) as its final value. Bytes before the first record (a row
//     with no record: all of them) take start 0 and payload 0, a copy of
//     offset 1, first hop -1;
//  3. the chains inside the window settle by pointer doubling in place,
//     e = entry[e], until every entry is a final value (__syncthreads_or).
//     Entries are 32 bits: a pointer is a position below 65536, a final
//     value is >= FLAG or below 0, so a read that races a write sees an
//     old pointer or a newer pointer or value, each on the same chain;
//  4. the window's values go to the output row in 16-byte stores, FLAG
//     from declen on.
// So the plane equals the plain version's on every row: a chain that ends
// at a literal resolves, and one that reaches below 0 takes position 0's
// value, as Jacobi doubling over a clipped gather gives (its log2(d_pad)
// rounds cover every chain, since each hop goes strictly back). A window,
// its start bits and a pass's records take 25 KiB of shared memory.
// Taking the whole row into shared memory at once (a uint16 plane of first
// hops, doubling window by window as K10 does, then every value read back
// from the output row: one 1024-thread CTA an SM, the 455-row group in
// four waves) took 0.33 ms; resolve_parse_probe.py keeps it and times the
// phases.
//
// K9 (rows of d_pad <= 65536, the plane of records_to_pointers): K8's CTA
// and windows (256 threads, four CTAs an SM, 4,096 positions a window in
// order), fed by the plane instead of records. A window's plane values are
// copied into shared memory (cp.async) while the window before is worked.
// Its first hops: a value >= FLAG is a root; a pointer below 0 reads
// position 0, as the plain version's clipped gather does (position 0 itself
// keeps such a value); a pointer at or past its own position is never
// chased (a root keeping its value, below FLAG, so the row is flagged); a
// pointer before the window takes the final value already stored there at
// once. The rest double in place in shared memory (a uint16 window position
// a pointer, roots pointing to themselves, their values beside them) until
// every chain reaches its root (__syncthreads_or), for at most max_rounds
// rounds (12 settle any chain of 4,096 positions; a chain still open after
// a smaller budget keeps its window position, below FLAG); then the
// window's values go out in 16-byte stores. So the plane equals the plain
// version's (resolve_reference, Jacobi doubling over whole rows) on every
// plane with no pointer past its own position; where the plain version
// chases such a pointer, the row stays flagged here. The output plane is
// read back through plain loads, never the read-only path (no const
// __restrict__ on it): the CTA wrote it. The design this one replaced took
// 1,024-position tiles strictly in turn, a thread a position and 12 Jacobi
// rounds a tile; replay_resolve_probe.py keeps it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int kTile = 1024;
constexpr int32_t kFlag = 1 << 17;
constexpr int kThreads = 256;      // K8's CTA
constexpr int kCtas = 4;           // K8's CTAs an SM
constexpr int kWarps = kThreads / kWarp;
constexpr int kWin = 4096;         // positions of a window
constexpr int kSteps = kWin / kThreads;  // positions a thread takes in a window
constexpr int kPerThread = 4;      // records a thread takes in a pass
constexpr int kPass = kPerThread * kThreads;
constexpr int kMaxRow = 65536;     // widest row K8 takes (pointers below it)
constexpr int kHopBatch = 16;      // words of first hops a warp takes at once

// Inclusive scan of x over the CTA (warp_sums: a word a warp); returns the
// sum of the threads before this one.
__device__ __forceinline__ int exclusive_scan(int x, int* warp_sums) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int mine = x;
  for (int o = 1; o < kWarp; o <<= 1) {
    const int y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == kWarp - 1) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
    for (int o = 1; o < kWarp; o <<= 1) {
      const int y = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  return x - mine + (warp ? warp_sums[warp - 1] : 0);
}

// A pointer: an earlier position of the row (a final value is >= FLAG or < 0).
__device__ __forceinline__ bool is_pointer(int e) { return static_cast<unsigned>(e) < kMaxRow; }

__global__ void __launch_bounds__(kThreads, kCtas)
resolve_fh_kernel(const int32_t* __restrict__ startsx,
                  const int32_t* __restrict__ payload, int64_t cap,
                  const int32_t* __restrict__ declens, int d_pad, int32_t* out) {
  __shared__ int win[kWin];                  // the window's entries
  __shared__ uint32_t starts[kWin / 32];     // a bit per covering start in the window
  __shared__ int start_of[kPass], pay_of[kPass];  // a pass's covering records
  __shared__ int warp_sums[kWarps];
  __shared__ int last_before;                // the last record that starts before the window's end

  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t % kWarp, warp = t / kWarp;
  const int32_t* st = startsx + b * cap;
  const int32_t* pk = payload + b * cap;
  int32_t* row = out + b * static_cast<int64_t>(d_pad);
  const int lim = static_cast<int>(max(min(static_cast<int64_t>(declens[b]), static_cast<int64_t>(d_pad)),
                                       int64_t{0}));
  int64_t j0 = 0;  // the first record of the next pass, the same in every thread
  for (int base = 0; base < d_pad; base += kWin) {
    const int wend = min(base + kWin, lim);
    if (base < wend) {  // the same in every thread
      for (int w = t; w < kWin / 32; w += kThreads) starts[w] = 0;
      if (t == 0) last_before = static_cast<int>(j0);
      __syncthreads();
      // 1-2, a pass at a time; carry is where the pass's span starts.
      int carry = base;
      while (carry < wend) {
        int s0[kPerThread + 1], s[kPerThread + 1], pv[kPerThread];
        int last = -1;  // this thread's last record that starts before wend
#pragma unroll
        for (int u = 0; u <= kPerThread; ++u) {
          const int64_t j = j0 + kPerThread * t + u;
          s0[u] = j < cap ? st[j] : INT32_MAX;
          s[u] = max(s0[u], carry);  // a start before carry counts as carry
          if (u < kPerThread) {
            pv[u] = j < cap ? pk[j] : 0;
            if (s0[u] < wend) last = static_cast<int>(j);
          }
        }
        last = __reduce_max_sync(kAll, last);
        if (lane == 0 && last >= 0) atomicMax(&last_before, last);
        bool covers[kPerThread];
        int x = 0;
#pragma unroll
        for (int u = 0; u < kPerThread; ++u) {
          covers[u] = s[u] < wend && s[u] != s[u + 1];
          x += covers[u];
        }
        int rank = exclusive_scan(x, warp_sums);
#pragma unroll
        for (int u = 0; u < kPerThread; ++u) {
          if (!covers[u]) continue;
          start_of[rank] = s0[u];  // its true start
          pay_of[rank] = pv[u];
          const int r = s[u] - base;
          atomicOr(starts + (r >> 5), 1u << (r & 31));
          rank++;
        }
        const int64_t jn = j0 + kPass;
        const int hi = jn < cap ? min(max(st[jn], carry), wend) : wend;
        __syncthreads();
        // Each warp takes a run of the span's 32-position words. The starts
        // at or before a position, counted from the pass's first, give its
        // record.
        const int w_lo = (carry - base) >> 5, w_hi = (hi - base + 31) >> 5;
        const int per_warp = (w_hi - w_lo + kWarps - 1) / kWarps;
        const int wa = w_lo + warp * per_warp, wb = min(wa + per_warp, w_hi);
        const uint32_t from_carry = ~0u << ((carry - base) & 31);  // the first word's bits from carry on
        int count = 0;
        for (int w = wa + lane; w < wb; w += kWarp)
          count += __popc(starts[w] & (w == w_lo ? from_carry : ~0u));
        count = __reduce_add_sync(kAll, count);
        int before = exclusive_scan(lane == 0 ? count : 0, warp_sums);  // the pass's starts before
        before = __shfl_sync(kAll, before, 0);
        const uint32_t upto = 0xFFFFFFFFu >> (kWarp - 1 - lane);  // bits at or below this lane
        for (int w0 = wa; w0 < wb; w0 += kHopBatch) {
          int q[kHopBatch], e[kHopBatch];
#pragma unroll
          for (int u = 0; u < kHopBatch; ++u) {
            const int w = w0 + u;
            const uint32_t bits = w < wb ? starts[w] & (w == w_lo ? from_carry : ~0u) : 0u;
            const int p = base + 32 * w + lane;
            q[u] = w < wb && p >= carry && p < hi ? 32 * w + lane : -1;
            const int i = min(before + __popc(bits & upto) - 1, kPass - 1);
            before += __popc(bits);
            const int start = i >= 0 ? start_of[i] : 0;  // before the first record: a copy
            const int pay = i >= 0 ? pay_of[i] : 0;      // of offset 1 at 0
            const int w1 = pay & 0x1FFFF;
            const int j = p - start;
            if ((pay >> 17) == 1) {
              e[u] = kFlag + w1 + j;
            } else {
              const int off = max(w1, 1);
              const int h = start - off + (j < off ? j : j % off);
              e[u] = h < 0 && p == 0 ? h : max(h, 0);
            }
          }
#pragma unroll
          for (int u = 0; u < kHopBatch; ++u)  // pointers before the window: their values
            if (q[u] >= 0 && is_pointer(e[u]) && e[u] < base) e[u] = row[e[u]];
#pragma unroll
          for (int u = 0; u < kHopBatch; ++u)
            if (q[u] >= 0) win[q[u]] = e[u];
        }
        carry = hi;
        if (carry < wend) j0 = jn;  // the window needs the next pass
        __syncthreads();
      }
      j0 = last_before;

      // 3: the window's chains.
      int h[kSteps];
      bool open[kSteps];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int q = u * kThreads + t;
        h[u] = base + q < wend ? win[q] : kFlag;
        open[u] = is_pointer(h[u]);
        any |= open[u];
      }
      while (__syncthreads_or(any)) {
        any = false;
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          if (!open[u]) continue;
          h[u] = win[h[u] - base];
          win[u * kThreads + t] = h[u];
          open[u] = is_pointer(h[u]);
          any |= open[u];
        }
      }
    }
    // 4: the window's values, FLAG from lim on.
    for (int c = t; c < kWin / 4; c += kThreads) {
      const int p0 = base + 4 * c;
      if (p0 >= d_pad) break;
      int v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = p0 + i < lim ? win[4 * c + i] : kFlag;
      reinterpret_cast<int4*>(row)[p0 / 4] = make_int4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
  }
}

// Copies 16 bytes from device memory to shared memory without the registers
// (cp.async); cp.async.wait_all makes this thread's copies visible to it.
__device__ __forceinline__ void copy16_async(void* to, const void* from) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(from) : "memory");
}

// K9: the plane's chains, a window of kWin positions at a time in order, with
// K8's phases 3-4 (see the note at the top of the file).
__global__ void __launch_bounds__(kThreads, kCtas)
resolve_kernel(const int32_t* __restrict__ a0, int d_pad, int max_rounds, int32_t* out) {
  // A window's plane values, copied in during the window before; each
  // thread's own positions then hold their roots' values.
  __shared__ __align__(16) int buf[2][kWin];
  __shared__ uint16_t hop[kWin];      // a window position's pointer in the window, or itself
  const int64_t b = blockIdx.x;
  const int t = threadIdx.x;
  const int32_t* a = a0 + b * static_cast<int64_t>(d_pad);
  int32_t* row = out + b * static_cast<int64_t>(d_pad);
  // A thread copies the four 4-position chunks of a window that it reads.
  auto fetch = [&](int base, int* to) {
    const int chunks = min(kWin, d_pad - base) / 4;
#pragma unroll
    for (int k = 0; k < kSteps / 4; ++k) {
      const int c = t + k * kThreads;
      if (c < chunks) copy16_async(to + 4 * c, a + base + 4 * c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  fetch(0, buf[0]);
  for (int base = 0, w = 0; base < d_pad; base += kWin, ++w) {
    const int chunks = min(kWin, d_pad - base) / 4;  // 4-position chunks, 4 a thread
    int* val = buf[w & 1];
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (base + kWin < d_pad) fetch(base + kWin, buf[(w + 1) & 1]);  // free since the last barrier
    // 1: first hops. A value >= FLAG, a pointer at or past its position
    // (never chased) and position 0's value below 0 are roots; a pointer
    // below 0 reads position 0; a pointer before the window takes the final
    // value stored there at once.
    int e[kSteps], tgt[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps / 4; ++k) {
      const int c = t + k * kThreads;
      const int4 v = c < chunks ? reinterpret_cast<const int4*>(val)[c] : make_int4(kFlag, kFlag, kFlag, kFlag);
      const int vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = base + 4 * c + i;
        e[4 * k + i] = vs[i];
        tgt[4 * k + i] = vs[i] >= kFlag ? -1 : (vs[i] < 0 ? (p > 0 ? 0 : -1) : (vs[i] < p ? vs[i] : -1));
      }
    }
#pragma unroll
    for (int u = 0; u < kSteps; ++u)  // pointers before the window: their values
      if (tgt[u] >= 0 && tgt[u] < base) e[u] = row[tgt[u]];
    bool open[kSteps];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      const int q = 4 * (t + (u / 4) * kThreads) + u % 4;
      open[u] = tgt[u] >= base;
      if (q < 4 * chunks) {
        hop[q] = static_cast<uint16_t>(open[u] ? tgt[u] - base : q);
        val[q] = e[u];
      }
      tgt[u] = open[u] ? tgt[u] - base : q;
      any |= open[u];
    }
    // 2: the window's chains by pointer doubling in place, hop[q] = hop[hop[q]],
    // at most max_rounds rounds (12 settle any chain of a window).
    for (int r = 0; r < max_rounds && __syncthreads_or(any); ++r) {
      any = false;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (!open[u]) continue;
        const int h2 = hop[tgt[u]];
        if (h2 == tgt[u]) {
          open[u] = false;  // a root
        } else {
          tgt[u] = h2;
          hop[4 * (t + (u / 4) * kThreads) + u % 4] = static_cast<uint16_t>(h2);
          any = true;
        }
      }
    }
    __syncthreads();
    // 3: each position's root value (a chain still open after the budget
    // keeps its window position, below FLAG, unless it reached its root),
    // 16 bytes a store.
#pragma unroll
    for (int k = 0; k < kSteps / 4; ++k) {
      const int c = t + k * kThreads;
      if (c >= chunks) continue;
      int v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = tgt[4 * k + i];
        v[i] = !open[4 * k + i] || hop[h] == h ? val[h] : base + h;
      }
      reinterpret_cast<int4*>(row + base)[c] = make_int4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
  }
}

}  // namespace

// startsx, payload: (n_rows, cap) int32 (ops/resolve.py
// records_to_kernel_inputs); declens: (n_rows,) int32; out: (n_rows, d_pad)
// int32, d_pad a multiple of 1024 up to 65536.
extern "C" int stpu_cuda_resolve_fh(const int32_t* startsx, const int32_t* payload,
                                    int64_t n_rows, int64_t cap,
                                    const int32_t* declens, int64_t d_pad,
                                    int32_t* out, void* stream) {
  if (d_pad <= 0 || d_pad > kMaxRow || d_pad % kTile) return static_cast<int>(cudaErrorInvalidValue);
  resolve_fh_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      startsx, payload, cap, declens, static_cast<int>(d_pad), out);
  return static_cast<int>(cudaGetLastError());
}

// a0, out: (n_rows, d_pad) int32, d_pad a multiple of 1024 up to 65536.
extern "C" int stpu_cuda_resolve(const int32_t* a0, int64_t n_rows, int64_t d_pad,
                                 int max_rounds, int32_t* out, void* stream) {
  if (d_pad <= 0 || d_pad > kMaxRow || d_pad % kTile) return static_cast<int>(cudaErrorInvalidValue);
  resolve_kernel<<<static_cast<unsigned>(n_rows), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a0, static_cast<int>(d_pad), max_rounds, out);
  return static_cast<int>(cudaGetLastError());
}
