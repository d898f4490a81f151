// Flat-gather decode, K2 and K11.
//
// K2:  out[b, d] = src[b, base(b, d >> 10) * 128 + idx[b, phys(d)]] for
//      d < declen[b] and a position inside the row; every other byte is 0.
// K11: the same in layout 1 with a window bucket gb per 16 KiB group: a byte
//      also needs its window-relative row idx >> 7 below the bucket's window
//      w (widths[gb], computed by the wrapper), and a dead group (v3: gb
//      outside 0..2; v4: gb < 0) is zeros.
// layout 0 keeps idx in output order (phys(d) = d); layout 1 is the TPU v2
// kernel's transposed block order, each 16 KiB group a 128 x 128 block:
//   phys(d) = (d >> 14 << 14) | ((d & 127) << 7) | (((d >> 10) & 15) << 3)
//             | ((d >> 7) & 7)
// In both layouts a 16 KiB unit of output has its indices in one contiguous
// run of 32 KiB (layout 1 permutes only inside the unit).
//
// Replaces: snappy_tpu/ops/pallas/decode.py decode_flat_pallas_v2 (layout 1),
// decode_flat_pallas (layout 0), decode_flat_pallas_v3 and _v4 (K11). Mosaic
// has no gather, so the TPU kernels route bytes with one-hot matrix products
// over 128/256/512-row source windows; here a window is a bounds test.
//
// What bounds it: device-memory bytes (per output byte, 2 index bytes and a
// source byte read and a byte written). The first design ran at nearly five
// times that bound, not for its scattered source loads as such (dropping
// them saved a fifth of its time) but for its chains of dependent loads:
// each thread made 4 bytes, each behind its index load, in 64-bit
// arithmetic. Staging each CTA's source span in shared memory and gathering
// from there took 0.94 of the time of a CTA a unit, at 80 registers with
// spills and 72 KB of shared memory a CTA (flat_gather_probe.py, PERF.md §6).
//
// K2 (flat_groups_kernel, every K2 launch through stpu_cuda_flat_gather_groups):
// a persistent walk. A launch's units, (group, row, unit) with the unit
// fastest, are numbered 0..total-1; the grid is min(total, the CTAs the card
// holds at once, found once a card), so a one-unit decode runs one CTA and a
// row group a full card. CTA c takes units c, c + grid, c + 2 grid, ... for
// kStaticRounds steps, so neighbouring units of a row run side by side and
// their source rows stay warm in L2; past those rounds (a launch longer
// than that gets a counter, two zeroed words a stream that the last CTA out
// zeroes again) it claims each next unit with an atomic a step ahead, so
// that CTAs of unequal speed end together. A CTA a unit, as a 2-D grid gave
// it, ran as waves that start together and run one chain together (index
// loads, gather, store, fold); a launch of under two waves (the 16 MiB frame
// read's, about 1,040 units) paid that chain in full. In the walk:
// 1. The next unit's indices are in flight while a CTA gathers: a ring of
//    kStages slots in shared memory, each a unit's 32 KiB of indices, its 16
//    tiles' metadata, its unit number and declen. After a unit's gather has
//    read its slot, every gathering thread copies its share of the unit
//    kStages steps on into it (cp.async, a commit group a step), so a step
//    waits only for its own group and a barrier. That unit's declen is
//    loaded at the top of the step and used only after the gather. A unit
//    wholly past declen copies nothing.
// 2. The gather: each warp's load instruction takes 32 output bytes lying in
//    a run of 32 (layout 1) or 64 (layout 0) bytes, so that it reads a few
//    neighbouring sectors of the source, where a lane a chunk of the slot,
//    in layout 1 16 tiles apart, read 16 tiles' sources; a thread's chunk is
//    then a column of a tile (layout 1; the slot's chunks XOR-swizzled so
//    that 8 columns of a tile lie in 8 bank groups) or 4 pairs of bytes.
//    A thread issues two chunks' loads (16) before it stores their bytes:
//    more in flight took more registers than three CTAs an SM leave.
// 3. The bytes go straight out (each warp store fills whole sectors); a unit
//    wholly past declen stores zeros and reads nothing.
// Three CTAs of 256 threads an SM (33 KiB of shared memory each, 80
// registers a thread), one slot a CTA. Two slots, more loads in flight and
// an output tile in shared memory were each slower (PERF.md §6).
//
// The frame checksum (kCrc, stpu_cuda_flat_gather_crc): the same kernel also
// writes each row's masked CRC32C of its first declen bytes, as K1 would of
// the output, so the frame read needs no K1 after it. kCrc is a template
// parameter: the instance without it is the code above alone. A CRC
// register is linear over GF(2): the raw register of A || B from 0 is
// M_|B|(R(A)) ^ R(B), where M_n advances a register past n zero bytes. An
// M_n is held as eight nibble tables of 16 words (128 words) or, where a
// warp applies it with shuffles, as seven tables of 5-bit chunks (196).
// The fold is the SM's shuffle pipe's work and the gather its load and store
// pipe's, so they run in different warps: each CTA has 4 fold warps after
// its 8 gathering warps (two CTAs an SM, 74 KiB of shared memory each). The
// gatherers put a live unit's bytes in an output tile in shared memory (two
// tiles, by the parity of the units handed over; layout 0 a chunk's 8
// bytes at once), store the tile out and hand it over (named barriers: the
// tile's full, then the fold warps hand it back empty once they hold its
// bytes), so the fold of unit n runs while unit n + 1 gathers:
// 4. The fold warps copy in M_4 and the tree's levels (6.1 KiB) once, and a
//    unit's shift and the two inverses below (1.5 KiB) as they take it.
// 5. Each fold thread takes output bytes [128 t, 128 t + 128) of the unit
//    into registers, through the swizzle (each lane's chunks in a rotated
//    order, so that a quarter warp's 16-byte loads hit 8 bank groups), and
//    folds them from a register of 0, four bytes a step (r = M_4(r ^ word)).
//    Unit 0 XORs the initial 0xFFFFFFFF into the row's first four bytes. A
//    warp holds an operator in seven registers, a 32-word table for each
//    5-bit chunk of a register (lane l: word l), so a lookup is a shuffle,
//    with no bank conflicts. The runs join in a tree: level k XORs
//    M_{128 2^k} of the earlier group of 2^k runs with the later group
//    (shuffles in a warp for k < 5, then fold warp 0 over the warps' sums),
//    so each level's operator is one for all lanes. The zeros past declen
//    are in the tile, so the unit's register is its bytes' followed by zeros
//    up to 16 KiB.
// 6. The unit's share of the row's register: a unit before the row's last
//    live one advances its register by M_{16384 (last - u)}; then every
//    live unit takes back the t = 16384 (last + 1) - declen < 2^14 zeros
//    after declen with M_{t % 128}^-1 and M_{128 (t / 128)}^-1 (M_n is
//    invertible: CRC32C's polynomial has a constant term; the tables hold
//    all 254). The shares XOR to the row's register. A row of one live unit
//    writes its CRC; otherwise each unit XORs its share and its bit 32 + u
//    into the row's 64-bit word of state with one atomic, and the unit
//    whose atomic completes the bits writes the CRC and zeroes the word for
//    the next launch. A row's units may fall to different CTAs and steps of
//    the walk; the atomic does not care. Units past declen store zeros and
//    add nothing; a row of declen 0 writes K1's value of an empty row.
// Folding in the gathering warps, between a step's loads and stores, or
// after the walk, was slower: the two pipes then took turns (PERF.md §6).
// Why not K1's way: its 24 KiB of lane tables a CTA, copied from L2 by every
// CTA, cost more than the fold; table lookups in shared memory ran slower
// than shuffles, even copied 32 times to avoid bank conflicts. Why not a
// cluster a row, combined in unit 0's shared memory: clusters of 4 left 8 of
// the 132 SMs idle, and the row waited 0.7-1.1 µs on the cluster barrier or
// an mbarrier, against 0.3 µs for the atomic.
//
// Several launch groups in one launch: up to 16 groups of one layout, each
// of its own rows and widths, in one numbering of units (a unit finds its
// group by comparing its number with the groups' first units), so no row
// is padded wider and no copy grows.
//
// K11 (grouped_kernel) keeps a CTA a (unit, row) of a 2-D grid and its
// indices in registers: its window test and its bucket plane are per unit,
// it has no checksum, and only its tests and tools call it, which time it
// against its own earlier readings.

#include <atomic>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

// One launch group of stpu_cuda_flat_gather_groups (ops/decode_flat.py
// _FlatGroup). Outside the anonymous namespace: the C entry takes it.
struct FlatGroup {
  const uint8_t* srcs;
  const uint16_t* idx;
  const int32_t* tile_meta;
  const int32_t* declens;
  uint8_t* out;
  int64_t* crc;
  int64_t rows, s_width, d_pad;
};

namespace {

constexpr int kThreads = 256;                        // a CTA's gathering threads
constexpr int kMinBlocks = 4;                        // K11: CTAs per SM the registers allow
constexpr int kStages = 1;                           // K2: slots of a CTA's ring
constexpr int kStaticRounds = 2;                     // K2: rounds of the grid before units are claimed
constexpr int kTile = 1024;
constexpr int kUnit = 16384;                         // output bytes per unit
constexpr int kTiles = kUnit / kTile;
constexpr int kChunksPerThread = kUnit / 8 / kThreads;
constexpr int kBatch = 2;                            // K2: chunks whose loads are in flight at once
static_assert(kChunksPerThread % kBatch == 0, "whole batches");
constexpr int kMaxDevices = 64;
static_assert(kStaticRounds > kStages, "the prologue's units are the CTA's own");

// The checksum's tables (ops/decode_flat.py flat_crc_tables), in words.
constexpr int kCrcThreads = 128;                     // the fold warps' threads, after the gatherers
constexpr int kCrcWarps = kCrcThreads / 32;
constexpr int kRun = kUnit / kCrcThreads;            // bytes a thread folds
constexpr int kLevels = 7;                           // M_{128 2^k}: 128 runs join in 7 levels
constexpr int kFive = 6 * 32 + 4;                    // an operator's 5-bit tables: bits 5c.., 30-31
constexpr int kOp = 128;                             // an operator's nibble tables
constexpr int kMaxUnits = 8;                         // units a row, one bit each in its state
constexpr int kStaged = (1 + kLevels) * kFive;       // M_4 and the levels: every CTA's
constexpr int kUnitAt = kStaged;                     // M_{16384 k}, k = 1..7
constexpr int kInvAt = kUnitAt + (kMaxUnits - 1) * kOp;  // M_n^-1, n = lo, 128 hi; 0 < lo, hi < 128
constexpr int kRadix = 128;                          // the zeros past declen: 128 hi + lo < 2^14
constexpr uint32_t kEmptyCrc = 0xA282EAD8u;          // the masked CRC of no bytes
static_assert(kRun == 128 && kCrcWarps == 1 << (kLevels - 5), "128-byte runs, 4 warps");
static_assert(kFive % 4 == 0 && kOp % 4 == 0, "whole 16-byte copies");
static_assert(kRadix * kRadix == kUnit, "two inverses take back any tail");

// K2: a CTA's threads, and the CTAs an SM holds (registers bind both).
template <bool kCrc>
constexpr int kBlock = kThreads + (kCrc ? kCrcThreads : 0);
template <bool kCrc>
constexpr int kWalkBlocks = kCrc ? 2 : 3;

// Named barriers of a walking CTA (0 is __syncthreads'): the gatherers'
// own; with the checksum, a tile's full (gatherers arrive, fold warps wait)
// and empty (the reverse) by the tile's parity, and the fold warps' own.
constexpr int kGatherBar = 1, kFullBar = 2, kEmptyBar = 4, kFoldBar = 6;

// kCrc: what a unit's checksum needs of it.
struct Folded {
  long long b;
  int k, unit, declen, d_pad;  // unit -1: the walk has ended
};

// A walking CTA's shared memory (dynamic: past the 48 KiB of a static array).
// The instance without the checksum has only the part before tile.
struct WalkSmem {
  uint4 idx[kStages][kUnit / 8];       // the slots' indices
  int2 meta[kStages][kTiles];          // the slots' tile_meta rows
  int declen[kStages];                 // the slots' declens
  int unit[kStages];                   // the slots' units of the launch (total: none)
  int claim[2];                        // thread 0's claims, made a step before their use
  uint4 tile[2][kUnit / 16];           // kCrc: a live unit's bytes, for its fold (by parity)
  Folded folded[2];                    // kCrc: that unit
  alignas(16) uint32_t ops[2][3 * kOp];  // kCrc: its shift and inverses
  alignas(16) uint32_t tabs[kStaged];  // kCrc: M_4 and the levels
  uint32_t wsum[2][kCrcWarps];         // kCrc: its warps' sums
};

// Per-phase timestamps of the walk, only in a build with STPU_FLAT_PROBE
// (k2_phase_probe.py): thread 0 of each CTA writes %globaltimer at each mark
// of each step to g_probe[(cta * kProbeSteps + step) * kProbeMarks + mark].
#ifdef STPU_FLAT_PROBE
constexpr int kProbeSteps = 128, kProbeMarks = 8;
__device__ unsigned long long* g_probe;
__device__ __forceinline__ void probe_mark(int step, int mark) {
  if (threadIdx.x != 0 || step >= kProbeSteps || g_probe == nullptr) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_probe[(static_cast<size_t>(blockIdx.x) * kProbeSteps + step) * kProbeMarks + mark] = t;
}
#else
__device__ __forceinline__ void probe_mark(int, int) {}
#endif

// Physical 16-byte chunk of output chunk q of the unit (q >> 6 is its tile).
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 6) & 7); }

// Chunk c of a unit in layout 1 (column c >> 4 of tile c & 15): the output
// byte its first index is for (x) and where that byte lies in the tile (y),
// whose 16-byte chunks are swizzled as swz has them; byte k is 128 k on.
__device__ __forceinline__ int2 chunk_at(int c) {
  const int t = c & 15, col = c >> 4;
  return make_int2(t * kTile + col, t * kTile + (((col >> 4) ^ (t & 7)) << 4) + (col & 15));
}

// A tile's base row, times 128. Clamped, it leaves every position on the
// same side of 0 and s_width.
__device__ __forceinline__ int tile_base(int m, int s_width) {
  return min(max(m, -513), s_width / 128 + 1) * 128;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most n of this thread's commit groups are still in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Named barrier id of n threads: wait for it, or arrive and go on.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Copies words [at, at + n) of the tables to dst, 16 bytes at a time: the
// calling thread its chunk i and every step-th after it (none for i < 0).
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* tabs, int at, int n, int i,
                                      int step) {
  for (; i >= 0 && i < n / 4; i += step) cp_async16(dst + 4 * i, tabs + at + 4 * i);
}

// The row's last live unit, and the zeros after declen in it as two
// base-128 digits.
struct RowEnd {
  int last, lo, hi;
};

__device__ __forceinline__ RowEnd row_end(int declen, int d_pad) {
  const int len = min(declen, d_pad);
  const int last = (len + kUnit - 1) / kUnit - 1;
  const int tail = kUnit * (last + 1) - len;
  return {last, tail % kRadix, tail / kRadix};
}

// Eight nibble lookups: nibble q of v through the 16-entry table t + 16 q.
__device__ __forceinline__ uint32_t lookup8(const uint32_t* t, uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int q = 0; q < 8; q++) r ^= t[16 * q + ((v >> (4 * q)) & 15u)];
  return r;
}

// The operator at tab (shared memory, 5-bit tables) as a warp holds it:
// word 32 c + lane of chunk c's table in register c, and the last chunk's
// four words in lanes 0-3 of register 6.
__device__ __forceinline__ void load_op(uint32_t (&op)[7], const uint32_t* tab, int lane) {
#pragma unroll
  for (int c = 0; c < 6; c++) op[c] = tab[32 * c + lane];
  op[6] = lane < 4 ? tab[192 + lane] : 0u;
}

// The held operator on v (every lane of the warp takes part): bits 5c to
// 5c + 4 of v index chunk c's table, a shuffle from that lane.
__device__ __forceinline__ uint32_t apply(const uint32_t (&op)[7], uint32_t v) {
  uint32_t r = __shfl_sync(0xFFFFFFFFu, op[6], v >> 30);
#pragma unroll
  for (int c = 0; c < 6; c++) r ^= __shfl_sync(0xFFFFFFFFu, op[c], (v >> (5 * c)) & 31u);
  return r;
}

// Level k of the tree over lanes (or warps): each pair of groups 2^k apart
// joins, the earlier one advanced by the level's operator.
__device__ __forceinline__ uint32_t join(const uint32_t* tab, int lane, int k, uint32_t r) {
  uint32_t op[7];
  load_op(op, tab, lane);
  const uint32_t t = apply(op, r);
  const uint32_t own = (lane >> k) & 1 ? r : t;
  return own ^ __shfl_xor_sync(0xFFFFFFFFu, own, 1 << k);
}

// K11 (stpu_cuda_flat_grouped): a CTA a (unit, row) of a 2-D grid, its
// indices loaded into registers.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
grouped_kernel(const uint8_t* __restrict__ srcs, int s_width, const uint16_t* __restrict__ idx,
               const int32_t* __restrict__ tile_meta, const int32_t* __restrict__ gbuck,
               const int32_t* __restrict__ declens, int d_pad, int variant, int w0, int w1,
               int w2, uint8_t* __restrict__ out) {
  __shared__ uint4 tile4[kUnit / 16];
  const int unit = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int g0 = unit * kUnit;
  const int n_chunks = min(kUnit, d_pad - g0) / 8;
  const int lim = declens[b] - g0;  // live bytes of the unit
  const int gb = gbuck[b * (d_pad / kUnit) + unit];
  const bool live = lim > 0 && (variant == 3 ? gb >= 0 && gb <= 2 : gb >= 0);
  const int wlim = (gb == 0 ? w0 : (gb == 1 ? w1 : w2)) * 128;
  uint4* dst = reinterpret_cast<uint4*>(out + b * d_pad + g0);
  if (!live) {
    for (int q = tid; q < n_chunks / 2; q += kThreads) dst[q] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint8_t* src = srcs + b * s_width;
  const int32_t* meta = tile_meta + (b * (d_pad / kTile) + g0 / kTile) * 2;
  const uint4* gidx = reinterpret_cast<const uint4*>(idx + b * d_pad + g0);
  uint4 chunk[kChunksPerThread];
  int base[kChunksPerThread];
#pragma unroll
  for (int j = 0; j < kChunksPerThread; j++) {
    const int c = tid + j * kThreads;
    chunk[j] = c < n_chunks ? __ldg(gidx + c) : make_uint4(0, 0, 0, 0);
    base[j] = tile_base(c < n_chunks ? __ldg(meta + (c & 15) * 2) : 0, s_width);
  }
  uint8_t* tile = reinterpret_cast<uint8_t*>(tile4);
#pragma unroll
  for (int j = 0; j < kChunksPerThread; j++) {
    const int c = tid + j * kThreads;
    const int2 at = chunk_at(c);
    // Index r is read when rlo <= r < rlo + rn: inside the row and the window.
    const int rlo = max(0, -base[j]);
    const unsigned rn = max(0, min(s_width - base[j], wlim) - rlo);
    const int dlim = min(lim, n_chunks * 8) - at.x;  // byte k is live iff 128 k < dlim
    const uint32_t w[4] = {chunk[j].x, chunk[j].y, chunk[j].z, chunk[j].w};
    if (c < n_chunks) {
#pragma unroll
      for (int k = 0; k < 8; k++) {
        const int r = (w[k >> 1] >> (16 * (k & 1))) & 0xFFFF;
        uint8_t x = 0;
        if (static_cast<unsigned>(r - rlo) < rn && k * 128 < dlim) x = __ldg(src + base[j] + r);
        tile[at.y + k * 128] = x;
      }
    }
  }
  __syncthreads();
  for (int q = tid; q < n_chunks / 2; q += kThreads) dst[q] = tile4[swz(q)];
}

// Several launch groups of one layout in one launch (K2, with or without the
// checksum; never K11's buckets). Group k holds units [first[k], first[k +
// 1]) of the launch, a unit a (row, unit) of its own rows and width with the
// unit fastest; no unit lies past a row's d_pad. The groups' rows take
// consecutive words of state from state_row[k]. Entries past the last group
// hold first = the launch's units.
constexpr int kMaxGroups = 16;  // ops/decode_flat.py MAX_LAUNCH_GROUPS

struct Groups {
  FlatGroup g[kMaxGroups];
  int first[kMaxGroups + 1];
  int units[kMaxGroups];
  int state_row[kMaxGroups];
};

// Unit v of the launch: its group, row and unit of the row.
struct Unit {
  int k, u;
  long long b;
};

__device__ __forceinline__ Unit locate(const Groups& l, int v) {
  int k = 0;
#pragma unroll
  for (int i = 1; i < kMaxGroups; i++) k += v >= l.first[i];
  const int local = v - l.first[k];
  const int row = local / l.units[k];
  return {k, local - row * l.units[k], row};
}

// Every thread's share of filling slot s with unit v, whose row's declen
// is declen (step 1): nothing for a unit wholly past declen, and for v past
// the launch's units the slot's mark that the walk has ended. The caller
// commits the group.
template <int kLayout>
__device__ __forceinline__ void fill(WalkSmem& sm, int s, const Groups& l, int v, int declen) {
  const int total = l.first[kMaxGroups];
  if (threadIdx.x == 0) {
    sm.unit[s] = min(v, total);
    sm.declen[s] = declen;
  }
  if (v >= total) return;
  const Unit n = locate(l, v);
  const FlatGroup& g = l.g[n.k];
  const int d_pad = static_cast<int>(g.d_pad), g0 = n.u * kUnit;
  if (declen <= g0) return;
  const int n_chunks = min(kUnit, d_pad - g0) / 8;
  const uint4* gidx = reinterpret_cast<const uint4*>(g.idx + n.b * d_pad + g0);
#pragma unroll
  for (int j = 0; j < kChunksPerThread; j++) {
    const int c = threadIdx.x + j * kThreads;
    // Layout 1: chunk c (column c >> 4 of tile c & 15) at c ^ (c >> 4 & 7), so
    // that 8 columns of a tile lie in 8 different bank groups.
    if (c < n_chunks) cp_async16(&sm.idx[s][kLayout ? c ^ ((c >> 4) & 7) : c], gidx + c);
  }
  const int2* meta =
      reinterpret_cast<const int2*>(g.tile_meta) + n.b * (d_pad / kTile) + g0 / kTile;
  const int t = threadIdx.x;
  if (t < n_chunks * 8 / kTile) cp_async8(&sm.meta[s][t], meta + t);
}

// The masked CRC32C of a row whose register (from 0xFFFFFFFF) is u.
__device__ __forceinline__ int64_t masked_crc(uint32_t u) {
  const uint32_t crc = u ^ 0xFFFFFFFFu;
  return static_cast<int64_t>(((crc >> 15) | (crc << 17)) + kEmptyCrc);
}

// Steps 5-6 for warp 0 of the fold warps, once the warps' sums (wsum[p]) of
// unit f are in: the tree's last levels, the unit's share (its operators at
// ops), and the row's CRC, at once or, through the row's state, by the
// row's last unit.
__device__ __forceinline__ void fold_tail(const WalkSmem& sm, const Groups& l,
                                          unsigned long long* crc_state, const uint32_t* ops,
                                          int p, const Folded& f) {
  const int lane = threadIdx.x & 31;
  uint32_t u = lane < kCrcWarps ? sm.wsum[p][lane] : 0u;
#pragma unroll
  for (int k = 5; k < kLevels; k++) u = join(sm.tabs + kFive * (1 + k), lane, k - 5, u);
  if (lane != 0) return;
  // The unit's share of the row's register: to the live units' end, then
  // back past the zeros after declen.
  const RowEnd e = row_end(f.declen, f.d_pad);
  if (f.unit < e.last) u = lookup8(ops, u);
  if (e.lo) u = lookup8(ops + kOp, u);
  if (e.hi) u = lookup8(ops + 2 * kOp, u);
  if (e.last > 0) {
    // The row's state: the XOR of its units' shares, and bit 32 + u for
    // each unit in. The unit that completes the bits has the register and
    // zeroes the state for the next launch on this stream.
    unsigned long long* state = crc_state + l.state_row[f.k] + f.b;
    const unsigned long long mine = (1ull << (32 + f.unit)) | u;
    const unsigned long long now = atomicXor(state, mine) ^ mine;
    if (static_cast<unsigned>(now >> 32) != (1u << (e.last + 1)) - 1) return;
    *state = 0;
    u = static_cast<uint32_t>(now);
  }
  l.g[f.k].crc[f.b] = masked_crc(u);
}

// The fold warps (kCrc; threads kThreads.. of the CTA): steps 4-6 on each
// live unit the gatherers hand over, in their order, while the gatherers
// gather the next. For the unit in tile p: wait for it (full), take this
// thread's run of 128 bytes into registers (each lane's chunks in a rotated
// order, so that a quarter warp's 16-byte loads hit 8 bank groups), hand
// the tile back (empty), copy the unit's operators in, fold the run from a
// register of 0, four bytes a step (r = M_4(r ^ word); unit 0's first four
// bytes XORed with the initial value), join the runs over the warp, then
// warp 0 the warps' sums (fold_tail). Ends at the gatherers' mark.
__device__ __forceinline__ void fold_warps(WalkSmem& sm, const Groups& l,
                                           const uint32_t* __restrict__ crc_tabs,
                                           unsigned long long* __restrict__ crc_state) {
  constexpr int kHandoff = kThreads + kCrcThreads;
  const int t = threadIdx.x - kThreads, lane = t & 31, warp = t >> 5;
  stage(sm.tabs, crc_tabs, 0, kStaged, t, kCrcThreads);
  for (int n = 0;; n++) {
    const int p = n & 1;
    bar_sync(kFullBar + p, kHandoff);
    const Folded f = sm.folded[p];
    if (f.unit < 0) break;
    const int n_chunks = min(kUnit, f.d_pad - f.unit * kUnit) / 8;
    const int rot = t & 7;
    uint4 run[kRun / 16];
#pragma unroll
    for (int i = 0; i < kRun / 16; i++) {
      const int q = t * (kRun / 16) + ((i + rot) & 7);  // none past the unit's n_chunks
      run[i] = q < n_chunks / 2 ? sm.tile[p][swz(q)] : make_uint4(0, 0, 0, 0);
    }
    bar_arrive(kEmptyBar + p, kHandoff);
#pragma unroll
    for (int s = 1; s < 8; s <<= 1) {
      if (rot & s) {
        uint4 rolled[kRun / 16];
#pragma unroll
        for (int i = 0; i < kRun / 16; i++) rolled[i] = run[(i - s) & 7];
#pragma unroll
        for (int i = 0; i < kRun / 16; i++) run[i] = rolled[i];
      }
    }
    if (t == 0 && f.unit == 0) run[0].x ^= 0xFFFFFFFFu;
    {
      const RowEnd e = row_end(f.declen, f.d_pad);
      // a warp an operator
      if (f.unit < e.last)
        stage(sm.ops[p], crc_tabs, kUnitAt + kOp * (e.last - f.unit - 1), kOp, t, 32);
      if (e.lo) stage(sm.ops[p] + kOp, crc_tabs, kInvAt + kOp * (e.lo - 1), kOp, t - 32, 32);
      if (e.hi)
        stage(sm.ops[p] + 2 * kOp, crc_tabs, kInvAt + kOp * (kRadix - 2 + e.hi), kOp, t - 64, 32);
    }
    uint32_t op[7];
    cp_async_commit();
    cp_async_wait<0>();  // the tables (the first unit), the unit's operators
    bar_sync(kFoldBar, kCrcThreads);
    load_op(op, sm.tabs, lane);  // M_4
    uint32_t r = 0;
#pragma unroll
    for (int i = 0; i < kRun / 16; i++) {
      r = apply(op, r ^ run[i].x);
      r = apply(op, r ^ run[i].y);
      r = apply(op, r ^ run[i].z);
      r = apply(op, r ^ run[i].w);
    }
#pragma unroll
    for (int k = 0; k < 5; k++) r = join(sm.tabs + kFive * (1 + k), lane, k, r);
    if (lane == 0) sm.wsum[p][warp] = r;
    bar_sync(kFoldBar, kCrcThreads);
    if (warp == 0) fold_tail(sm, l, crc_state, sm.ops[p], p, f);
  }
}

// Steps 2-3: slot s's unit, its bytes [0, live) from src (a row of s_width
// bytes) and zeros up to the unit's end (n_bytes), to out (its first output
// byte) or, with kToTile (the checksum's gatherers), to tile4 in the
// layout the store-out reads (16-byte chunk q at swz(q)). A warp's load
// instruction takes 32 output bytes in a run of 32 (layout 1) or 64
// (layout 0), and its stores fill whole sectors. A thread takes 8 bytes a
// chunk: in layout 1 column col of a tile, rows 0-7, one 16-byte chunk of
// the slot (placed by fill's swizzle); in layout 0 four pairs of
// neighbouring bytes 512 apart, or into the tile 8 consecutive bytes (its
// 2-byte stores there were slower). It issues the loads of kBatch chunks
// before it stores any of their bytes.
template <int kLayout, bool kToTile>
__device__ __forceinline__ void gather(const WalkSmem& sm, int s, const uint8_t* __restrict__ src,
                                       int s_width, int live, int n_bytes,
                                       uint8_t* __restrict__ out, uint4* tile4) {
  const int tid = threadIdx.x;
  uint8_t* tile = reinterpret_cast<uint8_t*>(tile4);
  const int warp = tid >> 5, col = (warp & 3) * 32 + (tid & 31);
  const uint16_t* idx = reinterpret_cast<const uint16_t*>(sm.idx[s]);
#pragma unroll
  for (int j0 = 0; j0 < kChunksPerThread; j0 += kBatch) {
    uint32_t x[kBatch][8];
#pragma unroll
    for (int jb = 0; jb < kBatch; jb++) {
      const int j = j0 + jb;
      if constexpr (kLayout) {
        const int t = 2 * j + (warp >> 2), c = (col << 4) | t;
        const uint4 q = sm.idx[s][c ^ (col & 7)];
        const int base = tile_base(sm.meta[s][t].x, s_width);
        const int dlim = live - (t * kTile + col);  // row k is live iff 128 k < dlim
        const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int k = 0; k < 8; k++) {
          const int p = base + ((w[k >> 1] >> (16 * (k & 1))) & 0xFFFF);  // inside the row?
          x[jb][k] = static_cast<unsigned>(p) < static_cast<unsigned>(s_width) && k * 128 < dlim
                         ? __ldg(src + p) : 0u;
        }
      } else if (kToTile) {  // a chunk's 8 bytes at once into the tile
        const int c = tid + j * kThreads;
        if (c * 8 < n_bytes) {
          const uint4 q = sm.idx[s][c];
          const int base = tile_base(sm.meta[s][c >> 7].x, s_width);
          const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int k = 0; k < 8; k++) {
            const int p = base + ((w[k >> 1] >> (16 * (k & 1))) & 0xFFFF);
            x[jb][k] = static_cast<unsigned>(p) < static_cast<unsigned>(s_width) && c * 8 + k < live
                           ? __ldg(src + p) : 0u;
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < 4; h++) {
          const int d = (4 * j + h) * 2 * kThreads + 2 * tid;  // all of a step's threads, or none
          if ((4 * j + h) * 2 * kThreads < n_bytes) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(idx + d);
            const int base = tile_base(sm.meta[s][d / kTile].x, s_width);
#pragma unroll
            for (int e = 0; e < 2; e++) {
              const int p = base + ((w >> (16 * e)) & 0xFFFF);
              x[jb][2 * h + e] = static_cast<unsigned>(p) < static_cast<unsigned>(s_width) &&
                                 d + e < live ? __ldg(src + p) : 0u;
            }
          }
        }
      }
    }
#pragma unroll
    for (int jb = 0; jb < kBatch; jb++) {
      const int j = j0 + jb;
      if constexpr (kLayout) {
        const int2 at = chunk_at((col << 4) | (2 * j + (warp >> 2)));
        uint8_t* o = kToTile ? tile + at.y : out + at.x;
#pragma unroll
        for (int k = 0; k < 8; k++) o[k * 128] = static_cast<uint8_t>(x[jb][k]);
      } else if (kToTile) {
        const int c = tid + j * kThreads;
        if (c * 8 < n_bytes)
          *reinterpret_cast<uint2*>(tile + (swz(c >> 1) << 4) + (c & 1) * 8) =
              make_uint2(x[jb][0] | x[jb][1] << 8 | x[jb][2] << 16 | x[jb][3] << 24,
                         x[jb][4] | x[jb][5] << 8 | x[jb][6] << 16 | x[jb][7] << 24);
      } else {
#pragma unroll
        for (int h = 0; h < 4; h++) {
          const int d = (4 * j + h) * 2 * kThreads + 2 * tid;
          if ((4 * j + h) * 2 * kThreads < n_bytes)
            *reinterpret_cast<uint16_t*>(kToTile ? tile + (swz(d >> 4) << 4) + (d & 15) : out + d) =
                static_cast<uint16_t>(x[jb][2 * h] | x[jb][2 * h + 1] << 8);
        }
      }
    }
  }
}

// The declen of unit v's row, or 0 past the launch's units.
__device__ __forceinline__ int declen_of(const Groups& l, int v, int total) {
  if (v >= total) return 0;
  const Unit n = locate(l, v);
  return __ldg(l.g[n.k].declens + n.b);
}

// The walk (steps 1-3 by the gatherers, threads 0..kThreads-1; kCrc: steps
// 4-6 by the fold warps after them, fold_warps): CTA blockIdx.x takes units
// blockIdx.x + i gridDim.x of the launch's l.first[kMaxGroups] for its first
// kStaticRounds steps, then (with a counter) units it claims.
template <int kLayout, bool kCrc>
__global__ void __launch_bounds__(kBlock<kCrc>, kWalkBlocks<kCrc>)
flat_groups_kernel(const __grid_constant__ Groups l, const uint32_t* __restrict__ crc_tabs,
                   unsigned long long* __restrict__ crc_state, unsigned* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  WalkSmem& sm = *reinterpret_cast<WalkSmem*>(smem_raw);
  const int tid = threadIdx.x;
  if constexpr (kCrc) {
    if (tid >= kThreads) {
      fold_warps(sm, l, crc_tabs, crc_state);
      return;
    }
  }
  constexpr int kHandoff = kThreads + kCrcThreads;
  const int total = l.first[kMaxGroups], grid = gridDim.x;
#pragma unroll
  for (int s = 0; s < kStages; s++) {
    const int v = blockIdx.x + s * grid;
    fill<kLayout>(sm, s, l, v, declen_of(l, v, total));
    cp_async_commit();
  }
  int claim = 0;  // thread 0: the unit its step claims
  int handed = 0;  // kCrc: live units handed to the fold warps
  for (int i = 0;; i++) {
    const int s = i % kStages;  // this step's slot
    probe_mark(i, 0);
    // The unit that refills this slot after the gather: in the grid's first
    // kStaticRounds rounds (all of them without a counter) its own, then one
    // claimed a step before; its declen is wanted after the gather. Thread 0
    // claims the next step's.
    auto refill = [&] {
      return i + kStages < kStaticRounds ? blockIdx.x + (i + kStages) * grid
                                         : sm.claim[(i - 1) & 1];
    };
    const int ahead = declen_of(l, refill(), total);
    if (tid == 0)
      claim = counter != nullptr && i + 1 + kStages >= kStaticRounds
                  ? kStaticRounds * grid + static_cast<int>(atomicAdd(counter, 1u))
                  : blockIdx.x + (i + 1 + kStages) * grid;
    cp_async_wait<kStages - 1>();
    bar_sync(kGatherBar, kThreads);
    probe_mark(i, 1);
    const int v = sm.unit[s];
    if (v >= total) break;
    const Unit n = locate(l, v);
    const FlatGroup& g = l.g[n.k];
    const long long b = n.b;
    const int unit = n.u, d_pad = static_cast<int>(g.d_pad), s_width = static_cast<int>(g.s_width);
    const int g0 = unit * kUnit;
    const int n_chunks = min(kUnit, d_pad - g0) / 8;
    const int lim = sm.declen[s] - g0;  // live bytes of the unit
    const bool live = lim > 0;
    if constexpr (kCrc) {
      if (unit == 0 && tid == 0 && !live) g.crc[b] = kEmptyCrc;  // K1's value of no bytes
    }
    uint8_t* const out = g.out + b * d_pad + g0;
    const int p = handed & 1;  // kCrc: the tile this unit takes
    if (live) {
      if constexpr (kCrc) {
        if (handed >= 2) bar_sync(kEmptyBar + p, kHandoff);  // its last unit folded
        probe_mark(i, 3);
      }
      gather<kLayout, kCrc>(sm, s, g.srcs + b * s_width, s_width, min(lim, n_chunks * 8),
                            n_chunks * 8, out, sm.tile[p]);
    }
    if (tid == 0) sm.claim[i & 1] = claim;
    bar_sync(kGatherBar, kThreads);  // the unit is gathered and its slot read
    probe_mark(i, 2);
    fill<kLayout>(sm, s, l, refill(), ahead);  // refill() again: no register holds it
    cp_async_commit();
    uint4* dst = reinterpret_cast<uint4*>(out);
    if (!live) {
      for (int q = tid; q < n_chunks / 2; q += kThreads) dst[q] = make_uint4(0, 0, 0, 0);
    } else if constexpr (kCrc) {
      for (int q = tid; q < n_chunks / 2; q += kThreads) dst[q] = sm.tile[p][swz(q)];
      if (tid == 0) sm.folded[p] = {b, n.k, unit, lim + g0, d_pad};
      bar_arrive(kFullBar + p, kHandoff);
      handed++;
    }
  }
  if constexpr (kCrc) {
    // The fold warps' end: the mark in the next tile, once its last unit is
    // folded; then the last unit handed over, so that every arrival is met.
    const int p = handed & 1;
    if (handed >= 2) bar_sync(kEmptyBar + p, kHandoff);
    if (tid == 0) sm.folded[p].unit = -1;
    bar_arrive(kFullBar + p, kHandoff);
    if (handed >= 1) bar_sync(kEmptyBar + (p ^ 1), kHandoff);
  }
  // The last CTA out, once every CTA's claims are made, zeroes the counter
  // for the next launch on this stream.
  if (counter != nullptr && tid == 0) {
    __threadfence();
    if (atomicAdd(counter + 1, 1u) == static_cast<unsigned>(grid) - 1) {
      counter[0] = 0;
      counter[1] = 0;
    }
  }
}

// The dynamic shared memory of a walking CTA.
template <bool kCrc>
constexpr size_t walk_smem() {
  return kCrc ? sizeof(WalkSmem) : offsetof(WalkSmem, tile);
}

using WalkKernel = void (*)(Groups, const uint32_t*, unsigned long long*, unsigned*);

// The CTAs of `kernel` the current card holds at once (its SMs times the CTAs
// an SM holds), found once a card and kept; 0 if the query fails. The
// first call on a card also lets the kernel take its dynamic shared memory.
template <int kLayout, bool kCrc>
int resident_ctas() {
  static std::atomic<int> held[kMaxDevices];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  int n = held[dev].load(std::memory_order_relaxed);
  if (n > 0) return n;
  const WalkKernel kernel = flat_groups_kernel<kLayout, kCrc>;
  int sms = 0, per_sm = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(walk_smem<kCrc>())) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock<kCrc>,
                                                    walk_smem<kCrc>()) != cudaSuccess)
    return 0;
  n = sms * per_sm;
  held[dev].store(n, std::memory_order_relaxed);
  return n;
}

}  // namespace

// K2 over groups[0, n) in one launch, 1 <= n <= kMaxGroups, every group of
// one layout and at least one row and unit: each group's out (and, with
// crc_tabs, the checksum instance, its crc) as a launch of that group alone
// would write them. With the checksum a group's d_pad is at most 8 units
// and state holds the groups' rows' zeroed words, which are left zeroed:
// the rows' units meet there. counter, two zeroed words (or null: a static
// walk), hands out the units past the grid's first rounds and is left
// zeroed. walked, unless null, receives the units the launch walks and the
// CTAs it runs.
extern "C" int stpu_cuda_flat_gather_groups(const FlatGroup* groups, int n, int layout,
                                            const uint32_t* crc_tabs,
                                            unsigned long long* state, unsigned* counter,
                                            int64_t* walked, void* stream) {
  if (n < 1 || n > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  Groups l{};
  long long units = 0, rows = 0;
  for (int k = 0; k < n; k++) {
    const FlatGroup& g = groups[k];
    const long long row_units = (g.d_pad + kUnit - 1) / kUnit;
    if (g.rows < 1 || row_units < 1 || (crc_tabs != nullptr && row_units > kMaxUnits))
      return static_cast<int>(cudaErrorInvalidValue);
    l.g[k] = g;
    l.first[k] = static_cast<int>(units);
    l.units[k] = static_cast<int>(row_units);
    l.state_row[k] = static_cast<int>(rows);
    units += row_units * g.rows;
    rows += g.rows;
    if (units > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = n; k <= kMaxGroups; k++) l.first[k] = static_cast<int>(units);
  const bool crc = crc_tabs != nullptr;
  const WalkKernel kernel = crc ? (layout ? flat_groups_kernel<1, true>
                                         : flat_groups_kernel<0, true>)
                                : (layout ? flat_groups_kernel<1, false>
                                          : flat_groups_kernel<0, false>);
  const int resident = crc ? (layout ? resident_ctas<1, true>() : resident_ctas<0, true>())
                           : (layout ? resident_ctas<1, false>() : resident_ctas<0, false>());
  if (resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long ctas = units < resident ? units : resident;
  // A launch of at most kStaticRounds rounds walks them without the counter.
  if (units <= kStaticRounds * ctas) counter = nullptr;
  if (walked != nullptr) {
    walked[0] = units;
    walked[1] = ctas;
  }
  kernel<<<static_cast<unsigned>(ctas), crc ? kBlock<true> : kBlock<false>,
           crc ? walk_smem<true>() : walk_smem<false>(),
           static_cast<cudaStream_t>(stream)>>>(l, crc_tabs, state, counter);
  return static_cast<int>(cudaGetLastError());
}

// K2 on one group: stpu_cuda_flat_gather_groups with one entry.
extern "C" int stpu_cuda_flat_gather(const uint8_t* srcs, int64_t n_rows, int64_t s_width,
                                     const uint16_t* idx, const int32_t* tile_meta,
                                     const int32_t* declens, int64_t d_pad, int layout,
                                     uint8_t* out, void* stream) {
  const FlatGroup g{srcs, idx, tile_meta, declens, out, nullptr, n_rows, s_width, d_pad};
  return stpu_cuda_flat_gather_groups(&g, 1, layout, nullptr, nullptr, nullptr, nullptr, stream);
}

// K2 with the frame checksum on one group: crc[b] is the masked CRC32C of
// out[b, :declen] (declen clamped to [0, d_pad]).
extern "C" int stpu_cuda_flat_gather_crc(const uint8_t* srcs, int64_t n_rows, int64_t s_width,
                                         const uint16_t* idx, const int32_t* tile_meta,
                                         const int32_t* declens, int64_t d_pad, int layout,
                                         const uint32_t* crc_tabs, uint8_t* out, int64_t* crc,
                                         unsigned long long* state, void* stream) {
  const FlatGroup g{srcs, idx, tile_meta, declens, out, crc, n_rows, s_width, d_pad};
  return stpu_cuda_flat_gather_groups(&g, 1, layout, crc_tabs, state, nullptr, nullptr, stream);
}

// K11: K2 in layout 1 with a window bucket a 16 KiB group (gbuck), a CTA a
// (unit, row) of a 2-D grid.
extern "C" int stpu_cuda_flat_grouped(const uint8_t* srcs, int64_t n_rows, int64_t s_width,
                                      const uint16_t* idx, const int32_t* tile_meta,
                                      const int32_t* gbuck, const int32_t* declens,
                                      int64_t d_pad, int variant, int w0, int w1, int w2,
                                      uint8_t* out, void* stream) {
  const dim3 grid(static_cast<unsigned>((d_pad + kUnit - 1) / kUnit), static_cast<unsigned>(n_rows));
  grouped_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      srcs, static_cast<int>(s_width), idx, tile_meta, gbuck, declens, static_cast<int>(d_pad),
      variant, w0, w1, w2, out);
  return static_cast<int>(cudaGetLastError());
}

#ifdef STPU_FLAT_PROBE
// The probe build's buffer of timestamps: kProbeSteps steps of kProbeMarks
// marks a CTA (0: no mark written), or null for none.
extern "C" int stpu_cuda_flat_probe(unsigned long long* buf, int* steps, int* marks) {
  *steps = kProbeSteps;
  *marks = kProbeMarks;
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, &buf, sizeof(buf)));
}
#endif
