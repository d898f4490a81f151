// Flat-gather decode, K2 and K11 in one kernel.
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
// arithmetic. With the loads issued together this design runs at 1.75
// times the bound, and at 1.0 without its source reads. Staging each CTA's
// source span in shared memory and gathering from there took 0.94 of this
// design's time, at 80 registers with spills and 72 KB of shared memory a
// CTA; this one keeps 64 registers, 16 KB and no span machinery
// (flat_gather_probe.py, PERF.md §6).
//
// Design: one CTA of 256 threads per (16 KiB unit of output, row).
// 1. A unit wholly past declen, or dead under K11, stores zeros, reads nothing.
// 2. Each thread loads 8 chunks of 8 indices, 16 bytes each, coalesced,
//    into registers, with their tiles' bases. In layout 1 a chunk holds
//    output bytes d, d+128, ..., d+896 of one tile; in layout 0, 8
//    consecutive ones.
// 3. It then issues its 64 source loads, independent of each other, in
//    32-bit arithmetic (L1 caches the rows), and stores each byte into an
//    output tile in shared memory, whose 16-byte chunks are XOR-swizzled by
//    tile so that layout 1's column stores spread over the banks.
// 4. The tile goes out with 16-byte stores.
//
// The frame checksum (kCrc, stpu_cuda_flat_gather_crc): the same kernel also
// writes each row's masked CRC32C of its first declen bytes, as K1 would of
// the output, so the frame read needs no K1 after it. kCrc is a template
// parameter: the instance without it (K2, K11) is the code above alone. A
// CRC register is linear over GF(2): the raw register of A || B from 0 is
// M_|B|(R(A)) ^ R(B), where M_n advances a register past n zero bytes. An
// M_n is held as eight nibble tables of 16 words (128 words) or, where a
// warp applies it with shuffles, as seven tables of 5-bit chunks (196).
// 5. While the gather runs, the CTA copies in (cp.async) the operators it
//    will need: M_4, the tree's levels, its unit's shift and the inverses
//    below, up to 7.6 KiB.
// 6. Once the tile is written out, each of the first 128 threads takes
//    output bytes [128 t, 128 t + 128) of the unit into registers, through
//    the swizzle (each lane's chunks in a rotated order, so that a quarter
//    warp's 16-byte loads hit 8 bank groups), and folds them from a
//    register of 0, four bytes a step (r = M_4(r ^ word)). Unit 0 XORs the
//    initial 0xFFFFFFFF into the row's first four bytes. A warp holds an
//    operator in seven registers, a 32-word table for each 5-bit chunk of
//    a register (lane l: word l), so a lookup is a shuffle, with no bank
//    conflicts; a shuffle takes two cycles of the SM's shared pipe, so the
//    fold is that pipe's work, and 128 threads of 128 bytes need fewer of
//    them than 256 of 64 (the tree below is shorter). The runs join in a
//    tree: level k XORs M_{128 2^k} of the earlier group of 2^k runs with
//    the later group (shuffles in a warp for k < 5, then warp 0 over the
//    warps' sums), so each level's operator is one for all lanes. The
//    zeros past declen are in the tile, so the unit's register is its
//    bytes' followed by zeros up to 16 KiB.
// 7. The unit's share of the row's register: a unit before the row's last
//    live one advances its register by M_{16384 (last - u)}; then every
//    live unit takes back the t = 16384 (last + 1) - declen < 2^14 zeros
//    after declen with M_{t % 128}^-1 and M_{128 (t / 128)}^-1 (M_n is
//    invertible: CRC32C's polynomial has a constant term; the tables hold
//    all 254). The shares XOR to the row's register. A row of one live unit
//    writes its CRC; otherwise each unit XORs its share and its bit 32 + u
//    into the row's 64-bit word of state with one atomic, and the unit
//    whose atomic completes the bits writes the CRC and zeroes the word for
//    the next launch. Units past declen store zeros and add nothing; a row
//    of declen 0 writes K1's value of an empty row.
// Why not K1's way (PERF.md §6): its 24 KiB of lane tables a CTA, copied
// from L2 by every CTA, cost more than the fold; table lookups in shared
// memory ran slower than shuffles, even copied 32 times to avoid bank
// conflicts. Why not a cluster a row, combined in unit 0's shared memory:
// clusters of 4 left 8 of the 132 SMs idle, and the row waited 0.7-1.1 µs
// on the cluster barrier or an mbarrier, against 0.3 µs for the atomic.
//
// Several launch groups in one launch (stpu_cuda_flat_gather_groups, every
// K2 launch, of one group or more; K11 keeps its 2-D grid): a frame read's
// groups, one a source width, are each often under one wave (528 CTAs at 4
// an SM), so launched apart each costs a lone CTA's latency chain. One 1-D
// grid over a call's groups fills the card instead (the 16 MiB read's five,
// PERF.md §6); each group keeps its own widths, so no row is padded wider
// and no copy grows.

#include <climits>
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

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;                        // CTAs per SM the registers allow
constexpr int kTile = 1024;
constexpr int kUnit = 16384;                         // output bytes per CTA
constexpr int kChunksPerThread = kUnit / 8 / kThreads;

// The checksum's tables (ops/decode_flat.py flat_crc_tables), in words.
constexpr int kCrcThreads = 128;                     // the threads that fold the unit
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

// Physical 16-byte chunk of output chunk q of the unit (q >> 6 is its tile).
__device__ __forceinline__ int swz(int q) { return q ^ ((q >> 6) & 7); }

// The checksum's shared memory: M_4 and the levels (5-bit tables), then
// this unit's shift to the live units' end and the two inverses of the
// zeros past declen (nibble tables), copied in while the gather runs; then
// the warps' sums. Only the kCrc
// instance calls this, so only it holds the array.
__device__ __forceinline__ uint32_t* crc_smem() {
  __shared__ __align__(16) uint32_t s[kStaged + 3 * kOp + kCrcWarps];
  return s;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies words [at, at + n) of the tables to dst.
__device__ __forceinline__ void stage(uint32_t* dst, const uint32_t* tabs, int at, int n) {
  for (int i = threadIdx.x; i < n / 4; i += kThreads) cp_async16(dst + 4 * i, tabs + at + 4 * i);
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

// The XOR of the warp's 32 registers, in every lane.
__device__ __forceinline__ uint32_t warp_xor(uint32_t r) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) r ^= __shfl_xor_sync(0xFFFFFFFFu, r, o);
  return r;
}

// One CTA's work: 16 KiB unit `unit` of row `b` (steps 1-7 above).
template <int kLayout, bool kCrc>
__device__ __forceinline__ void flat_unit(
    const uint8_t* __restrict__ srcs, int s_width, const uint16_t* __restrict__ idx,
    const int32_t* __restrict__ tile_meta, const int32_t* __restrict__ gbuck,
    const int32_t* __restrict__ declens, int d_pad, int variant, int w0, int w1, int w2,
    uint8_t* __restrict__ out, const uint32_t* __restrict__ crc_tabs,
    int64_t* __restrict__ crc_out, unsigned long long* __restrict__ crc_state, int unit,
    long long b) {
  constexpr int kStep = kLayout ? 128 : 1;  // output bytes between a chunk's indices
  __shared__ uint4 tile4[kUnit / 16];
  const int tid = threadIdx.x;
  const int g0 = unit * kUnit;
  const int n_chunks = min(kUnit, d_pad - g0) / 8;
  const int lim = declens[b] - g0;  // live bytes of the unit
  bool live = lim > 0;
  int wlim = 1 << 16;  // above every uint16 index: K2 takes each byte
  if (gbuck != nullptr) {
    const int gb = gbuck[b * (d_pad / kUnit) + unit];
    live = live && (variant == 3 ? gb >= 0 && gb <= 2 : gb >= 0);
    wlim = (gb == 0 ? w0 : (gb == 1 ? w1 : w2)) * 128;
  }
  uint4* dst = reinterpret_cast<uint4*>(out + b * d_pad + g0);
  if constexpr (kCrc) {
    // A row with no live unit: K1's value of no bytes. Written here, not in
    // the branch below: there it changed the live path's code and cost the
    // gather ~0.5 µs a CTA.
    if (unit == 0 && tid == 0 && !live) crc_out[b] = kEmptyCrc;
  }
  if (!live) {
    for (int q = tid; q < n_chunks / 2; q += kThreads) dst[q] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint8_t* src = srcs + b * s_width;
  const int32_t* meta = tile_meta + (b * (d_pad / kTile) + g0 / kTile) * 2;
  // Chunk j of this thread: c = tid + j * kThreads, the indices of output
  // bytes d0 + k * kStep, stored in the tile at a0 + k * kStep.
  const uint4* gidx = reinterpret_cast<const uint4*>(idx + b * d_pad + g0);
  uint4 chunk[kChunksPerThread];
  int base[kChunksPerThread];
#pragma unroll
  for (int j = 0; j < kChunksPerThread; j++) {
    const int c = tid + j * kThreads;
    chunk[j] = c < n_chunks ? __ldg(gidx + c) : make_uint4(0, 0, 0, 0);
    // Clamped, a base leaves every position on the same side of 0 and s_width.
    const int m = c < n_chunks ? __ldg(meta + (kLayout ? c & 15 : c >> 7) * 2) : 0;
    base[j] = min(max(m, -513), s_width / 128 + 1) * 128;
  }
  if constexpr (kCrc) {
    const RowEnd e = row_end(lim + g0, d_pad);
    const int last = e.last, lo = e.lo, hi = e.hi;
    uint32_t* t = crc_smem();
    stage(t, crc_tabs, 0, kStaged);
    if (unit < last) stage(t + kStaged, crc_tabs, kUnitAt + kOp * (last - unit - 1), kOp);
    if (lo) stage(t + kStaged + kOp, crc_tabs, kInvAt + kOp * (lo - 1), kOp);
    if (hi) stage(t + kStaged + 2 * kOp, crc_tabs, kInvAt + kOp * (kRadix - 2 + hi), kOp);
  }
  uint8_t* tile = reinterpret_cast<uint8_t*>(tile4);
#pragma unroll
  for (int j = 0; j < kChunksPerThread; j++) {
    const int c = tid + j * kThreads, t = c & 15, col = c >> 4;
    const int d0 = kLayout ? t * kTile + col : c * 8;
    const int a0 = kLayout ? t * kTile + (((col >> 4) ^ (t & 7)) << 4) + (col & 15)
                           : (swz(c >> 1) << 4) + (c & 1) * 8;
    // Index r is read when rlo <= r < rlo + rn: inside the row and the window.
    const int rlo = max(0, -base[j]);
    const unsigned rn = max(0, min(s_width - base[j], wlim) - rlo);
    const int dlim = min(lim, n_chunks * 8) - d0;  // byte k is live iff k * kStep < dlim
    const uint32_t w[4] = {chunk[j].x, chunk[j].y, chunk[j].z, chunk[j].w};
    if (c < n_chunks) {
#pragma unroll
      for (int k = 0; k < 8; k++) {
        const int r = (w[k >> 1] >> (16 * (k & 1))) & 0xFFFF;
        uint8_t x = 0;
        if (static_cast<unsigned>(r - rlo) < rn && k * kStep < dlim) x = __ldg(src + base[j] + r);
        tile[a0 + k * kStep] = x;
      }
    }
  }
  if constexpr (kCrc) cp_async_wait_all();
  __syncthreads();
  for (int q = tid; q < n_chunks / 2; q += kThreads) dst[q] = tile4[swz(q)];
  if constexpr (kCrc) {
    const RowEnd e = row_end(lim + g0, d_pad);  // again: no register holds it over the gather
    const int last = e.last, lo = e.lo, hi = e.hi;
    const uint32_t* tabs = crc_smem();
    uint32_t* wsum = crc_smem() + kStaged + 3 * kOp;
    const int lane = tid & 31, warp = tid >> 5;
    if (tid < kCrcThreads) {
      // Chunk (i + rot) & 7 of the run first, so that the 8 lanes of each
      // quarter warp read 8 different bank groups; then back in order.
      const int rot = tid & 7;
      uint4 run[kRun / 16];
#pragma unroll
      for (int i = 0; i < kRun / 16; i++) {
        const int q = tid * (kRun / 16) + ((i + rot) & 7);  // none past the unit's n_chunks
        run[i] = q < n_chunks / 2 ? tile4[swz(q)] : make_uint4(0, 0, 0, 0);
      }
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
      if (tid == 0 && unit == 0) run[0].x ^= 0xFFFFFFFFu;
      uint32_t op[7];
      load_op(op, tabs, lane);  // M_4
      uint32_t r = 0;
#pragma unroll
      for (int i = 0; i < kRun / 16; i++) {
        r = apply(op, r ^ run[i].x);
        r = apply(op, r ^ run[i].y);
        r = apply(op, r ^ run[i].z);
        r = apply(op, r ^ run[i].w);
      }
#pragma unroll
      for (int k = 0; k < 5; k++) r = join(tabs + kFive * (1 + k), lane, k, r);
      if (lane == 0) wsum[warp] = r;
    }
    __syncthreads();
    if (warp != 0) return;
    uint32_t u = lane < kCrcWarps ? wsum[lane] : 0u;
#pragma unroll
    for (int k = 5; k < kLevels; k++) u = join(tabs + kFive * (1 + k), lane, k - 5, u);
    if (lane != 0) return;
    // The unit's share of the row's register: to the live units' end, then
    // back past the zeros after declen.
    if (unit < last) u = lookup8(tabs + kStaged, u);
    if (lo) u = lookup8(tabs + kStaged + kOp, u);
    if (hi) u = lookup8(tabs + kStaged + 2 * kOp, u);
    if (last > 0) {
      // The row's state: the XOR of its units' shares, and bit 32 + u for
      // each unit in. The unit that completes the bits has the register.
      const unsigned long long mine = (1ull << (32 + unit)) | u;
      const unsigned long long full = ((1ull << (last + 1)) - 1) << 32;
      const unsigned long long now = atomicXor(crc_state + b, mine) ^ mine;
      if ((now & ~0xFFFFFFFFull) != full) return;
      crc_state[b] = 0;  // for the next launch on this stream
      u = static_cast<uint32_t>(now);
    }
    const uint32_t crc = u ^ 0xFFFFFFFFu;
    crc_out[b] = static_cast<int64_t>(((crc >> 15) | (crc << 17)) + kEmptyCrc);
  }
}

// K11 (stpu_cuda_flat_grouped): a CTA a (unit, row) of a 2-D grid.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
grouped_kernel(const uint8_t* __restrict__ srcs, int s_width, const uint16_t* __restrict__ idx,
               const int32_t* __restrict__ tile_meta, const int32_t* __restrict__ gbuck,
               const int32_t* __restrict__ declens, int d_pad, int variant, int w0, int w1,
               int w2, uint8_t* __restrict__ out) {
  flat_unit<1, false>(srcs, s_width, idx, tile_meta, gbuck, declens, d_pad, variant, w0, w1, w2,
                      out, nullptr, nullptr, nullptr, blockIdx.x, blockIdx.y);
}

// Several launch groups of one layout in one launch (K2, with or without the
// checksum; never K11's buckets). Group k runs CTAs [first[k], first[k + 1])
// of a 1-D grid, a CTA a (row, unit) of its own rows and width with the unit
// fastest, as a 2-D grid orders them; no CTA lies past a row's d_pad. A CTA
// finds its group by comparing its index with first[1..], then runs the
// body (flat_unit) on its (row, unit). The groups' rows take consecutive words of state
// from state_row[k]. Entries past the last group hold first = the grid.
constexpr int kMaxGroups = 16;  // ops/decode_flat.py MAX_LAUNCH_GROUPS

struct Groups {
  FlatGroup g[kMaxGroups];
  int first[kMaxGroups + 1];
  int units[kMaxGroups];
  int state_row[kMaxGroups];
};

template <int kLayout, bool kCrc>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
flat_groups_kernel(const __grid_constant__ Groups l, const uint32_t* __restrict__ crc_tabs,
                   unsigned long long* __restrict__ crc_state) {
  const int cta = blockIdx.x;
  int k = 0;
#pragma unroll
  for (int i = 1; i < kMaxGroups; i++) k += cta >= l.first[i];
  const FlatGroup& g = l.g[k];
  const int units = l.units[k];
  const int local = cta - l.first[k];
  const int row = local / units;
  flat_unit<kLayout, kCrc>(g.srcs, static_cast<int>(g.s_width), g.idx, g.tile_meta, nullptr,
                           g.declens, static_cast<int>(g.d_pad), 0, 0, 0, 0, g.out, crc_tabs,
                           g.crc, kCrc ? crc_state + l.state_row[k] : nullptr, local - row * units,
                           row);
}

}  // namespace

// K2 over groups[0, n) in one launch, 1 <= n <= kMaxGroups, every group of
// one layout and at least one row and unit: each group's out (and, with
// crc_tabs, the checksum instance, its crc) as a launch of that group alone
// would write them. With the checksum a group's d_pad is at most 8 units
// and state holds the groups' rows' zeroed words, which are left zeroed:
// the rows' units meet there.
extern "C" int stpu_cuda_flat_gather_groups(const FlatGroup* groups, int n, int layout,
                                            const uint32_t* crc_tabs,
                                            unsigned long long* state, void* stream) {
  if (n < 1 || n > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  Groups l{};
  long long ctas = 0, rows = 0;
  for (int k = 0; k < n; k++) {
    const FlatGroup& g = groups[k];
    const long long units = (g.d_pad + kUnit - 1) / kUnit;
    if (g.rows < 1 || units < 1 || (crc_tabs != nullptr && units > kMaxUnits))
      return static_cast<int>(cudaErrorInvalidValue);
    l.g[k] = g;
    l.first[k] = static_cast<int>(ctas);
    l.units[k] = static_cast<int>(units);
    l.state_row[k] = static_cast<int>(rows);
    ctas += units * g.rows;
    rows += g.rows;
    if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = n; k <= kMaxGroups; k++) l.first[k] = static_cast<int>(ctas);
  const auto kernel = crc_tabs != nullptr ? (layout ? flat_groups_kernel<1, true>
                                                    : flat_groups_kernel<0, true>)
                                          : (layout ? flat_groups_kernel<1, false>
                                                    : flat_groups_kernel<0, false>);
  kernel<<<static_cast<unsigned>(ctas), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      l, crc_tabs, state);
  return static_cast<int>(cudaGetLastError());
}

// K2 on one group: stpu_cuda_flat_gather_groups with one entry.
extern "C" int stpu_cuda_flat_gather(const uint8_t* srcs, int64_t n_rows, int64_t s_width,
                                     const uint16_t* idx, const int32_t* tile_meta,
                                     const int32_t* declens, int64_t d_pad, int layout,
                                     uint8_t* out, void* stream) {
  const FlatGroup g{srcs, idx, tile_meta, declens, out, nullptr, n_rows, s_width, d_pad};
  return stpu_cuda_flat_gather_groups(&g, 1, layout, nullptr, nullptr, stream);
}

// K2 with the frame checksum on one group: crc[b] is the masked CRC32C of
// out[b, :declen] (declen clamped to [0, d_pad]).
extern "C" int stpu_cuda_flat_gather_crc(const uint8_t* srcs, int64_t n_rows, int64_t s_width,
                                         const uint16_t* idx, const int32_t* tile_meta,
                                         const int32_t* declens, int64_t d_pad, int layout,
                                         const uint32_t* crc_tabs, uint8_t* out, int64_t* crc,
                                         unsigned long long* state, void* stream) {
  const FlatGroup g{srcs, idx, tile_meta, declens, out, crc, n_rows, s_width, d_pad};
  return stpu_cuda_flat_gather_groups(&g, 1, layout, crc_tabs, state, stream);
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
