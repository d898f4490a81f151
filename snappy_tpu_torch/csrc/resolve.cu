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
//
// What bounds it: dependent loads. Each round of a tile reads one value per
// byte from shared memory or from the row's plane, and the rounds of a tile
// follow each other; K8 adds a binary search over the row's record starts
// per byte (about log2(records) dependent loads). The bytes it must move
// (records or the first-hop plane in, the resolved plane out) are small.
//
// Design: one CTA of 1024 threads per row, one thread per position of a
// 1024-byte tile, sweeping the tiles left to right as the TPU kernel does.
// Snappy pointers go strictly backward, so when tile t runs every position
// before it is final: a pointer into an earlier tile is resolved by one read
// of the row's plane in device memory. Pointers inside the tile jump Jacobi
// style (each round replaces a pointer by its target's value, so the hops
// covered double) over two 4 KiB buffers in shared memory, until
// __syncthreads_and says every position is >= FLAG, for at most max_rounds
// rounds (12: the TPU kernel's first round and 11 passes). Then the tile is
// stored, and a __syncthreads() makes the stores visible to the CTA's later
// reads of them; the plane is therefore read through plain loads, never the
// read-only path (no const __restrict__ on it). The TPU kernel's digit
// planes, one-hot routing matmuls, transposes and 128/256/512-row windows
// exist because Mosaic has no gather; here a gather is a load.
//
// Error rows: the scan records only the valid prefix of a corrupt row, so the
// positions past its last record extend that record; a row with no record
// (nops == 0, declen > 0) gets hop -1 everywhere, as the TPU kernel's empty
// one-hot row gives. A pointer below 0 or at or past its own position is
// never chased, and a tile over the round budget is stored as it stands, so
// such a row keeps values below FLAG and the caller flags it for fallback.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;
constexpr int32_t kFlag = 1 << 17;

// Resolves position d (thread threadIdx.x of the tile starting at t0) from
// its first hop v and stores it in the row's plane.
__device__ __forceinline__ void resolve_tile(int32_t v, int64_t d, int64_t t0,
                                             int32_t* plane, int32_t* buf,
                                             int max_rounds) {
  int32_t* cur = buf;
  int32_t* nxt = buf + kTile;
  cur[threadIdx.x] = v;
  int done = __syncthreads_and(v >= kFlag);
  for (int r = 0; !done && r < max_rounds; ++r) {
    if (v < kFlag && v >= 0 && v < d) v = v < t0 ? plane[v] : cur[v - t0];
    nxt[threadIdx.x] = v;
    done = __syncthreads_and(v >= kFlag);
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  plane[d] = v;
  __syncthreads();
}

__global__ void __launch_bounds__(kTile)
resolve_fh_kernel(const int32_t* __restrict__ startsx,
                  const int32_t* __restrict__ payload, int64_t cap,
                  const int32_t* __restrict__ declens, int64_t d_pad,
                  int max_rounds, int32_t* out) {
  __shared__ int32_t buf[2 * kTile];
  const int64_t b = blockIdx.x;
  const int64_t declen = declens[b];
  const int32_t* st = startsx + b * cap;
  const int32_t* pk = payload + b * cap;
  int32_t* plane = out + b * d_pad;
  for (int64_t t0 = 0; t0 < d_pad; t0 += kTile) {
    const int64_t d = t0 + threadIdx.x;
    if (t0 >= declen) {  // the same for every thread of the row
      plane[d] = kFlag;
      continue;
    }
    int32_t v = kFlag;
    if (d < declen) {
      // The covering record: the last one whose start is at or before d
      // (records past nops carry start = declen > d).
      int64_t lo = 0, hi = cap;
      while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (st[mid] <= d) lo = mid + 1; else hi = mid;
      }
      int32_t start = 0, pay = 0;  // no record: a copy of offset 1 at 0
      if (lo > 0) {
        start = st[lo - 1];
        pay = pk[lo - 1];
      }
      const int32_t w1 = pay & 0x1FFFF;
      const int32_t j = static_cast<int32_t>(d) - start;
      if (pay >> 17) {
        v = kFlag + w1 + j;
      } else {
        const int32_t off = max(w1, 1);
        v = start - off + (j < off ? j : j % off);
      }
    }
    resolve_tile(v, d, t0, plane, buf, max_rounds);
  }
}

__global__ void __launch_bounds__(kTile)
resolve_kernel(const int32_t* __restrict__ a0, int64_t d_pad, int max_rounds,
               int32_t* out) {
  __shared__ int32_t buf[2 * kTile];
  const int64_t b = blockIdx.x;
  const int32_t* row = a0 + b * d_pad;
  int32_t* plane = out + b * d_pad;
  for (int64_t t0 = 0; t0 < d_pad; t0 += kTile) {
    const int64_t d = t0 + threadIdx.x;
    resolve_tile(row[d], d, t0, plane, buf, max_rounds);
  }
}

}  // namespace

extern "C" int stpu_cuda_resolve_fh(const int32_t* startsx, const int32_t* payload,
                                    int64_t n_rows, int64_t cap,
                                    const int32_t* declens, int64_t d_pad,
                                    int max_rounds, int32_t* out, void* stream) {
  resolve_fh_kernel<<<static_cast<unsigned>(n_rows), kTile, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      startsx, payload, cap, declens, d_pad, max_rounds, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stpu_cuda_resolve(const int32_t* a0, int64_t n_rows, int64_t d_pad,
                                 int max_rounds, int32_t* out, void* stream) {
  resolve_kernel<<<static_cast<unsigned>(n_rows), kTile, 0,
                   static_cast<cudaStream_t>(stream)>>>(a0, d_pad, max_rounds, out);
  return static_cast<int>(cudaGetLastError());
}
