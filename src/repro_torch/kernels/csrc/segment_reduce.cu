// The relational engine's pre-aggregation (K2) for NVIDIA Hopper
// (sm_90a), written by hand.
//
// Replaces the jitted segment reduction of src/repro/core/relops.py:562
// (device_segment_reducer -> _core, jax.jit at :637): every accumulator
// column of one partition scatter-reduced into its n group slots, `sum`
// (float64 for floats, int64 for bools, integers in their own width,
// wrapping), `min` / `max` in float64 from +-inf, byte-identical to
// numpy's np.add.at / np.minimum.at / np.maximum.at.
//
// Float addition is not associative, so a sum equals np.add.at's bytes
// only when each group's rows are added in row order from +0.0: no
// atomics (index_add_ / scatter_add order them by arrival) and no tree.
// Hence two passes:
//
// 1. a stable counting sort of row ids by group: the rows are cut into C
//    chunks, one warp each, walked 32 rows at a time in order. The warp
//    counts each group's rows in its chunk (count_chunks), one scan over
//    the (group, chunk) counts gives every chunk's first slot in each
//    group (scan_counts), and the warp walks its chunk again placing each
//    row at its group's next slot, lanes of one group ranked by lane
//    (scatter_rows). Inside a group, chunks and rows keep their order.
// 2. one warp per (column, group, inner element) walks its group's rows
//    in order and accumulates as numpy_ops.cuh says (reduce_groups): the
//    lanes load, every lane adds every row in row order.
//
// What bounds it: the bytes (every value and group id read once, the
// accumulators written once) take well under a millisecond at TPC-H Q1's
// partition of ~15 M rows; but with Q1's few groups, pass 2 is a few
// dozen warps each adding millions of dependent float64 values in order,
// so the chain of adds, not the memory, is the time. A row outside [0, n) is
// dropped, as the reference's scatter drops it. The C entry point takes
// the device index and returns a cudaError_t.
#include "hopper.cuh"
#include "numpy_ops.cuh"

namespace {

using namespace hopper;

constexpr int kMaxCols = 32;  // accumulator columns of one launch
constexpr int kWarpsPerBlock = 8;
constexpr int kScanThreads = 1024;
constexpr int kReduceThreads = 64;

enum Combiner : int { kSum = 0, kMin = 1, kMax = 2 };

struct Column {
  const void* in;   // (rows, inner) values of dtype `dtype`
  void* out;        // (n, inner) accumulators of dtype `acc`
  int64_t inner;
  int64_t first;    // the column's first warp of reduce_groups
  int32_t dtype;
  int32_t acc;
  int32_t comb;
};

struct Columns {
  int ncols;
  uint64_t nan64;  // the host's default float64 NaN
  Column col[kMaxCols];
};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// counts[g * C + c]: the rows of group g in chunk c (zeroed by the host).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    count_chunks(const int64_t* __restrict__ inv, int64_t rows, int64_t n,
                 int64_t C, int64_t chunk, int64_t* __restrict__ counts) {
  const int64_t c = blockIdx.x * static_cast<int64_t>(kWarpsPerBlock) +
                    (threadIdx.x >> 5);
  if (c >= C) return;
  const int lane = threadIdx.x & 31;
  const int64_t end = (c + 1) * chunk < rows ? (c + 1) * chunk : rows;
  for (int64_t base = c * chunk; base < end; base += 32) {
    const int64_t r = base + lane;
    int64_t g = r < end ? inv[r] : -1;
    if (g >= n) g = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    if (g >= 0 && lane == __ffs(peers) - 1) {
      counts[g * C + c] += __popc(peers);
    }
    __syncwarp();
  }
}

// In-place exclusive scan of counts[0, total), one block.
__global__ void __launch_bounds__(kScanThreads)
    scan_counts(int64_t* __restrict__ counts, int64_t total) {
  __shared__ int64_t warp_sums[kScanThreads / 32];
  __shared__ int64_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < total; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const int64_t v = i < total ? counts[i] : 0;
    int64_t x = v;  // inclusive scan within the warp
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int64_t w = warp_sums[lane];
      for (int d = 1; d < 32; d <<= 1) {
        const int64_t y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int64_t before = carry + (warp ? warp_sums[warp - 1] : 0);
    if (i < total) counts[i] = before + x - v;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
}

// order[slot]: the row ids grouped by group, in row order within each; on
// return cursor[g * C + c] is the end of chunk c's rows of group g, so
// cursor[g * C + C - 1] ends group g.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    scatter_rows(const int64_t* __restrict__ inv, int64_t rows, int64_t n,
                 int64_t C, int64_t chunk, int64_t* __restrict__ cursor,
                 int64_t* __restrict__ order) {
  const int64_t c = blockIdx.x * static_cast<int64_t>(kWarpsPerBlock) +
                    (threadIdx.x >> 5);
  if (c >= C) return;
  const int lane = threadIdx.x & 31;
  const unsigned below = lanemask_lt();
  const int64_t end = (c + 1) * chunk < rows ? (c + 1) * chunk : rows;
  for (int64_t base = c * chunk; base < end; base += 32) {
    const int64_t r = base + lane;
    int64_t g = r < end ? inv[r] : -1;
    if (g >= n) g = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    int64_t slot = 0;
    if (g >= 0) {
      slot = cursor[g * C + c] + __popc(peers & below);
      order[slot] = r;
    }
    __syncwarp();
    if (g >= 0 && lane == __ffs(peers) - 1) {
      cursor[g * C + c] += __popc(peers);
    }
    __syncwarp();
  }
}

// Element i of a column of `size`-byte elements, zero-extended: the load
// alone, so that nothing waits on it until the value is used.
__device__ __forceinline__ uint64_t load_raw(const void* p, int64_t i,
                                             int size) {
  switch (size) {
    case 1: return static_cast<const uint8_t*>(p)[i];
    case 2: return static_cast<const uint16_t*>(p)[i];
    case 4: return static_cast<const uint32_t*>(p)[i];
    default: return static_cast<const uint64_t*>(p)[i];
  }
}

// A loaded element of dtype dt as the accumulator takes it: float64 bits
// for a float sum and for min / max, the integer (sign-extended; wrapped
// when stored) for an integer or bool sum.
__device__ __forceinline__ uint64_t widen(uint64_t raw, int dt,
                                          bool to_float) {
  if (npops::is_signed(dt)) {
    const int s = 64 - npops::width_bits(dt);
    raw = static_cast<uint64_t>(static_cast<int64_t>(raw << s) >> s);
  }
  return to_float ? npops::to_f64_bits(raw, dt) : raw;
}

// acc combined with one value, numpy's way (numpy_ops.cuh).
template <int COMB, bool FLOAT_SUM>
__device__ __forceinline__ uint64_t step(uint64_t acc, uint64_t v,
                                         uint64_t nan64) {
  return COMB == kMax ? npops::max_at(acc, v)
         : COMB == kMin ? npops::min_at(acc, v)
         : FLOAT_SUM ? npops::add_at(acc, v, nan64)
                     : acc + v;
}

// acc combined with v[0, m) in order, value by value: the NaN rule's
// path, out of line so that the hot loop stays small.
template <int COMB, bool FLOAT_SUM>
__device__ __noinline__ uint64_t chain_by_value(uint64_t acc,
                                                const uint64_t* v, int m,
                                                uint64_t nan64) {
  for (int j = 0; j < m; ++j) acc = step<COMB, FLOAT_SUM>(acc, v[j], nan64);
  return acc;
}

// acc combined with v[0, m) in order. A float sum runs as a bare chain of
// rounded adds, and again value by value with the host's NaN rule only
// when the chain ends NaN (NaN + x stays NaN, so the first NaN decides).
template <int COMB, bool FLOAT_SUM>
__device__ __forceinline__ uint64_t chain(uint64_t acc, const uint64_t* v,
                                          int m, uint64_t nan64) {
  if (FLOAT_SUM) {
    if (npops::nan64(acc)) return acc;  // a NaN accumulator keeps its bits
    double a = npops::bits_f64(acc);
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (j < m) a = npops::dadd(a, npops::bits_f64(v[j]));
    }
    const uint64_t u = npops::f64_bits(a);
    return npops::nan64(u) ? chain_by_value<COMB, true>(acc, v, m, nan64)
                           : u;
  }
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    if (j < m) acc = step<COMB, FLOAT_SUM>(acc, v[j], nan64);
  }
  return acc;
}

// One group's rows [s, e) of one column element, in row order, by one
// warp, 256 rows a block (a lane every 32nd row): while the warp adds
// block t, the values of block t + 1 are in flight, read through row ids
// of block t + 1 that were loaded during block t - 1, so no load waits on
// another. Every lane takes the 32 values of each 32-row piece by
// shuffles and adds them in row order, so each lane holds the same
// accumulator. One thread alone would wait on each load in turn.
template <int COMB, bool FLOAT_SUM>
__device__ uint64_t walk(const Column& col, const int64_t* __restrict__ order,
                         int64_t s, int64_t e, int64_t k, uint64_t nan64,
                         int lane) {
  constexpr bool kToFloat = COMB != kSum || FLOAT_SUM;
  constexpr int kU = 8, kStep = 32 * kU;
  const int dt = col.dtype, size = npops::width_bits(dt) / 8;
  const int64_t inner = col.inner;
  uint64_t acc = COMB == kSum ? 0ull
                 : COMB == kMax ? 0xfff0000000000000ull   // -inf
                                : 0x7ff0000000000000ull;  // +inf
  int64_t ids[kU];     // row ids of the block after the one in flight
  uint64_t cur[kU], nxt[kU], v[32];
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int64_t i = s + u * 32 + lane, i2 = i + kStep;
    cur[u] = i < e ? load_raw(col.in, order[i] * inner + k, size) : 0;
    ids[u] = i2 < e ? order[i2] : 0;
  }
  for (int64_t base = s; base < e; base += kStep) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t i1 = base + kStep + u * 32 + lane, i2 = i1 + kStep;
      nxt[u] = i1 < e ? load_raw(col.in, ids[u] * inner + k, size) : 0;
      ids[u] = i2 < e ? order[i2] : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t left = e - base - u * 32;  // the same in every lane
      if (left <= 0) break;
      const uint64_t x = widen(cur[u], dt, kToFloat);
#pragma unroll
      for (int j = 0; j < 32; ++j) v[j] = __shfl_sync(0xffffffffu, x, j);
      acc = chain<COMB, FLOAT_SUM>(acc, v, left < 32 ? int(left) : 32,
                                   nan64);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
  }
  return acc;
}

__global__ void __launch_bounds__(kReduceThreads)
    reduce_groups(const int64_t* __restrict__ order,
                  const int64_t* __restrict__ cursor, int64_t C,
                  int64_t warps, Columns cols) {
  const int64_t t = (blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x) >> 5;  // this warp's (column, group, k)
  const int lane = threadIdx.x & 31;
  if (t >= warps) return;
  int j = 0;
  while (j + 1 < cols.ncols && cols.col[j + 1].first <= t) ++j;
  const Column& col = cols.col[j];
  const int64_t local = t - col.first;
  const int64_t g = local / col.inner, k = local % col.inner;
  const int64_t s = g == 0 ? 0 : cursor[(g - 1) * C + C - 1];
  const int64_t e = cursor[g * C + C - 1];
  const uint64_t acc =
      col.comb == kMax ? walk<kMax, false>(col, order, s, e, k, cols.nan64,
                                           lane)
      : col.comb == kMin ? walk<kMin, false>(col, order, s, e, k, cols.nan64,
                                             lane)
      : npops::is_float(col.dtype)
          ? walk<kSum, true>(col, order, s, e, k, cols.nan64, lane)
          : walk<kSum, false>(col, order, s, e, k, cols.nan64, lane);
  if (lane != 0) return;
  const int64_t o = g * col.inner + k;
  switch (npops::width_bits(col.acc)) {  // an integer sum wraps here
    case 8: static_cast<uint8_t*>(col.out)[o] = static_cast<uint8_t>(acc);
      break;
    case 16: static_cast<uint16_t*>(col.out)[o] = static_cast<uint16_t>(acc);
      break;
    case 32: static_cast<uint32_t*>(col.out)[o] = static_cast<uint32_t>(acc);
      break;
    default: static_cast<uint64_t*>(col.out)[o] = acc;
  }
}

// inv: (rows,) int64 group ids; n groups; C chunks of `chunk` rows;
// counts: (n * C,) int64 scratch; order: (rows,) int64 scratch; a[...]:
// per column (in, out, inner, dtype, acc, comb).
int reduce(int device, const int64_t* inv, int64_t rows, int64_t n,
           int64_t C, int64_t chunk, int64_t* counts, int64_t* order,
           uint64_t nan64, int ncols, const int64_t* a, void* stream) {
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  if (rows <= 0 || n <= 0 || C <= 0 || chunk <= 0 || C * chunk < rows ||
      ncols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int64_t) * n * C, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned sort_blocks =
      static_cast<unsigned>((C + kWarpsPerBlock - 1) / kWarpsPerBlock);
  count_chunks<<<sort_blocks, kWarpsPerBlock * 32, 0, st>>>(inv, rows, n, C,
                                                          chunk, counts);
  scan_counts<<<1, kScanThreads, 0, st>>>(counts, n * C);
  scatter_rows<<<sort_blocks, kWarpsPerBlock * 32, 0, st>>>(
      inv, rows, n, C, chunk, counts, order);
  for (int first = 0; first < ncols; first += kMaxCols) {
    Columns cols;
    cols.ncols = ncols - first < kMaxCols ? ncols - first : kMaxCols;
    cols.nan64 = nan64;
    int64_t warps = 0;
    for (int j = 0; j < cols.ncols; ++j) {
      const int64_t* d = a + 6 * (first + j);
      Column& col = cols.col[j];
      col.in = reinterpret_cast<const void*>(d[0]);
      col.out = reinterpret_cast<void*>(d[1]);
      col.inner = d[2];
      col.dtype = static_cast<int32_t>(d[3]);
      col.acc = static_cast<int32_t>(d[4]);
      col.comb = static_cast<int32_t>(d[5]);
      col.first = warps;
      if (col.inner <= 0) return static_cast<int>(cudaErrorInvalidValue);
      warps += n * col.inner;
    }
    const unsigned blocks = static_cast<unsigned>(
        (warps * 32 + kReduceThreads - 1) / kReduceThreads);
    reduce_groups<<<blocks, kReduceThreads, 0, st>>>(order, counts, C,
                                                     warps, cols);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper's arguments as one block of int64 (kernels/nvcc.py
// ``launch``): device, inv, rows, n, C, chunk, counts, order, nan64,
// ncols, then 6 per column (in, out, inner, dtype, acc dtype, combiner),
// and the stream last.
extern "C" int repro_segment_reduce(const int64_t* a, int n) {
  if (n < 11) return static_cast<int>(cudaErrorInvalidValue);
  const int ncols = static_cast<int>(a[9]);
  if (n != 11 + 6 * ncols) return static_cast<int>(cudaErrorInvalidValue);
  return reduce(static_cast<int>(a[0]), reinterpret_cast<const int64_t*>(a[1]),
                a[2], a[3], a[4], a[5], reinterpret_cast<int64_t*>(a[6]),
                reinterpret_cast<int64_t*>(a[7]),
                static_cast<uint64_t>(a[8]), ncols, a + 10,
                reinterpret_cast<void*>(a[n - 1]));
}
