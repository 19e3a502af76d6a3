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
// Float addition is not associative, so a float sum equals np.add.at's
// bytes only when each group's rows are added in row order from +0.0: no
// atomics and no tree. Integer sums and min / max are exact in any
// grouping, so only the float sums are chains. The passes:
//
// 1. sort: a stable least-significant-digit radix sort of the row ids by
//    group (a row outside [0, n) takes the key n and sorts last). Each
//    pass cuts the rows into C chunks, a warp each walking 32 rows at a
//    time in order: count_digits counts each digit's rows of its chunk,
//    a scan over the (digit, chunk) counts in three kernels (tile sums,
//    their scan, the tiles) gives every chunk's first slot for each
//    digit, and scatter_digits places each row at its digit's next slot.
//    Few groups take one pass; counts stay at most radix x C (the
//    wrapper's plan), so every pass has work for each SM at any n.
//    group_starts reads each group's first slot off the sorted keys.
// 2. gather: each float-sum column of inner width <= kGatherInner is
//    copied in group order, as float64, one contiguous lane per element
//    (16-byte stores), so that every chain reads contiguous memory.
// 3. pieces: a group of an integer sum or a min / max longer than kLong
//    rows is cut at kLong-row pieces of the sorted order; a block reduces
//    each piece's share of it, each thread a contiguous run, combined
//    left to right, so min / max keep numpy's rule (the first NaN wins,
//    else the last row at the extreme; a +-0.0 tie takes the later row):
//    in a left-to-right combine a row's position is the order itself.
// 4. finish: a thread per (column, group, element) writes the result: a
//    short group's chain or fold read directly (adjacent threads take
//    adjacent elements of a row, so wide rows read coalesced), a long
//    group's pieces combined in order; a long float chain of a gathered
//    lane is appended to the ring's list instead.
// 5. ring_sums: one block per long float chain (persistent over the
//    list): a producer thread streams the chain's contiguous values into
//    a ring of shared-memory stages by cp.async.bulk, completing on
//    mbarriers; one consumer thread adds them in order with __dadd_rn
//    from registers, read two at a time from shared memory. A stage whose
//    sum ends NaN is added again value by value with the host's NaN rule.
//
// What bounds it: the bytes (every value and group id read once, the
// accumulators written once) take well under a millisecond at TPC-H Q1's
// partitions of ~15 M rows; with Q1's few groups the float sums are a few
// dozen chains of millions of dependent adds, so the time is at least the
// largest group's rows x the latency of one DADD (the chain bound). The C
// entry points take the device index and return a cudaError_t.
#include "hopper.cuh"
#include "numpy_ops.cuh"

namespace {

using namespace hopper;

constexpr int kMaxCols = 32;       // accumulator columns of one launch
constexpr int kWarpsPerBlock = 8;  // sort passes: a warp per chunk
constexpr int kScanThreads = 1024;
constexpr int kScanTile = 4 * kScanThreads;  // counts of one scan block
constexpr int kThreads = 256;      // gather, pieces, finish
constexpr int kGatherInner = 8;    // float sums this narrow are gathered
constexpr int64_t kLong = 4096;    // rows past which a group is long
constexpr int kStage = 1024;       // float64 values of one ring stage
constexpr int kStages = 4;
constexpr int kRingThreads = 64;   // a producer warp and a consumer warp

enum Combiner : int { kSum = 0, kMin = 1, kMax = 2 };

struct Column {
  const void* in;  // (rows, inner) values of dtype `dtype`
  void* out;       // (n, inner) accumulators of dtype `acc`
  int64_t inner;
  int64_t first;   // the column's first thread of `finish`
  int64_t lane;    // its first gathered lane, or -1
  int64_t ofl;     // its first order-free lane (pieces), or -1
  int32_t dtype;
  int32_t acc;
  int32_t comb;
};

struct Columns {
  int ncols;
  uint64_t nan64;  // the host's default float64 NaN
  Column col[kMaxCols];
};

// One radix pass: pass 0 reads the keys from inv (row ids are positions),
// later passes the keys and row ids the previous pass wrote.
struct Pass {
  const int64_t* inv;
  const int64_t* keys_in;  // null in pass 0
  const int64_t* order_in;
  int64_t* keys_out;
  int64_t* order_out;
  int64_t rows, n, C, chunk;
  int shift, mask;
};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ int64_t pass_key(const Pass& p, int64_t i) {
  if (p.keys_in != nullptr) return p.keys_in[i];
  const int64_t g = p.inv[i];
  return g >= 0 && g < p.n ? g : p.n;
}

// counts[d * C + c]: the rows of digit d in chunk c (zeroed by the host).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    count_digits(const Pass p, int64_t* __restrict__ counts) {
  const int64_t c = blockIdx.x * static_cast<int64_t>(kWarpsPerBlock) +
                    (threadIdx.x >> 5);
  if (c >= p.C) return;
  const int lane = threadIdx.x & 31;
  const int64_t end = (c + 1) * p.chunk < p.rows ? (c + 1) * p.chunk : p.rows;
  for (int64_t base = c * p.chunk; base < end; base += 32) {
    const int64_t i = base + lane;
    const int64_t d = i < end ? (pass_key(p, i) >> p.shift) & p.mask : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d >= 0 && lane == __ffs(peers) - 1) {
      counts[d * p.C + c] += __popc(peers);
    }
    __syncwarp();
  }
}

// Row ids and keys placed at their digit's next slot; lanes of one digit
// ranked by lane, so chunks and rows keep their order within a digit.
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    scatter_digits(const Pass p, int64_t* __restrict__ cursor) {
  const int64_t c = blockIdx.x * static_cast<int64_t>(kWarpsPerBlock) +
                    (threadIdx.x >> 5);
  if (c >= p.C) return;
  const int lane = threadIdx.x & 31;
  const unsigned below = lanemask_lt();
  const int64_t end = (c + 1) * p.chunk < p.rows ? (c + 1) * p.chunk : p.rows;
  for (int64_t base = c * p.chunk; base < end; base += 32) {
    const int64_t i = base + lane;
    const int64_t key = i < end ? pass_key(p, i) : 0;
    const int64_t d = i < end ? (key >> p.shift) & p.mask : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, d);
    if (d >= 0) {
      const int64_t slot = cursor[d * p.C + c] + __popc(peers & below);
      p.order_out[slot] = p.order_in != nullptr ? p.order_in[i] : i;
      p.keys_out[slot] = key;
    }
    __syncwarp();
    if (d >= 0 && lane == __ffs(peers) - 1) {
      cursor[d * p.C + c] += __popc(peers);
    }
    __syncwarp();
  }
}

// The exclusive prefix of x over the block's kScanThreads threads, and
// the block's total in *total.
__device__ __forceinline__ int64_t block_exclusive_scan(int64_t x,
                                                      int64_t* total) {
  __shared__ int64_t warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
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
  *total = warp_sums[kScanThreads / 32 - 1];
  const int64_t before = warp ? warp_sums[warp - 1] : 0;
  __syncthreads();  // warp_sums is reused by the next call
  return before + incl - x;
}

// tile_sums[b]: the sum of counts[b * kScanTile, (b + 1) * kScanTile).
__global__ void __launch_bounds__(kScanThreads)
    scan_tiles(const int64_t* __restrict__ counts, int64_t total,
               int64_t* __restrict__ tile_sums) {
  const int64_t base = blockIdx.x * static_cast<int64_t>(kScanTile) +
                       threadIdx.x * 4;
  int64_t x = 0;
  for (int u = 0; u < 4; ++u) x += base + u < total ? counts[base + u] : 0;
  int64_t sum;
  block_exclusive_scan(x, &sum);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = sum;
}

// In-place exclusive scan of tile_sums[0, tiles), one block.
__global__ void __launch_bounds__(kScanThreads)
    scan_tile_sums(int64_t* __restrict__ tile_sums, int64_t tiles) {
  int64_t carry = 0;
  for (int64_t base = 0; base < tiles; base += kScanThreads) {
    const int64_t i = base + threadIdx.x;
    const int64_t x = i < tiles ? tile_sums[i] : 0;
    int64_t sum;
    const int64_t before = block_exclusive_scan(x, &sum);
    if (i < tiles) tile_sums[i] = carry + before;
    carry += sum;
  }
}

// In-place exclusive scan of counts, each tile from its scanned sum.
__global__ void __launch_bounds__(kScanThreads)
    scan_apply(int64_t* __restrict__ counts, int64_t total,
               const int64_t* __restrict__ tile_sums) {
  const int64_t base = blockIdx.x * static_cast<int64_t>(kScanTile) +
                       threadIdx.x * 4;
  int64_t v[4], x = 0;
  for (int u = 0; u < 4; ++u) {
    v[u] = base + u < total ? counts[base + u] : 0;
    x += v[u];
  }
  int64_t sum;
  int64_t at = tile_sums[blockIdx.x] + block_exclusive_scan(x, &sum);
  for (int u = 0; u < 4; ++u) {
    if (base + u < total) counts[base + u] = at;
    at += v[u];
  }
}

// starts[g], g in [0, n]: the first sorted slot whose key is >= g, so
// group g holds slots [starts[g], starts[g + 1]) and starts[n] ends the
// rows kept.
__global__ void __launch_bounds__(kThreads)
    group_starts(const int64_t* __restrict__ keys, int64_t rows, int64_t n,
                 int64_t* __restrict__ starts) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (i > rows) return;
  const int64_t prev = i == 0 ? -1 : keys[i - 1];
  const int64_t cur = i == rows ? n + 1 : keys[i];
  for (int64_t g = prev + 1; g <= cur && g <= n; ++g) starts[g] = i;
}

// Element i of a column of `size`-byte elements, zero-extended.
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

__device__ __forceinline__ uint64_t load_value(const Column& col,
                                               int64_t row, int64_t k) {
  const bool to_float = col.comb != kSum || npops::is_float(col.dtype);
  return widen(load_raw(col.in, row * col.inner + k,
                        npops::width_bits(col.dtype) / 8),
               col.dtype, to_float);
}

__device__ __forceinline__ uint64_t identity(int comb) {
  return comb == kSum ? 0ull
         : comb == kMax ? 0xfff0000000000000ull   // -inf
                        : 0x7ff0000000000000ull;  // +inf
}

// Two order-free partials, a of rows before b's: integers add (wrapping),
// min / max by numpy's rule, which over partials in row order picks the
// first NaN, else the last row at the extreme.
__device__ __forceinline__ uint64_t combine(int comb, uint64_t a,
                                            uint64_t b) {
  return comb == kMax ? npops::max_at(a, b)
         : comb == kMin ? npops::min_at(a, b)
                        : a + b;
}

__device__ __forceinline__ void store_acc(const Column& col, int64_t o,
                                          uint64_t acc) {
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

__host__ __device__ __forceinline__ bool float_sum(const Column& col) {
  return col.comb == kSum && npops::is_float(col.dtype);
}

// gathered[lane * stride + i]: the value of sorted slot i (row order[i])
// of each gathered lane, as float64; two slots a thread, one 16-byte
// store per lane.
__global__ void __launch_bounds__(kThreads)
    gather_lanes(const int64_t* __restrict__ order, int64_t rows,
                 int64_t stride, const __grid_constant__ Columns cols,
                 double* __restrict__ gathered) {
  const int64_t i = 2 * (blockIdx.x * static_cast<int64_t>(kThreads) +
                         threadIdx.x);
  if (i >= rows) return;
  const int64_t r0 = order[i], r1 = i + 1 < rows ? order[i + 1] : -1;
  for (int j = 0; j < cols.ncols; ++j) {
    const Column& col = cols.col[j];
    if (col.lane < 0) continue;
    for (int64_t k = 0; k < col.inner; ++k) {
      double2 x;
      x.x = npops::bits_f64(load_value(col, r0, k));
      x.y = r1 >= 0 ? npops::bits_f64(load_value(col, r1, k)) : 0.0;
      *reinterpret_cast<double2*>(gathered + (col.lane + k) * stride + i) =
          x;
    }
  }
}

// The column of gathered lane q (or of order-free lane q when `ofl`), and
// the element it carries.
__device__ __forceinline__ int column_of(const Columns& cols, int64_t q,
                                         bool ofl, int64_t* k) {
  for (int j = 0; j < cols.ncols; ++j) {
    const int64_t first = ofl ? cols.col[j].ofl : cols.col[j].lane;
    if (first >= 0 && q >= first && q < first + cols.col[j].inner) {
      *k = q - first;
      return j;
    }
  }
  return -1;
}

// The group holding sorted slot i < starts[n]: the last g with
// starts[g] <= i.
__device__ int64_t group_of(const int64_t* __restrict__ starts, int64_t n,
                            int64_t i) {
  int64_t lo = 0, hi = n;  // starts[lo] <= i < starts[hi]
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (starts[mid] <= i) lo = mid; else hi = mid;
  }
  return lo;
}

// The fold of slots [a, b) of one order-free lane by the block, each
// thread a contiguous run, combined left to right (a tree over adjacent
// runs); valid in thread 0.
__device__ uint64_t block_fold(const Column& col, int64_t k,
                               const int64_t* __restrict__ order, int64_t a,
                               int64_t b, uint64_t* red) {
  const int64_t per = (b - a + kThreads - 1) / kThreads;
  const int64_t s = a + threadIdx.x * per;
  const int64_t e = s + per < b ? s + per : b;
  uint64_t acc = identity(col.comb);
  for (int64_t i = s; i < e; ++i) {
    acc = combine(col.comb, acc, load_value(col, order[i], k));
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    if ((threadIdx.x & (2 * d - 1)) == 0) {
      red[threadIdx.x] = combine(col.comb, red[threadIdx.x],
                                 red[threadIdx.x + d]);
    }
    __syncthreads();
  }
  const uint64_t out = red[0];
  __syncthreads();
  return out;
}

// partials[(lane * pieces + p) * 2 + slot]: piece p's share of the long
// group holding its first slot (slot 0) and, when another, of the long
// group holding its last slot (slot 1); a piece holds at most these two.
__global__ void __launch_bounds__(kThreads)
    piece_partials(const int64_t* __restrict__ order,
                   const int64_t* __restrict__ starts, int64_t n,
                   int64_t pieces, const __grid_constant__ Columns cols,
                   uint64_t* __restrict__ partials) {
  __shared__ uint64_t red[kThreads];
  const int64_t p = blockIdx.x % pieces, q = blockIdx.x / pieces;
  const int64_t lo = p * kLong;
  const int64_t hi = lo + kLong < starts[n] ? lo + kLong : starts[n];
  if (lo >= hi) return;
  int64_t k;
  const int j = column_of(cols, q, true, &k);
  if (j < 0) return;
  const Column& col = cols.col[j];
  const int64_t g0 = group_of(starts, n, lo);
  const int64_t g1 = group_of(starts, n, hi - 1);
  uint64_t* out = partials + (q * pieces + p) * 2;
  if (starts[g0 + 1] - starts[g0] > kLong) {
    const int64_t e = starts[g0 + 1] < hi ? starts[g0 + 1] : hi;
    const uint64_t v = block_fold(col, k, order, lo, e, red);
    if (threadIdx.x == 0) out[0] = v;
  }
  if (g1 != g0 && starts[g1 + 1] - starts[g1] > kLong) {
    const uint64_t v = block_fold(col, k, order, starts[g1], hi, red);
    if (threadIdx.x == 0) out[1] = v;
  }
}

// acc + values [s, e) in order, in blocks of 16: a bare chain of rounded
// adds, redone value by value with the host's NaN rule only for a block
// that ends NaN (NaN + x stays NaN, so the first NaN decides, and a NaN
// accumulator keeps its bits).
template <bool GATHERED>
__device__ uint64_t direct_chain(const Column& col, int64_t k,
                                 const int64_t* __restrict__ order,
                                 const double* __restrict__ lane, int64_t s,
                                 int64_t e, uint64_t nan64) {
  uint64_t acc = 0;
  for (int64_t i = s; i < e && !npops::nan64(acc); i += 16) {
    double x[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      x[u] = i + u >= e ? 0.0
             : GATHERED ? lane[i + u]
                        : npops::bits_f64(load_value(col, order[i + u], k));
    }
    double a = npops::bits_f64(acc);
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (i + u < e) a = npops::dadd(a, x[u]);
    }
    const uint64_t bits = npops::f64_bits(a);
    if (!npops::nan64(bits)) {
      acc = bits;
      continue;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      if (i + u < e) acc = npops::add_at(acc, npops::f64_bits(x[u]), nan64);
    }
  }
  return acc;
}

// A thread per (column, group, element): a short group's result, a long
// order-free group's pieces combined in order, or a long gathered chain
// handed to ring_sums through ring_list (gathered lane * n + group).
__global__ void __launch_bounds__(kThreads)
    finish(const int64_t* __restrict__ order,
           const int64_t* __restrict__ starts, int64_t n, int64_t stride,
           const double* __restrict__ gathered,
           const uint64_t* __restrict__ partials, int64_t pieces,
           int64_t threads, const __grid_constant__ Columns cols,
           int64_t* __restrict__ ring_list,
           unsigned long long* __restrict__ ring_count) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (t >= threads) return;
  int j = 0;
  while (j + 1 < cols.ncols && cols.col[j + 1].first <= t) ++j;
  const Column& col = cols.col[j];
  const int64_t local = t - col.first;
  const int64_t g = local / col.inner, k = local % col.inner;
  const int64_t s = starts[g], e = starts[g + 1];
  uint64_t acc;
  if (float_sum(col)) {
    if (col.lane >= 0 && e - s > kLong) {
      ring_list[atomicAdd(ring_count, 1ull)] = (col.lane + k) * n + g;
      return;
    }
    acc = col.lane >= 0
              ? direct_chain<true>(col, k, order,
                                   gathered + (col.lane + k) * stride, s, e,
                                   cols.nan64)
              : direct_chain<false>(col, k, order, nullptr, s, e,
                                    cols.nan64);
  } else if (e - s > kLong) {
    acc = identity(col.comb);
    const int64_t q = col.ofl + k;
    for (int64_t p = s / kLong; p * kLong < e; ++p) {
      const int slot = p * kLong >= s ? 0 : 1;
      acc = combine(col.comb, acc, partials[(q * pieces + p) * 2 + slot]);
    }
  } else {
    acc = identity(col.comb);
    for (int64_t i = s; i < e; ++i) {
      acc = combine(col.comb, acc, load_value(col, order[i], k));
    }
  }
  store_acc(col, g * col.inner + k, acc);
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// acc + v[lo, hi) in order (one ring stage): a bare chain of rounded adds
// from registers, the values read from shared memory two at a time, the
// next 16 loaded while the last 16 are added, so no add waits on a load;
// the stage again value by value with the host's NaN rule only when the
// chain ends NaN.
__device__ __forceinline__ uint64_t stage_chain(uint64_t acc,
                                                const double* v, int lo,
                                                int hi, uint64_t nan64) {
  constexpr int kPairs = 8;
  if (npops::nan64(acc)) return acc;  // a NaN accumulator keeps its bits
  double a = npops::bits_f64(acc);
  int i = lo;
  if ((i & 1) && i < hi) a = npops::dadd(a, v[i++]);
  const double2* p = reinterpret_cast<const double2*>(v + i);
  const int pairs = (hi - i) >> 1;
  int k = 0;
  if (pairs >= kPairs) {
    double2 cur[kPairs];
#pragma unroll
    for (int u = 0; u < kPairs; ++u) cur[u] = p[u];
    for (k = kPairs; k + kPairs <= pairs; k += kPairs) {
      double2 nxt[kPairs];
#pragma unroll
      for (int u = 0; u < kPairs; ++u) nxt[u] = p[k + u];
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        a = npops::dadd(a, cur[u].x);
        a = npops::dadd(a, cur[u].y);
        cur[u] = nxt[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      a = npops::dadd(a, cur[u].x);
      a = npops::dadd(a, cur[u].y);
    }
  }
  for (; k < pairs; ++k) {
    const double2 x = p[k];
    a = npops::dadd(a, x.x);
    a = npops::dadd(a, x.y);
  }
  i += 2 * pairs;
  if (i < hi) a = npops::dadd(a, v[i]);
  const uint64_t bits = npops::f64_bits(a);
  if (!npops::nan64(bits)) return bits;
  for (i = lo; i < hi; ++i) {
    acc = npops::add_at(acc, npops::f64_bits(v[i]), nan64);
  }
  return acc;
}

// The long float chains of ring_list, a block each in turn: thread 0
// (the producer) keeps kStages stages of the chain's gathered lane in
// flight, 16-byte aligned (a chain starting or ending at an odd slot
// reads one value more, skipped); thread 32 (the consumer) adds them.
__global__ void __launch_bounds__(kRingThreads)
    ring_sums(const int64_t* __restrict__ starts, int64_t n, int64_t stride,
              const double* __restrict__ gathered,
              const int64_t* __restrict__ ring_list,
              const unsigned long long* __restrict__ ring_count,
              const __grid_constant__ Columns cols) {
  __shared__ __align__(128) double ring[kStages][kStage];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int64_t items = static_cast<int64_t>(*ring_count);
  if (threadIdx.x == 0) {  // producer
    uint32_t it = 0;
    for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
      const int64_t q = ring_list[item] / n, g = ring_list[item] % n;
      const int64_t a0 = starts[g] & ~1ll, a1 = (starts[g + 1] + 1) & ~1ll;
      const double* src = gathered + q * stride;
      for (int64_t c0 = a0; c0 < a1; c0 += kStage, ++it) {
        const int slot = it % kStages;
        mbar_wait(smem_addr(&empty[slot]), ((it / kStages) & 1) ^ 1);
        const int bytes =
            static_cast<int>((a1 - c0 < kStage ? a1 - c0 : kStage) * 8);
        mbar_expect_tx(smem_addr(&full[slot]), bytes);
        bulk_load(smem_addr(ring[slot]), src + c0, bytes,
                  smem_addr(&full[slot]));
      }
    }
  } else if (threadIdx.x == 32) {  // consumer
    uint32_t it = 0;
    for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
      const int64_t q = ring_list[item] / n, g = ring_list[item] % n;
      const int64_t s = starts[g], e = starts[g + 1];
      const int64_t a0 = s & ~1ll, a1 = (e + 1) & ~1ll;
      uint64_t acc = 0;
      for (int64_t c0 = a0; c0 < a1; c0 += kStage, ++it) {
        const int slot = it % kStages;
        mbar_wait(smem_addr(&full[slot]), (it / kStages) & 1);
        const int lo = static_cast<int>((s > c0 ? s : c0) - c0);
        const int hi = static_cast<int>((e < c0 + kStage ? e : c0 + kStage) -
                                        c0);
        acc = stage_chain(acc, ring[slot], lo, hi, cols.nan64);
        mbar_arrive(smem_addr(&empty[slot]));
      }
      int64_t k;
      const int j = column_of(cols, q, false, &k);
      static_cast<uint64_t*>(cols.col[j].out)[g * cols.col[j].inner + k] = acc;
    }
  }
}

constexpr int kProbeUnroll = 8;

// One thread adding x[1] to x[0] `steps` times, each add waiting on the
// last: the latency of one DADD (steps a multiple of kProbeUnroll).
__global__ void dadd_chain(const double* __restrict__ x, int64_t steps,
                           double* __restrict__ out) {
  double a = x[0];
  const double b = x[1];
  for (int64_t i = 0; i < steps; i += kProbeUnroll) {
#pragma unroll
    for (int u = 0; u < kProbeUnroll; ++u) a = __dadd_rn(a, b);
  }
  out[0] = a;
}

struct Plan {
  const int64_t* inv;
  int64_t rows, n;
  int passes, bits;
  int64_t C, chunk;
  int64_t* counts;     // (radix * C,)
  int64_t* tile_sums;  // (tiles,)
  int64_t* keys[2];    // (rows,) each; keys[1] null for one pass
  int64_t* order[2];
  int64_t* starts;     // (n + 1,)
  double* gathered;    // (lanes * stride,), or null
  int64_t stride;
  uint64_t* partials;  // (order-free lanes * pieces * 2,), or null
  int64_t pieces;
  int64_t* ring_list;  // (ring_cap,), or null
  unsigned long long* ring_count;
  int64_t ring_blocks;
  uint64_t nan64;
};

cudaError_t sort(const Plan& pl, cudaStream_t st) {
  const int64_t radix = int64_t{1} << pl.bits;
  const int64_t total = radix * pl.C;
  const int64_t tiles = (total + kScanTile - 1) / kScanTile;
  const unsigned sort_blocks =
      static_cast<unsigned>((pl.C + kWarpsPerBlock - 1) / kWarpsPerBlock);
  for (int pass = 0; pass < pl.passes; ++pass) {
    Pass p;
    p.inv = pl.inv;
    p.keys_in = pass ? pl.keys[(pass - 1) & 1] : nullptr;
    p.order_in = pass ? pl.order[(pass - 1) & 1] : nullptr;
    p.keys_out = pl.keys[pass & 1];
    p.order_out = pl.order[pass & 1];
    p.rows = pl.rows;
    p.n = pl.n;
    p.C = pl.C;
    p.chunk = pl.chunk;
    p.shift = pass * pl.bits;
    p.mask = static_cast<int>(radix - 1);
    cudaError_t err =
        cudaMemsetAsync(pl.counts, 0, sizeof(int64_t) * total, st);
    if (err != cudaSuccess) return err;
    count_digits<<<sort_blocks, kWarpsPerBlock * 32, 0, st>>>(p, pl.counts);
    scan_tiles<<<static_cast<unsigned>(tiles), kScanThreads, 0, st>>>(
        pl.counts, total, pl.tile_sums);
    scan_tile_sums<<<1, kScanThreads, 0, st>>>(pl.tile_sums, tiles);
    scan_apply<<<static_cast<unsigned>(tiles), kScanThreads, 0, st>>>(
        pl.counts, total, pl.tile_sums);
    scatter_digits<<<sort_blocks, kWarpsPerBlock * 32, 0, st>>>(p,
                                                                pl.counts);
  }
  group_starts<<<static_cast<unsigned>((pl.rows + kThreads) / kThreads),
                 kThreads, 0, st>>>(pl.keys[(pl.passes - 1) & 1], pl.rows,
                                    pl.n, pl.starts);
  return cudaGetLastError();
}

// Columns [first, first + cols.ncols) after the sort.
cudaError_t reduce_columns(const Plan& pl, Columns& cols, cudaStream_t st) {
  const int64_t* order = pl.order[(pl.passes - 1) & 1];
  int64_t threads = 0, of_lanes = 0;
  bool gathered = false;
  for (int j = 0; j < cols.ncols; ++j) {
    Column& col = cols.col[j];
    col.first = threads;
    threads += pl.n * col.inner;
    gathered |= col.lane >= 0;
    if (col.ofl >= 0) of_lanes += col.inner;
  }
  if (gathered) {
    const int64_t pairs = (pl.rows + 1) / 2;
    gather_lanes<<<static_cast<unsigned>((pairs + kThreads - 1) / kThreads),
                   kThreads, 0, st>>>(order, pl.rows, pl.stride, cols,
                                      pl.gathered);
  }
  if (of_lanes > 0) {
    // the blocks of order-free lanes outside this launch's columns return
    int64_t lanes_end = 0;
    for (int j = 0; j < cols.ncols; ++j) {
      if (cols.col[j].ofl >= 0) {
        const int64_t end = cols.col[j].ofl + cols.col[j].inner;
        lanes_end = end > lanes_end ? end : lanes_end;
      }
    }
    piece_partials<<<static_cast<unsigned>(lanes_end * pl.pieces), kThreads,
                     0, st>>>(order, pl.starts, pl.n, pl.pieces, cols,
                              pl.partials);
  }
  cudaError_t err = cudaMemsetAsync(pl.ring_count, 0,
                                    sizeof(unsigned long long), st);
  if (err != cudaSuccess) return err;
  finish<<<static_cast<unsigned>((threads + kThreads - 1) / kThreads),
           kThreads, 0, st>>>(order, pl.starts, pl.n, pl.stride, pl.gathered,
                              pl.partials, pl.pieces, threads, cols,
                              pl.ring_list, pl.ring_count);
  if (gathered) {
    ring_sums<<<static_cast<unsigned>(pl.ring_blocks), kRingThreads, 0,
                st>>>(pl.starts, pl.n, pl.stride, pl.gathered, pl.ring_list,
                      pl.ring_count, cols);
  }
  return cudaGetLastError();
}

int reduce(int device, Plan& pl, int ncols, const int64_t* a, void* stream) {
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  if (pl.rows <= 0 || pl.n <= 0 || pl.C <= 0 || pl.chunk <= 0 ||
      pl.C * pl.chunk < pl.rows || pl.passes < 1 || pl.bits < 1 ||
      pl.bits * pl.passes > 62 || (pl.n >> (pl.bits * pl.passes)) != 0 ||
      ncols <= 0 || pl.pieces != (pl.rows + kLong - 1) / kLong ||
      pl.stride % 2 != 0 || pl.stride < pl.rows ||
      ((int64_t{1} << pl.bits) * pl.C + kScanTile - 1) / kScanTile >
          int64_t{1} << 30 ||
      (pl.passes > 1 && (pl.keys[1] == nullptr || pl.order[1] == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = sort(pl, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int first = 0; first < ncols; first += kMaxCols) {
    Columns cols;
    cols.ncols = ncols - first < kMaxCols ? ncols - first : kMaxCols;
    cols.nan64 = pl.nan64;
    for (int j = 0; j < cols.ncols; ++j) {
      const int64_t* d = a + 8 * (first + j);
      Column& col = cols.col[j];
      col.in = reinterpret_cast<const void*>(d[0]);
      col.out = reinterpret_cast<void*>(d[1]);
      col.inner = d[2];
      col.dtype = static_cast<int32_t>(d[3]);
      col.acc = static_cast<int32_t>(d[4]);
      col.comb = static_cast<int32_t>(d[5]);
      col.lane = d[6];
      col.ofl = d[7];
      const bool chain = float_sum(col);
      if (col.inner <= 0 || (col.lane >= 0) != (chain &&
                                                 col.inner <= kGatherInner) ||
          (col.ofl >= 0) == chain || (col.lane >= 0 && !pl.gathered) ||
          (col.ofl >= 0 && !pl.partials)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    err = reduce_columns(pl, cols, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper's arguments as one block of int64 (kernels/nvcc.py
// ``launch``): device, inv, rows, n, passes, bits, C, chunk, counts,
// tile_sums, keys0, keys1, order0, order1, starts, gathered, stride,
// partials, pieces, ring_list, ring_count, ring_blocks, nan64, ncols, then
// 8 per column (in, out, inner, dtype, acc dtype, combiner, gathered lane
// or -1, order-free lane or -1), and the stream last.
extern "C" int repro_segment_reduce(const int64_t* a, int n) {
  constexpr int kHead = 24;
  if (n < kHead + 1) return static_cast<int>(cudaErrorInvalidValue);
  const int ncols = static_cast<int>(a[23]);
  if (n != kHead + 1 + 8 * ncols) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan pl;
  pl.inv = reinterpret_cast<const int64_t*>(a[1]);
  pl.rows = a[2];
  pl.n = a[3];
  pl.passes = static_cast<int>(a[4]);
  pl.bits = static_cast<int>(a[5]);
  pl.C = a[6];
  pl.chunk = a[7];
  pl.counts = reinterpret_cast<int64_t*>(a[8]);
  pl.tile_sums = reinterpret_cast<int64_t*>(a[9]);
  pl.keys[0] = reinterpret_cast<int64_t*>(a[10]);
  pl.keys[1] = reinterpret_cast<int64_t*>(a[11]);
  pl.order[0] = reinterpret_cast<int64_t*>(a[12]);
  pl.order[1] = reinterpret_cast<int64_t*>(a[13]);
  pl.starts = reinterpret_cast<int64_t*>(a[14]);
  pl.gathered = reinterpret_cast<double*>(a[15]);
  pl.stride = a[16];
  pl.partials = reinterpret_cast<uint64_t*>(a[17]);
  pl.pieces = a[18];
  pl.ring_list = reinterpret_cast<int64_t*>(a[19]);
  pl.ring_count = reinterpret_cast<unsigned long long*>(a[20]);
  pl.ring_blocks = a[21];
  pl.nan64 = static_cast<uint64_t>(a[22]);
  if (pl.ring_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  return reduce(static_cast<int>(a[0]), pl, ncols, a + kHead,
                reinterpret_cast<void*>(a[n - 1]));
}

// The DADD latency probe: device, x (2 float64: start, step), steps (a
// multiple of 8), out (1 float64), stream. One thread; time it by events.
extern "C" int repro_dadd_chain(const int64_t* a, int n) {
  if (n != 5 || a[2] <= 0 || a[2] % kProbeUnroll != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(static_cast<int>(a[0]));
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  dadd_chain<<<1, 1, 0, reinterpret_cast<cudaStream_t>(a[4])>>>(
      reinterpret_cast<const double*>(a[1]), a[2],
      reinterpret_cast<double*>(a[3]));
  return static_cast<int>(cudaGetLastError());
}
