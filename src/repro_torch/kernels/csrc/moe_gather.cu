// MoE dispatch gather for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_dispatch.py:37
// (moe_gather, body _kernel). Same function: row i of the (S, d) dispatch
// buffer is x[token_ids[i]] when keep[i], else zeros. The token id of a
// kept slot is clamped to [0, T), as the reference's gather clamps; the id
// of an unkept slot (-1 on the model's path) is never read through, and x
// is not touched for it.
//
// On the TPU one grid step owns a block of slots and copies their rows one
// by one from HBM into its VMEM output tile. Here one warp owns one slot
// row, and its 32 lanes copy the row side by side, so neighbouring lanes
// touch neighbouring addresses. The work is a copy: no arithmetic, bound
// by device-memory bytes (each needed row of x read, each slot row
// written). So the kernel moves 16-byte words where x, the output and both
// row strides are 16-byte aligned, which is every row width the models use,
// and elements one at a time otherwise; an unkept row is zero-filled
// without reading x. The copy moves raw bits, so bf16 and float32 differ
// only in the element size, and the result equals the plain version bit for
// bit. A version that moved rows through shared memory by Hopper's 1-D bulk
// copies (cp.async.bulk, a ring of mbarrier-guarded row buffers a warp, a
// persistent grid) measured the same at the prefill shape on an H100
// (PERF.md): the time is the memory system's write path, not the copy's
// form. At the decode shape the device takes a few microseconds of the
// call; the rest is the host's launch path, which the wrapper keeps short
// (kernels/nvcc.py ``launch``). The C entry point takes the device index
// and returns a cudaError_t.
//
// The backward (repro_moe_gather_bwd) is the gradient the reference takes
// by autodiff of its dispatch, models/moe.py:117 (``.at[pos].set(xt[st])``)
// with respect to xt: dx[t] = the sum of g[s] over the kept slots s of
// token t. The TPU has no kernel for it. Here it is a fixed-fan-in
// gather-sum without atomics and without an inverse map: the caller hands
// over each token's slots, a (T, k) int64 map in increasing slot order with
// dropped slots at S or beyond (moe_apply's ``pos_tok``, which the forward
// already holds). One warp owns one token row: it reads the token's k slot
// ids once, skips those outside [0, S), and adds the kept slots' rows of g
// in map order, in float32, rounding once. So the result is the same bits
// on every run and equals the plain version (ref.moe_gather_bwd_ref), which
// adds in the same order, bit for bit; the wrapper makes one launch. Bound
// by bytes: each kept slot's row of g read once, the map read once, dx
// written once.
#include <cuda_bf16.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kWarps = 8;  // slots per block, one warp each

// Copy or zero one slot row per warp, in words of type W (uint4: 16 bytes;
// uint16_t / uint32_t: one bf16 / float32 element).
template <typename W>
__global__ void __launch_bounds__(kWarps * 32)
    moe_gather_rows(const char* __restrict__ x,
                    const int32_t* __restrict__ token_ids,
                    const uint8_t* __restrict__ keep, char* __restrict__ out,
                    int64_t S, int64_t T, int64_t row_words,
                    int64_t x_stride_bytes, int64_t out_stride_bytes) {
  const int64_t slot =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (slot >= S) return;
  const int lane = threadIdx.x & 31;
  W* dst = reinterpret_cast<W*>(out + slot * out_stride_bytes);
  if (!keep[slot]) {
    const W zero{};
    for (int64_t j = lane; j < row_words; j += 32) dst[j] = zero;
    return;
  }
  int64_t t = token_ids[slot];
  t = t < 0 ? 0 : (t >= T ? T - 1 : t);
  const W* src = reinterpret_cast<const W*>(x + t * x_stride_bytes);
#pragma unroll 4
  for (int64_t j = lane; j < row_words; j += 32) dst[j] = __ldg(src + j);
}

template <typename W>
void launch_rows(const void* x, const int32_t* token_ids,
                 const uint8_t* keep, void* out, int64_t S, int64_t T,
                 int64_t row_bytes, int64_t x_stride_bytes,
                 cudaStream_t stream) {
  const int64_t blocks = (S + kWarps - 1) / kWarps;
  moe_gather_rows<W><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                       stream>>>(
      static_cast<const char*>(x), token_ids, keep, static_cast<char*>(out),
      S, T, row_bytes / static_cast<int64_t>(sizeof(W)), x_stride_bytes,
      row_bytes);
}

// x: (T, d) rows x_row_stride elements apart, elements of elem_size bytes
// (2: bf16, 4: float32); token_ids: (S,) int32; keep: (S,) bool as bytes;
// out: (S, d) contiguous. S > 0 and T > 0.
int gather(int device, const void* x, const void* token_ids,
           const void* keep, void* out, int64_t S, int64_t T, int64_t d,
           int64_t x_row_stride, int elem_size, void* stream) {
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  if (S <= 0 || T <= 0 || (elem_size != 2 && elem_size != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t row_bytes = d * elem_size;
  const int64_t x_stride_bytes = x_row_stride * elem_size;
  const auto* ids = static_cast<const int32_t*>(token_ids);
  const auto* kp = static_cast<const uint8_t*>(keep);
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   row_bytes % 16 == 0 && x_stride_bytes % 16 == 0;
  if (vec) {
    launch_rows<uint4>(x, ids, kp, out, S, T, row_bytes, x_stride_bytes, st);
  } else if (elem_size == 2) {
    launch_rows<uint16_t>(x, ids, kp, out, S, T, row_bytes, x_stride_bytes,
                          st);
  } else {
    launch_rows<uint32_t>(x, ids, kp, out, S, T, row_bytes, x_stride_bytes,
                          st);
  }
  return static_cast<int>(cudaGetLastError());
}

// float32 <-> the element type E (float or __nv_bfloat16, rounded to
// nearest even as PyTorch's conversion rounds).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename E>
__device__ __forceinline__ E from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One warp per token row t: dx[t] = the sum of g[slots[t, i]] over i < k
// whose slot lies in [0, S), in increasing i, in float32. Lanes walk the
// row in groups of V elements (one 16-byte word, or one element); the loop
// over the row is warp-uniform, so the shuffles see every lane.
//   - k <= kFan (every model's top-k): the warp reads the token's slot ids
//     once, one a lane, each lane takes all k by shuffles, and for each
//     group issues the k loads before it adds any, so they are in flight
//     together;
//   - a wider map: the ids 32 at a time, one a lane, the kept ones walked
//     by their ballot, one load after another.
constexpr int kFan = 8;

// A group of V elements as one word: the element itself, or 16 bytes.
template <typename E, int V>
using Word = typename std::conditional<V == 1, E, uint4>::type;

template <typename E, int V>
__device__ __forceinline__ void add_bits(float (&acc)[V],
                                         const Word<E, V>& w) {
  const E* e = reinterpret_cast<const E*>(&w);
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] += to_f32(e[i]);
}

template <typename E, int V>
__device__ __forceinline__ void add_word(float (&acc)[V], const E* src) {
  add_bits<E, V>(acc, __ldg(reinterpret_cast<const Word<E, V>*>(src)));
}

template <typename E, int V>
__device__ __forceinline__ void store_word(E* dst, const float (&acc)[V]) {
  if constexpr (V == 1) {
    dst[0] = from_f32<E>(acc[0]);
  } else {
    uint4 w;
    E* e = reinterpret_cast<E*>(&w);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f32<E>(acc[i]);
    *reinterpret_cast<uint4*>(dst) = w;
  }
}

template <typename E, int V>
__global__ void __launch_bounds__(kWarps * 32)
    moe_gather_bwd_rows(const E* __restrict__ g,
                        const int64_t* __restrict__ slots, int k, int64_t S,
                        E* __restrict__ dx, int64_t T, int64_t d) {
  using W = Word<E, V>;
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= T) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const int64_t* row = slots + t * k;
  E* dst = dx + t * d;
  if (k <= kFan) {
    const int64_t mine = lane < k ? __ldg(row + lane) : -1;
    int64_t s[kFan];
#pragma unroll
    for (int i = 0; i < kFan; ++i) {
      s[i] = __shfl_sync(0xffffffffu, mine, i);
      if (!(s[i] >= 0 && s[i] < S)) s[i] = -1;  // lanes >= k hold -1
    }
    for (int64_t j = static_cast<int64_t>(lane) * V; j < d; j += 32 * V) {
      W w[kFan];
#pragma unroll
      for (int i = 0; i < kFan; ++i)
        if (s[i] >= 0)
          w[i] = __ldg(reinterpret_cast<const W*>(g + s[i] * d + j));
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < kFan; ++i)
        if (s[i] >= 0) add_bits<E, V>(acc, w[i]);
      store_word<E, V>(dst + j, acc);
    }
    return;
  }
  auto ids = [&](int i0, int64_t& mine) {  // slot ids i0 .. i0 + 31
    mine = i0 + lane < k ? __ldg(row + i0 + lane) : -1;
    return __ballot_sync(0xffffffffu, mine >= 0 && mine < S);
  };
  for (int64_t j0 = 0; j0 < d; j0 += 32 * V) {
    const int64_t j = j0 + static_cast<int64_t>(lane) * V;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int i0 = 0; i0 < k; i0 += 32) {
      int64_t mine;
      for (unsigned kept = ids(i0, mine); kept; kept &= kept - 1) {
        const int64_t s = __shfl_sync(0xffffffffu, mine, __ffs(kept) - 1);
        if (j < d) add_word<E, V>(acc, g + s * d + j);
      }
    }
    if (j < d) store_word<E, V>(dst + j, acc);
  }
}

template <typename E>
void launch_bwd(const void* g, const int64_t* slots, int k, int64_t S,
                void* dx, int64_t T, int64_t d, bool vec,
                cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((T + kWarps - 1) / kWarps);
  const auto* gp = static_cast<const E*>(g);
  auto* out = static_cast<E*>(dx);
  constexpr int kV = 16 / static_cast<int>(sizeof(E));
  if (vec) {
    moe_gather_bwd_rows<E, kV><<<blocks, kWarps * 32, 0, stream>>>(
        gp, slots, k, S, out, T, d);
  } else {
    moe_gather_bwd_rows<E, 1><<<blocks, kWarps * 32, 0, stream>>>(
        gp, slots, k, S, out, T, d);
  }
}

// g: (S, d) contiguous; slots: (T, k) int64 contiguous, token t's slots at
// row t in the order they are added, entries outside [0, S) skipped; dx:
// (T, d) contiguous, elements of elem_size bytes (2: bf16, 4: float32).
// T > 0, d > 0, k >= 0.
int gather_bwd(int device, const void* g, const void* slots, void* dx,
               int64_t T, int64_t k, int64_t S, int64_t d, int elem_size,
               void* stream) {
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  if (T <= 0 || d <= 0 || k < 0 || k > INT32_MAX - 32 ||
      (elem_size != 2 && elem_size != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                   (d * elem_size) % 16 == 0;
  const auto* sl = static_cast<const int64_t*>(slots);
  auto st = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  if (elem_size == 2) {
    launch_bwd<__nv_bfloat16>(g, sl, kk, S, dx, T, d, vec, st);
  } else {
    launch_bwd<float>(g, sl, kk, S, dx, T, d, vec, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward's arguments as one block of n = 10 int64: device, g,
// slots, dx, T, k, S, d, elem_size, stream.
extern "C" int repro_moe_gather_bwd(const int64_t* a, int n) {
  if (n != 10) return static_cast<int>(cudaErrorInvalidValue);
  auto p = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  return gather_bwd(static_cast<int>(a[0]), p(1), p(2), p(3), a[4], a[5],
                    a[6], a[7], static_cast<int>(a[8]), p(9));
}

// The wrapper's arguments as one block of n = 11 int64 (kernels/nvcc.py
// ``launch``: one ctypes argument instead of 11 conversions): device, x,
// token_ids, keep, out, S, T, d, x_row_stride, elem_size, stream.
extern "C" int repro_moe_gather(const int64_t* a, int n) {
  if (n != 11) return static_cast<int>(cudaErrorInvalidValue);
  auto p = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  return gather(static_cast<int>(a[0]), p(1), p(2), p(3), p(4), a[5], a[6],
                a[7], a[8], static_cast<int>(a[9]), p(10));
}
