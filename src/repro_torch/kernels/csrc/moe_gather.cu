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
// token t. The TPU has no kernel for it. Here it is a sum without atomics:
// the wrapper hands over the kept slots sorted by token (stable, so each
// token's slots stay in increasing order) and each token's range in that
// list; one warp owns one token row and adds its slots' rows of g in that
// order, in float32, and rounds once. So the result is the same bits on
// every run and equals the plain version (ref.moe_gather_bwd_ref), which
// adds in the same order, bit for bit. Bound by bytes: each kept slot's
// row of g read once, dx written once.
#include <cuda_bf16.h>

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

// One warp per token row t: dx[t] = sum over k in [offsets[t],
// offsets[t + 1]) of g[order[k]], in that order, in float32. Lanes walk
// the row in groups of V elements (one 16-byte word, or one element).
template <typename E, int V>
__global__ void __launch_bounds__(kWarps * 32)
    moe_gather_bwd_rows(const E* __restrict__ g,
                        const int32_t* __restrict__ order,
                        const int32_t* __restrict__ offsets,
                        E* __restrict__ dx, int64_t T, int64_t d) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (t >= T) return;
  const int lane = threadIdx.x & 31;
  const int k0 = offsets[t], k1 = offsets[t + 1];
  E* dst = dx + t * d;
  for (int64_t j = static_cast<int64_t>(lane) * V; j < d; j += 32 * V) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int k = k0; k < k1; ++k) {
      const E* src = g + static_cast<int64_t>(order[k]) * d + j;
      if constexpr (V == 1) {
        acc[0] += to_f32(src[0]);
      } else {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(src));
        const E* e = reinterpret_cast<const E*>(&w);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += to_f32(e[i]);
      }
    }
    if constexpr (V == 1) {
      dst[j] = from_f32<E>(acc[0]);
    } else {
      uint4 w;
      E* e = reinterpret_cast<E*>(&w);
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = from_f32<E>(acc[i]);
      *reinterpret_cast<uint4*>(dst + j) = w;
    }
  }
}

template <typename E>
void launch_bwd(const void* g, const int32_t* order, const int32_t* offsets,
                void* dx, int64_t T, int64_t d, bool vec,
                cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((T + kWarps - 1) / kWarps);
  const auto* gp = static_cast<const E*>(g);
  auto* out = static_cast<E*>(dx);
  constexpr int kV = 16 / static_cast<int>(sizeof(E));
  if (vec) {
    moe_gather_bwd_rows<E, kV>
        <<<blocks, kWarps * 32, 0, stream>>>(gp, order, offsets, out, T, d);
  } else {
    moe_gather_bwd_rows<E, 1>
        <<<blocks, kWarps * 32, 0, stream>>>(gp, order, offsets, out, T, d);
  }
}

// g: (S, d) contiguous; order: the kept slots' ids sorted by token, stable;
// offsets: (T + 1,) int32, token t's slots at order[offsets[t] ..
// offsets[t + 1]); dx: (T, d) contiguous, elements of elem_size bytes (2:
// bf16, 4: float32). T > 0.
int gather_bwd(int device, const void* g, const void* order,
               const void* offsets, void* dx, int64_t T, int64_t d,
               int elem_size, void* stream) {
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  if (T <= 0 || d <= 0 || (elem_size != 2 && elem_size != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dx) % 16 == 0 &&
                   (d * elem_size) % 16 == 0;
  const auto* ord = static_cast<const int32_t*>(order);
  const auto* off = static_cast<const int32_t*>(offsets);
  auto st = static_cast<cudaStream_t>(stream);
  if (elem_size == 2) {
    launch_bwd<__nv_bfloat16>(g, ord, off, dx, T, d, vec, st);
  } else {
    launch_bwd<float>(g, ord, off, dx, T, d, vec, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward's arguments as one block of n = 9 int64: device, g, order,
// offsets, dx, T, d, elem_size, stream.
extern "C" int repro_moe_gather_bwd(const int64_t* a, int n) {
  if (n != 9) return static_cast<int>(cudaErrorInvalidValue);
  auto p = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  return gather_bwd(static_cast<int>(a[0]), p(1), p(2), p(3), p(4), a[5],
                    a[6], static_cast<int>(a[7]), p(8));
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
