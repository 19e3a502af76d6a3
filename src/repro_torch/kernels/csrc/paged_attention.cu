// Paged decode attention for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py:65
// (paged_attention, body _kernel). Same function: one query token per
// sequence attends to a KV cache stored as fixed-size pages of a pool
// (P, page, K, hd), following the sequence's row of a block table of global
// page ids (-1 = hole). Scale hd^-0.5; position pos of page slot p is valid
// when pos < length[b] and table[b, p] >= 0; the G = H / K query heads of
// kv head kh (heads kh*G .. kh*G+G-1) share its pages; the softmax runs
// online in float32 and P V accumulates in float32; the output is cast to
// q's dtype. A row with no valid position (length 0, or holes only) gives
// what the reference gives there, where every score is -1e30 and the
// softmax is uniform: the mean of V over all max_pages * page gathered
// positions, each page read at max(id, 0).
//
// On the TPU one grid step (b, kh) walks the table in order and DMAs one
// page at a time into VMEM. Here one block owns one (b, kh, chunk of at
// most MAXG heads) and walks the pages in a loop; only the first
// ceil(length / page) table entries are visited and holes are skipped
// (both contribute exactly 0 to the softmax). A decode step reads each K/V
// byte once and does ~4 G flops per byte pair, so device-memory bytes bound
// it (see kernels/paged_attention.py). Per page:
//   A. the 4 warps split the page's tokens; each token's K row is read by
//      hd / VEC lanes with 16-byte loads, each lane dots its slice with
//      its slice of the G query rows (in registers), and the partial
//      products are summed with warp shuffles into a (G, page) score
//      tile in shared memory;
//   B. one warp per head folds the page into the running max and sum;
//   C. the warps split the tokens again and add p * V into per-lane
//      float32 accumulators (rescaled once per page).
// At the end the accumulators of the lanes and warps that shared a column
// slice are summed (shuffles, then shared memory, in a fixed order: no
// atomics) and divided by the sum. The C entry point returns
// cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t imax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int32_t* tables;
  const int32_t* lengths;
  void* out;
  int64_t B, H, K, G, hd, page, max_pages;
  int64_t sqb, sqh;  // q strides (elements); the head dim is contiguous
  int lanes;         // lanes per K/V row: hd / VEC, a power of two <= 32
  float scale;
};

// VEC elements of type T in 16 bytes, widened to float.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
  __device__ __forceinline__ static float to_float(float x) { return x; }
  __device__ __forceinline__ static float from_float(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* out) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  __device__ __forceinline__ static __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
};

// Floats of shared memory before the per-head softmax state: the
// (MAXG, page) score tile, reused at the end for the (kWarps, MAXG, hd)
// cross-warp sums.
template <int MAXG>
__host__ __device__ inline int64_t tile_floats(int64_t page, int64_t hd) {
  const int64_t scores = MAXG * page;
  const int64_t sums = kWarps * MAXG * hd;
  return scores > sums ? scores : sums;
}

template <typename T, int MAXG>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const Params p) {
  using V = Vec<T>;
  constexpr int VEC = V::N;
  extern __shared__ float smem[];
  const int64_t tile = tile_floats<MAXG>(p.page, p.hd);
  float* s_tile = smem;                 // (MAXG, page) scores, then probs
  float* s_m = smem + tile;             // (MAXG) running max
  float* s_l = s_m + MAXG;              // (MAXG) running sum
  float* s_corr = s_l + MAXG;           // (MAXG) this page's rescale

  const int64_t b = blockIdx.x;
  const int64_t kh = blockIdx.y;
  const int g0 = blockIdx.z * MAXG;     // first head of the group here
  const int ng = static_cast<int>(imin(MAXG, p.G - g0));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lanes = p.lanes;
  const int col = (lane & (lanes - 1)) * VEC;  // this lane's column slice
  const int row_in_warp = lane / lanes;        // token within a warp step
  const int rows_per_warp = 32 / lanes;
  const int rows_per_step = kWarps * rows_per_warp;

  // This lane's slice of the query rows, widened.
  float q[MAXG][VEC];
  const T* qb = static_cast<const T*>(p.q) + b * p.sqb;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    const T* qr = qb + (kh * p.G + g0 + (g < ng ? g : 0)) * p.sqh + col;
#pragma unroll
    for (int i = 0; i < VEC; ++i) q[g][i] = g < ng ? V::to_float(qr[i]) : 0.f;
  }
  float acc[MAXG][VEC];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[g][i] = 0.f;
  if (threadIdx.x < MAXG) {
    s_m[threadIdx.x] = kNeg;
    s_l[threadIdx.x] = 0.f;
  }

  const int64_t len = imax(p.lengths[b], 0);
  const int64_t n_pages = imin((len + p.page - 1) / p.page, p.max_pages);
  const int32_t* table = p.tables + b * p.max_pages;
  const int64_t row = p.K * p.hd;           // elements between tokens
  const int64_t page_elems = p.page * row;  // elements between pages
  const T* kbase = static_cast<const T*>(p.k_pages) + kh * p.hd + col;
  const T* vbase = static_cast<const T*>(p.v_pages) + kh * p.hd + col;
  __syncthreads();

  for (int64_t pg = 0; pg < n_pages; ++pg) {
    const int32_t id = table[pg];
    if (id < 0) continue;  // a hole: no valid position
    const int n = static_cast<int>(imin(p.page, len - pg * p.page));
    const T* kp = kbase + id * page_elems;
    const T* vp = vbase + id * page_elems;

    // A. scores of this page's n tokens. The loop bound is warp-uniform so
    // that every lane takes part in the shuffles.
    for (int base = warp * rows_per_warp; base < n; base += rows_per_step) {
      const int t = base + row_in_warp;
      float kv[VEC];
      if (t < n) {
        V::load(kp + t * row, kv);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kv[i] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) d = fmaf(q[g][i], kv[i], d);
        for (int off = lanes >> 1; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        if (g < ng && t < n && (lane & (lanes - 1)) == 0)
          s_tile[g * p.page + t] = d * p.scale;
      }
    }
    __syncthreads();

    // B. fold the page into each head's running max and sum.
    for (int g = warp; g < ng; g += kWarps) {
      float* s = s_tile + g * p.page;
      float mx = kNeg;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s[t]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = s_m[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float e = expf(s[t] - m_new);
        s[t] = e;
        sum += e;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        s_corr[g] = corr;
        s_m[g] = m_new;
        s_l[g] = s_l[g] * corr + sum;
      }
    }
    __syncthreads();

    // C. acc = acc * corr + p V over this page's tokens.
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      const float c = g < ng ? s_corr[g] : 0.f;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[g][i] *= c;
    }
    for (int t = warp * rows_per_warp + row_in_warp; t < n;
         t += rows_per_step) {
      float vv[VEC];
      V::load(vp + t * row, vv);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        const float w = g < ng ? s_tile[g * p.page + t] : 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[g][i] = fmaf(w, vv[i], acc[g][i]);
      }
    }
    __syncthreads();
  }

  // No valid position: the reference's softmax over all -1e30 scores is
  // uniform, so the row is the mean of V over every gathered position.
  const bool none_valid = s_l[0] == 0.f;  // a valid position adds >= 1
  if (none_valid) {
    for (int64_t pg = 0; pg < p.max_pages; ++pg) {
      const T* vp = vbase + imax(table[pg], 0) * page_elems;
      for (int t = warp * rows_per_warp + row_in_warp; t < p.page;
           t += rows_per_step) {
        float vv[VEC];
        V::load(vp + t * row, vv);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[g][i] += vv[i];
      }
    }
  }

  // Sum the accumulators of the lanes that share a column slice (shuffles
  // within a warp), then of the 4 warps (shared memory, in warp order).
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      for (int off = lanes; off < 32; off <<= 1)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
  float* s_sum = s_tile;  // (kWarps, MAXG, hd)
  if (lane < lanes) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        s_sum[(warp * MAXG + g) * p.hd + col + i] = acc[g][i];
  }
  __syncthreads();
  const float denom_none = static_cast<float>(p.max_pages * p.page);
  T* ob = static_cast<T*>(p.out) + (b * p.H + kh * p.G + g0) * p.hd;
  for (int e = threadIdx.x; e < ng * p.hd; e += kThreads) {
    const int g = e / static_cast<int>(p.hd);
    const int d = e - g * static_cast<int>(p.hd);
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_sum[(w * MAXG + g) * p.hd + d];
    const float denom = none_valid ? denom_none : fmaxf(s_l[g], 1e-30f);
    ob[e] = V::from_float(total / denom);
  }
}

template <typename T, int MAXG>
int launch(const Params& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(p.B), static_cast<unsigned>(p.K),
                  static_cast<unsigned>((p.G + MAXG - 1) / MAXG));
  const size_t bytes =
      (tile_floats<MAXG>(p.page, p.hd) + 3 * MAXG) * sizeof(float);
  paged_attention_kernel<T, MAXG><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, cudaStream_t stream) {
  if (p.G == 1) return launch<T, 1>(p, stream);
  if (p.G == 2) return launch<T, 2>(p, stream);
  if (p.G <= 4) return launch<T, 4>(p, stream);
  return launch<T, 8>(p, stream);  // G > 8 runs in chunks of 8 heads
}

}  // namespace

// The shared memory one launch needs, in bytes, for the wrapper's check
// against the 48 KB a block may take without opting in.
extern "C" int64_t repro_paged_attention_smem(int64_t G, int64_t page,
                                              int64_t hd) {
  const int64_t maxg = G == 1 ? 1 : G == 2 ? 2 : G <= 4 ? 4 : 8;
  const int64_t scores = maxg * page;
  const int64_t sums = kWarps * maxg * hd;
  return ((scores > sums ? scores : sums) + 3 * maxg) *
         static_cast<int64_t>(sizeof(float));
}

// q: (B, H, hd) with strides (sqb, sqh, 1); k_pages, v_pages: contiguous
// (P, page, K, hd), 16-byte aligned; tables: contiguous (B, max_pages)
// int32 global page ids, -1 = hole; lengths: (B,) int32; out: contiguous
// (B, H, hd). elem_size 2 (bf16) or 4 (float32); hd * elem_size a multiple
// of 16 with hd * elem_size / 16 a power of two <= 32. B, K >= 1.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, int64_t B, int64_t H,
    int64_t K, int64_t hd, int64_t page, int64_t max_pages, int64_t sqb,
    int64_t sqh, int elem_size, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.tables = static_cast<const int32_t*>(tables);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.out = out;
  p.B = B;
  p.H = H;
  p.K = K;
  p.G = H / K;
  p.hd = hd;
  p.page = page;
  p.max_pages = max_pages;
  p.sqb = sqb;
  p.sqh = sqh;
  p.lanes = static_cast<int>(hd * elem_size / 16);
  p.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  if (elem_size == 2) return dispatch<__nv_bfloat16>(p, st);
  return dispatch<float>(p, st);
}
