// Flash attention forward for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:82
// (flash_attention_fwd, body _kernel). Same function: scale hd^-0.5,
// top-left causal mask q_idx >= k_idx with fully masked kv tiles skipped,
// GQA through kv_head = h / (H / K), ragged S and T masked in the kernel,
// float32 running max / denominator / accumulator, masked scores -1e30,
// denominator clamped at 1e-30, output in q's dtype.
//
// On the TPU the kv grid axis runs in order and carries the softmax state
// in VMEM scratch. Here blocks run in parallel and in no order, so one
// block owns one (b, h, q tile) and walks the kv tiles in a loop, keeping
// the state in registers. At the prefill shape the kernel is bound by
// tensor-core operations (see kernels/flash_attention.py), so the bf16
// path runs both products on mma.sync m16n8k16 (bf16 in, f32 accumulate)
// with ldmatrix fragments; the 16x64 score tile of each warp never leaves
// registers, and device memory sees Q, K, V and O once. cp.async keeps a
// tile load in flight behind each product (V(t) behind Q K(t)^T, K(t+1)
// behind P V(t)). The f32 path is a plain FMA kernel of the same
// algorithm (the check path, not the model's).
//
// Inputs are read in the JAX layout through strides (q (B,S,H,hd), k/v
// (B,T,K,hd), head dim contiguous, 16-byte aligned rows); nothing is
// transposed or padded in device memory. The C entry point returns
// cudaGetLastError() after the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t S, T, H, K;
  int64_t sqb, sqs, sqh, skb, sks, skh, svb, svs, svh, sob, sos, soh;
  int causal;
  float scale_log2;  // hd^-0.5 * log2(e): the softmax runs on exp2
};

// Rows of a tile of `tile` rows starting at `start` that lie below `len`.
__device__ __forceinline__ int rows_below(int64_t len, int start, int tile) {
  const int64_t left = len - start;
  return left < tile ? static_cast<int>(left) : tile;
}

// Number of kv tiles a q tile [q_start, q_start + rows) must visit.
__device__ __forceinline__ int kv_tiles(const Params& p, int q_start,
                                        int rows, int tile) {
  int n = static_cast<int>((p.T + tile - 1) / tile);
  if (p.causal) {
    const int q_last = q_start + rows_below(p.S, q_start, rows) - 1;
    n = min(n, q_last / tile + 1);
  }
  return n;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------------ bf16
constexpr int kBM = 64;  // q rows per block, 16 per warp
constexpr int kBN = 64;  // kv rows per tile

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16x8, f32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Start copying `rows` rows of HD bf16 from global (row stride `stride`)
// into shared memory (row stride LD) with cp.async, 16 bytes per thread
// and copy; rows at or past `valid` are zero-filled (no global read) so
// that masked positions stay finite. Completion: cp_async_wait_all().
template <int HD, int LD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int64_t stride, int rows,
                                                int valid) {
  constexpr int kChunks = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < valid;
    const __nv_bfloat16* from = ok ? src + r * stride + c * 8 : src;
    asm volatile(
        "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
            smem_addr(dst + r * LD + c * 8)),
        "l"(from), "r"(ok ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const Params p) {
  constexpr int LD = HD + 8;  // 16-byte row pad: conflict-free ldmatrix
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBM * LD;
  __nv_bfloat16* Vs = Ks + kBN * LD;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * kBM;  // long rows first
  const int64_t kvh = h / (p.H / p.K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;  // mma fragment row / column pair
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix, row

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.sqb + h * p.sqh + q_start * p.sqs;
  const __nv_bfloat16* kg =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.skb + kvh * p.skh;
  const __nv_bfloat16* vg =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.svb + kvh * p.svh;

  const int n_tiles = kv_tiles(p, q_start, kBM, kBN);
  load_tile_async<HD, LD>(Qs, qg, p.sqs, kBM, rows_below(p.S, q_start, kBM));
  load_tile_async<HD, LD>(Ks, kg, p.sks, kBN, rows_below(p.T, 0, kBN));

  float o[HD / 8][4] = {};
  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end
  const int row0 = q_start + warp * 16 + g;  // this thread's rows: row0, +8

  // Pipeline: V(t) loads while S = Q K(t)^T and the softmax run; K(t+1)
  // loads while O += P V(t) runs. One buffer each for K and V.
  for (int t = 0; t < n_tiles; ++t) {
    const int kv_start = t * kBN;
    cp_async_wait_all();
    __syncthreads();  // K(t) landed; every warp is done with V(t-1)
    load_tile_async<HD, LD>(Vs, vg + kv_start * p.svs, p.svs, kBN,
                            rows_below(p.T, kv_start, kBN));

    // S = Q K^T for this warp's 16 rows x 64 kv columns.
    float s[kBN / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_addr(Qs + (warp * 16 + lane % 16) * LD + kk * 16 +
                               (lane / 16) * 8));
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) {
        uint32_t bf[4];
        ldmatrix_x4(bf, smem_addr(Ks + (j * 16 + mr + (mi / 2) * 8) * LD +
                                  kk * 16 + (mi % 2) * 8));
        mma_bf16(s[2 * j], a, bf[0], bf[1]);
        mma_bf16(s[2 * j + 1], a, bf[2], bf[3]);
      }
    }

    // Scale, mask, online softmax (rows row0 and row0 + 8).
    const bool need_mask =
        kv_start + kBN > p.T || (p.causal && kv_start + kBN - 1 > q_start);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale_log2;
        if (need_mask) {
          const int kidx = kv_start + j * 8 + 2 * c + (e & 1);
          const int qidx = row0 + (e / 2) * 8;
          if (kidx >= p.T || (p.causal && kidx > qidx)) x = kNeg;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = exp2f(s[j][e] - m[e / 2]);
        s[j][e] = pv;
        l[e / 2] += pv;
      }
    }
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[d][e] *= corr[e / 2];
    }

    cp_async_wait_all();
    __syncthreads();  // V(t) landed; every warp is done with K(t)
    if (t + 1 < n_tiles)
      load_tile_async<HD, LD>(Ks, kg + (kv_start + kBN) * p.sks, p.sks, kBN,
                              rows_below(p.T, kv_start + kBN, kBN));

    // O += P V, with P rounded to bf16 (as the plain path casts the
    // softmax weights to v's dtype) straight from the score registers.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < HD / 16; ++d) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, smem_addr(Vs + (kk * 16 + mr + (mi % 2) * 8) *
                                                 LD +
                                        d * 16 + (mi / 2) * 8));
        mma_bf16(o[2 * d], a, bf[0], bf[1]);
        mma_bf16(o[2 * d + 1], a, bf[2], bf[3]);
      }
    }
  }

  __nv_bfloat16* og =
      static_cast<__nv_bfloat16*>(p.o) + b * p.sob + h * p.soh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qidx = row0 + i * 8;
    const float den = fmaxf(quad_sum(l[i]), 1e-30f);
    if (qidx < p.S) {
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        *reinterpret_cast<uint32_t*>(og + qidx * p.sos + d * 8 + 2 * c) =
            pack_bf16(o[d][2 * i] / den, o[d][2 * i + 1] / den);
      }
    }
  }
}

// ------------------------------------------------------------------- f32
constexpr int kBMF = 32;  // q rows per block; 4 threads per row
constexpr int kBNF = 32;  // kv rows per tile

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  constexpr int LDQ = HD + 1;  // odd row stride: conflict-free row reads
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kBMF * LDQ;
  float* Vs = Ks + kBNF * LDQ;
  float* Ps = Vs + kBNF * HD;  // [kBMF][kBNF + 1]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * kBMF;
  const int64_t kvh = h / (p.H / p.K);
  const int r = threadIdx.x / 4, j = threadIdx.x % 4;  // row, quarter

  const float* qg =
      static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* kg = static_cast<const float*>(p.k) + b * p.skb + kvh * p.skh;
  const float* vg = static_cast<const float*>(p.v) + b * p.svb + kvh * p.svh;

  for (int i = threadIdx.x; i < kBMF * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD;
    Qs[rr * LDQ + d] =
        q_start + rr < p.S ? qg[(q_start + rr) * p.sqs + d] : 0.f;
  }

  float o[HD / 4] = {};  // columns j, j + 4, j + 8, ...
  float m = kNeg, l = 0.f;
  const int qidx = q_start + r;

  const int n_tiles = kv_tiles(p, q_start, kBMF, kBNF);
  for (int t = 0; t < n_tiles; ++t) {
    const int kv_start = t * kBNF;
    __syncthreads();
    for (int i = threadIdx.x; i < kBNF * HD; i += kThreads) {
      const int rr = i / HD, d = i % HD;
      const bool ok = kv_start + rr < p.T;
      Ks[rr * LDQ + d] = ok ? kg[(kv_start + rr) * p.sks + d] : 0.f;
      Vs[rr * HD + d] = ok ? vg[(kv_start + rr) * p.svs + d] : 0.f;
    }
    __syncthreads();

    float s[8];
    float mx = kNeg;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = j * 8 + i;
      float acc = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) acc += Qs[r * LDQ + d] * Ks[col * LDQ + d];
      float x = acc * p.scale_log2;
      const int kidx = kv_start + col;
      if (kidx >= p.T || (p.causal && kidx > qidx)) x = kNeg;
      s[i] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m, quad_max(mx));
    const float corr = exp2f(m - m_new);
    m = m_new;
    l *= corr;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float pv = exp2f(s[i] - m);
      l += pv;
      Ps[r * (kBNF + 1) + j * 8 + i] = pv;
    }
    __syncwarp();  // a row's probabilities are read by its own quad only
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) o[i] *= corr;
    for (int cc = 0; cc < kBNF; ++cc) {
      const float pv = Ps[r * (kBNF + 1) + cc];
#pragma unroll
      for (int i = 0; i < HD / 4; ++i) o[i] += pv * Vs[cc * HD + j + 4 * i];
    }
  }

  const float den = fmaxf(quad_sum(l), 1e-30f);
  if (qidx < p.S) {
    float* og = static_cast<float*>(p.o) + b * p.sob + h * p.soh +
                qidx * p.sos;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) og[j + 4 * i] = o[i] / den;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int q_tile, size_t smem_bytes,
                   const Params& p, int64_t B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(p.H), static_cast<unsigned>(B),
                  static_cast<unsigned>((p.S + q_tile - 1) / q_tile));
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch(int dtype, const Params& p, int64_t B,
                     cudaStream_t stream) {
  if (dtype == 1) {
    const size_t smem = (kBM + 2 * kBN) * (HD + 8) * sizeof(__nv_bfloat16);
    return launch(flash_fwd_bf16<HD>, kBM, smem, p, B, stream);
  }
  const size_t smem =
      ((kBMF + kBNF) * (HD + 1) + kBNF * HD + kBMF * (kBNF + 1)) *
      sizeof(float);
  return launch(flash_fwd_f32<HD>, kBMF, smem, p, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim
// is contiguous. Returns a cudaError_t (0 on success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t S, int64_t T, int64_t H, int64_t K, int64_t hd, int64_t sqb,
    int64_t sqs, int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
    int64_t svb, int64_t svs, int64_t svh, int64_t sob, int64_t sos,
    int64_t soh, int dtype, int causal, float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || K <= 0 || H % K != 0 || S <= 0 ||
      T <= 0 || B <= 0 || B > 65535 || (S + 31) / 32 > 65535 ||
      S > INT32_MAX / 2 || T > INT32_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,   k,   v,   o,   S,   T,   H,   K,   sqb,
                 sqs, sqh, skb, sks, skh, svb, svs, svh, sob,
                 sos, soh, causal, scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(dispatch<16>(dtype, p, B, st));
    case 32: return static_cast<int>(dispatch<32>(dtype, p, B, st));
    case 64: return static_cast<int>(dispatch<64>(dtype, p, B, st));
    case 128: return static_cast<int>(dispatch<128>(dtype, p, B, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
