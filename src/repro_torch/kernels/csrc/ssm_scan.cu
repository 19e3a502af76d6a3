// Selective-SSM scan (the Mamba recurrence) for NVIDIA Hopper (sm_90a),
// written by hand.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py:43
// (ssm_scan, body _kernel). Same function, per batch row b and channel c,
// walking t = 0 .. L-1 from h = 0:
//
//   h[n] = exp(dt[b,t,c] * A[c,n]) * h[n] + (dt[b,t,c] * x[b,t,c]) * B[b,t,n]
//   y[b,t,c] = sum_n h[n] * C[b,t,n]
//
// in float32 throughout; the (di, N) state never leaves the chip.
//
// What bounds it on an H100 (data sheet): at jamba's prefill shape (Bt=1,
// L=4096, di=16384, N=16) it takes L*di*N = 1.07 G exponentials, 0.256 ms
// at the special-function units' 16 per clock per SM on 132 SMs; it reads
// dt and x and writes y, 805 MB, 0.240 ms at 3.35 TB/s. Both are near, so
// the kernel must keep the special-function units busy and spend few other
// instructions per (t, c, n), while streaming at the memory's rate.
//
// On the TPU one grid step owns a (256-channel, N) state block in VMEM and
// walks the sequence with a fori_loop. Here the channels are the
// parallelism: a block owns kCh = 32 channels of one batch row and walks
// the whole sequence.
//   - A producer warp loads chunks of kT = 32 steps of dt and x (32 x 32,
//     one box of a 3-d tensor map over (Bt, L, di)) and of B and C (32 x
//     16, maps over (Bt, L, N)) by TMA into a ring of kStages stages, each
//     guarded by a full and an empty mbarrier. TMA's out-of-bounds zero
//     fill pads ragged L, di and N < 16: a zero dt leaves h unchanged, a
//     zero A or B keeps a padded state at 0, and y is stored through a
//     tensor map that clips, so padded steps and channels store nothing.
//   - Consumer warps: LPC neighbouring lanes own one channel, each with
//     16 / LPC of its states and those entries of A in registers, A
//     pre-scaled by log2 e once, so each state step is one FMUL (dt A'),
//     one ex2.approx.ftz (MUFU.EX2), one FMUL (dt x B) and two FFMAs (the
//     decay into h, h C into the lane's part of y). dt and x are read from
//     shared memory, B_t and C_t as 16-byte broadcasts.
//   - y once per 16 steps: each lane keeps its part of y for 16 steps in
//     registers; the LPC parts are added by a reduce-scatter of log2(LPC)
//     shuffle rounds (lane q ends with the sums of steps 16/LPC * q ..),
//     written to a y tile in shared memory, and each chunk's tile leaves by
//     one TMA store (two tiles, so a store drains under the next chunk).
// One exponential per (t, c, n) is kept: a chunked two-pass scan over time
// would compute the decays twice. ref.ssm_scan_ex2_ref is this arithmetic
// in plain PyTorch (exp2 of dt * (A log2 e); the parts of y summed in this
// order). The C entry point takes the device index and the wrapper's plan,
// encodes the tensor maps from the strides and returns a cudaError_t.
//
// The backward (repro_ssm_scan_bwd) is the gradient the reference takes by
// autodiff of its chunked scan (models/ssm.py:84). Given g = dL/dy it runs
// the recurrence backwards in time per channel:
//
//   dh[n] = g_t C[t,n] + exp(dt_{t+1} A[n]) dh_{t+1}[n]
//   dB[t,n] += dh[n] dt_t x_t      dC[t,n] += g_t h_t[n]     (sums over c)
//   w[n] = dh[n] h_{t-1}[n] exp(dt_t A[n])
//   ddt_t = x_t sum_n dh[n] B[t,n] + sum_n w[n] A[n]
//   dx_t = dt_t sum_n dh[n] B[t,n]     dA[n] += w[n] dt_t     (sum over b, t)
//
// It needs h_{t-1} and h_t going backwards, with no (L, di, N) tape (1 GiB
// at jamba's shape). One warp owns 32 channels of one batch row, a lane a
// channel with its 16 states in registers. Pass 1 runs the forward and
// keeps h at every kBT-th step (a checkpoint, (Bt, L / kBT, N, di) in
// device memory); pass 2 walks the chunks of kBT steps from the last:
// from the chunk's checkpoint it recomputes the chunk's states into shared
// memory (each lane its own column), then steps back through them. The
// decay is the forward's: ex2 of dt * (A log2 e), the same instructions,
// so the recomputed states are the forward's bits. The sums over channels
// (dB, dC) take no atomics: each step the warp adds its 32 lanes' 2N
// values by a reduce-scatter (lane j ends with the sum of value j) and
// writes one row of per-warp partials; a second kernel adds the partials
// of every warp in warp order, and dA's per-batch-row parts in row order.
// So two runs give the same bits. What bounds it on an H100: the
// exponentials (three per (t, c, n): pass 1, the chunk's recompute and the
// backward step) against about 2.2 GB moved at jamba's shape (dt and x read
// twice, g once, ddt and dx written, the checkpoints and partials written
// and read). This first version is a plain one: 32 channels a warp,
// jamba's Bt = 1 gives 512 warps, ~4 an SM, so it is bound by the latency
// of each lane's chain of dependent steps.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kN = 16;        // states per channel held in registers
constexpr int kCh = 32;       // channels per block
constexpr int kT = 32;        // time steps per staged chunk
constexpr int kSub = 16;      // steps per unrolled run (y reduced after it)
constexpr int kStages = 3;    // chunks in the ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTileBytes = kT * kCh * 4;          // dt, x or y: 4 KB
constexpr int kBCBytes = kT * kN * 4;             // B or C: 2 KB
constexpr int kStageBytes = 2 * kTileBytes + 2 * kBCBytes;
// 128 bytes to align the TMA boxes, the ring, two y tiles, the mbarriers
constexpr int kSmem =
    128 + kStages * kStageBytes + 2 * kTileBytes + 16 * kStages;

template <int LPC>
struct Shape {
  static constexpr int kConsumerWarps = kCh * LPC / 32;
  static constexpr int kThreads = (kConsumerWarps + 1) * 32;
  static constexpr int kPer = kN / LPC;  // states per lane
};

// v[0 .. NV) of this lane and of lane ^ M -> v[0 .. NV/2): the sums of the
// upper half where q & M, else of the lower half; then the next round.
template <int M, int NV>
__device__ __forceinline__ void reduce_scatter(float (&v)[kSub], int q) {
  const bool up = (q & M) != 0;
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) {
    const float keep = up ? v[i + NV / 2] : v[i];
    const float send = up ? v[i] : v[i + NV / 2];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
  if constexpr (M > 1) reduce_scatter<M / 2, NV / 2>(v, q);
}

template <int LPC>
__global__ void __launch_bounds__(Shape<LPC>::kThreads, 4)
    ssm_scan_kernel(const __grid_constant__ CUtensorMap tm_dt,
                    const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_B,
                    const __grid_constant__ CUtensorMap tm_C,
                    const __grid_constant__ CUtensorMap tm_y,
                    const float* __restrict__ A, int64_t s_A, int di, int N,
                    int L) {
  using P = Shape<LPC>;
  constexpr int kPer = P::kPer, kCW = P::kConsumerWarps;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  unsigned char* const smem = smem_raw + (base - raw);  // generic view
  const uint32_t bars = base + kStages * kStageBytes + 2 * kTileBytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = blockIdx.x * kCh, b = blockIdx.y;
  const int n_chunks = (L + kT - 1) / kT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kCW);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kCW) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      prefetch_map(&tm_dt);
      prefetch_map(&tm_x);
      prefetch_map(&tm_B);
      prefetch_map(&tm_C);
      for (int k = 0; k < n_chunks; ++k) {
        const int s = k % kStages;
        mbar_wait(empty(s), ((k / kStages) & 1) ^ 1);  // round 0 passes
        const uint32_t st = base + s * kStageBytes;
        mbar_expect_tx(full(s), kStageBytes);
        tma_load_3d(st, &tm_dt, full(s), c0, k * kT, b);
        tma_load_3d(st + kTileBytes, &tm_x, full(s), c0, k * kT, b);
        tma_load_3d(st + 2 * kTileBytes, &tm_B, full(s), 0, k * kT, b);
        tma_load_3d(st + 2 * kTileBytes + kBCBytes, &tm_C, full(s), 0,
                    k * kT, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  const int ch = warp * (32 / LPC) + lane / LPC, q = lane % LPC;
  const int c = c0 + ch;
  float A2[kPer], h[kPer];  // states q * kPer .. q * kPer + kPer - 1
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = q * kPer + j;
    A2[j] = (c < di && n < N) ? A[c * s_A + n] * kLog2e : 0.f;
    h[j] = 0.f;
  }
  const float* const fsm = reinterpret_cast<const float*>(smem);
  float* const ysm = reinterpret_cast<float*>(smem + kStages * kStageBytes);

  for (int k = 0; k < n_chunks; ++k) {
    const int s = k % kStages;
    mbar_wait(full(s), (k / kStages) & 1);
    const float* dts = fsm + s * (kStageBytes / 4);
    const float* xs = dts + kT * kCh;
    const float* Bs = xs + kT * kCh;
    const float* Cs = Bs + kT * kN;
    float* ys = ysm + (k & 1) * (kT * kCh);
#pragma unroll 1
    for (int t0 = 0; t0 < kT; t0 += kSub) {
      float yp[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        const int t = t0 + i;
        const float dtv = dts[t * kCh + ch];
        const float dx = dtv * xs[t * kCh + ch];
        float Bn[kPer], Cn[kPer];
#pragma unroll
        for (int j = 0; j < kPer; j += 4) {
          const float4 bv =
              *reinterpret_cast<const float4*>(Bs + t * kN + q * kPer + j);
          const float4 cv =
              *reinterpret_cast<const float4*>(Cs + t * kN + q * kPer + j);
          Bn[j] = bv.x, Bn[j + 1] = bv.y, Bn[j + 2] = bv.z, Bn[j + 3] = bv.w;
          Cn[j] = cv.x, Cn[j + 1] = cv.y, Cn[j + 2] = cv.z, Cn[j + 3] = cv.w;
        }
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          h[j] = fmaf(ex2(dtv * A2[j]), h[j], dx * Bn[j]);
          acc = fmaf(h[j], Cn[j], acc);
        }
        yp[i] = acc;
      }
      reduce_scatter<LPC / 2, kSub>(yp, q);
#pragma unroll
      for (int i = 0; i < kSub / LPC; ++i)
        ys[(t0 + q * (kSub / LPC) + i) * kCh + ch] = yp[i];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with stage s
    fence_async_smem();                    // y tile -> the TMA store
    if (threadIdx.x == 0) bulk_wait_read<0>();  // chunk k-1's store read
    named_barrier(1, kCW * 32);
    if (threadIdx.x == 0) {
      tma_store_3d(&tm_y, smem_addr(ys), c0, k * kT, b);
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

template <int LPC>
cudaError_t launch(const CUtensorMap (&maps)[5], const float* A,
                   int64_t s_A, int64_t Bt, int64_t di, int64_t N,
                   int64_t L, cudaStream_t stream) {
  static int allowed = 48 * 1024;
  const cudaError_t err = allow_smem(ssm_scan_kernel<LPC>, kSmem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((di + kCh - 1) / kCh),
                  static_cast<unsigned>(Bt));
  ssm_scan_kernel<LPC><<<grid, Shape<LPC>::kThreads, kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], A, s_A,
      static_cast<int>(di), static_cast<int>(N), static_cast<int>(L));
  return cudaGetLastError();
}

// dt, x: (Bt, L, di); A: (di, N); B, C: (Bt, L, N); y: (Bt, L, di); all
// float32 with innermost stride 1, strides in elements (batch, time; row
// for A); dt, x, B, C, y 16-byte aligned with strides of whole 16 bytes
// (TMA), except a stride whose dimension has extent 1. Bt, L, di > 0 and
// 0 < N <= 16. lanes .. smem_bytes: the wrapper's plan (lanes per
// channel, channels per block, steps per chunk, stages, shared-memory
// bytes), refused unless it is an instance's.
int scan(int device, const void* dt, const void* A, const void* B,
         const void* C, const void* x, void* y, int64_t Bt, int64_t L,
         int64_t di, int64_t N, int64_t s_dt_b, int64_t s_dt_t,
         int64_t s_x_b, int64_t s_x_t, int64_t s_A, int64_t s_B_b,
         int64_t s_B_t, int64_t s_C_b, int64_t s_C_t, int64_t s_y_b,
         int64_t s_y_t, int lanes, int channels, int chunk, int stages,
         int smem_bytes, void* stream) {
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  if ((lanes != 2 && lanes != 4) || channels != kCh || chunk != kT ||
      stages != kStages || smem_bytes != kSmem || Bt <= 0 || Bt > 65535 ||
      L <= 0 || L > INT32_MAX - kT || di <= 0 || di > INT32_MAX - kCh ||
      N <= 0 || N > kN)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[5];
  if (!encode_f32_3d(&maps[0], dt, Bt, L, di, s_dt_b, s_dt_t, kCh, kT) ||
      !encode_f32_3d(&maps[1], x, Bt, L, di, s_x_b, s_x_t, kCh, kT) ||
      !encode_f32_3d(&maps[2], B, Bt, L, N, s_B_b, s_B_t, kN, kT) ||
      !encode_f32_3d(&maps[3], C, Bt, L, N, s_C_b, s_C_t, kN, kT) ||
      !encode_f32_3d(&maps[4], y, Bt, L, di, s_y_b, s_y_t, kCh, kT))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const float*>(A);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      lanes == 2 ? launch<2>(maps, a, s_A, Bt, di, N, L, st)
                 : launch<4>(maps, a, s_A, Bt, di, N, L, st);
  return static_cast<int>(err);
}

// ------------------------------------------------------------- backward

constexpr int kBT = 16;  // steps per backward chunk: the checkpoint spacing

struct BwdArgs {
  const float *dt, *A, *B, *C, *x, *g;
  float *ddt, *dx, *ck, *part, *dA_part;
  int64_t s_dt_b, s_dt_t, s_x_b, s_x_t, s_g_b, s_g_t, s_A, s_B_b, s_B_t,
      s_C_b, s_C_t;
  int64_t L;
  int di, N;
};

// v[0 .. NV) of the 32 lanes -> lane j holds the sum over the lanes of
// value j (NV = 32): log2(32) rounds of shuffles, each halving the values
// a lane carries.
template <int M, int NV>
__device__ __forceinline__ void sum_scatter(float (&v)[2 * kN], int lane) {
  const bool up = (lane & M) != 0;
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) {
    const float keep = up ? v[i + NV / 2] : v[i];
    const float send = up ? v[i] : v[i + NV / 2];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
  if constexpr (M > 1) sum_scatter<M / 2, NV / 2>(v, lane);
}

__global__ void __launch_bounds__(32) ssm_scan_bwd_kernel(const BwdArgs p) {
  __shared__ float hs[kBT + 1][kN][32];  // h before and after each step
  __shared__ float sdt[kBT][32], sx[kBT][32], sg[kBT][32];
  __shared__ float sB[kBT][kN], sC[kBT][kN];
  const int lane = threadIdx.x, blk = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int di = p.di, N = p.N, c = blk * 32 + lane;
  const bool live = c < di;
  const int64_t L = p.L;
  const int64_t n_ck = (L + kBT - 1) / kBT;
  float An[kN], A2[kN], h[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    An[n] = (live && n < N) ? p.A[c * p.s_A + n] : 0.f;
    A2[n] = An[n] * kLog2e;  // as the forward's
    h[n] = 0.f;
  }
  // A chunk's inputs into shared memory: dt, x (and g) a column per lane,
  // the B and C rows that every lane reads. Zeros past di and N keep those
  // lanes' and states' values at 0.
  auto stage = [&](int64_t t0, int nt, bool with_g) {
    __syncwarp();  // every lane is done with the previous chunk's rows
    for (int i = 0; i < nt; ++i) {
      const int64_t t = t0 + i;
      sdt[i][lane] = live ? p.dt[b * p.s_dt_b + t * p.s_dt_t + c] : 0.f;
      sx[i][lane] = live ? p.x[b * p.s_x_b + t * p.s_x_t + c] : 0.f;
      if (with_g)
        sg[i][lane] = live ? p.g[b * p.s_g_b + t * p.s_g_t + c] : 0.f;
    }
    for (int j = lane; j < nt * kN; j += 32) {
      const int i = j / kN, n = j % kN;
      const int64_t t = t0 + i;
      sB[i][n] = n < N ? p.B[b * p.s_B_b + t * p.s_B_t + n] : 0.f;
      sC[i][n] = n < N ? p.C[b * p.s_C_b + t * p.s_C_t + n] : 0.f;
    }
    __syncwarp();
  };
  // this lane's checkpoint k: state n at [n * di]
  auto ck = [&](int64_t k) { return p.ck + (b * n_ck + k) * N * di + c; };

  // pass 1: the forward, keeping h before every chunk
  for (int64_t k = 0; k < n_ck; ++k) {
    const int64_t t0 = k * kBT;
    const int nt = static_cast<int>(L - t0 < kBT ? L - t0 : kBT);
    if (live) {
      float* out = ck(k);
#pragma unroll
      for (int n = 0; n < kN; ++n)
        if (n < N) out[n * di] = h[n];
    }
    stage(t0, nt, false);
    for (int i = 0; i < nt; ++i) {
      const float dtv = sdt[i][lane];
      const float dxv = dtv * sx[i][lane];
#pragma unroll
      for (int n = 0; n < kN; ++n)
        h[n] = fmaf(ex2(dtv * A2[n]), h[n], dxv * sB[i][n]);
    }
  }

  // pass 2: the chunks from the last, each recomputed, then walked back
  float dhc[kN], dA[kN];  // dhc: exp(dt_{t+1} A) dh_{t+1}
#pragma unroll
  for (int n = 0; n < kN; ++n) dhc[n] = dA[n] = 0.f;
  float* const part = p.part + (b * gridDim.x + blk) * L * 32;
  for (int64_t k = n_ck - 1; k >= 0; --k) {
    const int64_t t0 = k * kBT;
    const int nt = static_cast<int>(L - t0 < kBT ? L - t0 : kBT);
    const float* in = ck(k);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      h[n] = (live && n < N) ? in[n * di] : 0.f;
      hs[0][n][lane] = h[n];
    }
    stage(t0, nt, true);
    for (int i = 0; i < nt; ++i) {
      const float dtv = sdt[i][lane];
      const float dxv = dtv * sx[i][lane];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        h[n] = fmaf(ex2(dtv * A2[n]), h[n], dxv * sB[i][n]);
        hs[i + 1][n][lane] = h[n];
      }
    }
    for (int i = nt - 1; i >= 0; --i) {
      const float dtv = sdt[i][lane], xv = sx[i][lane], gv = sg[i][lane];
      const float dxv = dtv * xv;
      float v[2 * kN];  // dB's terms, then dC's
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float a = ex2(dtv * A2[n]);
        const float dh = fmaf(gv, sC[i][n], dhc[n]);
        const float w = dh * hs[i][n][lane] * a;
        v[n] = dh * dxv;
        v[kN + n] = gv * hs[i + 1][n][lane];
        s1 = fmaf(dh, sB[i][n], s1);
        s2 = fmaf(w, An[n], s2);
        dA[n] = fmaf(w, dtv, dA[n]);
        dhc[n] = a * dh;
      }
      const int64_t t = t0 + i;
      if (live) {
        const int64_t at = (b * L + t) * di + c;
        p.ddt[at] = fmaf(xv, s1, s2);
        p.dx[at] = dtv * s1;
      }
      sum_scatter<16, 2 * kN>(v, lane);
      part[t * 32 + lane] = v[0];
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < kN; ++n)
      if (n < N) p.dA_part[(b * di + c) * N + n] = dA[n];
  }
}

// dB, dC (Bt, L, N): the per-warp partials added in warp order; dA (di,
// N): the per-batch-row parts added in row order. A thread per output.
__global__ void __launch_bounds__(256)
    ssm_scan_bwd_finish(const float* __restrict__ part,
                        const float* __restrict__ dA_part,
                        float* __restrict__ dB, float* __restrict__ dC,
                        float* __restrict__ dA, int64_t Bt, int64_t L,
                        int n_warps, int di, int N) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_bc = Bt * L * 32;
  if (i < n_bc) {
    const int j = static_cast<int>(i % 32), n = j % kN;
    const int64_t bt = i / 32, b = bt / L, t = bt % L;
    if (n >= N) return;
    const float* src = part + (b * n_warps * L + t) * 32 + j;
    float s = 0.f;
    for (int w = 0; w < n_warps; ++w) s += src[w * L * 32];
    (j < kN ? dB : dC)[bt * N + n] = s;
  } else if (i < n_bc + static_cast<int64_t>(di) * N) {
    const int64_t q = i - n_bc;  // c * N + n
    float s = 0.f;
    for (int64_t b = 0; b < Bt; ++b) s += dA_part[b * di * N + q];
    dA[q] = s;
  }
}

// dt, x, g: (Bt, L, di); A: (di, N); B, C: (Bt, L, N); float32, innermost
// stride 1, other strides in elements. Outputs, contiguous float32: ddt,
// dx (Bt, L, di), dB, dC (Bt, L, N), dA (di, N). Scratch the wrapper
// allocates: ck (Bt, ceil(L / 16), N, di), part (Bt, ceil(di / 32), L, 32),
// dA_part (Bt, di, N). 0 < Bt <= 65535, L, di > 0 and 0 < N <= 16.
int scan_bwd(int device, const BwdArgs& args, float* dB, float* dC,
             float* dA, int64_t Bt, void* stream) {
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  if (Bt <= 0 || Bt > 65535 || args.L <= 0 || args.di <= 0 || args.N <= 0 ||
      args.N > kN)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int n_warps = (args.di + 31) / 32;
  ssm_scan_bwd_kernel<<<dim3(n_warps, static_cast<unsigned>(Bt)), 32, 0,
                        st>>>(args);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n = Bt * args.L * 32 + static_cast<int64_t>(args.di) * args.N;
  ssm_scan_bwd_finish<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                        st>>>(args.part, args.dA_part, dB, dC, dA, Bt,
                              args.L, n_warps, args.di, args.N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward's arguments as one block of n = 31 int64: device, dt, A,
// B, C, x, g, ddt, dx, dB, dC, dA, ck, part, dA_part, Bt, L, di, N, the
// strides s_dt_b, s_dt_t, s_x_b, s_x_t, s_g_b, s_g_t, s_A, s_B_b, s_B_t,
// s_C_b, s_C_t, stream.
extern "C" int repro_ssm_scan_bwd(const int64_t* a, int n) {
  if (n != 31 || a[17] <= 0 || a[17] > INT32_MAX - 32)
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [&](int i) { return reinterpret_cast<float*>(a[i]); };
  const BwdArgs args{f(1),  f(2),  f(3),  f(4),  f(5),  f(6),  f(7),
                     f(8),  f(12), f(13), f(14), a[19], a[20], a[21],
                     a[22], a[23], a[24], a[25], a[26], a[27], a[28],
                     a[29], a[16], static_cast<int>(a[17]),
                     static_cast<int>(a[18])};
  return scan_bwd(static_cast<int>(a[0]), args, f(9), f(10), f(11), a[15],
                  reinterpret_cast<void*>(a[30]));
}

// The wrapper's arguments as one block of n = 28 int64 (kernels/nvcc.py
// ``launch``): device, dt, A, B, C, x, y, Bt, L, di, N, the strides s_dt_b
// .. s_y_t, lanes, channels, chunk, stages, smem_bytes, stream.
extern "C" int repro_ssm_scan(const int64_t* a, int n) {
  if (n != 28) return static_cast<int>(cudaErrorInvalidValue);
  auto p = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  auto i32 = [&](int i) { return static_cast<int>(a[i]); };
  return scan(i32(0), p(1), p(2), p(3), p(4), p(5), p(6), a[7], a[8], a[9],
              a[10], a[11], a[12], a[13], a[14], a[15], a[16], a[17], a[18],
              a[19], a[20], a[21], i32(22), i32(23), i32(24), i32(25),
              i32(26), p(27));
}
