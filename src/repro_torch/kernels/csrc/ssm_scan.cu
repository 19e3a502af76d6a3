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
// With a gradient wanted the forward runs as ssm_scan_kernel<LPC, true>,
// which also stores h before every kBT = 8 steps into a (Bt, ceil(L / 8),
// di, 16) float32 buffer of checkpoints, a channel's states in one 64-byte
// row (16-byte stores, neighbouring lanes on neighbouring rows): 537 MB
// more stores at jamba's shape. The serving instance <LPC, false> stores
// none.
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
// It reads the forward's checkpoints, so it has no forward pass of its
// own, and keeps no (L, di, N) tape (1 GiB at jamba's shape). What bounds
// it on an H100: it reads dt, x, g and the checkpoints and writes ddt and
// dx, 1.88 GB at jamba's shape, 0.56 ms at 3.35 TB/s (without the 537 MB
// of checkpoints that the 8-step spacing costs, the function's own 1.35
// GB, 0.40 ms); one exponential per
// (t, c, n), 0.26 ms on the special-function units; ~18 float32 operations
// per (t, c, n) besides, and the sums over channels (dB, dC) and states
// (ddt, dx) across lanes, which make it bound by instruction issue. The
// design, ssm_scan_bwd_kernel<CH>:
//   - a block owns CH channels of one batch row and walks its chunks of
//     kBT steps from the last. Its thread 0 loads each chunk's dt, x and g
//     tiles (8 x CH), its B and C rows and its checkpoint (CH x 16 states)
//     by TMA, in reverse chunk order, into a ring of kBStages stages
//     guarded by an mbarrier each: kBStages chunks ahead, into the stage
//     that the block's barrier at a chunk's end has freed, so the loads
//     overlap the work. No warp is kept for loads: its registers would be
//     taken from the others. Out-of-bounds reads are zeros, as in the
//     forward.
//   - LPC = 4 neighbouring lanes own one channel, 4 of its states each
//     (2,048 warps at jamba's Bt = 1). From the checkpoint a lane
//     recomputes the chunk's steps with the forward's instructions (ex2 of
//     dt * (A log2 e), the same fmaf), so its states are the forward's
//     bits, and keeps each step's state and decay in registers (a lane's
//     4 states x 17 values). The reverse step reads the kept decay: one
//     exponential per (t, c, n). 2 lanes a channel, whose 8 states a lane
//     do not fit in registers with their decays, were slower at every
//     shape measured (PERF.md). Chunks of 8 steps, not 16: the unrolled
//     loop body and the registers a lane keeps are half as large; on an
//     H100 that won more than the doubled checkpoints cost (PERF.md).
//   - ddt and dx: each lane's share of the two n-sums, u = x s1 + s2 and
//     s1, is added over the channel's LPC lanes in log2(LPC) shuffle rounds
//     (a reduce-scatter, then an all-reduce); one lane writes ddt, another
//     dx = dt s1, into tiles in shared memory that leave by TMA stores (two
//     tiles each, so a store drains under the next chunk).
//   - dB and dC: each step the 2 x 16 / LPC terms of a lane are added over
//     the warp's channels by a reduce-scatter (each lane ends with one of
//     the 32 sums), the warps' sums are added in warp order through shared
//     memory after the chunk, and the block writes one row of partials a
//     step; ssm_scan_bwd_finish adds the blocks' partials in block order,
//     and dA's per-batch-row parts in row order. No atomics: two runs give
//     the same bits. More channels a block (128 at a large grid) means
//     fewer partials.
// ref.ssm_scan_bwd_ref is the backward in plain PyTorch (exp, sums in
// another order); the kernel is held to it within a tolerance.
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kN = 16;        // states per channel held in registers
constexpr int kCh = 32;       // channels per block
constexpr int kT = 32;        // time steps per staged chunk
constexpr int kSub = 16;      // steps per unrolled run (y reduced after it)
constexpr int kBT = 8;        // steps per checkpoint: half an unrolled run
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

// Where the checkpointing forward stores h before every kBT steps: state n
// of channel c before step kBT k of batch row b at p[((b * n_ck + k) * di +
// c) * 16 + n], a channel's 16 states (zeros past N) in one 64-byte row.
struct Checkpoints {
  float* p;
  int64_t n_ck;
};

template <int LPC, bool CK>
__global__ void __launch_bounds__(Shape<LPC>::kThreads, 4)
    ssm_scan_kernel(const __grid_constant__ CUtensorMap tm_dt,
                    const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_B,
                    const __grid_constant__ CUtensorMap tm_C,
                    const __grid_constant__ CUtensorMap tm_y,
                    const float* __restrict__ A, int64_t s_A, int di, int N,
                    int L, const Checkpoints ck) {
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
        if constexpr (CK) {  // h before steps t .. t + kBT - 1
          const int t = k * kT + t0 + i;
          if (i % kBT == 0 && c < di && t < L) {
            float* out = ck.p + ((b * ck.n_ck + t / kBT) * di + c) * kN +
                         q * kPer;
#pragma unroll
            for (int j = 0; j < kPer; j += 4)
              *reinterpret_cast<float4*>(out + j) =
                  make_float4(h[j], h[j + 1], h[j + 2], h[j + 3]);
          }
        }
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

template <int LPC, bool CK>
cudaError_t launch(const CUtensorMap (&maps)[5], const float* A,
                   int64_t s_A, int64_t Bt, int64_t di, int64_t N,
                   int64_t L, const Checkpoints& ck, cudaStream_t stream) {
  static int allowed = 48 * 1024;
  const cudaError_t err =
      allow_smem(ssm_scan_kernel<LPC, CK>, kSmem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((di + kCh - 1) / kCh),
                  static_cast<unsigned>(Bt));
  ssm_scan_kernel<LPC, CK><<<grid, Shape<LPC>::kThreads, kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], A, s_A,
      static_cast<int>(di), static_cast<int>(N), static_cast<int>(L), ck);
  return cudaGetLastError();
}

// dt, x: (Bt, L, di); A: (di, N); B, C: (Bt, L, N); y: (Bt, L, di); all
// float32 with innermost stride 1, strides in elements (batch, time; row
// for A); dt, x, B, C, y 16-byte aligned with strides of whole 16 bytes
// (TMA), except a stride whose dimension has extent 1. Bt, L, di > 0 and
// 0 < N <= 16. lanes .. smem_bytes: the wrapper's plan (lanes per
// channel, channels per block, steps per chunk, stages, shared-memory
// bytes), refused unless it is an instance's. ck: null (the serving
// instance) or the checkpoints, (Bt, ceil(L / 8), di, 16) float32,
// contiguous and 16-byte aligned.
int scan(int device, const void* dt, const void* A, const void* B,
         const void* C, const void* x, void* y, int64_t Bt, int64_t L,
         int64_t di, int64_t N, int64_t s_dt_b, int64_t s_dt_t,
         int64_t s_x_b, int64_t s_x_t, int64_t s_A, int64_t s_B_b,
         int64_t s_B_t, int64_t s_C_b, int64_t s_C_t, int64_t s_y_b,
         int64_t s_y_t, int lanes, int channels, int chunk, int stages,
         int smem_bytes, void* ck, void* stream) {
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
  const int64_t n_ck = (L + kBT - 1) / kBT;
  const Checkpoints cks{static_cast<float*>(ck), n_ck};
  cudaError_t err;
  if (ck == nullptr)
    err = lanes == 2 ? launch<2, false>(maps, a, s_A, Bt, di, N, L, cks, st)
                     : launch<4, false>(maps, a, s_A, Bt, di, N, L, cks, st);
  else
    err = lanes == 2 ? launch<2, true>(maps, a, s_A, Bt, di, N, L, cks, st)
                     : launch<4, true>(maps, a, s_A, Bt, di, N, L, cks, st);
  return static_cast<int>(err);
}

// ------------------------------------------------------------- backward

constexpr int kBStages = 3;  // chunks in the backward's ring

template <int CH>
struct Bwd {
  static constexpr int kLpc = 4;                    // lanes per channel
  static constexpr int kPer = kN / kLpc;            // states per lane
  static constexpr int kWarps = CH * kLpc / 32;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kTile = kBT * CH * 4;        // dt, x, g, ddt, dx
  static constexpr int kCk = kN * CH * 4;           // a checkpoint
  static constexpr int kRows = kBT * kN * 4;        // B or C rows
  static constexpr int kStage = 3 * kTile + kCk + 2 * kRows;
  static constexpr int kRed = kWarps * kBT * 2 * kN * 4;  // a chunk's sums
  // 128 bytes to align the TMA boxes, the ring, two ddt and two dx tiles,
  // two buffers of the warps' dB/dC sums, an mbarrier a stage
  static constexpr int kSmem =
      128 + kBStages * kStage + 4 * kTile + 2 * kRed + 8 * kBStages;
  static_assert(CH * kLpc % 32 == 0 && 2 * kPer == 32 / kLpc, "lane split");
};

// A lane's K consecutive floats of a row in shared memory, in 16-byte
// loads.
template <int K>
__device__ __forceinline__ void load_row(const float* src, float (&out)[K]) {
  static_assert(K % 4 == 0, "whole 16-byte words");
#pragma unroll
  for (int j = 0; j < K; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(src + j);
    out[j] = v.x, out[j + 1] = v.y, out[j + 2] = v.z, out[j + 3] = v.w;
  }
}

// v[0 .. NV) of this lane and of lane ^ M -> v[0 .. NV/2) (the upper half
// where lane & M), then the next round, down to mask MLO.
template <int M, int MLO, int NV, int SZ>
__device__ __forceinline__ void fold(float (&v)[SZ], int lane) {
  const bool up = (lane & M) != 0;
#pragma unroll
  for (int i = 0; i < NV / 2; ++i) {
    const float keep = up ? v[i + NV / 2] : v[i];
    const float send = up ? v[i] : v[i + NV / 2];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
  if constexpr (M > MLO) fold<M / 2, MLO, NV / 2, SZ>(v, lane);
}

struct BwdArgs {
  const float* A;
  float *part, *dA_part;
  int64_t s_A, L;
  int di, N;
};

// One block an SM is all the launch asks: ptxas then gives a thread what
// it needs, and the instances' ~120 registers still let two or more
// blocks share an SM.
template <int CH>
__global__ void __launch_bounds__(Bwd<CH>::kThreads, 1)
    ssm_scan_bwd_kernel(const __grid_constant__ CUtensorMap tm_dt,
                        const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_g,
                        const __grid_constant__ CUtensorMap tm_ck,
                        const __grid_constant__ CUtensorMap tm_B,
                        const __grid_constant__ CUtensorMap tm_C,
                        const __grid_constant__ CUtensorMap tm_ddt,
                        const __grid_constant__ CUtensorMap tm_dx,
                        const BwdArgs p) {
  using P = Bwd<CH>;
  constexpr int LPC = P::kLpc, kPer = P::kPer, kWarps = P::kWarps;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 127) & ~127u;
  unsigned char* const smem = smem_raw + (base - raw);  // generic view
  const int out_off = kBStages * P::kStage;             // ddt, dx tiles
  const int red_off = out_off + 4 * P::kTile;
  const uint32_t bars = base + red_off + 2 * P::kRed;
  auto full = [&](int s) { return bars + 8 * s; };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.x * CH, b = blockIdx.y;
  const int di = p.di, N = p.N;
  const int64_t L = p.L;
  const int n_ck = static_cast<int>((L + kBT - 1) / kBT);
  // thread 0: the loads of the kk-th chunk from the last into its stage
  auto load = [&](int kk) {
    const int k = n_ck - 1 - kk, s = kk % kBStages, t0 = k * kBT;
    const uint32_t st = base + s * P::kStage;
    mbar_expect_tx(full(s), P::kStage);
    tma_load_3d(st, &tm_dt, full(s), c0, t0, b);
    tma_load_3d(st + P::kTile, &tm_x, full(s), c0, t0, b);
    tma_load_3d(st + 2 * P::kTile, &tm_g, full(s), c0, t0, b);
    tma_load_3d(st + 3 * P::kTile, &tm_ck, full(s), 0, c0, b * n_ck + k);
    tma_load_3d(st + 3 * P::kTile + P::kCk, &tm_B, full(s), 0, t0, b);
    tma_load_3d(st + 3 * P::kTile + P::kCk + P::kRows, &tm_C, full(s), 0, t0,
                b);
  };

  if (tid == 0) {
    for (int s = 0; s < kBStages; ++s) mbar_init(full(s), 1);
    mbar_init_fence();
    prefetch_map(&tm_dt);
    prefetch_map(&tm_x);
    prefetch_map(&tm_g);
    prefetch_map(&tm_ck);
    prefetch_map(&tm_B);
    prefetch_map(&tm_C);
    for (int kk = 0; kk < kBStages && kk < n_ck; ++kk) load(kk);
  }
  __syncthreads();

  const int ch = warp * (32 / LPC) + lane / LPC, q = lane % LPC;
  const int c = c0 + ch;
  // A2 = A log2 e, as the forward's
  float An[kPer], A2[kPer], dhc[kPer], dA[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = q * kPer + j;
    An[j] = (c < di && n < N) ? p.A[c * p.s_A + n] : 0.f;
    A2[j] = An[j] * kLog2e;
    dhc[j] = dA[j] = 0.f;  // dhc: exp(dt_{t+1} A) dh_{t+1}
  }
  // the chunk's recomputed states h[0 .. kBT] (h[0] the checkpoint) and
  // decays, in registers
  float h[kBT + 1][kPer], a[kBT][kPer];
  // where this lane's sum of its warp's dB/dC terms goes in a step's row of
  // 32: term lane / LPC of its state group, dB for the first kPer
  const int jj = warp * kBT * 2 * kN + (lane / LPC) / kPer * kN + q * kPer +
                 (lane / LPC) % kPer;
  float* const part = p.part + (static_cast<int64_t>(b) * gridDim.x +
                                blockIdx.x) * L * 2 * kN;

#pragma unroll 1
  for (int kk = 0; kk < n_ck; ++kk) {
    const int k = n_ck - 1 - kk, s = kk % kBStages;
    mbar_wait(full(s), (kk / kBStages) & 1);
    const float* dts = reinterpret_cast<const float*>(smem + s * P::kStage);
    const float* xs = dts + kBT * CH;
    const float* gs = xs + kBT * CH;
    const float* cks = gs + kBT * CH;
    const float* Bs = cks + kN * CH;
    const float* Cs = Bs + kBT * kN;
    float* const ot = reinterpret_cast<float*>(smem + out_off) +
                      (kk & 1) * 2 * kBT * CH;  // ddt, then dx
    float* const red = reinterpret_cast<float*>(smem + red_off) +
                       (kk & 1) * kWarps * kBT * 2 * kN;

    // the chunk's states from its checkpoint, as the forward computes them
    load_row(cks + ch * kN + q * kPer, h[0]);
#pragma unroll
    for (int i = 0; i < kBT; ++i) {
      const float dtv = dts[i * CH + ch];
      const float dxv = dtv * xs[i * CH + ch];
      float Bn[kPer];
      load_row(Bs + i * kN + q * kPer, Bn);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        a[i][j] = ex2(dtv * A2[j]);
        h[i + 1][j] = fmaf(a[i][j], h[i][j], dxv * Bn[j]);
      }
    }

    // the reverse steps
#pragma unroll
    for (int i = kBT - 1; i >= 0; --i) {
      const float dtv = dts[i * CH + ch], xv = xs[i * CH + ch];
      const float gv = gs[i * CH + ch];
      const float dxv = dtv * xv;
      float Bn[kPer], Cn[kPer];
      load_row(Bs + i * kN + q * kPer, Bn);
      load_row(Cs + i * kN + q * kPer, Cn);
      float v[2 * kPer];  // dB's terms, then dC's
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float dh = fmaf(gv, Cn[j], dhc[j]);
        const float dn = a[i][j] * dh;
        const float w = dn * h[i][j];
        s1 = fmaf(dh, Bn[j], s1);
        s2 = fmaf(w, An[j], s2);
        dA[j] = fmaf(w, dtv, dA[j]);
        v[j] = dh * dxv;
        v[kPer + j] = gv * h[i + 1][j];
        dhc[j] = dn;
      }
      // u = x s1 + s2 and s1 over the channel's lanes: lanes q < LPC/2 end
      // with ddt, the others with s1
      const bool up = (q & (LPC / 2)) != 0;
      const float u = fmaf(xv, s1, s2);
      float r = (up ? s1 : u) +
                __shfl_xor_sync(0xffffffffu, up ? u : s1, LPC / 2);
#pragma unroll
      for (int m = LPC / 4; m >= 1; m /= 2)
        r += __shfl_xor_sync(0xffffffffu, r, m);
      if (q == 0) ot[i * CH + ch] = r;
      if (q == LPC / 2) ot[(kBT + i) * CH + ch] = dtv * r;
      fold<16, LPC, 2 * kPer>(v, lane);
      red[i * 2 * kN + jj] = v[0];
    }

    // the chunk's ddt and dx tiles out, its stage refilled, the block's
    // dB/dC sums (warps in order) as one row of partials a step
    fence_async_smem();                 // ddt, dx tiles -> the TMA store
    if (tid == 0) bulk_wait_read<0>();  // the last chunk's store read
    __syncthreads();                    // and every warp is done with s
    if (tid == 0) {
      tma_store_3d(&tm_ddt, smem_addr(ot), c0, k * kBT, b);
      tma_store_3d(&tm_dx, smem_addr(ot + kBT * CH), c0, k * kBT, b);
      bulk_commit();
      if (kk + kBStages < n_ck) load(kk + kBStages);  // into stage s
    }
    for (int e = tid; e < kBT * 2 * kN; e += P::kThreads) {
      const int64_t t = static_cast<int64_t>(k) * kBT + e / (2 * kN);
      float sum = red[e];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red[w * kBT * 2 * kN + e];
      if (t < L) part[t * 2 * kN + e % (2 * kN)] = sum;
    }
  }
  if (tid == 0) bulk_wait_all();
  if (c < di) {
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (q * kPer + j < N)
        p.dA_part[(static_cast<int64_t>(b) * di + c) * N + q * kPer + j] =
            dA[j];
  }
}

// dB, dC (Bt, L, N): the per-block partials added in block order; dA (di,
// N): the per-batch-row parts added in row order. A thread per output.
__global__ void __launch_bounds__(256)
    ssm_scan_bwd_finish(const float* __restrict__ part,
                        const float* __restrict__ dA_part,
                        float* __restrict__ dB, float* __restrict__ dC,
                        float* __restrict__ dA, int64_t Bt, int64_t L,
                        int n_blk, int di, int N) {
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t n_bc = Bt * L * 2 * kN;
  if (i < n_bc) {
    const int j = static_cast<int>(i % (2 * kN)), n = j % kN;
    const int64_t bt = i / (2 * kN), b = bt / L, t = bt % L;
    if (n >= N) return;
    const float* src = part + (b * n_blk * L + t) * 2 * kN + j;
    float s = 0.f;
#pragma unroll 8
    for (int w = 0; w < n_blk; ++w) s += src[w * L * 2 * kN];
    (j < kN ? dB : dC)[bt * N + n] = s;
  } else if (i < n_bc + static_cast<int64_t>(di) * N) {
    const int64_t q = i - n_bc;  // c * N + n
    float s = 0.f;
    for (int64_t b = 0; b < Bt; ++b) s += dA_part[b * di * N + q];
    dA[q] = s;
  }
}

template <int CH>
cudaError_t launch_bwd(const CUtensorMap (&maps)[8], const BwdArgs& args,
                       int64_t Bt, cudaStream_t stream) {
  using P = Bwd<CH>;
  static int allowed = 48 * 1024;
  const cudaError_t err =
      allow_smem(ssm_scan_bwd_kernel<CH>, P::kSmem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((args.di + CH - 1) / CH),
                  static_cast<unsigned>(Bt));
  ssm_scan_bwd_kernel<CH><<<grid, P::kThreads, P::kSmem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7],
      args);
  return cudaGetLastError();
}

// dt, x, g: (Bt, L, di); A: (di, N); B, C: (Bt, L, N); float32, innermost
// stride 1, other strides in elements, TMA-ready as ``scan``'s inputs. ck:
// the checkpointing forward's (Bt, ceil(L / 8), di, 16), contiguous and
// 16-byte aligned. Outputs: ddt, dx (Bt, L, di) with
// strides s_o_b, s_o_t (TMA-ready), contiguous dB, dC (Bt, L, N) and dA
// (di, N). Scratch the wrapper allocates: part (Bt, ceil(di / channels),
// L, 32), dA_part (Bt, di, N). 0 < Bt <= 65535, L, di > 0, 0 < N <= 16.
// lanes .. smem_bytes: the wrapper's plan (lanes per channel, channels per
// block, steps per chunk, stages, shared-memory bytes), refused unless it
// is an instance's: 4 lanes and 128 or 32 channels.
int scan_bwd(int device, const void* dt, const void* x, const void* g,
             const void* ck, const void* B, const void* C, void* ddt,
             void* dx, float* dB, float* dC, float* dA, const BwdArgs& args,
             int64_t Bt, int64_t s_dt_b, int64_t s_dt_t, int64_t s_x_b,
             int64_t s_x_t, int64_t s_g_b, int64_t s_g_t, int64_t s_B_b, int64_t s_B_t, int64_t s_C_b,
             int64_t s_C_t,
             int64_t s_o_b, int64_t s_o_t, int lanes, int channels,
             int chunk, int stages, int smem_bytes, void* stream) {
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  const int64_t L = args.L, di = args.di, N = args.N;
  auto is = [&](int ch, int smem) {
    return lanes == 4 && channels == ch && smem_bytes == smem;
  };
  const int instance = is(128, Bwd<128>::kSmem) ? 1
                       : is(32, Bwd<32>::kSmem) ? 2
                                                : 0;
  if (instance == 0 || chunk != kBT || stages != kBStages || Bt <= 0 ||
      Bt > 65535 || L <= 0 || L > INT32_MAX - kBT || di <= 0 ||
      di > INT32_MAX - 128 || N <= 0 || N > kN ||
      Bt * ((L + kBT - 1) / kBT) > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_ck = (L + kBT - 1) / kBT;
  CUtensorMap maps[8];
  if (!encode_f32_3d(&maps[0], dt, Bt, L, di, s_dt_b, s_dt_t, channels,
                     kBT) ||
      !encode_f32_3d(&maps[1], x, Bt, L, di, s_x_b, s_x_t, channels, kBT) ||
      !encode_f32_3d(&maps[2], g, Bt, L, di, s_g_b, s_g_t, channels, kBT) ||
      !encode_f32_3d(&maps[3], ck, Bt * n_ck, di, kN, di * kN, kN, kN,
                     channels) ||
      !encode_f32_3d(&maps[4], B, Bt, L, N, s_B_b, s_B_t, kN, kBT) ||
      !encode_f32_3d(&maps[5], C, Bt, L, N, s_C_b, s_C_t, kN, kBT) ||
      !encode_f32_3d(&maps[6], ddt, Bt, L, di, s_o_b, s_o_t, channels,
                     kBT) ||
      !encode_f32_3d(&maps[7], dx, Bt, L, di, s_o_b, s_o_t, channels, kBT))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = instance == 1
                              ? launch_bwd<128>(maps, args, Bt, st)
                              : launch_bwd<32>(maps, args, Bt, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blk = static_cast<int>((di + channels - 1) / channels);
  const int64_t n = Bt * L * 2 * kN + di * N;
  ssm_scan_bwd_finish<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                        st>>>(args.part, args.dA_part, dB, dC, dA, Bt, L,
                              n_blk, static_cast<int>(di),
                              static_cast<int>(N));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward's arguments as one block of n = 38 int64: device, dt, A,
// B, C, x, g, ck, ddt, dx, dB, dC, dA, part, dA_part, Bt, L, di, N, the
// strides s_dt_b, s_dt_t, s_x_b, s_x_t, s_g_b, s_g_t, s_A, s_B_b, s_B_t,
// s_C_b, s_C_t, s_o_b, s_o_t, lanes, channels, chunk, stages, smem_bytes,
// stream.
extern "C" int repro_ssm_scan_bwd(const int64_t* a, int n) {
  if (n != 38 || a[17] <= 0 || a[17] > INT32_MAX - 128)
    return static_cast<int>(cudaErrorInvalidValue);
  auto p = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  auto f = [&](int i) { return reinterpret_cast<float*>(a[i]); };
  auto i32 = [&](int i) { return static_cast<int>(a[i]); };
  const BwdArgs args{f(2), f(13), f(14), a[25], a[16], i32(17), i32(18)};
  return scan_bwd(i32(0), p(1), p(5), p(6), p(7), p(3), p(4), p(8), p(9),
                  f(10), f(11), f(12), args, a[15], a[19], a[20], a[21],
                  a[22], a[23], a[24], a[26], a[27], a[28], a[29], a[30],
                  a[31], i32(32), i32(33), i32(34), i32(35), i32(36), p(37));
}

// The wrapper's arguments as one block of n = 29 int64 (kernels/nvcc.py
// ``launch``): device, dt, A, B, C, x, y, Bt, L, di, N, the strides s_dt_b
// .. s_y_t, lanes, channels, chunk, stages, smem_bytes, ck (0: none),
// stream.
extern "C" int repro_ssm_scan(const int64_t* a, int n) {
  if (n != 29) return static_cast<int>(cudaErrorInvalidValue);
  auto p = [&](int i) { return reinterpret_cast<void*>(a[i]); };
  auto i32 = [&](int i) { return static_cast<int>(a[i]); };
  return scan(i32(0), p(1), p(2), p(3), p(4), p(5), p(6), a[7], a[8], a[9],
              a[10], a[11], a[12], a[13], a[14], a[15], a[16], a[17], a[18],
              a[19], a[20], a[21], i32(22), i32(23), i32(24), i32(25),
              i32(26), p(27), p(28));
}
