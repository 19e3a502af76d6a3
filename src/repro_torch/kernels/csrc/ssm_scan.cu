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
// On the TPU one grid step owns a (256-channel, N) state block in VMEM and
// walks the whole sequence with a fori_loop. Here blocks run in parallel,
// so the channels are the parallelism: 4 neighbouring lanes of a warp own
// one channel of one batch row, each with 4 of its 16 states and the
// matching 4 entries of A in registers, and add their parts of y with
// warp shuffles. A block of 128 threads owns 32 channels and walks the
// sequence in chunks of kT steps. Each chunk
// of dt and x (kT x channels, coalesced) and of B and C (kT x N, the same
// for every channel) is staged in shared memory with cp.async,
// double-buffered, so the next chunk's loads run behind this chunk's
// arithmetic; B_t and C_t are read from shared memory as 16-byte
// broadcasts. Everything is read through strides (innermost stride 1), so
// the column slices B and C of the x_proj output need no copy. Ragged L, a
// di that is not a multiple of the block's channels and N below the
// register width kN = 16 are zero-filled in shared memory: a zero A gives
// exp(0) = 1 and a zero B keeps the padded states at 0, and padded
// channels store nothing.
//
// What bounds it on an H100 (data sheet): at jamba's prefill shape
// (Bt=1, L=4096, di=16384, N=16) it reads dt and x and writes y, 805 MB,
// 0.240 ms at 3.35 TB/s; it takes L*di*N = 1.07 G exponentials, ~0.28 ms
// at the special-function units' 16 per clock per SM on 132 SMs at
// ~1.8 GHz; the ~4.3 GFLOP of f32 arithmetic take ~0.064 ms at 67 TFLOP/s.
// So the exponentials set the bound. Bt=1 leaves only di = 16,384
// independent recurrences per state: with one thread per channel that is
// ~4 warps per SM, too few to hide the latency of each step's dependent
// multiply-add chain; four lanes per channel give ~16 warps per SM for a
// few more instructions per step (two shuffles and adds for y).
//
// The decay takes __expf (one ex2.approx on the special-function units),
// not expf (the same plus a range reduction on the FMA pipe, the accuracy
// of the plain version's torch.exp): on an H100 at jamba's prefill shape
// it was 11% faster and stayed within the 1e-5 tolerance (PERF.md). The
// C entry point returns cudaGetLastError() after the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kT = 16;         // time steps per staged chunk
constexpr int kN = 16;         // states per channel held in registers
constexpr int kPer = 4;        // states per lane
constexpr int kLanes = kN / kPer;          // lanes per channel
constexpr int kCh = kThreads / kLanes;     // channels per block

struct Params {
  const float* dt;
  const float* A;
  const float* B;
  const float* C;
  const float* x;
  float* y;
  int64_t L, di, N;
  int64_t s_dt_b, s_dt_t;  // dt: (Bt, L, di), innermost stride 1
  int64_t s_x_b, s_x_t;    // x:  (Bt, L, di)
  int64_t s_A;             // A:  (di, N) row stride
  int64_t s_B_b, s_B_t;    // B:  (Bt, L, N)
  int64_t s_C_b, s_C_t;    // C:  (Bt, L, N)
  int64_t s_y_b, s_y_t;    // y:  (Bt, L, di)
};

struct __align__(16) Stage {
  float dt[kT][kCh];
  float x[kT][kCh];
  float B[kT][kN];
  float C[kT][kN];
};

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 4-byte cp.async; when !ok nothing is read and the word is zero-filled.
__device__ __forceinline__ void copy_word(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// Start the copies of chunk [t0, t0 + kT) into stage s, as one group.
// dt_row, x_row point at (b, t=0, c0): the block's first channel c0.
__device__ __forceinline__ void load_chunk(Stage& s, const Params& p,
                                           const float* dt_row,
                                           const float* x_row,
                                           const float* B_row,
                                           const float* C_row, int64_t t0,
                                           int64_t c0) {
  for (int i = threadIdx.x; i < kT * kCh; i += kThreads) {
    const int t = i / kCh, ch = i % kCh;
    const bool ok = c0 + ch < p.di && t0 + t < p.L;
    const int64_t tt = ok ? t0 + t : 0, cc = ok ? ch : 0;
    copy_word(&s.dt[t][ch], dt_row + tt * p.s_dt_t + cc, ok);
    copy_word(&s.x[t][ch], x_row + tt * p.s_x_t + cc, ok);
  }
  for (int i = threadIdx.x; i < kT * kN; i += kThreads) {
    const int t = i / kN, n = i % kN;
    const bool ok = t0 + t < p.L && n < p.N;
    const int64_t tt = ok ? t0 + t : 0, nn = ok ? n : 0;
    copy_word(&s.B[t][n], B_row + tt * p.s_B_t + nn, ok);
    copy_word(&s.C[t][n], C_row + tt * p.s_C_t + nn, ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(const Params p) {
  __shared__ Stage stage[2];

  const int64_t b = blockIdx.y;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kCh;
  const int ch = threadIdx.x / kLanes, q = threadIdx.x % kLanes;
  const int64_t c = c0 + ch;
  const bool channel_ok = c < p.di;
  const float* dt_row = p.dt + b * p.s_dt_b + c0;
  const float* x_row = p.x + b * p.s_x_b + c0;
  const float* B_row = p.B + b * p.s_B_b;
  const float* C_row = p.C + b * p.s_C_b;
  float* y_row = p.y + b * p.s_y_b + (channel_ok ? c : 0);

  float A[kPer], h[kPer];  // states q * kPer .. q * kPer + kPer - 1
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int n = q * kPer + j;
    A[j] = (channel_ok && n < p.N) ? p.A[c * p.s_A + n] : 0.f;
    h[j] = 0.f;
  }

  const int64_t n_chunks = (p.L + kT - 1) / kT;
  load_chunk(stage[0], p, dt_row, x_row, B_row, C_row, 0, c0);
  for (int64_t k = 0; k < n_chunks; ++k) {
    const int64_t t0 = k * kT;
    if (k + 1 < n_chunks) {
      // stage (k+1)&1 was last read in chunk k-1, before its closing sync
      load_chunk(stage[(k + 1) & 1], p, dt_row, x_row, B_row, C_row,
                 t0 + kT, c0);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // chunk k landed for every thread
    const Stage& s = stage[k & 1];
    const int steps = static_cast<int>(p.L - t0 < kT ? p.L - t0 : kT);
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const float dtv = s.dt[t][ch];
      const float dx = dtv * s.x[t][ch];
      const float4 Bt = *reinterpret_cast<const float4*>(&s.B[t][q * kPer]);
      const float4 Ct = *reinterpret_cast<const float4*>(&s.C[t][q * kPer]);
      const float Bn[kPer] = {Bt.x, Bt.y, Bt.z, Bt.w};
      const float Cn[kPer] = {Ct.x, Ct.y, Ct.z, Ct.w};
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float a = __expf(dtv * A[j]);
        h[j] = a * h[j] + dx * Bn[j];
        acc += h[j] * Cn[j];
      }
      // every lane runs the same steps, so the whole warp shuffles
#pragma unroll
      for (int m = 1; m < kLanes; m *= 2) {
        acc += __shfl_xor_sync(0xffffffffu, acc, m);
      }
      if (channel_ok && q == 0) y_row[(t0 + t) * p.s_y_t] = acc;
    }
    __syncthreads();  // every thread is done with stage k&1
  }
}

}  // namespace

// dt, x: (Bt, L, di); A: (di, N); B, C: (Bt, L, N); y: (Bt, L, di); all
// float32 with innermost stride 1, strides in elements (batch, time; row
// for A). Bt, L, di > 0 and 0 < N <= 16. Returns cudaGetLastError().
extern "C" int repro_ssm_scan(
    const void* dt, const void* A, const void* B, const void* C,
    const void* x, void* y, int64_t Bt, int64_t L, int64_t di, int64_t N,
    int64_t s_dt_b, int64_t s_dt_t, int64_t s_x_b, int64_t s_x_t,
    int64_t s_A, int64_t s_B_b, int64_t s_B_t, int64_t s_C_b, int64_t s_C_t,
    int64_t s_y_b, int64_t s_y_t, void* stream) {
  const Params p{static_cast<const float*>(dt), static_cast<const float*>(A),
                 static_cast<const float*>(B),  static_cast<const float*>(C),
                 static_cast<const float*>(x),  static_cast<float*>(y),
                 L, di, N, s_dt_b, s_dt_t, s_x_b, s_x_t, s_A,
                 s_B_b, s_B_t, s_C_b, s_C_t, s_y_b, s_y_t};
  const dim3 grid(static_cast<unsigned>((di + kCh - 1) / kCh),
                  static_cast<unsigned>(Bt));
  ssm_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
