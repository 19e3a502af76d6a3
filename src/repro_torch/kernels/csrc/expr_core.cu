// The fused expression core of the relational engine (K1) for NVIDIA
// Hopper (sm_90a), written by hand.
//
// Replaces the jitted numeric core of src/repro/core/exprc.py:490
// (_compile_jax -> _core, jax.jit at :527): the compare / bool / arith
// DAG of one fused APPLY/FILTER/HASH run over the columns of one batch,
// in every numpy numeric dtype, byte-identical to numpy.
//
// Design: one kernel binary interprets a run's instruction list, which the
// host encodes once per run signature (kernels/expr_core.py `encode`).
// Each thread takes rows, grid-strided; a row's values live in 64-bit
// registers, each of the dtype the host's zero-row probe recorded; each
// instruction converts its inputs into numpy's loop dtypes
// (np.ufunc.resolve_dtypes, worked out on the host) and computes as
// numpy_ops.cuh says: rounded intrinsics (no contraction into an FMA),
// the host's NaNs, integer wrap. A kernel generated per signature would
// cost an nvcc build each; this one is built once.
//
// What bounds it: at the executor's 8,192-row batches a launch reads and
// writes a few hundred KB, a microsecond of memory time; the copies to
// and from the card and the launch itself are the time. The C entry point
// takes the device index and returns a cudaError_t.
#include "hopper.cuh"
#include "numpy_ops.cuh"

namespace {

using namespace hopper;

constexpr int kMaxIn = 64;     // input columns of one run
constexpr int kMaxOut = 64;    // columns returned
constexpr int kMaxRegs = 128;  // values of one row
constexpr int kThreads = 256;

// Program words (int32), laid out by kernels/expr_core.py `encode`:
//   [0] n_in  [1] n_instr  [2] n_out  [3] n_regs
//   [4] [5] the float64 default NaN (low, high word)  [6] the float32 one
//   n_in dtype codes; n_instr x (op, a, b, la, lb, da, db, dst);
//   n_out x (register, dtype)
constexpr int kHeader = 7;
constexpr int kInstrWords = 8;

struct Columns {
  const void* in[kMaxIn];
  int64_t in_step[kMaxIn];  // 1, or 0 for a constant held once
  void* out[kMaxOut];
};

__device__ __forceinline__ uint64_t load(const void* p, int64_t i, int dt) {
  using namespace npops;
  switch (dt) {
    case kBool: case kU8: return static_cast<const uint8_t*>(p)[i];
    case kI8: return static_cast<uint64_t>(
        static_cast<int64_t>(static_cast<const int8_t*>(p)[i]));
    case kI16: return static_cast<uint64_t>(
        static_cast<int64_t>(static_cast<const int16_t*>(p)[i]));
    case kU16: case kF16: return static_cast<const uint16_t*>(p)[i];
    case kI32: return static_cast<uint64_t>(
        static_cast<int64_t>(static_cast<const int32_t*>(p)[i]));
    case kU32: case kF32: return static_cast<const uint32_t*>(p)[i];
    default: return static_cast<const uint64_t*>(p)[i];
  }
}

__device__ __forceinline__ void store(void* p, int64_t i, int dt,
                                      uint64_t v) {
  switch (npops::width_bits(dt)) {
    case 8: static_cast<uint8_t*>(p)[i] = static_cast<uint8_t>(v); break;
    case 16: static_cast<uint16_t*>(p)[i] = static_cast<uint16_t>(v); break;
    case 32: static_cast<uint32_t*>(p)[i] = static_cast<uint32_t>(v); break;
    default: static_cast<uint64_t*>(p)[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
    expr_core_kernel(const int32_t* __restrict__ prog, int n_words,
                     int64_t n, Columns cols) {
  extern __shared__ int32_t sp[];
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) sp[i] = prog[i];
  __syncthreads();
  const int n_in = sp[0], n_instr = sp[1], n_out = sp[2];
  npops::NanBits nb;
  nb.f64 = static_cast<uint64_t>(static_cast<uint32_t>(sp[4])) |
           (static_cast<uint64_t>(static_cast<uint32_t>(sp[5])) << 32);
  nb.f32 = static_cast<uint32_t>(sp[6]);
  const int32_t* in_dt = sp + kHeader;
  const int32_t* code = in_dt + n_in;
  const int32_t* outs = code + n_instr * kInstrWords;
  uint64_t reg[kMaxRegs];
  for (int64_t row = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       row < n; row += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    for (int k = 0; k < n_in; ++k) {
      reg[k] = load(cols.in[k], row * cols.in_step[k], in_dt[k]);
    }
    for (int j = 0; j < n_instr; ++j) {
      const int32_t* c = code + j * kInstrWords;
      reg[c[7]] = npops::apply(c[0], reg[c[1]], c[5], reg[c[2]], c[6], c[3],
                               c[4], nb);
    }
    for (int k = 0; k < n_out; ++k) {
      store(cols.out[k], row, outs[2 * k + 1], reg[outs[2 * k]]);
    }
  }
}

int run(int device, const int32_t* prog, int n_words, int64_t n, int n_in,
        int n_out, const int64_t* ptrs, void* stream) {
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  if (n_in > kMaxIn || n_out > kMaxOut || n_in < 0 || n_out < 0 ||
      n_words <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaSuccess);
  Columns cols;
  for (int k = 0; k < n_in; ++k) {
    cols.in[k] = reinterpret_cast<const void*>(ptrs[k]);
    cols.in_step[k] = ptrs[n_in + k];
  }
  for (int k = 0; k < n_out; ++k) {
    cols.out[k] = reinterpret_cast<void*>(ptrs[2 * n_in + k]);
  }
  const size_t smem = static_cast<size_t>(n_words) * sizeof(int32_t);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  expr_core_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(prog, n_words, n,
                                                          cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper's arguments as one block of int64 (kernels/nvcc.py
// ``launch``): device, program, n_words, n, n_in, n_out, then n_in input
// pointers, n_in input steps (1, or 0 for a constant), n_out output
// pointers, and the stream last.
extern "C" int repro_expr_core(const int64_t* a, int n) {
  if (n < 7) return static_cast<int>(cudaErrorInvalidValue);
  const int n_in = static_cast<int>(a[4]), n_out = static_cast<int>(a[5]);
  if (n != 7 + 2 * n_in + n_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(static_cast<int>(a[0]), reinterpret_cast<const int32_t*>(a[1]),
             static_cast<int>(a[2]), a[3], n_in, n_out, a + 6,
             reinterpret_cast<void*>(a[n - 1]));
}
