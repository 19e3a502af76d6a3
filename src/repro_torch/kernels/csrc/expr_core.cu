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
// registers of shared memory (a slot per thread and register: indexed by
// the program, they would sit in local memory), each of the dtype the
// host's zero-row probe recorded; each instruction converts its inputs
// into numpy's loop dtypes (np.ufunc.resolve_dtypes, worked out on the
// host) and computes as numpy_ops.cuh says: rounded intrinsics (no
// contraction into an FMA), the host's NaNs, integer wrap. A kernel
// generated per signature would cost an nvcc build each; this one is
// built once.
//
// Inputs and outputs: a column may lie in device memory or in pinned host
// memory, which the kernel reads and writes through its device-mapped
// address, so that a batch crosses the host link once each way with no
// copy of its own. The C entry asks cudaPointerGetAttributes about every
// pointer and refuses one the card cannot reach (pageable host memory).
//
// What bounds it: at the executor's 8,192-row batches a launch reads and
// writes a few hundred KB, a microsecond of device-memory time; from
// pinned host memory, the same bytes over the host link and the launch
// itself are the time. The C entry point takes the device index and
// returns a cudaError_t.
#include "hopper.cuh"
#include "numpy_ops.cuh"

namespace {

using namespace hopper;

constexpr int kMaxIn = 64;     // input columns of one run
constexpr int kMaxOut = 64;    // columns returned
constexpr int kMaxRegs = 128;  // values of one row
constexpr int kThreads = 256;
constexpr size_t kRegBytes = 96 * 1024;  // shared memory for registers
constexpr int kLoads = 8;  // input loads of a row in flight together

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
                     int n_regs, int64_t n,
                     const __grid_constant__ Columns cols) {
  // regs: register r of thread t at reg[r * blockDim.x + t]; then the
  // program's words
  extern __shared__ uint64_t smem[];
  uint64_t* reg = smem + threadIdx.x;
  int32_t* sp = reinterpret_cast<int32_t*>(smem + n_regs * blockDim.x);
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) sp[i] = prog[i];
  __syncthreads();
  const int n_in = sp[0], n_instr = sp[1], n_out = sp[2];
  const int stride = blockDim.x;
  npops::NanBits nb;
  nb.f64 = static_cast<uint64_t>(static_cast<uint32_t>(sp[4])) |
           (static_cast<uint64_t>(static_cast<uint32_t>(sp[5])) << 32);
  nb.f32 = static_cast<uint32_t>(sp[6]);
  const int32_t* in_dt = sp + kHeader;
  const int32_t* code = in_dt + n_in;
  const int32_t* outs = code + n_instr * kInstrWords;
  for (int64_t row = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       row < n; row += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    // a row's inputs loaded kLoads at a time before any is stored, so
    // that their reads (over the host link, from pinned memory) overlap
    for (int k0 = 0; k0 < n_in; k0 += kLoads) {
      uint64_t x[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (k0 + u < n_in) {
          x[u] = load(cols.in[k0 + u], row * cols.in_step[k0 + u],
                      in_dt[k0 + u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (k0 + u < n_in) reg[(k0 + u) * stride] = x[u];
      }
    }
    for (int j = 0; j < n_instr; ++j) {
      const int32_t* c = code + j * kInstrWords;
      reg[c[7] * stride] = npops::apply(c[0], reg[c[1] * stride], c[5],
                                        reg[c[2] * stride], c[6], c[3], c[4],
                                        nb);
    }
    for (int k = 0; k < n_out; ++k) {
      store(cols.out[k], row, outs[2 * k + 1], reg[outs[2 * k] * stride]);
    }
  }
}

// The address at which `device` reaches p: p itself in its own memory,
// the device-mapped address of pinned host memory; null for memory the
// card cannot reach (pageable host memory, another card's memory).
void* reachable(const void* p, int device) {
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, p) != cudaSuccess) {
    cudaGetLastError();  // clear the error
    return nullptr;
  }
  switch (attr.type) {
    case cudaMemoryTypeDevice:
    case cudaMemoryTypeManaged:
      return attr.device == device ? attr.devicePointer : nullptr;
    case cudaMemoryTypeHost:
      return attr.devicePointer;
    default:
      return nullptr;
  }
}

int run(int device, const int32_t* prog, int n_words, int n_regs, int64_t n,
        int n_in, int n_out, const int64_t* ptrs, void* stream) {
  DeviceGuard guard(device);
  if (guard.error != cudaSuccess) return static_cast<int>(guard.error);
  if (n_in > kMaxIn || n_out > kMaxOut || n_in < 0 || n_out < 0 ||
      n_words <= 0 || n_regs <= 0 || n_regs > kMaxRegs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaSuccess);
  Columns cols;
  const void* words = reachable(prog, device);
  bool ok = words != nullptr;
  for (int k = 0; k < n_in; ++k) {
    cols.in[k] = reachable(reinterpret_cast<const void*>(ptrs[k]), device);
    cols.in_step[k] = ptrs[n_in + k];
    ok = ok && cols.in[k] != nullptr;
  }
  for (int k = 0; k < n_out; ++k) {
    cols.out[k] = reachable(reinterpret_cast<void*>(ptrs[2 * n_in + k]),
                            device);
    ok = ok && cols.out[k] != nullptr;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidHostPointer);
  // fewer threads a block for a long program: its registers fill shared
  // memory
  int threads = kThreads;
  while (threads > 32 &&
         static_cast<size_t>(n_regs) * threads * 8 > kRegBytes) {
    threads /= 2;
  }
  const size_t smem = static_cast<size_t>(n_regs) * threads * 8 +
                      static_cast<size_t>(n_words) * sizeof(int32_t);
  static int allowed = 48 * 1024;
  cudaError_t err = allow_smem(expr_core_kernel, static_cast<int>(smem),
                               allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  expr_core_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(words), n_words, n_regs, n, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The wrapper's arguments as one block of int64 (kernels/nvcc.py
// ``launch``): device, program, n_words, n_regs, n, n_in, n_out, then n_in
// input pointers, n_in input steps (1, or 0 for a constant), n_out output
// pointers, and the stream last. Each pointer lies in the device's memory
// or in pinned host memory; cudaErrorInvalidHostPointer refuses another.
extern "C" int repro_expr_core(const int64_t* a, int n) {
  if (n < 8) return static_cast<int>(cudaErrorInvalidValue);
  const int n_in = static_cast<int>(a[5]), n_out = static_cast<int>(a[6]);
  if (n != 8 + 2 * n_in + n_out) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(static_cast<int>(a[0]), reinterpret_cast<const int32_t*>(a[1]),
             static_cast<int>(a[2]), static_cast<int>(a[3]), a[4], n_in,
             n_out, a + 7, reinterpret_cast<void*>(a[n - 1]));
}
