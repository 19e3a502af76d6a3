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
// block owns one (b, h, 128-row q tile) and walks the kv tiles in a loop,
// keeping the state in registers. At the prefill shape the work is bound
// by tensor-core operations (see kernels/flash_attention.py), and on
// Hopper only wgmma reaches the tensor cores' full rate. So the bf16 path
// is warp-specialised:
//   - one producer warp (in a warpgroup that gives its registers away with
//     setmaxnreg) loads the Q tile once, then K and V tiles through a ring
//     of stages in dynamic shared memory with TMA (cp.async.bulk.tensor),
//     each stage guarded by a full and an empty mbarrier;
//   - two consumer warpgroups, 64 q rows each, run S = Q K^T as wgmma with
//     Q and K read from shared memory (K-major descriptors), the online
//     softmax in float32 registers (ex2 with the scale folded into
//     log2 e, one FFMA an element), and O += P V as wgmma of N = hd with P
//     taken from registers (the score accumulators rounded to bf16 A
//     fragments, as the plain path casts the softmax weights to v's
//     dtype) and V from shared memory (MN-major: the transpose bit);
//   - the softmax is hidden under the tensor cores twice: within a
//     warpgroup S(t) is issued together with P V(t-1) and the softmax of
//     S(t) runs while P V(t-1) is still running; between the two
//     warpgroups the issue of products takes turns (named barriers), so
//     one warpgroup's softmax runs under the other's products;
//   - the output is normalised, written to the consumer's own rows of the
//     Q tile in shared memory and stored with TMA, which clips rows >= S.
// Tiles are swizzled (128 B for rows of 64/128/192/256 bf16, 64 B for 32
// and 96, 32 B for 16) in chunks of one swizzle span of columns, so each
// TMA box and each wgmma operand is one canonical layout. The plan per
// head dim (q tile, kv tile, stages, swizzle, shared-memory bytes) is
// Plan<HD> below; the wrapper computes the same plan and the C entry
// refuses a call whose plan differs. Device memory sees Q, K, V and O once
// (K and V again from L2 for the q heads of one kv head).
//
// Inputs are read in the JAX layout through strides (q (B,S,H,hd), k/v
// (B,T,K,hd), head dim contiguous, 16-byte aligned base and strides): the
// tensor maps are encoded per call from the strides, so nothing is
// transposed or padded in device memory. cuTensorMapEncodeTiled is a
// driver function, reached through cudaGetDriverEntryPoint so that the
// library needs no -lcuda (hopper.cuh, with the PTX wrappers the port's
// kernels share). The f32 path is a plain FMA kernel of the same
// algorithm (the check path, not the model's). The C entry point returns
// cudaGetLastError() after the launch.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;  // the f32 kernel: 4 warps
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSmemLimit = 232448;  // opt-in shared memory of one block

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------- Hopper primitives (PTX)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Keep registers that an asynchronous wgmma reads or writes where they
// are until it has completed: the compiler may not move them across.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), layout (1: 128 B swizzle, 2: 64 B,
// 3: 32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// d (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (64 x 16, smem,
// K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// d (64 x 80, f32) (+)= A (64 x 16, smem, K-major) * B (80 x 16, smem,
// K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n80(float (&d)[40], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// d (64 x 128, f32) (+)= A (64 x 16, smem, K-major) * B (128 x 16, smem,
// K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d)
      : "memory");
}

// d (64 x 16, f32) += A (64 x 16, bf16 registers) * B (16 x 16, smem,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 32, f32) += A (64 x 16, bf16 registers) * B (16 x 32, smem,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 96, f32) += A (64 x 16, bf16 registers) * B (16 x 96, smem,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 192, f32) += A (64 x 16, bf16 registers) * B (16 x 192, smem,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d (64 x 256, f32) += A (64 x 16, bf16 registers) * B (16 x 256, smem,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, scale_d);
  else if constexpr (N == 80) wgmma_ss_n80(d, da, db, scale_d);
  else wgmma_ss_n128(d, da, db, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// ------------------------------------------------------------------ bf16
constexpr int kConsumers = 2;  // consumer warpgroups, 64 q rows each
constexpr int kHopperThreads = (kConsumers + 1) * 128;  // + the producer's
constexpr int kProducerRegs = 24;  // setmaxnreg: 128 x 24 + 256 x 240
constexpr int kConsumerRegs = 240;  // <= 65,536 registers of the SM

// The tile plan of one head dim; kernels/flash_attention.py's plan()
// computes the same numbers.
template <int HD>
struct Plan {
  // columns of one swizzle span: 64 (128 B) where they divide hd, else 32
  // (64 B) or 16 (32 B)
  static constexpr int kCW = HD % 64 == 0 ? 64 : (HD % 32 == 0 ? 32 : 16);
  static constexpr int kSwizzle = 2 * kCW;  // bytes
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : kSwizzle == 64 ? 2 : 3;
  static constexpr int kChunks = HD / kCW;
  static constexpr int kBM = 128;  // q rows per block
  // kv rows per tile: fewer where O's hd/2 floats a thread leave fewer
  // registers (64 at hd 192 keeps three stages; 80 at 256, two)
  static constexpr int kBN = HD <= 128 ? 128 : HD == 192 ? 64 : 80;
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kQChunk = kBM * kCW * 2;
  static constexpr int kKVChunk = kBN * kCW * 2;
  static constexpr int kTileBytes = kBN * HD * 2;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kFit = (kSmemLimit - kQBytes - 1024 - 128) / kStageBytes;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  // 1 KB to align the swizzled tiles, Q, the ring, the barriers
  static constexpr int kSmem =
      1024 + kQBytes + kStages * kStageBytes + 8 * (1 + 3 * kStages);
  static_assert(kStages >= 2 && kSmem <= kSmemLimit, "plan does not fit");
};

template <int HD>
__global__ void __launch_bounds__(kHopperThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_o, const Params p) {
  using P = Plan<HD>;
  constexpr int CW = P::kCW, BN = P::kBN, ST = P::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* const gbase = smem_raw + (base - raw);  // generic view
  const uint32_t bars = base + P::kQBytes + ST * P::kStageBytes;
  const uint32_t full_q = bars;
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + ST + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * ST + s); };
  auto k_tile = [&](int s) { return base + P::kQBytes + s * P::kStageBytes; };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * P::kBM;  // long rows first
  const int kvh = static_cast<int>(h / (p.H / p.K));
  const int n_tiles = kv_tiles(p, q_start, P::kBM, BN);
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_expect_tx(full_q, P::kQBytes);
#pragma unroll
      for (int c = 0; c < P::kChunks; ++c)
        tma_load_4d(base + c * P::kQChunk, &tm_q, full_q, c * CW, q_start, h,
                    b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % ST;
        mbar_wait(empty(s), ((t / ST) & 1) ^ 1);  // round 0 passes at once
        const uint32_t kt = k_tile(s), vt = kt + P::kTileBytes;
        mbar_expect_tx(full_k(s), P::kTileBytes);
#pragma unroll
        for (int c = 0; c < P::kChunks; ++c)
          tma_load_4d(kt + c * P::kKVChunk, &tm_k, full_k(s), c * CW, t * BN,
                      kvh, b);
        mbar_expect_tx(full_v(s), P::kTileBytes);
#pragma unroll
        for (int c = 0; c < P::kChunks; ++c)
          tma_load_4d(vt + c * P::kKVChunk, &tm_v, full_v(s), c * CW, t * BN,
                      kvh, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int wg_q0 = q_start + 64 * wg;  // this warpgroup's first q row
    const bool has_rows = wg_q0 < p.S;
    const int wg_last = has_rows ? wg_q0 + rows_below(p.S, wg_q0, 64) - 1 : 0;
    const int row0 = wg_q0 + warp * 16 + lane / 4;  // this thread's rows: +0, +8
    constexpr uint32_t kSBO = 8 * CW * 2;  // bytes between 8-row groups

    // O: 64 rows x hd, accumulator i at column 8 (i / 4) + 2 (lane % 4) +
    // i % 2 of row row0 + 8 (i / 2 % 2), as every wgmma accumulator.
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNeg, kNeg};
    float l[2] = {0.f, 0.f};  // per-thread partial sums, reduced at the end

    // The tiles this warpgroup's rows see: under the causal mask the
    // later tiles of the block may lie wholly above its rows.
    int n_own = has_rows ? n_tiles : 0;
    if (p.causal && has_rows) n_own = min(n_own, wg_last / BN + 1);
    auto k_stage = [&](int t) { return k_tile(t % ST); };
    auto parity = [&](int t) { return static_cast<uint32_t>((t / ST) & 1); };
    auto release = [&](int t) {  // one arrival per warp on the empty barrier
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(t % ST));
    };
    // S = Q K(t)^T for this warpgroup's 64 rows x BN kv columns (issued,
    // not waited for).
    auto issue_s = [&](float (&sc)[BN / 2], int t) {
      const uint32_t kt = k_stage(t);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk * 16 / CW, kin = (kk * 16 % CW) * 2;
        const uint64_t da = make_desc(
            base + c * P::kQChunk + wg * 64 * CW * 2 + kin, 16, kSBO,
            P::kLayout);
        const uint64_t db =
            make_desc(kt + c * P::kKVChunk + kin, 16, kSBO, P::kLayout);
        wgmma_ss<BN>(sc, da, db, kk > 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    // O += P V(t) (issued, not waited for): one wgmma of N = hd per
    // 16 kv rows, V MN-major, its column chunks kKVChunk bytes apart.
    auto issue_pv = [&](const uint32_t (&pa)[BN / 16][4], int t) {
      const uint32_t vt = k_stage(t) + P::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = make_desc(vt + kk * 16 * CW * 2, P::kKVChunk,
                                      kSBO, P::kLayout);
        wgmma_rs<HD>(o, pa[kk], db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    };
    // Online softmax of tile t in place: mask, the running max m (in log2
    // units), corr = 2^(m_old - m_new), sc = 2^(s scale log2 e - m), l.
    // Accumulator i holds column 8 (i / 4) + 2 (lane % 4) + i % 2 of row
    // row0 + 8 (i / 2 % 2).
    auto softmax = [&](float (&sc)[BN / 2], int t, float (&corr)[2]) {
      const int kv_start = t * BN;
      if (kv_start + BN > p.T || (p.causal && kv_start + BN - 1 > wg_q0)) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) {
          const int kidx = kv_start + (i / 4) * 8 + 2 * (lane % 4) + (i & 1);
          const int qidx = row0 + ((i / 2) & 1) * 8;
          if (kidx >= p.T || (p.causal && kidx > qidx)) sc[i] = kNeg;
        }
      }
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]) * p.scale_log2);
        corr[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i / 2) & 1;
        sc[i] = ex2(fmaf(sc[i], p.scale_log2, -m[r]));
        sum[r] += sc[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
    };
    // P rounded to bf16 as wgmma A fragments: k-step kk covers columns
    // 16 kk .. 16 kk + 15, i.e. accumulators 8 kk .. 8 kk + 7.
    auto pack = [&](const float (&sc)[BN / 2], uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
    };
    auto hold_p = [&](uint32_t (&pa)[BN / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) hold(pa[kk]);
    };

    // Two pipelines. Within a warpgroup, S(t) = Q K(t)^T is issued with
    // O += P(t-1) V(t-1), and the softmax of S(t) runs while P V(t-1) is
    // still on the tensor cores. Between the two warpgroups, the issue
    // of each turn's products alternates (named barriers 3 and 4: a
    // warpgroup waits on its own, then arrives on the other's), so that
    // one warpgroup's softmax runs under the other's products. Each takes
    // n_tiles + 1 turns, whatever its own rows see; warpgroup 1 does not
    // hand its last turn on.
    const int gate_mine = 3 + wg, gate_other = 4 - wg;
    int turns = 0;
    auto take_turn = [&]() { named_barrier(gate_mine, 256); };
    auto pass_turn = [&]() {
      if (wg == 0 || ++turns <= n_tiles) named_arrive(gate_other, 256);
    };
    mbar_wait(full_q, 0);
    if (wg == 1) named_arrive(gate_other, 256);  // warpgroup 0 goes first
    if (n_own > 0) {
      float sc[BN / 2];
      uint32_t pa[BN / 16][4];
      float corr[2];
      mbar_wait(full_k(0), 0);
      take_turn();
      wgmma_fence();
      issue_s(sc, 0);
      pass_turn();
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      hold(sc);
      softmax(sc, 0, corr);
      pack(sc, pa);
      for (int t = 1; t < n_own; ++t) {
        mbar_wait(full_k(t % ST), parity(t));
        mbar_wait(full_v((t - 1) % ST), parity(t - 1));
        take_turn();
        wgmma_fence();
        issue_s(sc, t);
        issue_pv(pa, t - 1);
        pass_turn();
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        hold(sc);
        softmax(sc, t, corr);
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        hold(o);
        hold_p(pa);
        release(t - 1);
#pragma unroll
        for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i / 2) & 1];
        pack(sc, pa);
      }
      mbar_wait(full_v((n_own - 1) % ST), parity(n_own - 1));
      take_turn();
      wgmma_fence();
      issue_pv(pa, n_own - 1);
      pass_turn();
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      hold(o);
      hold_p(pa);
      release(n_own - 1);
    } else {
      take_turn();  // the turn of a prologue this warpgroup does not run
      pass_turn();
    }
    // Tiles the block loads that these rows cannot see: released once
    // landed, so that the empty barrier counts one round per tile; their
    // turns are passed on.
    for (int t = n_own; t < n_tiles; ++t) {
      mbar_wait(full_k(t % ST), parity(t));
      mbar_wait(full_v(t % ST), parity(t));
      release(t);
      take_turn();
      pass_turn();
    }
    if (!has_rows) return;

    // Normalise, round to bf16 into this warpgroup's rows of the Q tile
    // (its own rows only: the other warpgroup may still read its own),
    // swizzled as TMA expects, then store with TMA.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
    constexpr uint32_t kMask = P::kSwizzle / 16 - 1;
#pragma unroll
    for (int i = 0; i < HD / 2; i += 2) {
      const int r = (i / 2) & 1;
      const uint32_t row = wg * 64 + warp * 16 + lane / 4 + 8 * r;
      const uint32_t col = (i / 4) * 8 + 2 * (lane % 4);
      uint32_t off = (col / CW) * P::kQChunk + row * CW * 2 + (col % CW) * 2;
      off ^= ((off >> 7) & kMask) << 4;
      *reinterpret_cast<uint32_t*>(gbase + off) =
          pack_bf16(o[i] * inv[r], o[i + 1] * inv[r]);
    }
    fence_async_smem();
    named_barrier(1 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < P::kChunks; ++c)
        tma_store_4d(&tm_o, base + c * P::kQChunk + wg * 64 * CW * 2, c * CW,
                     wg_q0, h, b);
      bulk_commit();
      bulk_wait_read<0>();
    }
  }
}

// ------------------------------------------------------------------- f32
constexpr int kBMF = 32;  // q rows per block; 4 threads per row
constexpr int kBNF = 32;  // kv rows per tile

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_f32(const Params p) {
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
cudaError_t launch_f32(Kernel kernel, size_t smem_bytes, const Params& p,
                       int64_t B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(p.H), static_cast<unsigned>(B),
                  static_cast<unsigned>((p.S + kBMF - 1) / kBMF));
  kernel<<<grid, kThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

// ------------------------------------------------------- host: tensor maps
// The 4-d bf16 tensor map of a (batch, rows, heads, hd) tensor with element
// strides (sb, sr, sh) and a contiguous head dim, read in boxes of
// (box_cols, box_rows, 1, 1). A dimension of extent 1 gets a stride that
// continues the one below it (its stride is never used).
bool encode_map(CUtensorMap* map, const void* ptr, int64_t batch,
                int64_t rows, int64_t heads, int64_t hd, int64_t sb,
                int64_t sr, int64_t sh, int box_cols, int box_rows,
                int swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const int64_t given[3] = {sr, sh, sb};
  cuuint64_t strides[3];
  int64_t below = hd * 2;  // bytes spanned by the dimensions below
  for (int i = 0; i < 3; ++i) {
    strides[i] = static_cast<cuuint64_t>(dims[i + 1] == 1 ? below
                                                          : given[i] * 2);
    below = static_cast<int64_t>(strides[i]) *
            static_cast<int64_t>(dims[i + 1]);
  }
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw =
      swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_bf16(const Params& p, int64_t B, cudaStream_t stream) {
  using P = Plan<HD>;
  CUtensorMap tq, tk, tv, to;
  if (!encode_map(&tq, p.q, B, p.S, p.H, HD, p.sqb, p.sqs, p.sqh, P::kCW,
                  P::kBM, P::kSwizzle) ||
      !encode_map(&tk, p.k, B, p.T, p.K, HD, p.skb, p.sks, p.skh, P::kCW,
                  P::kBN, P::kSwizzle) ||
      !encode_map(&tv, p.v, B, p.T, p.K, HD, p.svb, p.svs, p.svh, P::kCW,
                  P::kBN, P::kSwizzle) ||
      !encode_map(&to, p.o, B, p.S, p.H, HD, p.sob, p.sos, p.soh, P::kCW, 64,
                  P::kSwizzle))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(p.H), static_cast<unsigned>(B),
                  static_cast<unsigned>((p.S + P::kBM - 1) / P::kBM));
  flash_fwd_bf16<HD><<<grid, kHopperThreads, P::kSmem, stream>>>(tq, tk, tv,
                                                                  to, p);
  return cudaGetLastError();
}

// The plan the caller computed, against this instance's: q tile, kv tile,
// stages, swizzle bytes, shared-memory bytes.
template <int HD>
cudaError_t dispatch(int dtype, const int (&plan)[5], const Params& p,
                     int64_t B, cudaStream_t stream) {
  if (dtype == 1) {
    using P = Plan<HD>;
    const int want[5] = {P::kBM, P::kBN, P::kStages, P::kSwizzle, P::kSmem};
    for (int i = 0; i < 5; ++i)
      if (plan[i] != want[i]) return cudaErrorInvalidValue;
    return launch_bf16<HD>(p, B, stream);
  }
  const int smem =
      ((kBMF + kBNF) * (HD + 1) + kBNF * HD + kBMF * (kBNF + 1)) *
      static_cast<int>(sizeof(float));
  const int want[5] = {kBMF, kBNF, 1, 0, smem};
  for (int i = 0; i < 5; ++i)
    if (plan[i] != want[i]) return cudaErrorInvalidValue;
  return launch_f32(flash_fwd_f32<HD>, smem, p, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the head dim
// is contiguous. q_tile .. smem_bytes: the wrapper's plan for (hd, dtype),
// refused unless it is this library's. Returns a cudaError_t (0 on
// success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int64_t B,
    int64_t S, int64_t T, int64_t H, int64_t K, int64_t hd, int64_t sqb,
    int64_t sqs, int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
    int64_t svb, int64_t svs, int64_t svh, int64_t sob, int64_t sos,
    int64_t soh, int dtype, int causal, float scale, int q_tile,
    int kv_tile, int stages, int swizzle, int smem_bytes, void* stream) {
  if ((dtype != 0 && dtype != 1) || K <= 0 || H % K != 0 || S <= 0 ||
      T <= 0 || B <= 0 || B > 65535 || (S + 31) / 32 > 65535 ||
      H > INT32_MAX || S > INT32_MAX / 2 || T > INT32_MAX / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q,   k,   v,   o,   S,   T,   H,   K,   sqb,
                 sqs, sqh, skb, sks, skh, svb, svs, svh, sob,
                 sos, soh, causal, scale * kLog2e};
  const int plan[5] = {q_tile, kv_tile, stages, swizzle, smem_bytes};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return static_cast<int>(dispatch<16>(dtype, plan, p, B, st));
    case 32: return static_cast<int>(dispatch<32>(dtype, plan, p, B, st));
    case 64: return static_cast<int>(dispatch<64>(dtype, plan, p, B, st));
    case 96: return static_cast<int>(dispatch<96>(dtype, plan, p, B, st));
    case 128: return static_cast<int>(dispatch<128>(dtype, plan, p, B, st));
    case 192: return static_cast<int>(dispatch<192>(dtype, plan, p, B, st));
    case 256: return static_cast<int>(dispatch<256>(dtype, plan, p, B, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
