// Paged decode attention for NVIDIA Hopper (sm_90a), written by hand:
// split-sequence flash-decoding with a fixed-order combine pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_attention.py:65
// (paged_attention, body _kernel). Same function: one query token per
// sequence attends to a KV cache stored as fixed-size pages of a pool
// (P, page, K, hd), following the sequence's row of a block table of global
// page ids (-1 = hole). Scale hd^-0.5; position pos of page slot p is valid
// when pos < length[b] and table[b, p] >= 0; the G = H / K query heads of
// kv head kh (heads kh*G .. kh*G+G-1) share its pages; the softmax is in
// float32 and P V accumulates in float32; the output is cast to q's dtype.
// A row with no valid position (length 0, or holes only) gives what the
// reference gives there, where every score is -1e30 and the softmax is
// uniform: the mean of V over all max_pages * page gathered positions, each
// page read at max(id, 0).
//
// What bounds it: a decode step reads each cached K and V row once and does
// ~4 G flops per pair of elements read, so device-memory bytes bound it. At
// the smoke's decode shapes (chip_smoke.py PAGED_CASES, H100 at 3.35 TB/s):
// qwen2.5-32b (B=32, 40/8 heads, hd 128, 64 pages of 64) 0.0800 ms; jamba
// (B=8, 64/8 heads, 32 pages of 128) 0.0246 ms; qwen2-moe (B=4, 16/16
// heads, 8 pages of 64) 0.0033 ms, under one launch's latency.
//
// Design, against what held the one-block-per-(sequence, kv head) version
// back:
// - Too few blocks, uneven rows: each sequence is split into spans of a
//   fixed number of pages (flash-decoding). One block owns (span, kv head,
//   chunk of query heads, sequence); the wrapper picks the span length from
//   the static shapes only (B, K, G, max_pages, page), so that the grid
//   holds about four blocks per SM and a 4,096-token row is spread over
//   several blocks; the launch never depends on lengths on the device. A
//   block whose span starts past its row's length writes an empty partial
//   (max -1e30, sum 0) and exits.
// - Too few bytes in flight, barriers per page: every warp of a block runs
//   its own two-stage cp.async pipeline over chunks of the span (16
//   positions in bf16, 32 in float32), each position's K and V row for
//   this kv head copied as 16-byte words straight into shared memory
//   (zero-filled for holes and positions past the span), the next chunk's
//   copies in flight while this one is computed. Warps synchronise only
//   within themselves (__syncwarp) until the end of the span; each keeps
//   its own running max, sum and accumulator, and the block merges its
//   warps once, in warp order. Above 48 KB of shared memory the launch opts
//   in to what it asks for, up to the device's limit, and asks for the SM's
//   whole unified memory as shared memory (the carveout), so that three
//   blocks of ~73 KB fit an SM at hd 128.
// - Padding waste and shuffled dot products: in bf16, q K^T and P V run on
//   tensor cores (mma.sync m16n8k16, float32 accumulators) with the chunk's
//   query heads as the 16 rows of A; for G <= 8 the upper 8 rows are fed
//   zeros and their accumulator registers are not kept. P enters the P V
//   mma rounded to bf16 (as in FlashAttention; the running sum adds the
//   float32 probabilities), where the Pallas body keeps P in float32: a
//   relative error of at most 2^-8 a probability, the size of the bf16
//   output's own rounding (PERF.md gives the errors against the float32
//   answer; ref.paged_attention_split_ref rounds P the same way). In
//   float32 there are no tensor cores without TF32, which the 2e-5
//   tolerance rules out: each lane dots one position's K row with the G
//   query rows from shared memory (no shuffles), and P V runs with the
//   lanes over the head dim; the register arrays are sized by the exact G
//   (instances G = 1..8). A block takes at most 16 query heads in bf16
//   (one tile's rows) and 8 in float32; the entry point splits a larger G
//   into equal chunks.
// - Head dims: any hd up to 256 whose row is a whole number of 16-byte
//   words (bf16: multiples of 8; float32: multiples of 4). bf16 instances
//   are sized for hd <= 64, 128, 192 and 256: staged rows are that wide,
//   zero past hd, so the tensor-core loops have no branch on hd.
// - The combine: when a row has several spans, each block writes its
//   partial (max in log2 units, sum, float32 accumulator of G x hd) to
//   scratch, and a second kernel, one block per (query head, kv head,
//   sequence), merges the spans in span order by the log-sum-exp rule
//   (runs of consecutive spans summed in parallel, then the runs in
//   order): no atomics, the same bytes every run. A row whose every span is empty has no valid position and
//   gets the uniform mean of V there. With one span the first kernel
//   writes the output itself and the second is not launched.
// The C entry point returns cudaGetLastError() after the launches.
#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using hopper::smem_addr;

constexpr int kMaxWarps = 4;
constexpr int kStages = 2;
constexpr int kMlRows = 16;  // per-warp (max, sum) slots in shared memory
constexpr int kCombineThreads = 128;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int32_t* tables;
  const int32_t* lengths;
  void* out;        // (B, H, hd) in q's dtype
  float* part_acc;  // (B, K, n_spans, G, hd): when n_spans > 1
  float* part_ml;   // (B, K, n_spans, G, 2): max (log2 units), sum
  int64_t B, H, K, G, hd, page, max_pages;
  int64_t sqb, sqh;  // q strides (elements); the head dim is contiguous
  int64_t span_tokens, n_spans;
  int head_chunks, chunk_heads;  // query heads of a kv head per block
  int words;                     // 16-byte words per K or V row: hd*elem/16
  int q_vec;                     // q's rows 16-byte aligned
  float scale_log2;              // hd^-0.5 * log2(e)
};

// Shared memory of the split kernel, in bytes from the start:
//   [q rows][(max, sum) per warp and row][per warp: stages of K and V
//   chunks, the chunk's row offsets, (float32) the chunk's probabilities]
// The per-warp area is reused at the end for the warps' scaled
// accumulators and for the no-valid-position mean.
struct Layout {
  int ct;        // positions per warp chunk
  int row;       // bytes of one staged K or V row
  int q_bytes;
  int warp_off;  // start of the per-warp area
  int per_warp;
  int total;
};

// The bf16 instance for head dim hd: rows sized for hdb columns.
__host__ __device__ inline int bf16_bucket(int hd) {
  return hd <= 64 ? 64 : hd <= 128 ? 128 : hd <= 192 ? 192 : 256;
}

__host__ __device__ inline Layout make_layout(int elem, int hd, int qrows,
                                              int warps) {
  Layout l;
  l.ct = elem == 2 ? 16 : 32;
  // bf16 rows hold the instance's full width plus a 16-byte pad, zero past
  // hd, so that the tensor-core loops run the same steps for every hd of
  // the instance with no branch; the pad puts ldmatrix rows on distinct
  // banks. float32 rows carry 4 floats, for conflict-free float4 reads by
  // token.
  l.row = elem == 2 ? bf16_bucket(hd) * 2 + 16 : (hd + 4) * 4;
  l.q_bytes = elem == 2 ? qrows * l.row : qrows * hd * 4;
  l.warp_off = l.q_bytes + kMaxWarps * kMlRows * 2 * 4;
  l.per_warp = kStages * 2 * l.ct * l.row + l.ct * 8 +
               (elem == 4 ? 8 * 32 * 4 : 0);
  int body = warps * l.per_warp;
  const int sums = warps * kMlRows * hd * 4;
  const int mean = (hd > 1024 ? hd : 1024) * 4;
  if (sums > body) body = sums;
  if (mean > body) body = mean;
  l.total = l.warp_off + body;
  return l;
}

// ------------------------------------------------------------ helpers
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same with rows 8-15 of a zero: only the top 8 rows of d are kept.
__device__ __forceinline__ void mma_bf16(float (&d)[2], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  float lo, hi;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%10,%10};\n"
      : "+f"(d[0]), "+f"(d[1]), "=f"(lo), "=f"(hi)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float(float x) { return x; }
template <>
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float(float x) {
  return __float2bfloat16(x);
}

// Where a block of the split kernel works.
struct Pos {
  int64_t b, kh, span, s0, s_end;
  int g0, ng;
};

__device__ __forceinline__ Pos block_pos(const Params& p) {
  Pos ps;
  ps.span = blockIdx.x;
  ps.kh = blockIdx.y / p.head_chunks;
  ps.g0 = static_cast<int>(blockIdx.y % p.head_chunks) * p.chunk_heads;
  ps.ng = static_cast<int>(
      p.G - ps.g0 < p.chunk_heads ? p.G - ps.g0 : p.chunk_heads);
  ps.b = blockIdx.z;
  int64_t len = p.lengths[ps.b];
  const int64_t cap = p.max_pages * p.page;
  len = len < 0 ? 0 : (len > cap ? cap : len);
  ps.s0 = ps.span * p.span_tokens;
  ps.s_end = ps.s0 + p.span_tokens < len ? ps.s0 + p.span_tokens : len;
  return ps;
}

// The table entry of this lane's position in a chunk (lanes < CT; -1 past
// s_end, past the chunk or in a hole). Loaded a chunk ahead of its use, so
// that the table's latency hides behind the copies and math of the chunk
// before.
template <int CT>
__device__ __forceinline__ int32_t lookup(const Params& p,
                                          const int32_t* table, int pos0,
                                          int s_end, int lane) {
  const int pos = pos0 + lane;
  return lane < CT && pos < s_end ? table[pos / static_cast<int>(p.page)]
                                  : -1;
}

// Start copying the K and V rows of positions pos0 .. pos0+CT-1 (kv head
// kh; `id`, this lane's table entry from lookup) into one stage of this
// warp's buffers; invalid positions are zero-filled. Returns the mask of
// valid positions. One cp.async group is committed either way.
template <typename T, int CT>
__device__ __forceinline__ uint32_t issue_chunk(
    const Params& p, int32_t id, int64_t kh, int pos0, int64_t* offs,
    uint32_t kdst, uint32_t vdst, int row, int lane) {
  __syncwarp();  // every lane is done reading the last chunk's offsets
  int64_t off = -1;  // byte offset of this lane's K (and V) row
  if (lane < CT) {
    if (id >= 0) {
      const int page = static_cast<int>(p.page);
      const int pos = pos0 + lane;
      off = ((static_cast<int64_t>(id) * page + pos % page) * p.K + kh) *
            p.hd * static_cast<int64_t>(sizeof(T));
    }
    offs[lane] = off;
  }
  const uint32_t mask = __ballot_sync(0xffffffffu, off >= 0);
  __syncwarp();
  if (mask) {
    const char* kb = static_cast<const char*>(p.k_pages);
    const char* vb = static_cast<const char*>(p.v_pages);
    const int words = p.words;
    // this lane's copies: flat index lane + 32 i over (position, word)
    int t = lane / words;
    int w = lane - t * words;
    for (; t < CT;) {
      const int64_t o = offs[t];
      const bool ok = o >= 0;
      const int64_t byte = ok ? o + w * 16 : 0;
      const uint32_t at = t * row + w * 16;
      cp_async16(kdst + at, kb + byte, ok);
      cp_async16(vdst + at, vb + byte, ok);
      w += 32;
      while (w >= words) {
        w -= words;
        ++t;
      }
    }
  }
  cp_async_commit();
  return mask;
}

// Start copying this block's query rows (heads g0 .. g0+ng-1 of kv head
// kh) into `rows` rows of row_bytes in shared memory, zero past ng and
// past hd; 16-byte cp.async copies when q's rows are 16-byte aligned, else
// element by element. Commits one cp.async group either way.
template <typename T>
__device__ __forceinline__ void stage_q(const Params& p, const Pos& ps,
                                        unsigned char* q_s, int row_bytes,
                                        int rows) {
  constexpr int VEC = 16 / sizeof(T);
  const T* q = static_cast<const T*>(p.q) + ps.b * p.sqb +
               (ps.kh * p.G + ps.g0) * p.sqh;
  if (p.q_vec) {
    const int wpr = row_bytes / 16;
    for (int i = threadIdx.x; i < rows * wpr; i += blockDim.x) {
      const int r = i / wpr;
      const int w = i - r * wpr;
      const bool ok = r < ps.ng && w < p.words;
      cp_async16(smem_addr(q_s + r * row_bytes + w * 16),
                 ok ? q + r * p.sqh + w * VEC : q, ok);
    }
  } else {
    T* qs = reinterpret_cast<T*>(q_s);
    const int cols = row_bytes / static_cast<int>(sizeof(T));
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols;
      const int c = i - r * cols;
      qs[i] = r < ps.ng && c < p.hd ? q[r * p.sqh + c] : from_float<T>(0.f);
    }
  }
  cp_async_commit();
}

// Issue the k-th chunk of this warp's walk over the span (chunk warp + k *
// warps, into stage k % kStages): `id` holds this lane's table entry for
// it and is replaced by the entry for the chunk after. Returns the chunk's
// valid mask (0 past the span, after committing an empty group).
template <typename T, int CT>
__device__ __forceinline__ uint32_t issue_k(
    const Params& p, const int32_t* table, const Pos& ps, int k, int warp,
    int warps, int n_chunks, int32_t& id, int64_t* offs, uint32_t base,
    int stage_bytes, int rb, int lane) {
  const int c = warp + k * warps;
  const int s0 = static_cast<int>(ps.s0);
  const int32_t now = id;
  id = lookup<CT>(p, table, s0 + (c + warps) * CT, static_cast<int>(ps.s_end),
                  lane);
  if (c >= n_chunks) {
    cp_async_commit();
    return 0u;
  }
  const uint32_t dst = base + (k % kStages) * stage_bytes;
  return issue_chunk<T, CT>(p, now, ps.kh, s0 + c * CT, offs, dst,
                            dst + CT * rb, rb, lane);
}

// (max, sum) of local head g over the block's warps, in warp order.
__device__ __forceinline__ float2 block_ml(const float* ml_s, int warps,
                                           int g) {
  float m = kNeg;
  for (int w = 0; w < warps; ++w) m = fmaxf(m, ml_s[(w * kMlRows + g) * 2]);
  float l = 0.f;
  for (int w = 0; w < warps; ++w)
    l += ml_s[(w * kMlRows + g) * 2 + 1] *
         exp2f(ml_s[(w * kMlRows + g) * 2] - m);
  return make_float2(m, l);
}

// Output rows (b, kh*G + g0 .. + ng - 1) = the mean of V (kv head kh) over
// all max_pages * page gathered positions, each page read at max(id, 0):
// the reference's uniform softmax over a row with no valid position.
// Threads split (positions, 16-byte words); the partial sums are added in
// a fixed order through `red` (max(hd, 1024) floats). Block-wide.
template <typename T>
__device__ void write_mean(const Params& p, int64_t b, int64_t kh, int g0,
                           int ng, float* red) {
  constexpr int VEC = 16 / sizeof(T);
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int W = p.words;
  const int hd = static_cast<int>(p.hd);
  const int64_t n = p.max_pages * p.page;
  const int32_t* table = p.tables + b * p.max_pages;
  const T* vp = static_cast<const T*>(p.v_pages);
  T* out = static_cast<T*>(p.out);
  for (int w0 = 0; w0 < W; w0 += nthr) {
    const int wc = W - w0 < nthr ? W - w0 : nthr;
    const int R = nthr / wc;
    const int r = tid / wc;
    const int w = w0 + tid % wc;
    if (r < R) {
      float acc[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
      for (int64_t pos = r; pos < n; pos += R) {
        const int32_t id = table[pos / p.page];
        const int64_t at =
            ((static_cast<int64_t>(id < 0 ? 0 : id) * p.page + pos % p.page) *
                 p.K + kh) * p.hd + w * VEC;
        const uint4 raw = __ldg(reinterpret_cast<const uint4*>(vp + at));
        const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] += to_float(x[i]);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) red[r * hd + w * VEC + i] = acc[i];
    }
    __syncthreads();
    const int cols = wc * VEC;
    for (int e = tid; e < ng * cols; e += nthr) {
      const int g = e / cols;
      const int d = w0 * VEC + (e - g * cols);
      float total = 0.f;
      for (int rr = 0; rr < R; ++rr) total += red[rr * hd + d];
      out[(b * p.H + kh * p.G + g0 + g) * p.hd + d] =
          from_float<T>(total / static_cast<float>(n));
    }
    __syncthreads();
  }
}

// A block with no valid position in its span (with several spans): an
// empty partial for each of its heads.
__device__ __forceinline__ void write_empty(const Params& p, const Pos& ps) {
  if (threadIdx.x < ps.ng) {
    float* ml = p.part_ml + (((ps.b * p.K + ps.kh) * p.n_spans + ps.span) *
                                 p.G + ps.g0 + threadIdx.x) * 2;
    ml[0] = kNeg;
    ml[1] = 0.f;
  }
}

// The block's end, once every warp wrote its (max, sum) to ml_s and its
// accumulator, scaled to the block's max, to sums[(warp*16 + g)*hd + d]:
// sum the warps in order and write the output (one span) or the partial.
template <typename T>
__device__ void finish_block(const Params& p, const Pos& ps,
                             const float* ml_s, float* sums, int warps) {
  const int tid = threadIdx.x;
  const int hd = static_cast<int>(p.hd);
  // validity is per position, shared by the heads: one sum tells
  if (block_ml(ml_s, warps, 0).y == 0.f) {
    if (p.n_spans == 1)
      write_mean<T>(p, ps.b, ps.kh, ps.g0, ps.ng, sums);
    else
      write_empty(p, ps);
    return;
  }
  for (int e = tid; e < ps.ng * hd; e += blockDim.x) {
    const int g = e / hd;
    const int d = e - g * hd;
    const float2 ml = block_ml(ml_s, warps, g);
    float total = 0.f;
    for (int w = 0; w < warps; ++w) total += sums[(w * kMlRows + g) * hd + d];
    if (p.n_spans == 1) {
      static_cast<T*>(p.out)[(ps.b * p.H + ps.kh * p.G + ps.g0 + g) * p.hd +
                             d] = from_float<T>(total / ml.y);
    } else {
      const int64_t row =
          ((ps.b * p.K + ps.kh) * p.n_spans + ps.span) * p.G + ps.g0 + g;
      p.part_acc[row * p.hd + d] = total;
      if (d == 0) {
        p.part_ml[row * 2] = ml.x;
        p.part_ml[row * 2 + 1] = ml.y;
      }
    }
  }
}

// --------------------------------------------------------------- bf16
// HDB: the largest head dim of the instance (64, 128, 192 or 256); ROWS:
// 8 for up to 8 query heads per block, else 16.
template <int HDB, int ROWS>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    paged_split_bf16(const Params p) {
  constexpr int CT = 16;
  constexpr int NT = HDB / 8;   // 8-column tiles of the accumulator
  constexpr int KS = HDB / 16;  // 16-deep steps of q . k
  constexpr int NR = ROWS / 8;  // accumulator rows per thread: 1 or 2
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  const Pos ps = block_pos(p);
  if (ps.ng <= 0) return;
  if (p.n_spans > 1 && ps.s0 >= ps.s_end) {
    write_empty(p, ps);
    return;
  }
  const int hd = static_cast<int>(p.hd);
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const Layout lay = make_layout(2, hd, ROWS, warps);
  const int rb = lay.row;
  float* ml_s = reinterpret_cast<float*>(smem + lay.q_bytes);
  unsigned char* mine = smem + lay.warp_off + warp * lay.per_warp;
  int64_t* offs = reinterpret_cast<int64_t*>(mine + kStages * 2 * CT * rb);

  const int32_t* table = p.tables + ps.b * p.max_pages;
  const uint32_t q_base = smem_addr(smem);
  const uint32_t stage0 = smem_addr(mine);
  const int n_chunks = static_cast<int>((ps.s_end - ps.s0 + CT - 1) / CT);
  const int stage_bytes = 2 * CT * rb;
  // every staged K and V row past hd, zero (the copies write only hd
  // columns); the q rows and the first kStages - 1 chunks in flight
  // together
  {
    const int pad = (rb - hd * 2) / 16;  // 16-byte words past hd
    for (int i = lane; i < kStages * 2 * CT * pad; i += 32) {
      const int r = i / pad;
      *reinterpret_cast<uint4*>(mine + r * rb + hd * 2 + (i - r * pad) * 16) =
          make_uint4(0, 0, 0, 0);
    }
  }
  stage_q<T>(p, ps, smem, rb, ROWS);
  int32_t id = lookup<CT>(p, table, static_cast<int>(ps.s0) + warp * CT,
                          static_cast<int>(ps.s_end), lane);
  uint32_t masks[kStages];
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j)
    masks[j] = issue_k<T, CT>(p, table, ps, j, warp, warps, n_chunks, id, offs,
                              stage0, stage_bytes, rb, lane);
  cp_async_wait<kStages - 1>();  // q has landed
  __syncthreads();

  float acc[NT][2 * NR];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 2 * NR; ++i) acc[nt][i] = 0.f;
  float m[NR], l[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
  }

  for (int k = 0; warp + k * warps < n_chunks; ++k) {
    masks[kStages - 1] =
        issue_k<T, CT>(p, table, ps, k + kStages - 1, warp, warps, n_chunks,
                       id, offs, stage0, stage_bytes, rb, lane);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const uint32_t mask_cur = masks[0];
    if (mask_cur) {
      const uint32_t kb = stage0 + (k % kStages) * stage_bytes;
      const uint32_t vb = kb + CT * rb;
      // S (query heads x 16 positions) = q K^T, in two interleaved
      // chains of k-steps (columns past hd are zero on both sides)
      float s[2][4], s2[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = s2[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        {
          uint32_t a[4];
          if (ROWS == 16) {
            ldmatrix_x4(a, q_base + ((lane & 7) + ((lane >> 3) & 1) * 8) * rb +
                               (kk * 16 + (lane >> 4) * 8) * 2);
          } else {
            uint32_t r2[2];
            ldmatrix_x2(r2, q_base + (lane & 7) * rb +
                                (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
            a[0] = r2[0];
            a[1] = 0u;
            a[2] = r2[1];
            a[3] = 0u;
          }
          uint32_t bk[4];
          ldmatrix_x4(bk, kb + ((lane & 7) + (lane >> 4) * 8) * rb +
                              (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
          mma_bf16(kk & 1 ? s2[0] : s[0], a, bk[0], bk[1]);
          mma_bf16(kk & 1 ? s2[1] : s[1], a, bk[2], bk[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += s2[nt][e];
      // online softmax over the chunk, in log2 units; P as the A operand
      uint32_t pa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        float x[2][2];
        bool ok[2][2];
        float mx = kNeg;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int tok = nt * 8 + (lane & 3) * 2 + e;
            ok[nt][e] = (mask_cur >> tok) & 1u;
            x[nt][e] = ok[nt][e] ? s[nt][2 * r + e] * p.scale_log2 : kNeg;
            mx = fmaxf(mx, x[nt][e]);
          }
        mx = quad_max(mx);
        const float m_new = fmaxf(m[r], mx);
        const float corr = exp2f(m[r] - m_new);
        float pv[2][2];
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            pv[nt][e] = ok[nt][e] ? exp2f(x[nt][e] - m_new) : 0.f;
            sum += pv[nt][e];
          }
        l[r] = l[r] * corr + sum;
        m[r] = m_new;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          acc[nt][2 * r] *= corr;
          acc[nt][2 * r + 1] *= corr;
        }
        pa[r] = pack_bf16(pv[0][0], pv[0][1]);
        pa[2 + r] = pack_bf16(pv[1][0], pv[1][1]);
      }
      // acc += P V
#pragma unroll
      for (int dp = 0; dp < NT / 2; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vb + ((lane & 7) + ((lane >> 3) & 1) * 8) * rb +
                                  (dp * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(acc[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) masks[j] = masks[j + 1];
  }
  cp_async_wait<0>();

  // merge the warps: (max, sum) first, then the accumulators scaled to the
  // block's max, over the staging buffers
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    l[r] = quad_sum(l[r]);
    if ((lane & 3) == 0) {
      const int row = (lane >> 2) + 8 * r;
      ml_s[(warp * kMlRows + row) * 2] = m[r];
      ml_s[(warp * kMlRows + row) * 2 + 1] = l[r];
    }
  }
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem + lay.warp_off);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int row = (lane >> 2) + 8 * r;
    float mb = kNeg;
    for (int w = 0; w < warps; ++w)
      mb = fmaxf(mb, ml_s[(w * kMlRows + row) * 2]);
    const float sc = exp2f(m[r] - mb);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + (lane & 3) * 2;
      if (col < hd) {
        float* dst = sums + (warp * kMlRows + row) * hd + col;
        dst[0] = acc[nt][2 * r] * sc;
        dst[1] = acc[nt][2 * r + 1] * sc;
      }
    }
  }
  __syncthreads();
  finish_block<T>(p, ps, ml_s, sums, warps);
}

// ------------------------------------------------------------ float32
// G: query heads per block (1..8), the exact size of the register arrays.
template <int G>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    paged_split_f32(const Params p) {
  constexpr int CT = 32;
  constexpr int NJ = 8;  // columns per lane: lane + 32 j, hd <= 256
  extern __shared__ __align__(16) unsigned char smem[];
  const Pos ps = block_pos(p);
  if (ps.ng <= 0) return;
  if (p.n_spans > 1 && ps.s0 >= ps.s_end) {
    write_empty(p, ps);
    return;
  }
  const int hd = static_cast<int>(p.hd);
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const Layout lay = make_layout(4, hd, G, warps);
  const int rb = lay.row;
  const int rowf = rb / 4;
  float* ml_s = reinterpret_cast<float*>(smem + lay.q_bytes);
  unsigned char* mine = smem + lay.warp_off + warp * lay.per_warp;
  int64_t* offs = reinterpret_cast<int64_t*>(mine + kStages * 2 * CT * rb);
  float* p_s = reinterpret_cast<float*>(mine + kStages * 2 * CT * rb + CT * 8);

  const int32_t* table = p.tables + ps.b * p.max_pages;
  const uint32_t stage0 = smem_addr(mine);
  const int n_chunks = static_cast<int>((ps.s_end - ps.s0 + CT - 1) / CT);
  const int stage_bytes = 2 * CT * rb;
  const float* q_s = reinterpret_cast<const float*>(smem);
  stage_q<float>(p, ps, smem, hd * 4, G);
  int32_t id = lookup<CT>(p, table, static_cast<int>(ps.s0) + warp * CT,
                          static_cast<int>(ps.s_end), lane);
  uint32_t masks[kStages];
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j)
    masks[j] = issue_k<float, CT>(p, table, ps, j, warp, warps, n_chunks, id,
                                  offs, stage0, stage_bytes, rb, lane);
  cp_async_wait<kStages - 1>();  // q has landed
  __syncthreads();

  float acc[G][NJ];
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[g][j] = 0.f;
  }

  for (int k = 0; warp + k * warps < n_chunks; ++k) {
    masks[kStages - 1] =
        issue_k<float, CT>(p, table, ps, k + kStages - 1, warp, warps,
                           n_chunks, id, offs, stage0, stage_bytes, rb, lane);
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const uint32_t mask_cur = masks[0];
    if (mask_cur) {
      const float* ks = reinterpret_cast<const float*>(
          mine + (k % kStages) * stage_bytes);
      const float* vs = ks + CT * rowf;
      // this lane's position: its K row against the G query rows
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.f;
      const float* kr = ks + lane * rowf;
      for (int d = 0; d < hd; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + g * hd + d);
          s[g] = fmaf(qv.x, kv.x, s[g]);
          s[g] = fmaf(qv.y, kv.y, s[g]);
          s[g] = fmaf(qv.z, kv.z, s[g]);
          s[g] = fmaf(qv.w, kv.w, s[g]);
        }
      }
      const bool ok = (mask_cur >> lane) & 1u;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float x = ok ? s[g] * p.scale_log2 : kNeg;
        const float m_new = fmaxf(m[g], warp_max(x));
        const float corr = exp2f(m[g] - m_new);
        const float pv = ok ? exp2f(x - m_new) : 0.f;
        l[g] = l[g] * corr + pv;
        m[g] = m_new;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[g][j] *= corr;
        p_s[g * 32 + lane] = pv;
      }
      __syncwarp();
      for (int t = 0; t < CT; ++t) {
        if (((mask_cur >> t) & 1u) == 0u) continue;
        float w[G];  // this position's probabilities, broadcast reads
#pragma unroll
        for (int g = 0; g < G; ++g) w[g] = p_s[g * 32 + t];
        const float* vr = vs + t * rowf;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          if (d < hd) {
            const float v = vr[d];
#pragma unroll
            for (int g = 0; g < G; ++g) acc[g][j] = fmaf(w[g], v, acc[g][j]);
          }
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kStages - 1; ++j) masks[j] = masks[j + 1];
  }
  cp_async_wait<0>();

#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float lt = warp_sum(l[g]);
    if (lane == 0) {
      ml_s[(warp * kMlRows + g) * 2] = m[g];
      ml_s[(warp * kMlRows + g) * 2 + 1] = lt;
    }
  }
  __syncthreads();
  float* sums = reinterpret_cast<float*>(smem + lay.warp_off);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mb = kNeg;
    for (int w = 0; w < warps; ++w)
      mb = fmaxf(mb, ml_s[(w * kMlRows + g) * 2]);
    const float sc = exp2f(m[g] - mb);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) sums[(warp * kMlRows + g) * hd + d] = acc[g][j] * sc;
    }
  }
  __syncthreads();
  finish_block<float>(p, ps, ml_s, sums, warps);
}

// ------------------------------------------------------------ combine
// One block per (query head, kv head, sequence): merge the spans'
// partials by the log-sum-exp rule. The spans' weights e^(m_s - M) are
// computed once, in parallel, into shared memory; then R groups of threads
// each sum a run of consecutive spans, in span order, over 4-column
// slices, and the groups' sums are added in group order: span order in
// blocks, the same every run, no atomics. A row whose every span is empty
// has no valid position: the uniform mean of V.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    paged_combine(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);  // n_spans weights
  __shared__ float red[kCombineThreads * 8];
  __shared__ float warp_red[kCombineThreads / 32];
  const int64_t g = blockIdx.x;
  const int64_t kh = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int S = static_cast<int>(p.n_spans);
  const int64_t G = p.G;
  const int hd = static_cast<int>(p.hd);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t first = (b * p.K + kh) * S * G + g;  // span 0's partial row
  const float* ml = p.part_ml + first * 2;           // span s: + s * G * 2
  const float* acc = p.part_acc + first * p.hd;      // span s: + s * G * hd

  // M: the largest max over the non-empty spans (a block-wide max)
  float mx = kNeg;
  for (int s = tid; s < S; s += blockDim.x) {
    const float* x = ml + static_cast<int64_t>(s) * G * 2;
    if (x[1] > 0.f) mx = fmaxf(mx, x[0]);
  }
  mx = warp_max(mx);
  if (lane == 0) warp_red[warp] = mx;
  __syncthreads();
  mx = kNeg;
  for (int w = 0; w < kCombineThreads / 32; ++w) mx = fmaxf(mx, warp_red[w]);
  __syncthreads();
  // each span's weight, and L = sum of weight x sum (in a fixed tree)
  float lsum = 0.f;
  for (int s = tid; s < S; s += blockDim.x) {
    const float* x = ml + static_cast<int64_t>(s) * G * 2;
    const float w = x[1] > 0.f ? exp2f(x[0] - mx) : 0.f;
    w_s[s] = w;
    lsum += w * x[1];
  }
  lsum = warp_sum(lsum);
  if (lane == 0) warp_red[warp] = lsum;
  __syncthreads();
  float L = 0.f;
  for (int w = 0; w < kCombineThreads / 32; ++w) L += warp_red[w];
  if (L == 0.f) {  // every span empty (validity is shared by the heads)
    write_mean<T>(p, b, kh, static_cast<int>(g), 1, red);
    return;
  }
  const int cols = hd / 4;          // 4-column slices of the row
  const int R = kCombineThreads / cols;  // groups of threads over spans
  const int r = tid / cols;
  const int c = tid - r * cols;
  const int per = (S + R - 1) / R;  // spans of one group
  if (r < R) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    const int s_end = (r + 1) * per < S ? (r + 1) * per : S;
#pragma unroll 4
    for (int s = r * per; s < s_end; ++s) {
      const float w = w_s[s];
      if (w != 0.f) {
        const float4 a = *reinterpret_cast<const float4*>(
            acc + static_cast<int64_t>(s) * G * p.hd + c * 4);
        o.x = fmaf(w, a.x, o.x);
        o.y = fmaf(w, a.y, o.y);
        o.z = fmaf(w, a.z, o.z);
        o.w = fmaf(w, a.w, o.w);
      }
    }
    *reinterpret_cast<float4*>(red + r * hd + c * 4) = o;
  }
  __syncthreads();
  T* out = static_cast<T*>(p.out) + (b * p.H + kh * G + g) * p.hd;
  for (int d = tid; d < hd; d += blockDim.x) {
    float total = 0.f;
    for (int rr = 0; rr < R; ++rr) total += red[rr * hd + d];
    out[d] = from_float<T>(total / L);
  }
}

// ------------------------------------------------------------- launch
// The shared memory a block of device dev may opt in to (read once per
// device).
cudaError_t optin_smem(int dev, int* bytes) {
  constexpr int kDevices = 64;
  static int cache[kDevices] = {0};
  if (dev < kDevices && cache[dev]) {
    *bytes = cache[dev];
    return cudaSuccess;
  }
  const cudaError_t err = cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess && dev < kDevices) cache[dev] = *bytes;
  return err;
}

// Query heads of one kv head that a block takes: the 16 rows of one
// tensor-core tile in bf16, the float32 instances' G = 1..8.
int max_block_heads(int elem) { return elem == 2 ? 16 : 8; }

int qrows(int elem, int cg) { return elem == 2 ? (cg <= 8 ? 8 : 16) : cg; }

// Warps per block: as many (up to 4) as the shared memory allows; 0 if
// not even one fits.
int pick_warps(int elem, int hd, int cg, int limit) {
  for (int w = kMaxWarps; w >= 1; --w)
    if (make_layout(elem, hd, qrows(elem, cg), w).total <= limit) return w;
  return 0;
}

using Kernel = void (*)(const Params);

Kernel split_kernel(int elem, int hd, int cg) {
  if (elem == 2) {
    const bool big = cg > 8;
    switch (bf16_bucket(hd)) {
      case 64: return big ? paged_split_bf16<64, 16> : paged_split_bf16<64, 8>;
      case 128:
        return big ? paged_split_bf16<128, 16> : paged_split_bf16<128, 8>;
      case 192:
        return big ? paged_split_bf16<192, 16> : paged_split_bf16<192, 8>;
      default:
        return big ? paged_split_bf16<256, 16> : paged_split_bf16<256, 8>;
    }
  }
  switch (cg) {
    case 1: return paged_split_f32<1>;
    case 2: return paged_split_f32<2>;
    case 3: return paged_split_f32<3>;
    case 4: return paged_split_f32<4>;
    case 5: return paged_split_f32<5>;
    case 6: return paged_split_f32<6>;
    case 7: return paged_split_f32<7>;
    default: return paged_split_f32<8>;
  }
}

}  // namespace

// q: (B, H, hd) with strides (sqb, sqh, 1); k_pages, v_pages: contiguous
// (P, page, K, hd), 16-byte aligned; tables: contiguous (B, max_pages)
// int32 global page ids, -1 = hole; lengths: (B,) int32; out: contiguous
// (B, H, hd). elem_size 2 (bf16) or 4 (float32); hd * elem_size a multiple
// of 16, hd <= 256. Each row is split into n_spans spans of span_tokens
// positions (a whole number of pages); with n_spans > 1, part_acc (B, K,
// n_spans, G, hd) and part_ml (B, K, n_spans, G, 2) float32 are the
// partials' scratch and a combine kernel follows on the same stream.
extern "C" int repro_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* lengths, void* out, void* part_acc,
    void* part_ml, int64_t B, int64_t H, int64_t K, int64_t hd, int64_t page,
    int64_t max_pages, int64_t sqb, int64_t sqh, int64_t span_tokens, int64_t n_spans, int elem_size, float scale,
    void* stream) {
  Params p;
  p.q = q;
  p.k_pages = k_pages;
  p.v_pages = v_pages;
  p.tables = static_cast<const int32_t*>(tables);
  p.lengths = static_cast<const int32_t*>(lengths);
  p.out = out;
  p.part_acc = static_cast<float*>(part_acc);
  p.part_ml = static_cast<float*>(part_ml);
  p.B = B;
  p.H = H;
  p.K = K;
  p.G = H / K;
  p.hd = hd;
  p.page = page;
  p.max_pages = max_pages;
  p.sqb = sqb;
  p.sqh = sqh;
  p.span_tokens = span_tokens;
  p.n_spans = n_spans;
  const int64_t most = max_block_heads(elem_size);
  const int64_t head_chunks = (p.G + most - 1) / most;
  p.head_chunks = static_cast<int>(head_chunks);
  p.chunk_heads = static_cast<int>((p.G + head_chunks - 1) / head_chunks);
  p.words = static_cast<int>(hd * elem_size / 16);
  p.q_vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
            sqb * elem_size % 16 == 0 && sqh * elem_size % 16 == 0;
  p.scale_log2 = scale * kLog2e;
  const int cg = p.chunk_heads;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = optin_smem(dev, &limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = pick_warps(elem_size, static_cast<int>(hd), cg, limit);
  if (warps == 0) return cudaErrorInvalidValue;  // no warp's buffers fit
  const int bytes =
      make_layout(elem_size, static_cast<int>(hd), qrows(elem_size, cg), warps)
          .total;
  const Kernel kernel = split_kernel(elem_size, static_cast<int>(hd), cg);
  if (bytes > 48 * 1024) {
    // opt in once per (device, kernel) to the most any launch asked for
    constexpr int kSlots = 64;
    static const void* fn[kSlots] = {nullptr};
    static int dev_of[kSlots] = {0};
    static int granted[kSlots] = {0};
    int i = 0;
    while (i < kSlots && fn[i] &&
           (fn[i] != reinterpret_cast<const void*>(kernel) || dev_of[i] != dev))
      ++i;
    if (i == kSlots || !fn[i] || granted[i] < bytes) {
      err = cudaFuncSetAttribute(
          reinterpret_cast<const void*>(kernel),
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      // all of the SM's unified memory as shared memory, so that as many
      // blocks fit as their shared memory allows
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                   cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (i < kSlots) {
        fn[i] = reinterpret_cast<const void*>(kernel);
        dev_of[i] = dev;
        granted[i] = bytes;
      }
    }
  }
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_spans),
                  static_cast<unsigned>(K * head_chunks),
                  static_cast<unsigned>(B));
  kernel<<<grid, warps * 32, bytes, st>>>(p);
  if (n_spans > 1) {
    const dim3 cgrid(static_cast<unsigned>(p.G), static_cast<unsigned>(K),
                     static_cast<unsigned>(B));
    const size_t w_bytes = static_cast<size_t>(n_spans) * sizeof(float);
    if (elem_size == 2)
      paged_combine<__nv_bfloat16><<<cgrid, kCombineThreads, w_bytes, st>>>(p);
    else
      paged_combine<float><<<cgrid, kCombineThreads, w_bytes, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
