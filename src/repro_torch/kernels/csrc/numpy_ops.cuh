// Scalar arithmetic with numpy's bytes, for the relational kernels
// (expr_core.cu, segment_reduce.cu).
//
// The relational engine's contract is byte identity across its backends,
// so every operation here gives the bits numpy gives on the host:
//
// - floats are added, subtracted, multiplied and divided by the _rn
//   intrinsics, so nvcc cannot contract a product and a sum into one FMA
//   (the only FMAs in the SASS are the division routines' own);
// - a NaN result takes the host's NaN: the first NaN operand, quieted, or
//   the host's default NaN for an invalid operation (0/0, inf - inf);
//   both default NaNs come from the host (numpy's 0/0), since the card's
//   own arithmetic returns one canonical NaN;
// - float16 is computed in float32 and rounded once, as numpy's half loops
//   do, and converted between formats bit for bit as numpy converts
//   (NaN payloads kept, float32 -> float64 quieting as the x86 cvtss2sd);
// - integers wrap as numpy's do: + - * on the unsigned type of the width.
//
// Everything is __host__ __device__ and uses no CUDA header when built by
// a host compiler, so the arithmetic can be compiled and held against
// numpy on a machine without a card.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define NP_FN __host__ __device__ __forceinline__
#else
#define NP_FN static inline
#endif

namespace npops {

// numpy dtypes a relational kernel takes; the codes are the wrappers'
// (kernels/expr_core.py DTYPE_CODES).
enum Dtype : int {
  kBool = 0, kI8 = 1, kI16 = 2, kI32 = 3, kI64 = 4,
  kU8 = 5, kU16 = 6, kU32 = 7, kU64 = 8,
  kF16 = 9, kF32 = 10, kF64 = 11,
};

// Instruction codes of an expression program (kernels/expr_core.py OPS).
enum Op : int {
  kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5,
  kAnd = 6, kOr = 7, kNot = 8,
  kAdd = 9, kSub = 10, kMul = 11, kDiv = 12,
};

// The host's default NaNs (numpy's 0/0 in float64 and float32).
struct NanBits {
  uint64_t f64;
  uint32_t f32;
};

NP_FN bool is_float(int dt) { return dt >= kF16; }
NP_FN bool is_signed(int dt) { return dt >= kI8 && dt <= kI64; }
NP_FN int width_bits(int dt) {
  switch (dt) {
    case kBool: case kI8: case kU8: return 8;
    case kI16: case kU16: case kF16: return 16;
    case kI32: case kU32: case kF32: return 32;
    default: return 64;
  }
}

// ------------------------------------------------------------- bit casts
NP_FN uint64_t f64_bits(double x) {
#ifdef __CUDA_ARCH__
  return static_cast<uint64_t>(__double_as_longlong(x));
#else
  uint64_t u;
  memcpy(&u, &x, 8);
  return u;
#endif
}
NP_FN double bits_f64(uint64_t u) {
#ifdef __CUDA_ARCH__
  return __longlong_as_double(static_cast<long long>(u));
#else
  double x;
  memcpy(&x, &u, 8);
  return x;
#endif
}
NP_FN uint32_t f32_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(x);
#else
  uint32_t u;
  memcpy(&u, &x, 4);
  return u;
#endif
}
NP_FN float bits_f32(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float x;
  memcpy(&x, &u, 4);
  return x;
#endif
}

NP_FN bool nan64(uint64_t u) {
  return (u & 0x7fffffffffffffffull) > 0x7ff0000000000000ull;
}
NP_FN bool nan32(uint32_t u) { return (u & 0x7fffffffu) > 0x7f800000u; }

// ------------------------------------------------ rounded float operations
// _rn: no contraction into an FMA (nvcc contracts a*b+c by default).
NP_FN double dadd(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dadd_rn(a, b);
#else
  return a + b;
#endif
}
NP_FN double dsub(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dsub_rn(a, b);
#else
  return a - b;
#endif
}
NP_FN double dmul(double a, double b) {
#ifdef __CUDA_ARCH__
  return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
NP_FN float fadd(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
NP_FN float fsub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
NP_FN float fmul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
// IEEE division, round to nearest even, subnormals kept (no -ftz, and
// -prec-div stays on). The routines refine a reciprocal with FMAs of
// their own; those are exact steps, not a contraction of the program's
// product and sum.
NP_FN double ddiv(double a, double b) {
#ifdef __CUDA_ARCH__
  return __ddiv_rn(a, b);
#else
  return a / b;
#endif
}
NP_FN float fdiv(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fdiv_rn(a, b);
#else
  return a / b;
#endif
}

// The host's NaN for an operation on a and b whose result is NaN: the
// first NaN operand quieted, else the default NaN (an invalid operation).
NP_FN uint64_t nan_rule64(uint64_t a, uint64_t b, uint64_t dflt) {
  if (nan64(a)) return a | (1ull << 51);
  if (nan64(b)) return b | (1ull << 51);
  return dflt;
}
NP_FN uint32_t nan_rule32(uint32_t a, uint32_t b, uint32_t dflt) {
  if (nan32(a)) return a | (1u << 22);
  if (nan32(b)) return b | (1u << 22);
  return dflt;
}

// ---------------------------------------------------------- conversions
NP_FN double i64_to_f64(int64_t x) {
#ifdef __CUDA_ARCH__
  return __ll2double_rn(x);
#else
  return static_cast<double>(x);
#endif
}
NP_FN double u64_to_f64(uint64_t x) {
#ifdef __CUDA_ARCH__
  return __ull2double_rn(x);
#else
  return static_cast<double>(x);
#endif
}
NP_FN float i64_to_f32(int64_t x) {
#ifdef __CUDA_ARCH__
  return __ll2float_rn(x);
#else
  return static_cast<float>(x);
#endif
}
NP_FN float u64_to_f32(uint64_t x) {
#ifdef __CUDA_ARCH__
  return __ull2float_rn(x);
#else
  return static_cast<float>(x);
#endif
}

// float16 bits -> float32 bits, exact; a NaN keeps its payload unquieted
// (numpy's npy_halfbits_to_floatbits).
NP_FN uint32_t f16_to_f32_bits(uint32_t h) {
  const uint32_t sign = (h & 0x8000u) << 16;
  const uint32_t e = h & 0x7c00u, m = h & 0x3ffu;
  if (e == 0x7c00u) return sign | 0x7f800000u | (m << 13);
  if (e != 0) return sign | (((h & 0x7fffu) + 0x1c000u) << 13);
  if (m == 0) return sign;
  // subnormal: m * 2^-24, normalised into a float32
  int shift = 0;
  uint32_t mm = m;
  while ((mm & 0x400u) == 0) {
    mm <<= 1;
    ++shift;
  }
  return sign | (static_cast<uint32_t>(113 - shift) << 23) |
         ((mm & 0x3ffu) << 13);
}

// float32 bits -> float16 bits, round to nearest even; overflow to inf; a
// NaN keeps the top of its payload (never becoming inf), as numpy's
// npy_floatbits_to_halfbits.
NP_FN uint32_t f32_to_f16_bits(uint32_t f) {
  const uint32_t sign = (f >> 16) & 0x8000u;
  const uint32_t a = f & 0x7fffffffu;
  if (a >= 0x7f800000u) {
    if (a == 0x7f800000u) return sign | 0x7c00u;
    const uint32_t m = (a & 0x7fffffu) >> 13;
    return sign | 0x7c00u | (m ? m : 1u);
  }
  if (a >= 0x477ff000u) return sign | 0x7c00u;  // rounds past 65504
  if (a >= 0x38800000u) {                        // a normal half
    uint32_t x = a - 0x38000000u;                // rebias 127 -> 15
    x += 0xfffu + ((x >> 13) & 1u);
    return sign | (x >> 13);
  }
  if (a <= 0x33000000u) return sign;  // at most half the least subnormal
  const uint32_t e = a >> 23;         // 102..112
  const uint32_t m = (a & 0x7fffffu) | 0x800000u;
  const uint32_t shift = 126 - e;     // 14..24: units of 2^-24
  uint32_t q = m >> shift;
  const uint32_t rem = m & ((1u << shift) - 1u), half = 1u << (shift - 1);
  if (rem > half || (rem == half && (q & 1u))) ++q;
  return sign | q;
}

// float32 -> float64 as the x86 cvtss2sd: exact, a NaN quieted with its
// payload kept (the card's conversion returns one canonical NaN).
NP_FN uint64_t f32_to_f64_bits(uint32_t f) {
  if (nan32(f)) {
    return (static_cast<uint64_t>(f >> 31) << 63) | 0x7ff8000000000000ull |
           (static_cast<uint64_t>(f & 0x7fffffu) << 29);
  }
  return f64_bits(static_cast<double>(bits_f32(f)));
}

// float16 -> float64 as numpy's npy_halfbits_to_doublebits: exact, a NaN's
// payload kept unquieted.
NP_FN uint64_t f16_to_f64_bits(uint32_t h) {
  if ((h & 0x7c00u) == 0x7c00u && (h & 0x3ffu)) {
    return (static_cast<uint64_t>(h >> 15) << 63) | 0x7ff0000000000000ull |
           (static_cast<uint64_t>(h & 0x3ffu) << 42);
  }
  return f64_bits(static_cast<double>(bits_f32(f16_to_f32_bits(h))));
}

// A value of dtype dt held in a 64-bit register (signed integers sign-
// extended, unsigned and bool zero-extended, floats as their bits) as a
// float64 / float32, the way numpy casts it into a float loop.
NP_FN uint64_t to_f64_bits(uint64_t raw, int dt) {
  switch (dt) {
    case kF64: return raw;
    case kF32: return f32_to_f64_bits(static_cast<uint32_t>(raw));
    case kF16: return f16_to_f64_bits(static_cast<uint32_t>(raw));
    case kI8: case kI16: case kI32: case kI64:
      return f64_bits(i64_to_f64(static_cast<int64_t>(raw)));
    default: return f64_bits(u64_to_f64(raw));
  }
}
NP_FN uint32_t to_f32_bits(uint64_t raw, int dt) {
  switch (dt) {
    case kF32: return static_cast<uint32_t>(raw);
    case kF16: return f16_to_f32_bits(static_cast<uint32_t>(raw));
    case kI8: case kI16: case kI32: case kI64:
      return f32_bits(i64_to_f32(static_cast<int64_t>(raw)));
    default: return f32_bits(u64_to_f32(raw));
  }
}

// ------------------------------------------------------- float64/32 ops
NP_FN uint64_t arith64(int op, uint64_t a, uint64_t b, uint64_t dflt) {
  const double x = bits_f64(a), y = bits_f64(b);
  const double r = op == kAdd ? dadd(x, y) : op == kSub ? dsub(x, y)
                   : op == kMul ? dmul(x, y) : ddiv(x, y);
  const uint64_t u = f64_bits(r);
  return nan64(u) ? nan_rule64(a, b, dflt) : u;
}
NP_FN uint32_t arith32(int op, uint32_t a, uint32_t b, uint32_t dflt) {
  const float x = bits_f32(a), y = bits_f32(b);
  const float r = op == kAdd ? fadd(x, y) : op == kSub ? fsub(x, y)
                  : op == kMul ? fmul(x, y) : fdiv(x, y);
  const uint32_t u = f32_bits(r);
  return nan32(u) ? nan_rule32(a, b, dflt) : u;
}

NP_FN bool nonzero(uint64_t raw, int dt) {
  switch (dt) {
    case kF16: return (raw & 0x7fffu) != 0;
    case kF32: return (raw & 0x7fffffffu) != 0;
    case kF64: return (raw & 0x7fffffffffffffffull) != 0;
    default: return raw != 0;
  }
}

NP_FN bool compare_f64(int op, double x, double y) {
  switch (op) {
    case kEq: return x == y;
    case kNe: return x != y;
    case kLt: return x < y;
    case kLe: return x <= y;
    case kGt: return x > y;
    default: return x >= y;
  }
}
template <typename T>
NP_FN bool compare_int(int op, T x, T y) {
  switch (op) {
    case kEq: return x == y;
    case kNe: return x != y;
    case kLt: return x < y;
    case kLe: return x <= y;
    case kGt: return x > y;
    default: return x >= y;
  }
}

// Sign- or zero-extend the low `bits` bits of u.
NP_FN uint64_t wrap(uint64_t u, int bits, bool sgn) {
  if (bits == 64) return u;
  const int s = 64 - bits;
  return sgn ? static_cast<uint64_t>(static_cast<int64_t>(u << s) >> s)
             : (u << s) >> s;
}

// One instruction of an expression program, numpy's ufunc for `op` on a
// (dtype da) and b (dtype db) through numpy's loop of input dtypes la, lb
// (np.ufunc.resolve_dtypes): the result in its register form.
NP_FN uint64_t apply(int op, uint64_t a, int da, uint64_t b, int db, int la,
                     int lb, NanBits nb) {
  if (op == kNot) return !nonzero(a, da);
  if (op == kAnd) return nonzero(a, da) && nonzero(b, db);
  if (op == kOr) return nonzero(a, da) || nonzero(b, db);
  if (op <= kGe) {
    if (la != lb) {  // numpy's exact int64 / uint64 comparison
      const bool a_signed = la == kI64;
      const int64_t s = static_cast<int64_t>(a_signed ? a : b);
      const uint64_t u = a_signed ? b : a;
      if (s < 0) {  // the signed side is the smaller
        const bool lt = a_signed;  // a < b exactly when a is the signed one
        return op == kNe || (lt ? (op == kLt || op == kLe)
                                : (op == kGt || op == kGe));
      }
      return compare_int<uint64_t>(op, a_signed ? static_cast<uint64_t>(s) : u,
                                   a_signed ? u : static_cast<uint64_t>(s));
    }
    if (la == kF64) {
      return compare_f64(op, bits_f64(to_f64_bits(a, da)),
                         bits_f64(to_f64_bits(b, db)));
    }
    if (la == kF32 || la == kF16) {
      return compare_f64(op, bits_f32(to_f32_bits(a, da)),
                         bits_f32(to_f32_bits(b, db)));
    }
    if (is_signed(la)) {
      return compare_int<int64_t>(op, static_cast<int64_t>(a),
                                  static_cast<int64_t>(b));
    }
    return compare_int<uint64_t>(op, a, b);
  }
  if (la == kF64) return arith64(op, to_f64_bits(a, da), to_f64_bits(b, db),
                                 nb.f64);
  if (la == kF32) return arith32(op, to_f32_bits(a, da), to_f32_bits(b, db),
                                 nb.f32);
  if (la == kF16) {
    return f32_to_f16_bits(arith32(op, to_f32_bits(a, da), to_f32_bits(b, db),
                                   nb.f32));
  }
  if (la == kBool) return op == kAdd ? (a | b) : (a & b);  // numpy: or, and
  const uint64_t r = op == kAdd ? a + b : op == kSub ? a - b : a * b;
  return wrap(r, width_bits(la), is_signed(la));
}

// Max and min of numpy's indexed loops (np.maximum.at / np.minimum.at):
// the accumulator stays when it is NaN or strictly beyond the value; on a
// tie (+0.0 against -0.0 too) the value replaces it.
NP_FN uint64_t max_at(uint64_t acc, uint64_t v) {
  return (bits_f64(acc) > bits_f64(v) || nan64(acc)) ? acc : v;
}
NP_FN uint64_t min_at(uint64_t acc, uint64_t v) {
  return (bits_f64(acc) < bits_f64(v) || nan64(acc)) ? acc : v;
}

// np.add.at on a float64 accumulator: acc + v, NaN by the host's rule.
NP_FN uint64_t add_at(uint64_t acc, uint64_t v, uint64_t dflt) {
  const uint64_t u = f64_bits(dadd(bits_f64(acc), bits_f64(v)));
  return nan64(u) ? nan_rule64(acc, v, dflt) : u;
}

}  // namespace npops
