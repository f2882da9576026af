// Device twins of ops/df64.py: double-float values (hi + lo, two floats),
// the error-free transforms they are built from, and the operators that let
// one kernel body run on float or DF values (csrc/generic.cu).
//
// Each transform needs every float op rounded on its own. The intrinsics
// below are never contracted into fused multiply-adds, and the library is
// built with -fmad=false besides; two_prod asks for its one fused
// multiply-add explicitly, which makes its low word exact.
#pragma once

#include <cuda_runtime.h>

namespace accblas {

struct DF {
  float hi, lo;
};

// (s, e): s = fl(a + b) and s + e == a + b exactly
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

// the same, assuming |a| >= |b|
__device__ __forceinline__ void fast_two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  e = __fsub_rn(b, __fsub_rn(s, a));
}

// (p, e): p = fl(a * b) and p + e == a * b exactly
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  e = __fmaf_rn(a, b, -p);
}

__device__ __forceinline__ DF df_add(DF x, DF y) {
  float s, e;
  two_sum(x.hi, y.hi, s, e);
  e = __fadd_rn(e, __fadd_rn(x.lo, y.lo));
  DF r;
  fast_two_sum(s, e, r.hi, r.lo);
  return r;
}

__device__ __forceinline__ DF df_mul_f32(DF x, float y) {
  float p, e;
  two_prod(x.hi, y, p, e);
  e = __fadd_rn(e, __fmul_rn(x.lo, y));
  DF r;
  fast_two_sum(p, e, r.hi, r.lo);
  return r;
}

// DF x DF: the exact product of the high words plus the cross terms
__device__ __forceinline__ DF df_mul(DF x, DF y) {
  float p, e;
  two_prod(x.hi, y.hi, p, e);
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(x.hi, y.lo), __fmul_rn(x.lo, y.hi)));
  DF r;
  fast_two_sum(p, e, r.hi, r.lo);
  return r;
}

__device__ __forceinline__ DF df_from(float x) { return DF{x, 0.f}; }
__device__ __forceinline__ DF df_neg(DF x) { return DF{-x.hi, -x.lo}; }
__device__ __forceinline__ DF df_sub(DF x, DF y) { return df_add(x, df_neg(y)); }

// round to float32 (the accessor's cast-on-store to f32 storage)
__device__ __forceinline__ float df_to_f32(DF x) { return __fadd_rn(x.hi, x.lo); }

// ---- operators: a kernel body written once runs on float or DF values ----
// As in ops/df64.py's DF: a float operand of * takes df_mul_f32, a float
// operand of + or - is widened exactly first, and the DF operand comes first.
__device__ __forceinline__ DF operator+(DF x, DF y) { return df_add(x, y); }
__device__ __forceinline__ DF operator+(DF x, float y) { return df_add(x, df_from(y)); }
__device__ __forceinline__ DF operator+(float x, DF y) { return df_add(y, df_from(x)); }
__device__ __forceinline__ DF operator-(DF x, DF y) { return df_sub(x, y); }
__device__ __forceinline__ DF operator-(DF x, float y) { return df_sub(x, df_from(y)); }
__device__ __forceinline__ DF operator-(float x, DF y) { return df_sub(df_from(x), y); }
__device__ __forceinline__ DF operator-(DF x) { return df_neg(x); }
__device__ __forceinline__ DF operator*(DF x, DF y) { return df_mul(x, y); }
__device__ __forceinline__ DF operator*(DF x, float y) { return df_mul_f32(x, y); }
__device__ __forceinline__ DF operator*(float x, DF y) { return df_mul_f32(y, x); }

// ---- warp shuffles of float and DF values (a DF moves both words) ----
__device__ __forceinline__ float shfl_down(float v, int off, unsigned mask = 0xffffffffu) {
  return __shfl_down_sync(mask, v, off);
}
__device__ __forceinline__ DF shfl_down(DF v, int off, unsigned mask = 0xffffffffu) {
  return DF{shfl_down(v.hi, off, mask), shfl_down(v.lo, off, mask)};
}

}  // namespace accblas
