// Device twins of ops/df64.py: double-float values (hi + lo, two floats) and
// the error-free transforms they are built from.
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

}  // namespace accblas
