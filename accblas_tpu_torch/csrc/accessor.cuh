// Device side of the accessor: cast-on-load and cast-on-store per storage
// type, rounding to the arithmetic type of a tier, and the (storage, tier)
// codes shared with the Python wrappers (ops/dot.py, ops/gemv.py).
//
// The Python accessor (accessor/range.py) carries the (ar, st) pair as data;
// here the pair is a pair of template parameters, so each kernel is compiled
// once per combination and the casts cost nothing at run time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace accblas {

// storage codes (ops/_build.py STORAGE_CODE)
enum Storage : int { ST_F32 = 0, ST_BF16 = 1, ST_F16 = 2, ST_F8E4M3 = 3, ST_F8E5M2 = 4 };

// tier codes (ops/_build.py TIER_CODE): the arithmetic of a kernel
enum Tier : int {
  TIER_F32 = 0,         // f32 products and sums
  TIER_BF16 = 1,        // every product and every add rounded to bf16
  TIER_F16 = 2,         // every product and every add rounded to f16
  TIER_DF_FAST = 3,     // df64: f32 products, Kahan-compensated sums
  TIER_DF_PRECISE = 4,  // df64: exact products (two_prod), two_sum chains
};

// ---- cast-on-load: storage value -> float (exact for every storage type) ----
__device__ __forceinline__ float load_f32(float v) { return v; }
__device__ __forceinline__ float load_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float load_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float load_f32(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ float load_f32(__nv_fp8_e5m2 v) { return static_cast<float>(v); }

// ---- cast-on-store: float -> storage, round to nearest even ----
// f8 stores do not saturate: e4m3 overflows to NaN and e5m2 to inf, as
// torch's own conversion does.
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_f32(__half* p, float v) { *p = __float2half_rn(v); }
__device__ __forceinline__ void store_f32(__nv_fp8_e4m3* p, float v) {
  p->__x = __nv_cvt_float_to_fp8(v, __NV_NOSAT, __NV_E4M3);
}
__device__ __forceinline__ void store_f32(__nv_fp8_e5m2* p, float v) {
  p->__x = __nv_cvt_float_to_fp8(v, __NV_NOSAT, __NV_E5M2);
}

// the same casts with the storage type chosen at run time (epilogues, which
// touch one value per output row)
__device__ __forceinline__ float load_code(const void* p, int64_t i, int st) {
  switch (st) {
    case ST_BF16: return load_f32(static_cast<const __nv_bfloat16*>(p)[i]);
    case ST_F16: return load_f32(static_cast<const __half*>(p)[i]);
    case ST_F8E4M3: return load_f32(static_cast<const __nv_fp8_e4m3*>(p)[i]);
    case ST_F8E5M2: return load_f32(static_cast<const __nv_fp8_e5m2*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

__device__ __forceinline__ void store_code(void* p, int64_t i, int st, float v) {
  switch (st) {
    case ST_BF16: store_f32(static_cast<__nv_bfloat16*>(p) + i, v); break;
    case ST_F16: store_f32(static_cast<__half*>(p) + i, v); break;
    case ST_F8E4M3: store_f32(static_cast<__nv_fp8_e4m3*>(p) + i, v); break;
    case ST_F8E5M2: store_f32(static_cast<__nv_fp8_e5m2*>(p) + i, v); break;
    default: static_cast<float*>(p)[i] = v;
  }
}

// ---- rounding to the tier's arithmetic type (identity for f32 and df64) ----
template <int TIER>
__device__ __forceinline__ float round_ar(float v) {
  if constexpr (TIER == TIER_BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else if constexpr (TIER == TIER_F16) {
    return __half2float(__float2half_rn(v));
  } else {
    return v;
  }
}

// ---- vector loads: V storage values in one aligned access ----
template <class T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <class T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p) {
  return *reinterpret_cast<const Pack<T, V>*>(p);
}

// elements per vector step: 16 bytes of the wider of two operands
template <class A, class B>
__host__ __device__ constexpr int vec_width() {
  return 16 / (sizeof(A) > sizeof(B) ? sizeof(A) : sizeof(B));
}

// ---- host-side dispatch from run-time codes to template parameters ----
template <class T>
struct Tag {
  using type = T;
};

template <class F>
cudaError_t with_storage(int code, F&& f) {
  switch (code) {
    case ST_F32: return f(Tag<float>{});
    case ST_BF16: return f(Tag<__nv_bfloat16>{});
    case ST_F16: return f(Tag<__half>{});
    case ST_F8E4M3: return f(Tag<__nv_fp8_e4m3>{});
    case ST_F8E5M2: return f(Tag<__nv_fp8_e5m2>{});
    default: return cudaErrorInvalidValue;
  }
}

template <class F>
cudaError_t with_tier(int code, F&& f) {
  switch (code) {
    case TIER_F32: return f(std::integral_constant<int, TIER_F32>{});
    case TIER_BF16: return f(std::integral_constant<int, TIER_BF16>{});
    case TIER_F16: return f(std::integral_constant<int, TIER_F16>{});
    case TIER_DF_FAST: return f(std::integral_constant<int, TIER_DF_FAST>{});
    case TIER_DF_PRECISE: return f(std::integral_constant<int, TIER_DF_PRECISE>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace accblas
