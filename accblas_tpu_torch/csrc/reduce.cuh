// Tier arithmetic shared by the DOT and GEMV kernels: the value a tier
// carries through a reduction, how two such values combine, per-thread
// accumulation of products, and deterministic warp and block reductions.
//
// Every reduction here runs in a fixed order (shuffle trees, then a fixed
// walk over shared memory), so a kernel gives the same bits on every run.
#pragma once

#include "accessor.cuh"
#include "df64.cuh"

namespace accblas {

__host__ __device__ constexpr bool is_df_tier(int tier) {
  return tier == TIER_DF_FAST || tier == TIER_DF_PRECISE;
}

template <int TIER>
using value_t = std::conditional_t<is_df_tier(TIER), DF, float>;

// combine two partial results of a tier: an exact df_add for df64, an add
// rounded to the arithmetic type for the fixed tiers
template <int TIER>
__device__ __forceinline__ value_t<TIER> combine(value_t<TIER> a, value_t<TIER> b) {
  if constexpr (is_df_tier(TIER)) {
    return df_add(a, b);
  } else {
    return round_ar<TIER>(__fadd_rn(a, b));
  }
}

__device__ __forceinline__ float shfl_down(float v, int off) {
  return __shfl_down_sync(0xffffffffu, v, off);
}
__device__ __forceinline__ DF shfl_down(DF v, int off) {
  return DF{shfl_down(v.hi, off), shfl_down(v.lo, off)};
}

// pairwise tree over the 32 lanes of a warp; the result is valid in lane 0
template <int TIER>
__device__ __forceinline__ value_t<TIER> warp_reduce(value_t<TIER> v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = combine<TIER>(v, shfl_down(v, off));
  return v;
}

// warp trees, then one tree over the warps' results; valid in thread 0.
// Call at most once per kernel (one static shared buffer).
template <int TIER>
__device__ __forceinline__ value_t<TIER> block_reduce(value_t<TIER> v) {
  __shared__ value_t<TIER> part[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_reduce<TIER>(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? part[lane] : value_t<TIER>{};
    v = warp_reduce<TIER>(v);
  }
  return v;
}

// ---- per-thread accumulation of products x*y over V lanes ----
// add(j, x, y) feeds lane j; add_vec feeds one vector step (lane j takes
// element j); result() folds the lanes into one value of the tier.

// bf16/f16 fixed tiers: operands and products rounded to the arithmetic
// type, every add rounded too. Sums are pairwise: each vector step is
// reduced by a tree, and the step sums go through a binary counter of
// partial sums (level l holds the sum of 2^l steps), so the depth of
// rounded adds grows with log2 of the count, as in the reference's tree.
template <int TIER, int V>
struct ThreadAcc {
  float stk[32];
  unsigned cnt = 0;

  __device__ __forceinline__ static float prod(float x, float y) {
    return round_ar<TIER>(__fmul_rn(round_ar<TIER>(x), round_ar<TIER>(y)));
  }
  __device__ __forceinline__ void push(float v) {
    bool carry = true;
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      if (carry) {
        if ((cnt >> l) & 1u) {
          v = round_ar<TIER>(__fadd_rn(stk[l], v));
        } else {
          stk[l] = v;
          carry = false;
        }
      }
    }
    ++cnt;
  }
  __device__ __forceinline__ void add(int, float x, float y) { push(prod(x, y)); }
  __device__ __forceinline__ void add_vec(const float (&x)[V], const float (&y)[V]) {
    float p[V];
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = prod(x[j], y[j]);
#pragma unroll
    for (int w = V / 2; w > 0; w >>= 1) {
#pragma unroll
      for (int j = 0; j < w; ++j) p[j] = round_ar<TIER>(__fadd_rn(p[j], p[j + w]));
    }
    push(p[0]);
  }
  __device__ __forceinline__ float result() const {
    float s = 0.f;
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      if ((cnt >> l) & 1u) s = round_ar<TIER>(__fadd_rn(s, stk[l]));
    }
    return s;
  }
};

// f32 tier: V independent f32 sums of rounded f32 products
template <int V>
struct ThreadAcc<TIER_F32, V> {
  float s[V] = {};

  __device__ __forceinline__ void add(int j, float x, float y) {
    s[j] = __fadd_rn(s[j], __fmul_rn(x, y));
  }
  __device__ __forceinline__ void add_vec(const float (&x)[V], const float (&y)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) add(j, x[j], y[j]);
  }
  __device__ __forceinline__ float result() const {
    float r[V];
#pragma unroll
    for (int j = 0; j < V; ++j) r[j] = s[j];
#pragma unroll
    for (int w = V / 2; w > 0; w >>= 1) {
#pragma unroll
      for (int j = 0; j < w; ++j) r[j] = __fadd_rn(r[j], r[j + w]);
    }
    return r[0];
  }
};

// df64 chains: V independent (s, c) pairs, folded with df_add at the end.
//   fast (Kahan): f32 products; c is the pending deficit, so a chain is
//     worth s - c.
//   precise: exact products; two_sum captures each add's rounding exactly
//     and c collects those errors plus the products' low words, so a chain
//     is worth s + c.
template <int TIER, int V>
struct DFChains {
  float s[V] = {};
  float c[V] = {};

  __device__ __forceinline__ void add(int j, float x, float y) {
    if constexpr (TIER == TIER_DF_PRECISE) {
      float p, pe, t, e;
      two_prod(x, y, p, pe);
      two_sum(s[j], p, t, e);
      c[j] = __fadd_rn(c[j], __fadd_rn(e, pe));
      s[j] = t;
    } else {
      const float yv = __fsub_rn(__fmul_rn(x, y), c[j]);
      const float t = __fadd_rn(s[j], yv);
      c[j] = __fsub_rn(__fsub_rn(t, s[j]), yv);
      s[j] = t;
    }
  }
  __device__ __forceinline__ void add_vec(const float (&x)[V], const float (&y)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) add(j, x[j], y[j]);
  }
  __device__ __forceinline__ DF result() const {
    DF r[V];
#pragma unroll
    for (int j = 0; j < V; ++j) r[j] = DF{s[j], TIER == TIER_DF_PRECISE ? c[j] : -c[j]};
#pragma unroll
    for (int w = V / 2; w > 0; w >>= 1) {
#pragma unroll
      for (int j = 0; j < w; ++j) r[j] = df_add(r[j], r[j + w]);
    }
    return r[0];
  }
};

template <int V>
struct ThreadAcc<TIER_DF_FAST, V> : DFChains<TIER_DF_FAST, V> {};
template <int V>
struct ThreadAcc<TIER_DF_PRECISE, V> : DFChains<TIER_DF_PRECISE, V> {};

// convert one vector step of storage values to floats (exact)
template <class S, int V>
__device__ __forceinline__ void unpack(const Pack<S, V>& pk, float (&out)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) out[j] = load_f32(pk.v[j]);
}

}  // namespace accblas
