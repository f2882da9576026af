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

// The scratch of a kernel that folds across blocks in one launch (the DOT,
// the window sum): kScratchBlocks block partials of 8 bytes (a DF, or a
// float and a 0), then the ticket counter that finds the last block, 0
// before and after every launch. ops/_build.py's scratch() makes one such
// buffer a (device, stream); accblas_scratch_bytes() reports its size.
constexpr int kScratchBlocks = 1024;
constexpr int64_t kScratchBytes = kScratchBlocks * 8 + 4;

__host__ __device__ inline unsigned* scratch_ticket(void* scratch) {
  return reinterpret_cast<unsigned*>(static_cast<char*>(scratch) + kScratchBlocks * 8);
}

__host__ __device__ constexpr bool is_df_tier(int tier) {
  return tier == TIER_DF_FAST || tier == TIER_DF_PRECISE;
}

// log2 of a power of two
__host__ __device__ constexpr int log2_of(int k) { return k <= 1 ? 0 : 1 + log2_of(k / 2); }

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

// `+` as a functor: a fold written once runs on float or DF (df_add) values
struct Add {
  template <class T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

// halving fold over the first `width` lanes of a warp (a power of two <= 32):
// lane t takes op(v_t, v_{t+s}) for s = width/2, ..., 1; valid in lane 0.
// Every lane of `mask` takes part. No unroll pragma: at a run-time width it
// made the generic GEMV 25% slower on the H100; at a constant width nvcc
// unrolls the loop unasked.
template <class T, class Op>
__device__ __forceinline__ T warp_fold(T v, int width, Op op, unsigned mask = 0xffffffffu) {
  for (int s = width / 2; s > 0; s >>= 1) v = op(v, shfl_down(v, s, mask));
  return v;
}

// pairwise tree over the 32 lanes of a warp; the result is valid in lane 0
template <int TIER>
__device__ __forceinline__ value_t<TIER> warp_reduce(value_t<TIER> v) {
  return warp_fold(v, 32, [](value_t<TIER> a, value_t<TIER> b) { return combine<TIER>(a, b); });
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
// element j); add_steps<K, WX, WY>(x, y) feeds K vector steps of stored
// values (packs, as loaded), in order, with the bits of K add_vec calls,
// each step widened just before it is added by WX::widen and WY::widen (a
// Range's Row, range.cuh); result() folds the lanes into one value of the
// tier.

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
  // v, the sum of 2^L pushes, enters at level L (the count a multiple of
  // 2^L): the same levels and bits as those 2^L pushes
  template <int L = 0>
  __device__ __forceinline__ void push(float v) {
    bool carry = true;
#pragma unroll
    for (int l = L; l < 32; ++l) {
      if (carry) {
        if ((cnt >> l) & 1u) {
          v = round_ar<TIER>(__fadd_rn(stk[l], v));
        } else {
          stk[l] = v;
          carry = false;
        }
      }
    }
    cnt += 1u << L;
  }
  __device__ __forceinline__ static float step_sum(const float (&x)[V], const float (&y)[V]) {
    float p[V];
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = prod(x[j], y[j]);
#pragma unroll
    for (int w = V / 2; w > 0; w >>= 1) {
#pragma unroll
      for (int j = 0; j < w; ++j) p[j] = round_ar<TIER>(__fadd_rn(p[j], p[j + w]));
    }
    return p[0];
  }
  __device__ __forceinline__ void add(int, float x, float y) { push(prod(x, y)); }
  __device__ __forceinline__ void add_vec(const float (&x)[V], const float (&y)[V]) {
    push(step_sum(x, y));
  }
  // the K step sums folded as the counter folds K pushes (step s meets s +
  // w for w = 1, 2, ..., the earlier on the left), entering at level log2 K:
  // one carry chain for K steps. The count must be a multiple of K.
  template <int K, class WX, class WY, class PX, class PY>
  __device__ __forceinline__ void add_steps(const PX (&x)[K], const PY (&y)[K]) {
    float p[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      float xv[V], yv[V];
      WX::widen(x[s], xv);
      WY::widen(y[s], yv);
      p[s] = step_sum(xv, yv);
    }
#pragma unroll
    for (int w = 1; w < K; w <<= 1) {
#pragma unroll
      for (int r = 0; r < K; r += 2 * w) p[r] = round_ar<TIER>(__fadd_rn(p[r], p[r + w]));
    }
    push<log2_of(K)>(p[0]);
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
  template <int K, class WX, class WY, class PX, class PY>
  __device__ __forceinline__ void add_steps(const PX (&x)[K], const PY (&y)[K]) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      float xv[V], yv[V];
      WX::widen(x[s], xv);
      WY::widen(y[s], yv);
      add_vec(xv, yv);
    }
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
  template <int K, class WX, class WY, class PX, class PY>
  __device__ __forceinline__ void add_steps(const PX (&x)[K], const PY (&y)[K]) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      float xv[V], yv[V];
      WX::widen(x[s], xv);
      WY::widen(y[s], yv);
      add_vec(xv, yv);
    }
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

}  // namespace accblas
