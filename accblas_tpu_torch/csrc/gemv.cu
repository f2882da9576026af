// GEMV: res_out = alpha * A @ x + beta * res, in the arithmetic of a tier.
//
// Replaces both Pallas GEMV kernels of accblas_tpu/ops/gemv.py:
// `_gemv_kernel` (row-block x column-block grid; the bf16/f16 tiers round
// each column-block partial before the cross-block add) and
// `_gemv_fullrow_kernel` (one full row panel at a time; the f32 tier and the
// df64 Kahan / two_sum chains, and the unrounded (hi, lo) output `df_out`).
//
// On the H100 a matrix-vector product is bound by the bytes of A read from
// device memory (2 flops per element of A, however narrow its storage).
// The design streams each row once: one warp per row, each lane taking
// 16-byte vector loads of the row, so a warp reads 512 contiguous bytes per
// step; x is small and is re-read by every warp through the caches. Each
// lane keeps its partial sums in registers, in the tier's arithmetic, and
// the warp combines them with a fixed shuffle tree, so results repeat bit
// for bit from run to run.
//
// Tiers (accessor.cuh Tier):
//   f32      - f32 sums of f32 products;
//   bf16/f16 - per column block of `bn` columns, an f32 sum of the exact
//              products of the operands rounded to the arithmetic type,
//              rounded to it; the block partials add in that type;
//   df64     - per lane, Kahan (fast) or two_sum with exact products
//              (precise) chains, folded with df_add.
// Epilogue: alpha and beta in the tier's arithmetic; res is not read when
// beta == 0; the result is cast to the storage of res, or written as the
// unrounded (hi, lo) pair when `out_lo` is given (df64 tiers only).

#include "reduce.cuh"

namespace accblas {
namespace {

constexpr int kWarps = 8;  // rows per block, one warp each

// f32 sums of products of operands rounded to the tier's arithmetic type
// on load (the bf16/f16 tiers' column blocks): those products are exact in
// f32, so the sum is an f32 sum of exact values
template <int TIER, int V>
struct RoundedF32 {
  ThreadAcc<TIER_F32, V> f;
  __device__ __forceinline__ void add(int j, float p, float q) {
    f.add(j, round_ar<TIER>(p), round_ar<TIER>(q));
  }
  __device__ __forceinline__ void add_vec(const float (&p)[V], const float (&q)[V]) {
#pragma unroll
    for (int j = 0; j < V; ++j) add(j, p[j], q[j]);
  }
};

// one lane's share of the products over columns [c0, c1): whole vector
// steps when `vec_ok` (c0, c1 multiples of V), else single elements
template <class SA, class SX, int V, class Acc>
__device__ __forceinline__ void lane_sum(Acc& acc, const SA* __restrict__ a,
                                         const SX* __restrict__ x, int64_t c0, int64_t c1,
                                         int vec_ok, int lane) {
  if (vec_ok) {
    for (int64_t j = c0 / V + lane; j < c1 / V; j += 32) {
      float av[V], xv[V];
      unpack(load_pack<SA, V>(a + j * V), av);
      unpack(load_pack<SX, V>(x + j * V), xv);
      acc.add_vec(av, xv);
    }
  } else {
    for (int64_t j = c0 + lane; j < c1; j += 32) acc.add(0, load_f32(a[j]), load_f32(x[j]));
  }
}

// the row's sum of products in the tier's arithmetic; valid in lane 0
template <class SA, class SX, int TIER>
__device__ __forceinline__ value_t<TIER> row_sum(const SA* __restrict__ a,
                                                 const SX* __restrict__ x, int64_t n,
                                                 int64_t bn, int vec_ok, int lane) {
  constexpr int V = vec_width<SA, SX>();
  if constexpr (TIER == TIER_BF16 || TIER == TIER_F16) {
    float acc = 0.f;
    for (int64_t c0 = 0; c0 < n; c0 += bn) {
      RoundedF32<TIER, V> blk;
      lane_sum<SA, SX, V>(blk, a, x, c0, c0 + bn < n ? c0 + bn : n, vec_ok, lane);
      float part = warp_reduce<TIER_F32>(blk.f.result());
      part = __shfl_sync(0xffffffffu, part, 0);
      acc = round_ar<TIER>(__fadd_rn(acc, round_ar<TIER>(part)));
    }
    return acc;
  } else {
    ThreadAcc<TIER, V> acc;
    lane_sum<SA, SX, V>(acc, a, x, 0, n, vec_ok, lane);
    return warp_reduce<TIER>(acc.result());
  }
}

template <class SA, class SX, int TIER>
__global__ void __launch_bounds__(kWarps * 32)
    gemv_rows(const SA* __restrict__ A, const SX* __restrict__ x, const void* res, int res_st,
              void* out, float* out_lo, int64_t m, int64_t n, float alpha, float beta,
              int64_t bn, int vec_ok) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= m) return;  // a whole warp leaves together
  const value_t<TIER> total = row_sum<SA, SX, TIER>(A + row * n, x, n, bn, vec_ok, lane);
  if (lane != 0) return;
  // beta == 0: res is never read (it may hold garbage or NaN)
  const float rv = beta == 0.f ? 0.f : __fmul_rn(load_code(res, row, res_st), beta);
  if constexpr (is_df_tier(TIER)) {
    const DF o = df_add(df_mul_f32(total, alpha), DF{rv, 0.f});
    if (out_lo != nullptr) {
      static_cast<float*>(out)[row] = o.hi;
      out_lo[row] = o.lo;
    } else {
      store_code(out, row, res_st, __fadd_rn(o.hi, o.lo));
    }
  } else {
    store_code(out, row, res_st, round_ar<TIER>(__fadd_rn(__fmul_rn(total, alpha), rv)));
  }
}

}  // namespace
}  // namespace accblas

// A: m x n row-major (storage a_st), x: n (x_st), res and out: m (res_st);
// out_lo: null, or m floats that receive the lo words of an unrounded df64
// result (out then receives the hi words as floats). bn: column block of
// the bf16/f16 tiers. vec_ok: A and x 16-byte aligned and n a multiple of
// the vector width. Returns cudaGetLastError() after the launch.
extern "C" int accblas_gemv(const void* A, int a_st, const void* x, int x_st, const void* res,
                            int res_st, void* out, float* out_lo, int64_t m, int64_t n,
                            float alpha, float beta, int tier, int64_t bn, int vec_ok,
                            void* stream) {
  using namespace accblas;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = static_cast<unsigned>((m + kWarps - 1) / kWarps);
  return with_storage(a_st, [&](auto ta) {
    return with_storage(x_st, [&](auto tx) {
      return with_tier(tier, [&](auto tt) {
        using SA = typename decltype(ta)::type;
        using SX = typename decltype(tx)::type;
        constexpr int TIER = decltype(tt)::value;
        gemv_rows<SA, SX, TIER><<<blocks, kWarps * 32, 0, s>>>(
            static_cast<const SA*>(A), static_cast<const SX*>(x), res, res_st, out, out_lo, m,
            n, alpha, beta, bn, vec_ok);
        return cudaGetLastError();
      });
    });
  });
}
