// GEMV: res_out = alpha * A @ x + beta * res, in the arithmetic of a tier.
//
// Replaces both Pallas GEMV kernels of accblas_tpu/ops/gemv.py:
// `_gemv_kernel` (row-block x column-block grid; the bf16/f16 tiers round
// each column-block partial before the cross-block add) and
// `_gemv_fullrow_kernel` (one full row panel at a time; the f32 tier and the
// df64 Kahan / two_sum chains, and the unrounded (hi, lo) output `df_out`).
//
// On the H100 a matrix-vector product is bound by the bytes of A read from
// device memory: 2 flops per element of A, however narrow its storage, and
// every byte of A read once; x is small and is served from L1 and L2. Each
// choice below was timed against its alternatives in one run
// (scripts/torch_gemv_variants.py, at 16384^2):
//   - loads in flight. A loop that adds each step as soon as it loads it
//     keeps about one load of A a lane outstanding. Here a lane loads
//     kLoads = 16 vector steps of its row (16 bytes of A and of x each)
//     before it adds the first, then the ragged rest U / 4 and 1 at a time;
//     ptxas keeps as many in flight as its registers allow. This gains most
//     in the df64 tiers, whose chains spend more instructions per element.
//   - rows per warp (kRows). Rows that share each load of x cut the reads
//     of x, but x is served from L1 either way, and each row adds a stream
//     of A per warp: 2 and 4 rows were slower on bf16 A (f32 and df64
//     tiers), and won or lost by 1-3% on f32 A, so a warp takes one row.
//   - cache hints. Streaming A past L1 (ld.global.nc.L1::no_allocate) and
//     reading x through the read-only cache (__ldg) were no faster, so both
//     are plain loads.
//   - the grid. 4 warps a CTA: 16384 rows are 4096 CTAs, many resident per
//     SM, so the last wave is a small share of the work. 8 warps a CTA, and
//     a grid of one wave whose warps loop over the rows, were no faster.
// What is left is the start and drain of a 0.16 ms stream: the port's DOT
// kernel streams the same 512 MiB at 89-91% of the bytes bound in the same
// runs (95.7% at 2 GiB), and this kernel comes within 2% of it.
//
// Each lane keeps its partial sums in registers, in the tier's arithmetic,
// adding its vector steps (lane, lane + 32, ...) in column order; the warp
// combines the lanes with a fixed shuffle tree. No atomics: the results
// repeat bit for bit from run to run, and the unrolling does not change them.
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

constexpr int kWarps = 4;   // warps per CTA
constexpr int kLoads = 16;  // vector loads of A a lane issues before it adds one
// rows a warp takes, which then share each load of x (U = kLoads / kRows
// vector steps of each row are loaded at a time)
constexpr int kRows = 1;

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

// K vector steps of R rows: every load issued, then the products added in
// column order; the pointers move past the K steps
template <int K, int R, int V, class SA, class SX, class Acc>
__device__ __forceinline__ void vec_steps(Acc (&acc)[R], const SA* (&a)[R], const SX*& x) {
  constexpr int kStride = 32 * V;  // elements between a lane's steps
  Pack<SX, V> xp[K];
  Pack<SA, V> ap[K][R];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    xp[u] = load_pack<SX, V>(x + u * kStride);
#pragma unroll
    for (int r = 0; r < R; ++r) ap[u][r] = load_pack<SA, V>(a[r] + u * kStride);
  }
#pragma unroll
  for (int u = 0; u < K; ++u) {
    float xv[V];
    unpack(xp[u], xv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float av[V];
      unpack(ap[u][r], av);
      acc[r].add_vec(av, xv);
    }
  }
  x += K * kStride;
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] += K * kStride;
}

// one lane's share of R rows' products over columns [c0, c1): vector steps
// lane, lane + 32, ... when `vec_ok` (c0, c1 multiples of V), U steps at a
// time, the ragged rest U / 4 at a time and then one at a time; else single
// elements
template <int R, int U, int V, class SA, class SX, class Acc>
__device__ __forceinline__ void lane_sum(Acc (&acc)[R], const SA* const (&row)[R],
                                         const SX* __restrict__ x, int64_t c0, int64_t c1,
                                         int vec_ok, int lane) {
  if (vec_ok) {
    const int64_t j0 = c0 / V + lane, j1 = c1 / V;
    const int64_t steps = j0 < j1 ? (j1 - j0 + 31) / 32 : 0;
    const SX* xs = x + j0 * V;
    const SA* as[R];
#pragma unroll
    for (int r = 0; r < R; ++r) as[r] = row[r] + j0 * V;
    constexpr int U4 = U / 4 > 1 ? U / 4 : 1;
    int64_t s = 0;
    for (; s + U <= steps; s += U) vec_steps<U, R, V>(acc, as, xs);
    for (; s + U4 <= steps; s += U4) vec_steps<U4, R, V>(acc, as, xs);
    for (; s < steps; ++s) vec_steps<1, R, V>(acc, as, xs);
  } else {
    for (int64_t j = c0 + lane; j < c1; j += 32) {
      const float xv = load_f32(x[j]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r].add(0, load_f32(row[r][j]), xv);
    }
  }
}

// the R rows' sums of products in the tier's arithmetic; valid in lane 0
template <class SA, class SX, int TIER, int R>
__device__ __forceinline__ void rows_sum(value_t<TIER> (&total)[R], const SA* const (&row)[R],
                                         const SX* __restrict__ x, int64_t n, int64_t bn,
                                         int vec_ok, int lane) {
  constexpr int V = vec_width<SA, SX>();
  constexpr int U = kLoads / R;
  if constexpr (TIER == TIER_BF16 || TIER == TIER_F16) {
#pragma unroll
    for (int r = 0; r < R; ++r) total[r] = 0.f;
    for (int64_t c0 = 0; c0 < n; c0 += bn) {
      RoundedF32<TIER, V> blk[R];
      lane_sum<R, U, V>(blk, row, x, c0, c0 + bn < n ? c0 + bn : n, vec_ok, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float part = warp_reduce<TIER_F32>(blk[r].f.result());
        part = __shfl_sync(0xffffffffu, part, 0);
        total[r] = round_ar<TIER>(__fadd_rn(total[r], round_ar<TIER>(part)));
      }
    }
  } else {
    ThreadAcc<TIER, V> acc[R];
    lane_sum<R, U, V>(acc, row, x, 0, n, vec_ok, lane);
#pragma unroll
    for (int r = 0; r < R; ++r) total[r] = warp_reduce<TIER>(acc[r].result());
  }
}

// row i's result from its sum of products: alpha and beta in the tier's
// arithmetic; res is never read when beta == 0 (it may hold garbage or NaN)
template <int TIER>
__device__ __forceinline__ void store_row(value_t<TIER> total, const void* res, int res_st,
                                          void* out, float* out_lo, int64_t i, float alpha,
                                          float beta) {
  const float rv = beta == 0.f ? 0.f : __fmul_rn(load_code(res, i, res_st), beta);
  if constexpr (is_df_tier(TIER)) {
    const DF o = df_add(df_mul_f32(total, alpha), DF{rv, 0.f});
    if (out_lo != nullptr) {
      static_cast<float*>(out)[i] = o.hi;
      out_lo[i] = o.lo;
    } else {
      store_code(out, i, res_st, __fadd_rn(o.hi, o.lo));
    }
  } else {
    store_code(out, i, res_st, round_ar<TIER>(__fadd_rn(__fmul_rn(total, alpha), rv)));
  }
}

// one warp's kRows consecutive rows from row0: the last group's rows past m
// re-read row m - 1 and store nothing
template <class SA, class SX, int TIER>
__device__ __forceinline__ void gemv_group(const SA* __restrict__ A, const SX* __restrict__ x,
                                           const void* res, int res_st, void* out,
                                           float* out_lo, int64_t m, int64_t n, float alpha,
                                           float beta, int64_t bn, int vec_ok, int64_t row0,
                                           int lane) {
  const SA* row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) row[r] = A + (row0 + r < m ? row0 + r : m - 1) * n;
  value_t<TIER> total[kRows];
  rows_sum<SA, SX, TIER, kRows>(total, row, x, n, bn, vec_ok, lane);
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r < m) {
      store_row<TIER>(total[r], res, res_st, out, out_lo, row0 + r, alpha, beta);
    }
  }
}

template <class SA, class SX, int TIER>
__global__ void __launch_bounds__(kWarps * 32)
    gemv_rows(const SA* __restrict__ A, const SX* __restrict__ x, const void* res, int res_st,
              void* out, float* out_lo, int64_t m, int64_t n, float alpha, float beta,
              int64_t bn, int vec_ok) {
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kRows;
  if (row0 < m) {  // a whole warp leaves together
    gemv_group<SA, SX, TIER>(A, x, res, res_st, out, out_lo, m, n, alpha, beta, bn, vec_ok,
                             row0, threadIdx.x & 31);
  }
}

}  // namespace
}  // namespace accblas

// A: m x n row-major, x: n, res and out: m; out_lo: null, or m floats that
// receive the lo words of an unrounded df64 result (out then receives the
// hi words as floats). bn: column block of the bf16/f16 tiers. codes: the
// storage codes of A, x and res and the tier, 4 bits each from the lowest
// (ops/gemv.py `_gemv_call`). The vector loads run where A and x are 16-byte
// aligned and n is a multiple of the vector width. Returns
// cudaGetLastError() after the launch.
extern "C" int accblas_gemv(const void* A, const void* x, const void* res, void* out,
                            float* out_lo, int64_t m, int64_t n, float alpha, float beta,
                            int64_t bn, int codes, void* stream) {
  using namespace accblas;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int res_st = (codes >> 8) & 15;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(x)) & 15) == 0;
  return with_storage(codes & 15, [&](auto ta) {
    return with_storage((codes >> 4) & 15, [&](auto tx) {
      return with_tier((codes >> 12) & 15, [&](auto tt) {
        using SA = typename decltype(ta)::type;
        using SX = typename decltype(tx)::type;
        constexpr int TIER = decltype(tt)::value;
        constexpr int rows = kWarps * kRows;  // per CTA
        const int vec_ok = aligned && n % vec_width<SA, SX>() == 0;
        const int64_t grid = (m + rows - 1) / rows;
        gemv_rows<SA, SX, TIER><<<static_cast<unsigned>(grid), kWarps * 32, 0, s>>>(
            static_cast<const SA*>(A), static_cast<const SX*>(x), res, res_st, out, out_lo, m, n,
            alpha, beta, bn, vec_ok);
        return cudaGetLastError();
      });
    });
  });
}
