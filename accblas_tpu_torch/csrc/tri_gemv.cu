// Triangular residual: r = b - T x, T the upper or lower triangle of a full
// (LU-packed) n x n matrix A, with a unit diagonal when asked; f32 products
// accumulated as double-float, the result rounded to f32.
//
// Replaces the Pallas kernel `_tri_gemv_kernel` (accblas_tpu/ops/tri_gemv.py:27),
// which walks (block row, block column) pairs on a sequential grid, pads A
// to a block multiple first, and folds f32 block products into a (hi, lo)
// scratch pair. On the H100 the residual is bound by device-memory bytes:
// the triangle, n(n+1)/2 elements, is read once with one f32 product and one
// two_sum per element. So each row is one warp's: the lanes walk the row's
// triangle columns with 16-byte loads where A allows (element loads
// otherwise), each lane keeps a two_sum chain, and a fixed shuffle tree
// folds the lanes with df_add, so results repeat bit for bit. There is no
// padding: the kernel masks the triangle's edge itself.

#include "reduce.cuh"

namespace accblas {
namespace {

constexpr int kWarps = 8;  // rows per block, one warp each

template <class SA>
__global__ void __launch_bounds__(kWarps * 32)
    tri_gemv_rows(const SA* __restrict__ A, int64_t n, const float* __restrict__ x,
                  const float* __restrict__ b, float* __restrict__ r, int lower, int unit,
                  int vec_ok) {
  constexpr int V = 16 / sizeof(SA);
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // a whole warp leaves together
  // the row's triangle columns [c0, c1)
  const int64_t c0 = lower ? 0 : row;
  const int64_t c1 = lower ? row + 1 : n;
  const SA* arow = A + row * n;
  float s = 0.f, c = 0.f;  // the lane's chain: worth s + c
  auto add = [&](float a, int64_t col) {
    const float p = (unit && col == row) ? x[col] : __fmul_rn(a, x[col]);
    float t, e;
    two_sum(s, p, t, e);
    c = __fadd_rn(c, e);
    s = t;
  };
  if (vec_ok) {
    // whole vectors over [c0, c1), masked at both ends
    for (int64_t j = c0 / V + lane; j * V < c1; j += 32) {
      const Pack<SA, V> pk = load_pack<SA, V>(arow + j * V);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int64_t col = j * V + e;
        if (col >= c0 && col < c1) add(load_f32(pk.v[e]), col);
      }
    }
  } else {
    for (int64_t col = c0 + lane; col < c1; col += 32) add(load_f32(arow[col]), col);
  }
  DF acc;
  fast_two_sum(s, c, acc.hi, acc.lo);
  acc = warp_reduce<TIER_DF_PRECISE>(acc);
  if (lane == 0) {
    const DF res = df_add(DF{b[row], 0.f}, DF{-acc.hi, -acc.lo});
    r[row] = __fadd_rn(res.hi, res.lo);
  }
}

}  // namespace
}  // namespace accblas

// A: n x n row-major (storage a_st); x, b, r: n floats. vec_ok: A 16-byte
// aligned and n a multiple of the vector width. Returns cudaGetLastError().
extern "C" int accblas_tri_gemv(const void* A, int a_st, int64_t n, const float* x,
                                const float* b, float* r, int lower, int unit, int vec_ok,
                                void* stream) {
  using namespace accblas;
  const unsigned blocks = static_cast<unsigned>((n + kWarps - 1) / kWarps);
  return with_storage(a_st, [&](auto ta) {
    using SA = typename decltype(ta)::type;
    tri_gemv_rows<SA><<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const SA*>(A), n, x, b, r, lower, unit, vec_ok);
    return cudaGetLastError();
  });
}
