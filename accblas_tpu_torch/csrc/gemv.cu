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
// x stored in f8 (gemv_staged). There the conversions, not the loads, held
// the kernel: widening an f8 value takes a conversion to f16 (F2FP) and one
// to f32, and with one warp a row every row widened all of x again, m * n
// widenings of n values. So a CTA widens x once, into shared memory, and
// its warps then walk the rows of a persistent grid (as many CTAs as the
// shared memory and registers let an SM hold): x costs n widenings a CTA.
// A is widened two values a conversion (Row::widen_paired). The staged x
// is a Range of one row a lane step (V values) with a 16-byte gap after
// each row wider than 16 bytes, so that the 8 lanes of a quarter warp read
// 16 bytes each from 8 distinct bank groups. A lane keeps its columns, its
// steps in flight, its sums and their order, and the shuffle tree and
// epilogue are the per-row kernel's, so the bits are the per-row kernel's
// (widening f8 is exact, either way). Timed against gemv_rows on f8 x at
// 24576^2 (scripts/torch_generic_ab.py, scripts/torch_gemv_variants.py):
// 21% faster on the device in the f32 tier,
// 20% and 11% in the df64 tiers; slower where the work is bound by
// latency, which gemv_rows' many CTAs an SM hide and one staged CTA an SM
// does not: the bf16/f16 tiers, whose 1024-column blocks each end in a
// warp reduction (17%), and the element reads of unaligned or ragged
// operands (22%); and with bf16 A (8-value steps), where it was 0.3-0.7%
// slower at 16384^2 in every run (f32 A was not timed). So it takes A and
// x both stored in f8, in the f32 and df64 tiers, on the vector steps, up
// to the widest x a CTA's shared memory stages (46480 columns); the C
// entry (accblas_gemv) chooses, and sends every other call to gemv_rows.
//
// x given as a DF pair (gemv_rows_dfx). The residual r = b - A x of an
// iterative refinement (models/solvers.py lu_refine) needs x to more than
// an f32's precision: an f32 x caps the backward error near 6e-8, while
// HPL's test asks for 16 n 2^-53. Two passes, A x_hi then A x_lo, would read
// A twice; this kernel reads it once, with gemv_rows' rows, lanes, vector
// steps, fold and epilogue, in the precise df64 tier: each product of a
// with x_hi is exact (two_prod), and a * x_lo, an f32 product, joins the
// chain's error word (DFXChains), so a row's sum carries x_lo's part to
// about 2^-48 of the sum of |a||x|. A step loads three packs (A, x_hi,
// x_lo), so a lane keeps kDfxLoads = 8 steps in flight. The C entry is
// accblas_gemv_dfx. At 65536^2 on f32 A it read 5.53 ms on an H100 (700 W),
// 3.10 TB/s over A, x's two words, b and r's two words, against 5.41 ms
// for gemv_rows' precise tier on an f32 x (PERF.md).
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
//
// Every operand is read, and the result written, through the device
// accessor (range.cuh), as the JAX kernels read A and x and store through
// Ranges: A an (m, n) range whose rows are taken once (row(i)), x a (1, n)
// one, both read V stored values at a time (row.pack<V>, widened with
// Row::widen once the step's loads are issued), or one element at a time
// (row.from(j)(0)) where the operands are not aligned; a lane's walk along
// its rows moves their bases (row.from), as the pointers moved before, so
// a row may pass 2^31 columns as before. res and the result, whose storage
// the kernel is not instantiated on, go through coded ranges
// (Range<ReducedRowMajor<Ar, Coded>>, one dispatch a row); the unrounded
// (hi, lo) result through two f32 ranges. The ranges are built in the
// kernel from the restrict-qualified pointers it is given.

#include "range.cuh"
#include "reduce.cuh"

namespace accblas {
namespace {

constexpr int kWarps = 4;   // warps per CTA
constexpr int kLoads = 16;  // vector loads of A a lane issues before it adds one
// rows a warp takes, which then share each load of x (U = kLoads / kRows
// vector steps of each row are loaded at a time)
constexpr int kRows = 1;
// vector steps a lane of gemv_rows_dfx loads before it adds one: each is
// three packs (A, x_hi, x_lo), against two in gemv_rows
constexpr int kDfxLoads = 8;
// warps per CTA of the staged kernel, whose grid is persistent: x is
// widened once a CTA, and at 24576 columns the staged x takes more than
// half of an SM's shared memory, so one CTA an SM (8 warps were slower, 32
// no faster)
constexpr int kStagedWarps = 16;
// the type x is staged in: f32, or f16, which holds every f8 value exactly
using XStage = float;

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

// a row of A, and x, as the kernel reads them: f32 values of the stored ones
template <class S>
using in_row = row_t<float, const S>;

// values of the staged x in one 16-byte piece
constexpr int kStagedPiece = 16 / sizeof(XStage);

// the row stride of the staged x, in values: V, and a 16-byte gap after a
// row wider than 16 bytes. A lane reads its step's row in 16-byte pieces;
// rows of 2 or 4 pieces plus a gap are 3 or 5 pieces apart, odd, so the 8
// lanes of a quarter warp hit 8 distinct groups of 4 banks
template <int V>
__host__ __device__ constexpr int staged_stride() {
  return V * sizeof(XStage) > 16 ? V + kStagedPiece : V;
}

// x as widened into shared memory by a CTA of gemv_staged, read as a row of
// x is read: from(d) moves it d columns on, (0) is the value at its column
// 0, and load(j, v) gives the V values from its column j (j and the column
// it stands at multiples of V, as in the vector steps). Its range holds
// ceil(n / V) rows of V values, one lane step each, in the row stride
// staged_stride<V>().
template <int V>
struct StagedX {
  range_t<float, const XStage> r;
  int64_t c;  // the column its column 0 is

  // x is one row: row(0) is the reader itself, as x's range gives its row
  __device__ __forceinline__ StagedX row(int64_t) const { return *this; }
  __device__ __forceinline__ StagedX from(int64_t d) const { return {r, c + d}; }
  __device__ __forceinline__ float operator()(int j) const {
    const int64_t k = c + j;
    return r.get(k >> log2_of(V), k & (V - 1));
  }
  __device__ __forceinline__ void load(int j, float (&v)[V]) const {
    constexpr int P = V < kStagedPiece ? V : kStagedPiece;
    const auto row = r.row((c >> log2_of(V)) + (j >> log2_of(V)));
#pragma unroll
    for (int q = 0; q < V; q += P) {
      float w[P];
      row.template load<P>(q, w);
#pragma unroll
      for (int u = 0; u < P; ++u) v[q + u] = w[u];
    }
  }
};

// K vector steps of R rows: every load issued, then the products added in
// column order; the rows and x move past the K steps
template <int K, int R, int V, class SA, class SX, class Acc>
__device__ __forceinline__ void vec_steps(Acc (&acc)[R], in_row<SA> (&a)[R], in_row<SX>& x) {
  constexpr int kStride = 32 * V;  // elements between a lane's steps
  Pack<SX, V> xp[K];
  Pack<SA, V> ap[K][R];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    xp[u] = x.template pack<V>(u * kStride);
#pragma unroll
    for (int r = 0; r < R; ++r) ap[u][r] = a[r].template pack<V>(u * kStride);
  }
#pragma unroll
  for (int u = 0; u < K; ++u) {
    float xv[V];
    in_row<SX>::widen(xp[u], xv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float av[V];
      in_row<SA>::widen(ap[u][r], av);
      acc[r].add_vec(av, xv);
    }
  }
  x = x.from(K * kStride);
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = a[r].from(K * kStride);
}

// the same K steps with x staged in shared memory: only A's loads are kept
// in flight, x is read where a step is added and A widened two values a
// conversion
template <int K, int R, int V, class SA, class SX, class Acc>
__device__ __forceinline__ void vec_steps(Acc (&acc)[R], in_row<SA> (&a)[R], StagedX<V>& x) {
  constexpr int kStride = 32 * V;
  Pack<SA, V> ap[K][R];
#pragma unroll
  for (int u = 0; u < K; ++u) {
#pragma unroll
    for (int r = 0; r < R; ++r) ap[u][r] = a[r].template pack<V>(u * kStride);
  }
#pragma unroll
  for (int u = 0; u < K; ++u) {
    float xv[V];
    x.load(u * kStride, xv);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float av[V];
      in_row<SA>::widen_paired(ap[u][r], av);
      acc[r].add_vec(av, xv);
    }
  }
  x = x.from(K * kStride);
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = a[r].from(K * kStride);
}

// x given as a DF pair, its hi and lo words two f32 rows (gemv_rows_dfx),
// read as a row of x is read: from(d) moves both d columns on, (j) is the
// DF at column j
struct DFXRow {
  in_row<float> hi, lo;
  __device__ __forceinline__ DFXRow from(int64_t d) const { return {hi.from(d), lo.from(d)}; }
  __device__ __forceinline__ DF operator()(int j) const {
    return DF{static_cast<float>(hi(j)), static_cast<float>(lo(j))};
  }
};

// the precise df64 tier's chains with x a DF: the exact product of a with
// x_hi (two_prod), and the f32 product a * x_lo added to the chain's error
// word with the product's low word and the add's rounding
template <int V>
struct DFXChains : DFChains<TIER_DF_PRECISE, V> {
  __device__ __forceinline__ void add(int j, float a, DF x) {
    float p, pe, t, e;
    two_prod(a, x.hi, p, pe);
    two_sum(this->s[j], p, t, e);
    this->c[j] = __fadd_rn(this->c[j], __fadd_rn(e, __fadd_rn(pe, __fmul_rn(a, x.lo))));
    this->s[j] = t;
  }
};

// the K steps with x a DF pair: every load of A, x_hi and x_lo issued, then
// the products added in column order
template <int K, int R, int V, class SA, class SX, class Acc>
__device__ __forceinline__ void vec_steps(Acc (&acc)[R], in_row<SA> (&a)[R], DFXRow& x) {
  constexpr int kStride = 32 * V;
  Pack<float, V> hp[K], lp[K];
  Pack<SA, V> ap[K][R];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    hp[u] = x.hi.pack<V>(u * kStride);
    lp[u] = x.lo.pack<V>(u * kStride);
#pragma unroll
    for (int r = 0; r < R; ++r) ap[u][r] = a[r].template pack<V>(u * kStride);
  }
#pragma unroll
  for (int u = 0; u < K; ++u) {
    float h[V], l[V];
    in_row<float>::widen(hp[u], h);
    in_row<float>::widen(lp[u], l);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float av[V];
      in_row<SA>::widen(ap[u][r], av);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[r].add(j, av[j], DF{h[j], l[j]});
    }
  }
  x = x.from(K * kStride);
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = a[r].from(K * kStride);
}

// x at column j, as lane_sum's element loads read it: a float of x's row or
// of the staged x, or a DF of x given as a pair (DFXRow)
template <class XR>
__device__ __forceinline__ float x_at(const XR& x, int64_t j) {
  return x.from(j)(0);
}
__device__ __forceinline__ DF x_at(const DFXRow& x, int64_t j) { return x.from(j)(0); }

// one lane's share of R rows' products over columns [c0, c1): vector steps
// lane, lane + 32, ... when `vec_ok` (c0, c1 multiples of V), U steps at a
// time, the ragged rest U / 4 at a time and then one at a time; else single
// elements. XR: x's row (in_row<SX>), or x staged (StagedX<V>).
template <int R, int U, int V, class SA, class SX, class Acc, class XR>
__device__ __forceinline__ void lane_sum(Acc (&acc)[R], const in_row<SA> (&row)[R], XR x,
                                         int64_t c0, int64_t c1, int vec_ok, int lane) {
  if (vec_ok) {
    const int64_t j0 = c0 / V + lane, j1 = c1 / V;
    const int64_t steps = j0 < j1 ? (j1 - j0 + 31) / 32 : 0;
    XR xs = x.from(j0 * V);
    in_row<SA> as[R];
#pragma unroll
    for (int r = 0; r < R; ++r) as[r] = row[r].from(j0 * V);
    constexpr int U4 = U / 4 > 1 ? U / 4 : 1;
    int64_t s = 0;
    for (; s + U <= steps; s += U) vec_steps<U, R, V, SA, SX>(acc, as, xs);
    for (; s + U4 <= steps; s += U4) vec_steps<U4, R, V, SA, SX>(acc, as, xs);
    for (; s < steps; ++s) vec_steps<1, R, V, SA, SX>(acc, as, xs);
  } else {
    for (int64_t j = c0 + lane; j < c1; j += 32) {
      const auto xv = x_at(x, j);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r].add(0, row[r].from(j)(0), xv);
    }
  }
}

// the R rows' sums of products in the tier's arithmetic; valid in lane 0
template <class SA, class SX, int TIER, int R, class XR>
__device__ __forceinline__ void rows_sum(value_t<TIER> (&total)[R], const in_row<SA> (&row)[R],
                                         XR x, int64_t n, int64_t bn, int vec_ok, int lane) {
  constexpr int V = vec_width<SA, SX>();
  constexpr int U = kLoads / R;
  if constexpr (TIER == TIER_BF16 || TIER == TIER_F16) {
#pragma unroll
    for (int r = 0; r < R; ++r) total[r] = 0.f;
    for (int64_t c0 = 0; c0 < n; c0 += bn) {
      RoundedF32<TIER, V> blk[R];
      lane_sum<R, U, V, SA, SX>(blk, row, x, c0, c0 + bn < n ? c0 + bn : n, vec_ok, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float part = warp_reduce<TIER_F32>(blk[r].f.result());
        part = __shfl_sync(0xffffffffu, part, 0);
        total[r] = round_ar<TIER>(__fadd_rn(total[r], round_ar<TIER>(part)));
      }
    }
  } else {
    ThreadAcc<TIER, V> acc[R];
    lane_sum<R, U, V, SA, SX>(acc, row, x, 0, n, vec_ok, lane);
#pragma unroll
    for (int r = 0; r < R; ++r) total[r] = warp_reduce<TIER>(acc[r].result());
  }
}

// where row i's result goes: the (m, 1) result in the storage of res, or,
// for the unrounded df64 result (df_out), its hi and lo words as f32
template <int TIER>
struct Out {
  range_t<value_t<TIER>, Coded> val;
  range_t<float, float> hi, lo;
  bool df_out;
};

// row i's result from its sum of products: alpha and beta in the tier's
// arithmetic; res is never read when beta == 0 (it may hold garbage or NaN)
template <int TIER>
__device__ __forceinline__ void store_row(value_t<TIER> total, const range_t<float, const Coded>& res,
                                          const Out<TIER>& out, int64_t i, float alpha,
                                          float beta) {
  const float rv = beta == 0.f ? 0.f : __fmul_rn(res(i, 0), beta);
  if constexpr (is_df_tier(TIER)) {
    const DF o = df_add(df_mul_f32(total, alpha), DF{rv, 0.f});
    if (out.df_out) {
      out.hi(i, 0) = o.hi;
      out.lo(i, 0) = o.lo;
    } else {
      out.val(i, 0) = o;
    }
  } else {
    out.val(i, 0) = round_ar<TIER>(__fadd_rn(__fmul_rn(total, alpha), rv));
  }
}

// one warp's kRows consecutive rows from row0: the last group's rows past m
// re-read row m - 1 and store nothing. x: x's (1, n) range, or x staged.
template <class SA, class SX, int TIER, class XRange>
__device__ __forceinline__ void gemv_group(const range_t<float, const SA>& a, const XRange& x,
                                           const range_t<float, const Coded>& res,
                                           const Out<TIER>& out, float alpha, float beta,
                                           int64_t bn, int vec_ok, int64_t row0, int lane) {
  const int64_t m = a.length(0);
  in_row<SA> row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) row[r] = a.row(row0 + r < m ? row0 + r : m - 1);
  value_t<TIER> total[kRows];
  rows_sum<SA, SX, TIER, kRows>(total, row, x.row(0), a.length(1), bn, vec_ok, lane);
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r < m) store_row<TIER>(total[r], res, out, row0 + r, alpha, beta);
  }
}

template <class SA, class SX, int TIER>
__global__ void __launch_bounds__(kWarps * 32)
    gemv_rows(const SA* __restrict__ A, const SX* __restrict__ x, const void* res, int res_st,
              void* out, float* out_lo, int64_t m, int64_t n, float alpha, float beta,
              int64_t bn, int vec_ok) {
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kRows;
  if (row0 < m) {  // a whole warp leaves together
    const range_t<float, const SA> ra(A, m, n, n);
    const range_t<float, const SX> rx(x, 1, n, n);
    const range_t<float, const Coded> rr(res, res_st, m, 1, 1);
    const Out<TIER> ro{range_t<value_t<TIER>, Coded>(out, res_st, m, 1, 1),
                       range_t<float, float>(static_cast<float*>(out), m, 1, 1),
                       range_t<float, float>(out_lo, m, 1, 1), out_lo != nullptr};
    gemv_group<SA, SX, TIER>(ra, rx, rr, ro, alpha, beta, bn, vec_ok, row0, threadIdx.x & 31);
  }
}

// gemv_rows for x given as a DF pair (x_hi, x_lo, both f32) in the precise
// df64 tier: the residual r = b - A x of a refinement whose x carries more
// than an f32 holds. One pass over A: each lane's chains add the exact
// products of A with x_hi and the f32 products with x_lo (DFXChains), so the
// row's sum keeps x_lo's part without a second pass, A x_lo, over A. A step
// loads three packs (A, x_hi, x_lo), so a lane keeps kDfxLoads of them in
// flight rather than kLoads; the fold, the epilogue and the result are
// gemv_rows' (store_row), in the storage of res or as the (hi, lo) pair.
template <class SA>
__global__ void __launch_bounds__(kWarps * 32)
    gemv_rows_dfx(const SA* __restrict__ A, const float* __restrict__ x_hi,
                  const float* __restrict__ x_lo, const void* res, int res_st, void* out,
                  float* out_lo, int64_t m, int64_t n, float alpha, float beta, int vec_ok) {
  constexpr int V = vec_width<SA, float>();
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kRows;
  if (row0 >= m) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const range_t<float, const SA> ra(A, m, n, n);
  const DFXRow x{range_t<float, const float>(x_hi, 1, n, n).row(0),
                 range_t<float, const float>(x_lo, 1, n, n).row(0)};
  const range_t<float, const Coded> rr(res, res_st, m, 1, 1);
  const Out<TIER_DF_PRECISE> ro{range_t<DF, Coded>(out, res_st, m, 1, 1),
                                range_t<float, float>(static_cast<float*>(out), m, 1, 1),
                                range_t<float, float>(out_lo, m, 1, 1), out_lo != nullptr};
  in_row<SA> row[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) row[r] = ra.row(row0 + r < m ? row0 + r : m - 1);
  DFXChains<V> acc[kRows];
  lane_sum<kRows, kDfxLoads / kRows, V, SA, float>(acc, row, x, 0, n, vec_ok, lane);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const DF total = warp_reduce<TIER_DF_PRECISE>(acc[r].result());
    if (lane == 0 && row0 + r < m) store_row<TIER_DF_PRECISE>(total, rr, ro, row0 + r, alpha, beta);
  }
}

// x widened from its storage into the staged range xs by every thread of
// the CTA: V values (one row of xs) a thread at a time, two a conversion
template <int V, class SX>
__device__ __forceinline__ void stage_x(const range_t<float, XStage>& xs, const in_row<SX>& x,
                                        int64_t n) {
  constexpr int P = V < kStagedPiece ? V : kStagedPiece;
#pragma unroll 4
  for (int64_t j = threadIdx.x; j < n / V; j += blockDim.x) {
    float v[V];
    in_row<SX>::widen_paired(x.from(j * V).template pack<V>(0), v);
    const auto row = xs.row(j);
#pragma unroll
    for (int q = 0; q < V; q += P) {
      float w[P];
#pragma unroll
      for (int u = 0; u < P; ++u) w[u] = v[q + u];
      row.template store<P>(q, w);
    }
  }
}

// gemv_rows for A and x stored in f8, x widened once per CTA (the header),
// in the f32 and df64 tiers and on the vector steps only (A and x 16-byte
// aligned, n a multiple of V): the CTA stages x, then its warps take the
// rows blockIdx.x * kStagedWarps + warp, stepping by the grid's warps
template <class SA, class SX, int TIER>
__global__ void __launch_bounds__(kStagedWarps * 32)
    gemv_staged(const SA* __restrict__ A, const SX* __restrict__ x, const void* res, int res_st,
                void* out, float* out_lo, int64_t m, int64_t n, float alpha, float beta) {
  constexpr int V = vec_width<SA, SX>();
  extern __shared__ __align__(16) unsigned char x_smem[];
  const range_t<float, XStage> xs(reinterpret_cast<XStage*>(x_smem), n / V, V,
                                  staged_stride<V>());
  stage_x<V, SX>(xs, range_t<float, const SX>(x, 1, n, n).row(0), n);
  __syncthreads();
  const range_t<float, const SA> ra(A, m, n, n);
  const range_t<float, const Coded> rr(res, res_st, m, 1, 1);
  const Out<TIER> ro{range_t<value_t<TIER>, Coded>(out, res_st, m, 1, 1),
                     range_t<float, float>(static_cast<float*>(out), m, 1, 1),
                     range_t<float, float>(out_lo, m, 1, 1), out_lo != nullptr};
  const StagedX<V> sx{range_t<float, const XStage>(reinterpret_cast<const XStage*>(x_smem),
                                                   n / V, V, staged_stride<V>()),
                      0};
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kStagedWarps;
  for (int64_t row0 = static_cast<int64_t>(blockIdx.x) * kStagedWarps + (threadIdx.x >> 5);
       row0 < m; row0 += warps) {  // a whole warp leaves together
    // the f32 and df64 tiers take no column blocks (bn), and vec_ok holds
    gemv_group<SA, SX, TIER>(ra, sx, rr, ro, alpha, beta, n, 1, row0, threadIdx.x & 31);
  }
}

// the largest dynamic shared memory a CTA may take (an H100's opt-in
// limit)
constexpr int64_t kMaxStagedBytes = 232448;

// the staged x's shared memory at n columns (n a multiple of V)
template <int V>
constexpr int64_t staged_bytes(int64_t n) {
  return n / V * staged_stride<V>() * int64_t{sizeof(XStage)};
}

// whether the C entry sends a call to gemv_staged: A and x stored in f8,
// the f32 or df64 tiers (the header says why)
template <class SA, class SX, int TIER>
constexpr bool kStaged = is_f8<SA> && is_f8<SX> && TIER != TIER_BF16 && TIER != TIER_F16;

// launch gemv_staged (n a multiple of V, staged_bytes<V>(n) within
// kMaxStagedBytes): the first launch on a device lifts the CTA's shared
// memory limit; the grid is as many CTAs as the card holds at once (the
// occupancy of the last shared memory size asked, kept a device), or fewer
// where m has fewer rows than their warps
template <class SA, class SX, int TIER>
cudaError_t launch_staged(const void* A, const void* x, const void* res, int res_st, void* out,
                          float* out_lo, int64_t m, int64_t n, float alpha, float beta,
                          cudaStream_t s) {
  constexpr int V = vec_width<SA, SX>();
  constexpr int kDevices = 64;
  static int sms[kDevices], per_sm[kDevices];
  static int64_t sized[kDevices];  // the shared memory bytes per_sm was found for, + 1
  const auto kern = gemv_staged<SA, SX, TIER>;
  const int64_t smem = staged_bytes<V>(n);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (sized[dev] == 0) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxStagedBytes));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (sized[dev] != smem + 1) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], kern, kStagedWarps * 32,
                                                        static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    sized[dev] = smem + 1;
  }
  const int64_t need = (m + kStagedWarps - 1) / kStagedWarps;
  const int64_t held = static_cast<int64_t>(per_sm[dev]) * sms[dev];
  kern<<<static_cast<unsigned>(need < held ? need : held), kStagedWarps * 32,
         static_cast<size_t>(smem), s>>>(static_cast<const SA*>(A), static_cast<const SX*>(x),
                                         res, res_st, out, out_lo, m, n, alpha, beta);
  return cudaGetLastError();
}

}  // namespace
}  // namespace accblas

// A: m x n row-major, x: n, res and out: m; out_lo: null, or m floats that
// receive the lo words of an unrounded df64 result (out then receives the
// hi words as floats). bn: column block of the bf16/f16 tiers. codes: the
// storage codes of A, x and res and the tier, 4 bits each from the lowest,
// and in bits 16-17 the kernel asked for: 0 the one this entry chooses, 1
// gemv_rows, 2 gemv_staged (refused with an error where this entry would
// not choose it but for its route request). The vector loads run where A
// and x are 16-byte aligned and n is a multiple of the vector width; the
// entry chooses gemv_staged for A and x stored in f8, in the f32 and df64
// tiers, on the vector loads, where the staged x fits in kMaxStagedBytes
// (n <= 46480), else gemv_rows. staged: null, or set to 1 where
// gemv_staged was launched and 0 where gemv_rows was. Returns
// cudaGetLastError() after the launch, or the error that kept the kernel
// from launching.
extern "C" int accblas_gemv(const void* A, const void* x, const void* res, void* out,
                            float* out_lo, int64_t m, int64_t n, float alpha, float beta,
                            int64_t bn, int codes, void* stream, int* staged) {
  using namespace accblas;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int res_st = (codes >> 8) & 15;
  const int ask = (codes >> 16) & 3;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(x)) & 15) == 0;
  return with_storage(codes & 15, [&](auto ta) {
    return with_storage((codes >> 4) & 15, [&](auto tx) {
      return with_tier((codes >> 12) & 15, [&](auto tt) {
        using SA = typename decltype(ta)::type;
        using SX = typename decltype(tx)::type;
        constexpr int TIER = decltype(tt)::value;
        constexpr int rows = kWarps * kRows;  // per CTA
        constexpr int V = vec_width<SA, SX>();
        const int vec_ok = aligned && n % V == 0;
        bool take = false;
        if constexpr (kStaged<SA, SX, TIER>) {
          take = ask != 1 && vec_ok && staged_bytes<V>(n) <= kMaxStagedBytes;
        }
        if (ask == 2 && !take) return cudaErrorInvalidValue;
        if (staged) *staged = take;
        if constexpr (kStaged<SA, SX, TIER>) {
          if (take)
            return launch_staged<SA, SX, TIER>(A, x, res, res_st, out, out_lo, m, n, alpha, beta,
                                               s);
        }
        const int64_t grid = (m + rows - 1) / rows;
        gemv_rows<SA, SX, TIER><<<static_cast<unsigned>(grid), kWarps * 32, 0, s>>>(
            static_cast<const SA*>(A), static_cast<const SX*>(x), res, res_st, out, out_lo, m, n,
            alpha, beta, bn, vec_ok);
        return cudaGetLastError();
      });
    });
  });
}

// gemv_rows_dfx: A m x n row-major in storage a_st, x given as a DF pair of
// n floats each (x_hi, x_lo), res and out as accblas_gemv's (res_st the
// storage of res and of out unless out_lo is given), in the precise df64
// tier; the arguments in accblas_gemv's order, x's two words in x's place.
// The vector loads run where A, x_hi and x_lo are 16-byte aligned and n is
// a multiple of the vector width. Returns cudaGetLastError() after the
// launch, or the error that kept the kernel from launching.
extern "C" int accblas_gemv_dfx(const void* A, const float* x_hi, const float* x_lo,
                                const void* res, void* out, float* out_lo, int64_t m,
                                int64_t n, float alpha, float beta, int a_st, int res_st,
                                void* stream) {
  using namespace accblas;
  const bool aligned = ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(x_hi) |
                         reinterpret_cast<uintptr_t>(x_lo)) & 15) == 0;
  return with_storage(a_st, [&](auto ta) {
    using SA = typename decltype(ta)::type;
    const int vec_ok = aligned && n % vec_width<SA, float>() == 0;
    constexpr int rows = kWarps * kRows;  // per CTA
    gemv_rows_dfx<SA><<<static_cast<unsigned>((m + rows - 1) / rows), kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const SA*>(A), x_hi, x_lo, res, res_st, out, out_lo, m, n, alpha, beta,
        vec_ok);
    return cudaGetLastError();
  });
}
