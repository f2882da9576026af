// TRSV/TRSM: solve T X = B for the upper or lower triangle T of a full
// (LU-packed) n x n matrix A, k right-hand sides, in f32 or df64 arithmetic.
//
// Replaces the two Pallas kernels of accblas_tpu/ops/trsv.py:
//   `_extract_leaf_diag.kern` (:119) -> `leaf_diag` below: gathers the
//     kLeaf x kLeaf diagonal tiles of A as f32 and masks them to the
//     triangle in the same pass (what ops/common.py `tri_mask` does): the
//     dead triangle is zero, the diagonal is one where `unit`, and lanes
//     past n continue as the identity. It moves n * kLeaf elements each
//     way, a few microseconds; one CTA per tile with row-contiguous 16-byte
//     loads where A is aligned (`gather_leaf`, through range.cuh).
//     `leaf_phase` is phase 1 of a solve in one launch: the same gather
//     into shared memory, the tile inverted there, and the right-hand sides
//     laid out as the sweep reads them (below).
//   `_trsv_kernel` (:244) -> `trsv_sweep`: the whole sweep in one launch.
//
// The TPU kernel walks the live triangle on a sequential grid and carries
// the solved x in VMEM. Blocks of a CUDA grid run in parallel and in no
// order, so `trsv_sweep` orders itself, as the reference's own kernel does
// (cuda/trsv_kernels.cuh:69-235, after "A Fast Dense Triangular Solve in
// CUDA", doi 10.1137/12088358X):
//   - one CTA per block row of kLeaf rows and per panel of KP right-hand
//     sides; a block row's diagonal block is exactly one pre-inverted leaf;
//   - each CTA takes a ticket from an atomic counter of its panel, and the
//     ticket, not blockIdx, names its block row in dependency order (from
//     the bottom for upper, from the top for lower). A CTA waits only on
//     smaller tickets, held by CTAs that have already started, so the sweep
//     advances under any block scheduling order and for grids larger than
//     the card holds at once;
//   - a second counter per panel counts the block rows published. Before
//     any wait a CTA loads its leaf-inverse row and the tile of the column
//     block solved just before its own into registers; then it streams
//     every column block published so far, polling again only when it has
//     caught up, and adds A[rows, cols] * x[cols] in the order the blocks
//     were solved;
//   - once the block row before it has published, it adds that last tile,
//     folds its lanes in a fixed order, forms b - corr, multiplies by the
//     leaf inverse, stores x (hi and lo words for df64), and after a barrier
//     publishes with a release store of the counter; the result is written
//     in the output's storage after that, off the chain.
// So the waiting CTAs stream the triangle while the chain advances, and the
// chain is n / kLeaf steps of one tile-vector product, one lane fold and
// one inverse product. x is read with __ldcg (L2, never the non-coherent
// path); one thread per CTA polls with acquire loads and a __nanosleep
// backoff and a barrier releases the rest. Every wait is bounded: after
// kMaxPolls polls (seconds; a solve takes milliseconds) the kernel prints
// which wait ran out and traps, so a protocol fault fails the run with a
// CUDA error at the next synchronisation instead of hanging it.
//
// Sums: each right-hand side has its own accumulators, every thread adds
// its columns in the order the blocks were solved (in f32 each tile's
// partial sum, see add_tile), and lanes fold in a fixed tree; only tickets
// and counters are atomic. Results repeat bit for
// bit, and do not depend on KP or on when a block was streamed.
//
// What bounds it: the triangle is read once, n(n+1)/2 elements, about 2
// flops each (f32), so the solve is bound by device-memory bytes: 537 MB
// of f32 at n = 16384 is 0.16 ms at 3.35 TB/s. The chain of n / kLeaf
// dependent steps, each a few L2 round trips (the counter, x, the release),
// bounds it from the other side (PERF.md). kThreads = 256, no shared tiles
// and __launch_bounds__(kThreads, 2) hold two CTAs on every SM, so the 256
// block rows of n = 16384 are all resident at once on 132 SMs.
// Matrix-vector work: no wgmma, no TMA.
//
// Arithmetic: f32 sums of f32 products, a partial per tile; df64 carries x
// and the sums as (hi, lo) pairs: exact products of A with x_hi (two_prod),
// f32 products with x_lo, two_sum accumulation, df_add across lanes.
//
// The sweep reads its operands and writes its result through the device
// accessor (range.cuh), as the JAX kernel reads A and b and writes x through
// Ranges: A an (n, n) range, a thread's row taken once and each tile's
// columns from it (row.from), read V stored values at a time (row.load<V>)
// or one element at a time (r(j)) where A is not aligned; b a (k, npad) f32
// range; the result an (n, k) coded range (its storage chosen at run time).
// The published x is not an operand: it is the sweep's cross-CTA protocol
// (__stcg stores, load_cg reads through L2), which the JAX kernel keeps in
// VMEM scratch; an accessor read would allocate L1 lines, which are not
// coherent across CTAs within a launch.
//
// Phase 1, `leaf_phase`: one CTA per kLeaf-row leaf, m = npad / kLeaf of
// them. The CTA gathers its masked tile into shared memory (gather_leaf, the
// same code and bits as leaf_diag), upper tiles stored reversed (row and
// column kLeaf-1-i), so that every tile is lower triangular there, with the
// reciprocals of its diagonal beside it. Threads 0..kLeaf-1 then each solve
// one column c of the inverse in f32 registers against the identity column
// e_c, by forward substitution by rows (invert_column: fma sums in four
// chains, times the diagonal's reciprocal, not a division, which would sit
// on the chain of every row: column substitution dividing at each step took
// 20 us at n = 16384 on an H100, this 9.6); entries above the diagonal are
// written as exact zeros. The other threads meanwhile write the CTA's kLeaf
// columns of the (k, npad) f32 panels from b (any storage and strides, read
// through a coded range), zero past n: the cast is exact, so the panels
// have the bits of the plain version. The columns go through shared memory, then out coalesced,
// column-major per leaf (strides (kLeaf^2, 1, kLeaf)), the layout the sweep
// reads. A leaf past n is the identity, and lanes past n continue as the
// identity exactly: the masked tile is block diagonal there. The arithmetic
// is f32, as cuBLAS's batched triangular solve against the identity, which
// it replaces (ops/trsv.py `_leaf_inverses`, still the plain version's); the
// order of operations differs, so the inverses differ from cuBLAS's in the
// last bits: the card tests hold them within 1e-5 of each leaf's largest
// entry (tests/test_torch_cuda.py LEAF_INV_TOL); on an H100 they read at
// most 9.3e-9 on diagonally dominant operands in every storage, 2.2e-11 on
// the benchmark's unit upper operand at n = 16384. There the kernel takes
// 9.6 us against 53 us for leaf_diag, cuBLAS's solve and the panel ops it
// replaces (PERF.md).

#include <cstdio>

#include "range.cuh"
#include "reduce.cuh"

namespace accblas {
namespace {

constexpr int kLeaf = 64;                // rows of a block row (ops/trsv.py LEAF)
constexpr int kTpr = 4;                  // threads per row of a tile
constexpr int kThreads = kLeaf * kTpr;   // threads of a CTA
constexpr int kCols = kLeaf / kTpr;      // columns of a tile per thread
constexpr unsigned kMaxPolls = 1u << 21; // bound of one wait
constexpr unsigned kSpinPolls = 64;      // polls before each poll sleeps
constexpr unsigned kSleepNs = 256;       // the sleep between later polls

// the arithmetic of the reductions: f32, or df_add over (hi, lo) pairs
template <bool DF64>
constexpr int kRed = DF64 ? int(TIER_DF_PRECISE) : int(TIER_F32);

template <bool DF64>
using val_t = value_t<kRed<DF64>>;

// one lane's sum of a[c] * (x_hi[c] + x_lo[c])
template <bool DF64>
struct DotAcc {
  float s = 0.f, c = 0.f;
  __device__ __forceinline__ void add(float a, float xh, float xl) {
    if constexpr (DF64) {
      float p, pe, t, e;
      two_prod(a, xh, p, pe);
      two_sum(s, p, t, e);
      c = __fadd_rn(c, __fadd_rn(e, __fadd_rn(pe, __fmul_rn(a, xl))));
      s = t;
    } else {
      s = __fadd_rn(s, __fmul_rn(a, xh));
    }
  }
  __device__ __forceinline__ val_t<DF64> value() const {
    if constexpr (DF64) {
      DF r;
      fast_two_sum(s, c, r.hi, r.lo);
      return r;
    } else {
      return s;
    }
  }
};

__device__ __forceinline__ float hi_of(float v) { return v; }
__device__ __forceinline__ float hi_of(DF v) { return v.hi; }
__device__ __forceinline__ float lo_of(float) { return 0.f; }
__device__ __forceinline__ float lo_of(DF v) { return v.lo; }

template <bool DF64>
__device__ __forceinline__ val_t<DF64> make_val(float hi, float lo) {
  if constexpr (DF64) {
    return DF{hi, lo};
  } else {
    return hi;
  }
}

// a - b in the arithmetic of the sweep
template <bool DF64>
__device__ __forceinline__ val_t<DF64> sub(val_t<DF64> a, val_t<DF64> b) {
  if constexpr (DF64) {
    return df_add(a, DF{-b.hi, -b.lo});
  } else {
    return __fsub_rn(a, b);
  }
}

// sum over the kTpr consecutive lanes of a row, (l0 + l2) + (l1 + l3);
// valid in the row's first lane
template <bool DF64>
__device__ __forceinline__ val_t<DF64> row_fold(val_t<DF64> v) {
#pragma unroll
  for (int off = kTpr / 2; off > 0; off >>= 1) v = combine<kRed<DF64>>(v, shfl_down(v, off));
  return v;
}

// ---- phase 1: the leaf gather, and the leaf phase ----

// The masked gather of the leaf tile at rows and columns base..base+kLeaf-1
// by a CTA of kThreads threads: A[base + i, base + j] as f32 on the live
// triangle inside n, one on the diagonal where `unit` or past n, zero
// elsewhere. Each step takes V = 16 bytes of SA of one row (one aligned read
// where vec_ok) and hands them to put(i, j0, v), columns j0..j0+V-1.
template <class SA, class Put>
__device__ __forceinline__ void gather_leaf(const range_t<float, const SA>& ra, int64_t n,
                                            int64_t base, int lower, int unit, int vec_ok,
                                            Put&& put) {
  constexpr int V = 16 / sizeof(SA);
  constexpr int VR = kLeaf / V;  // vectors per tile row
  for (int e = threadIdx.x; e < kLeaf * VR; e += kThreads) {
    const int i = e / VR, j0 = (e % VR) * V;
    const int64_t row = base + i, col = base + j0;
    // the vector holds a live element only if it reaches the triangle
    const bool live = row < n && col < n && (lower ? j0 <= i : j0 + V - 1 >= i);
    float v[V];
    if (live && vec_ok) {
      ra.row(row).from(col).template load<V>(0, v);
    } else if (live) {
      const row_t<float, const SA> tr = ra.row(row).from(col);
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = col + u < n ? static_cast<float>(tr(u)) : 0.f;
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int j = j0 + u;
      const bool keep = (lower ? i >= j : i <= j) && row < n && base + j < n;
      v[u] = keep ? v[u] : 0.f;
      if (i == j && (unit || row >= n)) v[u] = 1.f;
    }
    put(i, j0, v);
  }
}

// tile blockIdx.x of d, gathered and masked (gather_leaf)
template <class SA>
__global__ void __launch_bounds__(kThreads)
    leaf_diag(const SA* __restrict__ A, int64_t n, float* __restrict__ d, int lower, int unit,
              int vec_ok) {
  const range_t<float, const SA> ra(A, n, n, n);
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kLeaf;
  float* tile = d + static_cast<int64_t>(blockIdx.x) * kLeaf * kLeaf;
  gather_leaf<SA>(ra, n, base, lower, unit, vec_ok, [&](int i, int j0, const auto& v) {
    constexpr int V = std::extent_v<std::remove_reference_t<decltype(v)>>;
#pragma unroll
    for (int u = 0; u < V; u += 4) {
      *reinterpret_cast<float4*>(tile + i * kLeaf + j0 + u) =
          make_float4(v[u], v[u + 1], v[u + 2], v[u + 3]);
    }
  });
}

// Column c of the inverse of the lower triangular tile s (row-major in
// shared memory), into x, given r[i] = 1 / s_ii: by rows, x_i = (e_c[i] -
// sum_{j<i} s_ij x_j) * r[i], the sum taken in four fma chains (j mod 4)
// added as (0 + 1) + (2 + 3). The chains keep four products in flight, and
// row i's sum runs ahead of x_{i-1}; row i of s is read four values at a
// time, the same address in every thread (a broadcast).
__device__ __forceinline__ void invert_column(const float (&s)[kLeaf][kLeaf],
                                              const float (&r)[kLeaf], int c,
                                              float (&x)[kLeaf]) {
#pragma unroll
  for (int i = 0; i < kLeaf; ++i) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j0 = 0; j0 < i; j0 += 4) {
      const float4 t = *reinterpret_cast<const float4*>(&s[i][j0]);
      const float ts[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j0 + u < i) acc[u] = __fmaf_rn(ts[u], x[j0 + u], acc[u]);
      }
    }
    const float sum = __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
    x[i] = __fmul_rn(__fsub_rn(i == c ? 1.f : 0.f, sum), r[i]);
  }
}

// Phase 1 for leaf blockIdx.x (the note at the top): its masked tile
// inverted into inv (m leaves, column-major per leaf), and its kLeaf columns
// of the (k, npad) panels bt from b, element (i, q) at b[i * bs0 + q * bs1]
// in storage b_st.
template <class SA>
__global__ void __launch_bounds__(kThreads)
    leaf_phase(const SA* __restrict__ A, int64_t n, const void* __restrict__ b, int b_st,
               int64_t bs0, int64_t bs1, int64_t k, float* __restrict__ inv,
               float* __restrict__ bt, int64_t npad, int lower, int unit, int vec_ok) {
  __shared__ __align__(16) float s[kLeaf][kLeaf];  // the tile, lower triangular
  __shared__ float r[kLeaf];                       // 1 / its diagonal
  __shared__ float xo[kLeaf][kLeaf + 1];           // the inverse's columns
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kLeaf;
  const range_t<float, const SA> ra(A, n, n, n);
  gather_leaf<SA>(ra, n, base, lower, unit, vec_ok, [&](int i, int j0, const auto& v) {
    constexpr int V = std::extent_v<std::remove_reference_t<decltype(v)>>;
    const int li = lower ? i : kLeaf - 1 - i;  // the row in s
#pragma unroll
    for (int u = 0; u < V; u += 4) {
      if (lower) {
        *reinterpret_cast<float4*>(&s[li][j0 + u]) = make_float4(v[u], v[u + 1], v[u + 2],
                                                                 v[u + 3]);
      } else {  // reversed: T[i][j] is s[kLeaf-1-i][kLeaf-1-j]
        *reinterpret_cast<float4*>(&s[li][kLeaf - 4 - j0 - u]) =
            make_float4(v[u + 3], v[u + 2], v[u + 1], v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      if (j0 + u == i) r[li] = __frcp_rn(v[u]);
    }
  });
  __syncthreads();
  if (threadIdx.x < kLeaf) {
    const int c = threadIdx.x;
    float x[kLeaf];
    invert_column(s, r, c, x);
    // x_i is entry (i, c) of inv(s): entry (i, c) of the tile's inverse, or
    // (kLeaf-1-i, kLeaf-1-c) for an upper tile; exact zeros above the
    // diagonal
#pragma unroll
    for (int i = 0; i < kLeaf; ++i) {
      const float v = i >= c ? x[i] : 0.f;
      if (lower) {
        xo[c][i] = v;
      } else {
        xo[kLeaf - 1 - c][kLeaf - 1 - i] = v;
      }
    }
  } else {
    const range_t<float, const Coded> rb(b, b_st, n, k, bs0);
    const range_t<float, float> rt(bt, k, npad, npad);
    for (int64_t e = threadIdx.x - kLeaf; e < k * kLeaf; e += kThreads - kLeaf) {
      const int64_t q = e / kLeaf, row = base + e % kLeaf;
      rt(q, row) = row < n ? static_cast<float>(rb(row, q * bs1)) : 0.f;
    }
  }
  __syncthreads();
  // column c of leaf blockIdx.x is row base + c of an (m * kLeaf, kLeaf) range
  const range_t<float, float> ri(inv, gridDim.x * static_cast<int64_t>(kLeaf), kLeaf, kLeaf);
  for (int e = threadIdx.x; e < kLeaf * kLeaf; e += kThreads) {
    ri(base + e / kLeaf, e % kLeaf) = xo[e / kLeaf][e % kLeaf];
  }
}

// ---- the sweep ----

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// CTA-wide: wait until *done >= target and return what was read. Thread 0
// polls; the barriers order the other threads' later loads of x after its
// acquire, and keep *s from being rewritten before every thread read it.
__device__ unsigned wait_published(const unsigned* done, unsigned target, unsigned* s,
                                   unsigned ticket) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned v = ld_acquire(done);
    for (unsigned polls = 1; v < target; ++polls) {
      if (polls == kMaxPolls) {
        printf("accblas trsv_sweep: panel %u, ticket %u waited %u polls for block row %u to "
               "publish (counter at %u); trapping\n",
               blockIdx.y, ticket, kMaxPolls, target - 1, v);
        __trap();
      }
      if (polls >= kSpinPolls) __nanosleep(kSleepNs);
      v = ld_acquire(done);
    }
    *s = v;
  }
  __syncthreads();
  return *s;
}

// V consecutive floats through L2 (x is written by other CTAs during the
// launch, so never through the non-coherent path)
template <int V>
__device__ __forceinline__ void load_cg(float (&v)[V], const float* p) {
#pragma unroll
  for (int u = 0; u < V; u += 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p + u));
    v[u] = q.x;
    v[u + 1] = q.y;
    v[u + 2] = q.z;
    v[u + 3] = q.w;
  }
}

// the thread's kCols columns of a tile row: vectors g, g + kTpr, ... of V
// elements, so that a warp's loads cover whole rows; zero past n. arow is
// the thread's row of A (a Range row), the tile its columns from c0 on.
template <class SA>
__device__ __forceinline__ void load_tile(float (&av)[kCols], const row_t<float, const SA>& arow,
                                          bool live, int64_t c0, int64_t n, int g, int vec_ok) {
  constexpr int V = 16 / sizeof(SA);
  const row_t<float, const SA> tile = arow.from(c0);
#pragma unroll
  for (int u = 0; u < kCols / V; ++u) {
    const int t = (g + kTpr * u) * V;  // the vector's first column in the tile
    const int64_t c = c0 + t;
    if (vec_ok) {  // n is a multiple of V: a vector lies wholly inside n or past it
      float v[V];
      if (live && c < n) {
        tile.template load<V>(t, v);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) av[u * V + e] = v[e];
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        av[u * V + e] = live && c + e < n ? static_cast<float>(tile(t + e)) : 0.f;
      }
    }
  }
}

// acc[q] += the tile's columns (those of load_tile) times x[c0 + ...]. In
// f32 the tile's kCols products are summed apart and the partial added
// once: a lane's running sum then takes one rounding per tile, not one per
// column (one chain of n / kTpr sequential adds erred 2.1e-4 against the
// fp64 master on the non-unit LU factor at n = 16384 on an H100, the JAX
// sweep 4.2e-5 on a TPU v5e; PERF.md). df64 sums exactly.
template <class SA, bool DF64, int KP>
__device__ __forceinline__ void add_tile(DotAcc<DF64> (&acc)[KP], const float (&av)[kCols],
                                         const float* xhi, const float* xlo, int64_t npad,
                                         int64_t p0, int64_t k, int64_t c0, int g) {
  constexpr int V = 16 / sizeof(SA);
#pragma unroll
  for (int q = 0; q < KP; ++q) {
    if (p0 + q < k) {
      const int64_t o = (p0 + q) * npad + c0;
      DotAcc<DF64> part;
      DotAcc<DF64>& into = DF64 ? acc[q] : part;
#pragma unroll
      for (int u = 0; u < kCols / V; ++u) {
        float h[V], l[V];
        load_cg<V>(h, xhi + o + (g + kTpr * u) * V);
        if constexpr (DF64) load_cg<V>(l, xlo + o + (g + kTpr * u) * V);
#pragma unroll
        for (int e = 0; e < V; ++e) into.add(av[u * V + e], h[e], DF64 ? l[e] : 0.f);
      }
      if constexpr (!DF64) acc[q].s = __fadd_rn(acc[q].s, part.s);
    }
  }
}

// The whole sweep for the right-hand sides [p0, p0 + KP), p0 = blockIdx.y * KP.
// sync holds two counters per panel: tickets taken, block rows published.
template <class SA, bool DF64, int KP>
__global__ void __launch_bounds__(kThreads, 2)
    trsv_sweep(const SA* __restrict__ A, int64_t n, int nr, int64_t npad,
               const float* __restrict__ inv, const float* __restrict__ bt, int64_t k,
               float* xhi, float* xlo, unsigned* sync, void* out, int out_st, int lower,
               int vec_ok) {
  __shared__ unsigned s_val;
  __shared__ float rh[KP][kLeaf], rl[KP][kLeaf];  // b - corr of the block row
  const int r = threadIdx.x / kTpr;  // the thread's row in the block row
  const int g = threadIdx.x % kTpr;  // its place among the row's lanes
  const int64_t p0 = static_cast<int64_t>(blockIdx.y) * KP;
  unsigned* tickets = sync + 2 * blockIdx.y;
  const unsigned* done = tickets + 1;

  if (threadIdx.x == 0) s_val = atomicAdd(tickets, 1u);
  __syncthreads();
  const int t = static_cast<int>(s_val);
  // the block row (and column block) solved at ticket j
  auto block_of = [&](int j) { return lower ? j : nr - 1 - j; };
  const int bi = block_of(t);
  const int64_t row = static_cast<int64_t>(bi) * kLeaf + r;
  const bool live = row < n;
  // A, b and the result through the accessor; the published x is the
  // sweep's own protocol (load_cg, __stcg), not an operand read
  const range_t<float, const SA> ra(A, n, n, n);
  const row_t<float, const SA> arow = ra.row(live ? row : 0);

  // before any wait: the leaf inverse's row r (columns as in load_tile for
  // f32; the leaf is column-major, as cuBLAS returns the batched solve), and
  // the tile of the block solved just before this one
  float w[kCols];
  const float* li = inv + static_cast<int64_t>(bi) * kLeaf * kLeaf;
#pragma unroll
  for (int u = 0; u < kCols / 4; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) w[u * 4 + e] = __ldg(li + ((g + kTpr * u) * 4 + e) * kLeaf + r);
  }
  float alast[kCols];
  if (t > 0) {
    load_tile<SA>(alast, arow, live, static_cast<int64_t>(block_of(t - 1)) * kLeaf, n, g, vec_ok);
  }
  const range_t<float, const float> rb(bt, k, npad, npad);
  float b[KP];
#pragma unroll
  for (int q = 0; q < KP; ++q) {
    b[q] = g == 0 && p0 + q < k ? static_cast<float>(rb(p0 + q, row)) : 0.f;
  }

  // stream every published column block but the last, in solve order
  DotAcc<DF64> acc[KP];
  int avail = 0;  // block rows known to be published
  for (int j = 0; j + 1 < t;) {
    if (j >= avail) avail = static_cast<int>(wait_published(done, j + 1, &s_val, t));
    const int64_t c0 = static_cast<int64_t>(block_of(j)) * kLeaf;
    float a0[kCols];
    load_tile<SA>(a0, arow, live, c0, n, g, vec_ok);
    if (j + 2 < t && j + 1 < avail) {  // two tiles' loads in flight at once
      const int64_t c1 = static_cast<int64_t>(block_of(j + 1)) * kLeaf;
      float a1[kCols];
      load_tile<SA>(a1, arow, live, c1, n, g, vec_ok);
      add_tile<SA, DF64, KP>(acc, a0, xhi, xlo, npad, p0, k, c0, g);
      add_tile<SA, DF64, KP>(acc, a1, xhi, xlo, npad, p0, k, c1, g);
      j += 2;
    } else {
      add_tile<SA, DF64, KP>(acc, a0, xhi, xlo, npad, p0, k, c0, g);
      j += 1;
    }
  }
  // the chain: the block row before this one, then this one
  if (t > 0) {
    if (t > avail) wait_published(done, t, &s_val, t);
    add_tile<SA, DF64, KP>(acc, alast, xhi, xlo, npad, p0, k,
                           static_cast<int64_t>(block_of(t - 1)) * kLeaf, g);
  }
#pragma unroll
  for (int q = 0; q < KP; ++q) {
    const val_t<DF64> corr = row_fold<DF64>(acc[q].value());
    if (g == 0) {
      const val_t<DF64> v = sub<DF64>(make_val<DF64>(b[q], 0.f), corr);
      rh[q][r] = hi_of(v);
      rl[q][r] = lo_of(v);
    }
  }
  __syncthreads();

  // x_r = sum_c inv[r][c] * (b - corr)_c through the pre-inverted leaf
  DotAcc<DF64> xa[KP];
#pragma unroll
  for (int u = 0; u < kCols / 4; ++u) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = (g + kTpr * u) * 4 + e;
#pragma unroll
      for (int q = 0; q < KP; ++q) xa[q].add(w[u * 4 + e], rh[q][c], rl[q][c]);
    }
  }
  val_t<DF64> x[KP];
#pragma unroll
  for (int q = 0; q < KP; ++q) {
    x[q] = row_fold<DF64>(xa[q].value());
    if (g == 0 && p0 + q < k) {
      const int64_t o = (p0 + q) * npad + row;
      __stcg(xhi + o, hi_of(x[q]));
      if constexpr (DF64) __stcg(xlo + o, lo_of(x[q]));
    }
  }
  // publish: the barrier orders every thread's x stores before thread 0's
  // release store of the counter, which makes them visible with it (the
  // pattern of CUTLASS's semaphore)
  __syncthreads();
  if (threadIdx.x == 0) st_release(tickets + 1, static_cast<unsigned>(t + 1));
  // the result, off the chain: (n, k) in the storage out_st, each value
  // rounded to it once (hi + lo for df64)
  const range_t<val_t<DF64>, Coded> ro(out, out_st, n, k, k);
#pragma unroll
  for (int q = 0; q < KP; ++q) {
    if (g == 0 && p0 + q < k && live) ro(row, p0 + q) = x[q];
  }
}

// calls f(Tag<SA>, DF64 as std::bool_constant, KP as std::integral_constant)
// for the run-time storage code, tier and number of right-hand sides k: a
// panel of KP = 1 right-hand side for TRSV, of KP = 4 for TRSM
template <class F>
cudaError_t with_sweep(int a_st, int df, int64_t k, F&& f) {
  using K1 = std::integral_constant<int, 1>;
  using K4 = std::integral_constant<int, 4>;
  return with_storage(a_st, [&](auto ta) {
    if (df) return k == 1 ? f(ta, std::true_type{}, K1{}) : f(ta, std::true_type{}, K4{});
    return k == 1 ? f(ta, std::false_type{}, K1{}) : f(ta, std::false_type{}, K4{});
  });
}

}  // namespace
}  // namespace accblas

// A: n x n row-major (storage a_st); d: m x kLeaf x kLeaf floats receiving
// the masked diagonal leaf tiles, m * kLeaf >= n. vec_ok: A 16-byte aligned
// and n a multiple of the vector width. Returns cudaGetLastError().
extern "C" int accblas_leaf_diag(const void* A, int a_st, int64_t n, float* d, int64_t m,
                                 int lower, int unit, int vec_ok, void* stream) {
  using namespace accblas;
  return with_storage(a_st, [&](auto ta) {
    using SA = typename decltype(ta)::type;
    leaf_diag<SA><<<static_cast<unsigned>(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const SA*>(A), n, d, lower, unit, vec_ok);
    return cudaGetLastError();
  });
}

// A: n x n row-major (storage a_st). b: (n, k) right-hand sides in storage
// b_st, element (i, q) at b[i * bs0 + q * bs1]. buf: m * kLeaf * kLeaf
// floats receiving the leaf inverses, column-major per leaf, then the
// (k, npad) f32 panels, npad = m * kLeaf >= n. vec_ok: A 16-byte aligned and
// n a multiple of the vector width. One launch of m CTAs on `stream`;
// returns cudaGetLastError().
extern "C" int accblas_leaf_phase(const void* A, int a_st, int64_t n, const void* b, int b_st,
                                  int64_t bs0, int64_t bs1, int64_t k, float* buf, int64_t m,
                                  int lower, int unit, int vec_ok, void* stream) {
  using namespace accblas;
  if (b_st < ST_F32 || b_st > ST_F8E5M2) return cudaErrorInvalidValue;
  return with_storage(a_st, [&](auto ta) {
    using SA = typename decltype(ta)::type;
    leaf_phase<SA><<<static_cast<unsigned>(m), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const SA*>(A), n, b, b_st, bs0, bs1, k, buf, buf + m * kLeaf * kLeaf,
        m * kLeaf, lower, unit, vec_ok);
    return cudaGetLastError();
  });
}

// A: n x n row-major (storage a_st). inv: (>= ceil(n / kLeaf), kLeaf, kLeaf)
// leaf inverses (identity past n), column-major per leaf. bt: (k, npad) f32
// right-hand sides, zero past n, npad >= ceil(n / kLeaf) * kLeaf. xhi (and
// xlo for df64): (k, npad) f32 scratch for the published x; sync: 2 * k
// unsigned counters (two per panel are used), zeroed here. out: (n, k) row-major in
// storage out_st. vec_ok: A 16-byte aligned and n a multiple of the vector
// width. One memset and one kernel launch on `stream`; returns the first
// error, or 0.
extern "C" int accblas_trsv_sweep(const void* A, int a_st, int64_t n, int64_t npad,
                                  const float* inv, const float* bt, int64_t k, float* xhi,
                                  float* xlo, unsigned* sync, void* out, int out_st, int lower,
                                  int df, int vec_ok, void* stream) {
  using namespace accblas;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nr = static_cast<int>((n + kLeaf - 1) / kLeaf);
  return with_sweep(a_st, df, k, [&](auto ta, auto dft, auto kpt) {
    using SA = typename decltype(ta)::type;
    constexpr bool DF64 = decltype(dft)::value;
    constexpr int KP = decltype(kpt)::value;
    const unsigned panels = static_cast<unsigned>((k + KP - 1) / KP);
    const cudaError_t err = cudaMemsetAsync(sync, 0, 2 * panels * sizeof(unsigned), s);
    if (err != cudaSuccess) return err;
    trsv_sweep<SA, DF64, KP><<<dim3(nr, panels), kThreads, 0, s>>>(
        static_cast<const SA*>(A), n, nr, npad, inv, bt, k, xhi, xlo, sync, out, out_st,
        lower, vec_ok);
    return cudaGetLastError();
  });
}

// CTAs of the sweep (storage a_st, df64 or f32, k right-hand sides) that one
// SM holds at once, into *blocks: with the SM count, the largest grid
// resident at once.
extern "C" int accblas_trsv_sweep_occupancy(int a_st, int df, int64_t k, int* blocks) {
  using namespace accblas;
  return with_sweep(a_st, df, k, [&](auto ta, auto dft, auto kpt) {
    using SA = typename decltype(ta)::type;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, trsv_sweep<SA, decltype(dft)::value, decltype(kpt)::value>, kThreads, 0);
  });
}
