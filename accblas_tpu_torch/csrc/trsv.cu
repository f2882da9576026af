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
//     loads where A is aligned. The batched inversion of the masked tiles
//     stays with cuBLAS (ops/trsv.py `_leaf_inverses`).
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

#include <cstdio>

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

// ---- the leaf gather ----

// tile blockIdx.x of d: A[base + i, base + j] as f32 on the live triangle
// inside n, one on the diagonal where `unit` or past n, zero elsewhere
template <class SA>
__global__ void __launch_bounds__(kThreads)
    leaf_diag(const SA* __restrict__ A, int64_t n, float* __restrict__ d, int lower, int unit,
              int vec_ok) {
  constexpr int V = 16 / sizeof(SA);
  constexpr int VR = kLeaf / V;  // vectors per tile row
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kLeaf;
  float* tile = d + static_cast<int64_t>(blockIdx.x) * kLeaf * kLeaf;
  for (int e = threadIdx.x; e < kLeaf * VR; e += kThreads) {
    const int i = e / VR, j0 = (e % VR) * V;
    const int64_t row = base + i, col = base + j0;
    // the vector holds a live element only if it reaches the triangle
    const bool live = row < n && col < n && (lower ? j0 <= i : j0 + V - 1 >= i);
    float v[V];
    if (live && vec_ok) {
      const Pack<SA, V> pk = load_pack<SA, V>(A + row * n + col);
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = load_f32(pk.v[u]);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u) {
        v[u] = live && col + u < n ? load_f32(A[row * n + col + u]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const int j = j0 + u;
      const bool keep = (lower ? i >= j : i <= j) && row < n && base + j < n;
      v[u] = keep ? v[u] : 0.f;
      if (i == j && (unit || row >= n)) v[u] = 1.f;
    }
#pragma unroll
    for (int u = 0; u < V; u += 4) {
      *reinterpret_cast<float4*>(tile + i * kLeaf + j0 + u) =
          make_float4(v[u], v[u + 1], v[u + 2], v[u + 3]);
    }
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
// elements, so that a warp's loads cover whole rows; zero past n
template <class SA>
__device__ __forceinline__ void load_tile(float (&av)[kCols], const SA* arow, bool live,
                                          int64_t c0, int64_t n, int g, int vec_ok) {
  constexpr int V = 16 / sizeof(SA);
#pragma unroll
  for (int u = 0; u < kCols / V; ++u) {
    const int64_t c = c0 + (g + kTpr * u) * V;
    if (vec_ok) {  // n is a multiple of V: a vector lies wholly inside n or past it
      if (live && c < n) {
        const Pack<SA, V> pk = load_pack<SA, V>(arow + c);
#pragma unroll
        for (int e = 0; e < V; ++e) av[u * V + e] = load_f32(pk.v[e]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) av[u * V + e] = 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        av[u * V + e] = live && c + e < n ? load_f32(arow[c + e]) : 0.f;
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
  const SA* arow = A + (live ? row : 0) * n;

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
  float b[KP];
#pragma unroll
  for (int q = 0; q < KP; ++q) b[q] = g == 0 && p0 + q < k ? bt[(p0 + q) * npad + row] : 0.f;

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
  // the result, off the chain
#pragma unroll
  for (int q = 0; q < KP; ++q) {
    if (g == 0 && p0 + q < k && live) {
      store_code(out, row * k + p0 + q, out_st,
                 DF64 ? __fadd_rn(hi_of(x[q]), lo_of(x[q])) : hi_of(x[q]));
    }
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
