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
//   - a CTA hands its solved x to the next as self-validating words: each
//     x value (hi and lo for df64, one a right-hand side of the panel) is
//     one aligned 8-byte word {value, tag}, stored with a scalar
//     st.relaxed.gpu.b64, single-copy atomic. The call's one memset zeroes
//     every word and the tickets before the launch, so a word whose tag is
//     set was published in this call, and its value half is the value;
//   - the load of x is the wait: a warp reads a column block's 64 words in
//     one access, two a lane, with ld.relaxed.gpu, until a vote finds every
//     tag set, and shuffles hand each thread the values of its columns. No
//     warp takes a word on another's say-so: no counter, no fence, no
//     barrier, no second read of x. Each block's words are loaded with its
//     tile of A, before the block is added: two blocks ahead where a block's
//     words are one set (TRSV), one where they are more (df64's lo words, a
//     panel's right-hand sides; the rest are loaded once the first have
//     come). So a CTA far behind the chain streams tiles and words together,
//     and the thread's row of the leaf inverse is in registers before any
//     wait (f32 sums; df64 reads it from shared memory);
//   - the wait for the block solved just before its own, the chain's hop,
//     spins, one load at a time, as do the waits of the few CTAs just
//     behind it (each must take its next block within one hop); a wait
//     further behind sleeps between polls, the longer the further behind,
//     so that the CTAs behind do not crowd the L2 lines of the words the
//     next hop publishes;
//   - once the hop's words have come, it adds that last tile, folds its
//     lanes in a fixed order, forms b - corr, multiplies by the leaf
//     inverse and publishes its x words; the result is written in the
//     output's storage after that, off the chain.
// So the CTAs behind stream the triangle while the chain advances, and a hop
// is one L2 round trip from the producer's store to the consumer's load,
// one tile-vector product, one lane fold, a barrier and one inverse product.
// Every wait is bounded: after kMaxPolls polls (seconds; a solve takes
// milliseconds) the kernel prints which wait ran out and traps, so a
// protocol fault fails the run with a CUDA error at the next synchronisation
// instead of hanging it. A debug build (ACCBLAS_TRSV_STAMPS, built by
// chip_smoke.py alone) stamps each hop's phases into a buffer; a test build
// lowers kMaxPolls and withholds one block row's words
// (ACCBLAS_TRSV_MAX_POLLS, ACCBLAS_TRSV_WITHHOLD). The library the main path
// loads has neither.
//
// Sums: each right-hand side has its own accumulators, every thread adds
// its columns in the order the blocks were solved (in f32 each tile's
// partial sum, see add_tile), and lanes fold in a fixed tree; only the
// tickets are atomic. Results repeat bit for bit, and do not depend on KP,
// on when a block was streamed or on how long a wait took.
//
// What bounds it: the triangle is read once, n(n+1)/2 elements, about 2
// flops each (f32), so the solve is bound by device-memory bytes: 537 MB
// of f32 at n = 16384 is 0.16 ms at 3.35 TB/s. The chain of n / kLeaf
// dependent steps, each an L2 round trip and a few hundred instructions,
// bounds it from the other side (PERF.md). kThreads = 256, no shared tiles
// of A (16 KB of shared memory for the leaf inverse) and
// __launch_bounds__(kThreads, 2) hold two CTAs on every SM, so the 256
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
// (the tagged words, stored and loaded at GPU scope through L2), which the
// JAX kernel keeps in VMEM scratch; an accessor read would allocate L1
// lines, which are not coherent across CTAs within a launch.
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
#ifndef ACCBLAS_TRSV_MAX_POLLS
#define ACCBLAS_TRSV_MAX_POLLS (1u << 21)
#endif
constexpr unsigned kMaxPolls = ACCBLAS_TRSV_MAX_POLLS;  // bound of one wait
constexpr int kSpinBehind = 4;      // waits this close behind the chain spin
constexpr unsigned kSleepNs = 256;  // a farther poll's sleep per column block beyond those
constexpr int kBehindCap = 16;      // ... counted up to this many blocks

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

// The CTA's leaf inverse in shared memory, copied there (cp.async) before
// any wait. Column-major as in global memory, the rows of column c at r ^
// (8 * ((c >> 2) & 3)): the reads of a warp (rows r0..r0+7, columns 4g +
// 16u + e for its four lanes g) fall in 32 distinct banks, and a copy's 4
// rows stay 16 contiguous bytes.
__device__ __forceinline__ int inv_slot(int r, int c) {
  return c * kLeaf + (r ^ (((c >> 2) & 3) << 3));
}

__device__ __forceinline__ void copy_leaf_inverse(float (&s)[kLeaf * kLeaf], const float* li) {
#pragma unroll
  for (int i = 0; i < kLeaf * kLeaf / (4 * kThreads); ++i) {
    const int e = (i * kThreads + static_cast<int>(threadIdx.x)) * 4;
    const float* to = &s[inv_slot(e % kLeaf, e / kLeaf)];
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                     static_cast<unsigned>(__cvta_generic_to_shared(to))),
                 "l"(li + e)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A published x value: its f32 bits in the low half of an aligned 8-byte
// word, kTag in the high half (the note at the top).
using Word = unsigned long long;
constexpr Word kTag = Word{1} << 32;
constexpr unsigned kFull = 0xffffffffu;  // every lane of a warp

__device__ __forceinline__ void publish(Word* p, float v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(kTag | __float_as_uint(v))
               : "memory");
}

// The lane's two words of a column block's 64 (words 2 * lane and 2 * lane
// + 1), from p, the block's first word: a warp reads the whole block in one
// access (the vector access is two scalar ones in the memory model, each
// single-copy atomic), and shuffles give each thread its columns (spread).
__device__ __forceinline__ void load_words(Word (&w)[2], const Word* p) {
  asm volatile("ld.relaxed.gpu.global.v2.b64 {%0, %1}, [%2];"
               : "=l"(w[0]), "=l"(w[1])
               : "l"(p + 2 * (threadIdx.x & 31))
               : "memory");
}

// whether every word the warp holds carries the tag (a vote of its lanes)
__device__ __forceinline__ bool tagged(const Word (&w)[2]) {
  return __all_sync(kFull, static_cast<unsigned>((w[0] & w[1]) >> 32) != 0);
}

#ifdef ACCBLAS_TRSV_STAMPS
// the debug build's stamps: kStampSlots words a CTA, at (panel * nr +
// ticket) * kStampSlots, written by thread 0 (accblas_trsv_stamps sets the
// buffer): %globaltimer when the hop's wait began and when x was published,
// clock64 at the hop's six points (wait begun, x come, last tile added, b -
// corr folded and shared, inverse product done, x published), and the polls
// the hop's wait took (1: its words had come before it looked)
constexpr int kStampSlots = 9;
__device__ Word* g_stamps;

__device__ __forceinline__ Word globaltimer() {
  Word v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}
// the CTA's stamps, its pointer taken once (a read of g_stamps at each stamp
// would be a global load on the path it times)
#define TRSV_STAMPS_AT(nr, t) \
  Word* const stamps = g_stamps + (blockIdx.y * static_cast<Word>(nr) + (t)) * kStampSlots
#define TRSV_STAMP(slot, value)           \
  do {                                    \
    if (threadIdx.x == 0) {               \
      stamps[slot] = (value);             \
    }                                     \
  } while (0)
#else
#define TRSV_STAMPS_AT(nr, t) \
  do {                        \
  } while (0)
#define TRSV_STAMP(slot, value) \
  do {                          \
  } while (0)
#endif

// A wait that ran out: which one, from one lane of each warp, then the trap.
// Out of line and never returning, so that a wait's registers need not be
// kept across the print.
__device__ __noinline__ void ran_out(int ticket, int block, int behind) {
  if ((threadIdx.x & 31) == __ffs(__activemask()) - 1) {
    printf("accblas trsv_sweep: panel %u, ticket %d waited %u polls for the x of block row %d "
           "(%d behind the chain); trapping\n",
           blockIdx.y, ticket, kMaxPolls, block, behind);
  }
  __trap();
}

// One more poll of a wait, trapping once a wait has taken kMaxPolls.
__device__ __forceinline__ void count_poll(unsigned& polls, int ticket, int block, int behind) {
  if (++polls == kMaxPolls) {
    ran_out(ticket, block, behind);
    __builtin_unreachable();
  }
}

// Polls until every word of w (load_words's, from p) carries the tag, and
// returns the polls it took (1: they had come when w was loaded). `behind`:
// column blocks between this one and the one solved just before the CTA's
// own (0: the chain's hop). Up to kSpinBehind it spins, one load at a time
// (more loads in flight slowed the hop: PERF.md); further behind it sleeps
// between polls, the longer the further. The first poll after w's load
// never sleeps: w may have been loaded long before (with its tile).
__device__ __forceinline__ unsigned await_words(Word (&w)[2], const Word* p, int behind,
                                                int block, int ticket) {
  unsigned polls = 1;
  while (!tagged(w)) {
    if (polls > 1 && behind > kSpinBehind) {
      __nanosleep(kSleepNs * min(behind - kSpinBehind, kBehindCap));
    }
    count_poll(polls, ticket, block, behind);
    load_words(w, p);
  }
  return polls;
}

// the thread's x values of a column block, in load_tile's columns, from its
// warp's words (load_words's, every tag set): a shuffle a value
template <int V>
__device__ __forceinline__ void spread(float (&x)[kCols], const Word (&w)[2], int g) {
  static_assert(V % 2 == 0, "a vector's columns pair up with a lane's two words");
  const float v0 = __uint_as_float(static_cast<unsigned>(w[0]));
  const float v1 = __uint_as_float(static_cast<unsigned>(w[1]));
#pragma unroll
  for (int u = 0; u < kCols / V; ++u) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const int c = (g + kTpr * u) * V + e;  // the column: word c, lane c / 2's
      x[u * V + e] = __shfl_sync(kFull, e % 2 ? v1 : v0, c / 2);
    }
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

// acc += the tile's kCols products with x, summed apart and the partial
// added once (f32; add_tile's note)
__device__ __forceinline__ void add_partial(DotAcc<false>& acc, const float (&av)[kCols],
                                            const float (&x)[kCols]) {
  DotAcc<false> part;
#pragma unroll
  for (int i = 0; i < kCols; ++i) part.add(av[i], x[i], 0.f);
  acc.s = __fadd_rn(acc.s, part.s);
}

// acc[q] += the tile's columns (those of load_tile) times the x of column
// block `block`: the first right-hand side's words w, loaded with the tile,
// the rest of its words (df64's lo words, a panel's other right-hand sides)
// loaded here once those have come, each awaited (await_words; `behind` and
// `ticket` as there) and spread to the thread's columns; `waited()` runs
// once w's words have come. In f32 the tile's kCols products are summed
// apart and the partial added once: a lane's running sum then takes one
// rounding per tile, not one per column (one chain of n / kTpr sequential
// adds erred 2.1e-4 against the fp64 master on the non-unit LU factor at
// n = 16384 on an H100, the JAX sweep 4.2e-5 on a TPU v5e; PERF.md). df64
// sums exactly. Returns the polls of w's wait.
template <class SA, bool DF64, int KP, class Waited>
__device__ __forceinline__ unsigned add_tile(DotAcc<DF64> (&acc)[KP], const float (&av)[kCols],
                                             Word (&w)[2], const Word* xhi, const Word* xlo,
                                             int64_t npad, int64_t p0, int64_t k, int block,
                                             int behind, int g, int ticket, Waited&& waited) {
  constexpr int V = 16 / sizeof(SA);
  constexpr int kRest = KP * (DF64 ? 2 : 1) - 1;  // words a lane loads here
  const int64_t c0 = static_cast<int64_t>(block) * kLeaf;
  const unsigned polls = await_words(w, xhi + p0 * npad + c0, behind, block, ticket);
  waited();
  // word set s of the block: right-hand side p0 + s / 2, hi or lo (df64),
  // or p0 + s (f32); set 0 is w's
  auto words_at = [&](int s) {
    return (DF64 && s % 2 ? xlo : xhi) + (p0 + (DF64 ? s / 2 : s)) * npad + c0;
  };
  auto live_set = [&](int s) { return p0 + (DF64 ? s / 2 : s) < k; };
  Word rest[kRest > 0 ? kRest : 1][2];
#pragma unroll
  for (int s = 1; s <= kRest; ++s) {
    if (live_set(s)) load_words(rest[s - 1], words_at(s));
  }
#pragma unroll
  for (int q = 0; q < KP; ++q) {
    if (p0 + q < k) {
      float h[kCols], l[kCols];
      const int sh = DF64 ? 2 * q : q;  // the set of q's (hi) words
      if (sh == 0) {
        spread<V>(h, w, g);
      } else {
        await_words(rest[sh > 0 ? sh - 1 : 0], words_at(sh), behind, block, ticket);
        spread<V>(h, rest[sh > 0 ? sh - 1 : 0], g);
      }
      if constexpr (DF64) {
        await_words(rest[sh], words_at(sh + 1), behind, block, ticket);
        spread<V>(l, rest[sh], g);
#pragma unroll
        for (int i = 0; i < kCols; ++i) acc[q].add(av[i], h[i], l[i]);
      } else {
        add_partial(acc[q], av, h);
      }
    }
  }
  return polls;
}

// The whole sweep for the right-hand sides [p0, p0 + KP), p0 = blockIdx.y * KP.
// xhi (xlo for df64): the published words, (k, npad); tickets: one counter
// a panel. Both zeroed before the launch.
template <class SA, bool DF64, int KP>
__global__ void __launch_bounds__(kThreads, 2)
    trsv_sweep(const SA* __restrict__ A, int64_t n, int nr, int64_t npad,
               const float* __restrict__ inv, const float* __restrict__ bt, int64_t k,
               Word* xhi, Word* xlo, unsigned* tickets, void* out, int out_st, int lower,
               int vec_ok) {
  __shared__ unsigned s_ticket;
  __shared__ __align__(16) float rh[KP][kLeaf], rl[KP][kLeaf];  // b - corr of the block row
  __shared__ __align__(16) float s_inv[kLeaf * kLeaf];  // the leaf inverse (inv_slot)
  const int r = threadIdx.x / kTpr;  // the thread's row in the block row
  const int g = threadIdx.x % kTpr;  // its place among the row's lanes
  const int64_t p0 = static_cast<int64_t>(blockIdx.y) * KP;

  if (threadIdx.x == 0) s_ticket = atomicAdd(tickets + blockIdx.y, 1u);
  __syncthreads();
  const int t = static_cast<int>(s_ticket);
  TRSV_STAMPS_AT(nr, t);
  // the block row (and column block) solved at ticket j
  auto block_of = [&](int j) { return lower ? j : nr - 1 - j; };
  const int bi = block_of(t);
  const int64_t row = static_cast<int64_t>(bi) * kLeaf + r;
  const bool live = row < n;
  // A, b and the result through the accessor; the published x is the
  // sweep's own protocol (load_words, publish), not an operand read
  const range_t<float, const SA> ra(A, n, n, n);
  const row_t<float, const SA> arow = ra.row(live ? row : 0);

  // before any wait: the leaf inverse into shared memory (column-major, as
  // cuBLAS returns the batched solve)
  copy_leaf_inverse(s_inv, inv + static_cast<int64_t>(bi) * kLeaf * kLeaf);
  const range_t<float, const float> rb(bt, k, npad, npad);
  float b[KP];
#pragma unroll
  for (int q = 0; q < KP; ++q) {
    b[q] = g == 0 && p0 + q < k ? static_cast<float>(rb(p0 + q, row)) : 0.f;
  }

  // every column block solved before this one, in solve order, the last
  // (ticket t - 1) the chain's hop. Each block's tile of A and the lane's
  // words of its x (the first right-hand side's) are loaded kRing - 1 blocks
  // before the block is added, into a ring of kRing: two tiles in flight
  // ahead of the one added where a block's words are one set, one where
  // they are more (df64, panels of right-hand sides), whose registers
  // the rest of the words take.
  constexpr int kRing = KP * (DF64 ? 2 : 1) == 1 ? 3 : 2;
  DotAcc<DF64> acc[KP];
  float a[kRing][kCols];
  Word xw[kRing][2];
  auto fetch = [&](float (&av)[kCols], Word (&w)[2], int j) {
    const int64_t c0 = static_cast<int64_t>(block_of(j)) * kLeaf;
    load_tile<SA>(av, arow, live, c0, n, g, vec_ok);
    load_words(w, xhi + p0 * npad + c0);
  };
#pragma unroll
  for (int s = 0; s + 1 < kRing; ++s) {
    if (s < t) fetch(a[s], xw[s], s);
  }

  // the thread's row of the leaf inverse, in the product's columns, taken
  // into registers before any wait where they hold it (f32 sums), so that
  // no load sits on the chain; df64 reads it at its use
  constexpr bool kInvRegs = !DF64;
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  float wr[kInvRegs ? kCols : 1];
  if constexpr (kInvRegs) {
#pragma unroll
    for (int i = 0; i < kCols; ++i) wr[i] = s_inv[inv_slot(r, (g + kTpr * (i / 4)) * 4 + i % 4)];
  }

  unsigned hop_polls = 0;
  auto finish = [&](const float (&av)[kCols], Word (&w)[2], int j) {
    const int behind = t - 1 - j;
    if (behind == 0) {
      TRSV_STAMP(0, globaltimer());
      TRSV_STAMP(2, clock64());
    }
    const unsigned polls = add_tile<SA, DF64, KP>(acc, av, w, xhi, xlo, npad, p0, k,
                                                  block_of(j), behind, g, t, [&] {
                                                    if (behind == 0) TRSV_STAMP(3, clock64());
                                                  });
    if (behind == 0) hop_polls = polls;
  };
  for (int j0 = 0; j0 < t; j0 += kRing) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      const int j = j0 + s;
      if (j < t) {
        const int f = (s + kRing - 1) % kRing;  // the slot of block j + kRing - 1
        if (j + kRing - 1 < t) fetch(a[f], xw[f], j + kRing - 1);
        finish(a[s], xw[s], j);
      }
    }
  }
  TRSV_STAMP(8, hop_polls);
  (void)hop_polls;
  TRSV_STAMP(4, clock64());
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
  TRSV_STAMP(5, clock64());

  // x_r = sum_c inv[r][c] * (b - corr)_c through the pre-inverted leaf, the
  // thread's columns as in load_tile for f32, b - corr read four at a time
  DotAcc<DF64> xa[KP];
#pragma unroll
  for (int u = 0; u < kCols / 4; ++u) {
    const int c0 = (g + kTpr * u) * 4;
#pragma unroll
    for (int q = 0; q < KP; ++q) {
      const float4 h = *reinterpret_cast<const float4*>(&rh[q][c0]);
      const float4 l = DF64 ? *reinterpret_cast<const float4*>(&rl[q][c0]) : float4{};
      const float hs[4] = {h.x, h.y, h.z, h.w}, ls[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float we;
        if constexpr (kInvRegs) {
          we = wr[u * 4 + e];
        } else {
          we = s_inv[inv_slot(r, c0 + e)];
        }
        xa[q].add(we, hs[e], ls[e]);
      }
    }
  }
  val_t<DF64> x[KP];
#pragma unroll
  for (int q = 0; q < KP; ++q) x[q] = row_fold<DF64>(xa[q].value());
  TRSV_STAMP(6, clock64());
  // publish: each row's x words, nothing else; the next CTAs' loads are
  // their wait
#pragma unroll
  for (int q = 0; q < KP; ++q) {
#ifdef ACCBLAS_TRSV_WITHHOLD
    if (t == ACCBLAS_TRSV_WITHHOLD) break;  // a test build's fault: never published
#endif
    if (g == 0 && p0 + q < k) {
      const int64_t o = (p0 + q) * npad + row;
      publish(xhi + o, hi_of(x[q]));
      if constexpr (DF64) publish(xlo + o, lo_of(x[q]));
    }
  }
  TRSV_STAMP(7, clock64());
  TRSV_STAMP(1, globaltimer());
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
// right-hand sides, zero past n, npad >= ceil(n / kLeaf) * kLeaf. scratch:
// the published x, (k, npad) 8-byte words (then as many again for df64's lo
// words), then a 32-bit ticket counter per panel of right-hand sides; all of
// it zeroed here. out: (n, k) row-major in storage out_st. vec_ok: A 16-byte
// aligned and n a multiple of the vector width. One memset and one kernel
// launch on `stream`; returns the first error, or 0.
extern "C" int accblas_trsv_sweep(const void* A, int a_st, int64_t n, int64_t npad,
                                  const float* inv, const float* bt, int64_t k, void* scratch,
                                  void* out, int out_st, int lower, int df, int vec_ok,
                                  void* stream) {
  using namespace accblas;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nr = static_cast<int>((n + kLeaf - 1) / kLeaf);
  return with_sweep(a_st, df, k, [&](auto ta, auto dft, auto kpt) {
    using SA = typename decltype(ta)::type;
    constexpr bool DF64 = decltype(dft)::value;
    constexpr int KP = decltype(kpt)::value;
    const unsigned panels = static_cast<unsigned>((k + KP - 1) / KP);
    Word* xhi = static_cast<Word*>(scratch);
    Word* xlo = DF64 ? xhi + k * npad : nullptr;
    unsigned* tickets = reinterpret_cast<unsigned*>(xhi + (DF64 ? 2 : 1) * k * npad);
    const size_t bytes = reinterpret_cast<char*>(tickets + panels) - static_cast<char*>(scratch);
    const cudaError_t err = cudaMemsetAsync(scratch, 0, bytes, s);
    if (err != cudaSuccess) return err;
    trsv_sweep<SA, DF64, KP><<<dim3(nr, panels), kThreads, 0, s>>>(
        static_cast<const SA*>(A), n, nr, npad, inv, bt, k, xhi, xlo, tickets, out, out_st,
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

#ifdef ACCBLAS_TRSV_STAMPS
// The debug build's stamp buffer (trsv_sweep's note on kStampSlots): at
// least panels * ceil(n / kLeaf) * 9 words for the next sweeps.
extern "C" int accblas_trsv_stamps(void* buf) {
  return cudaMemcpyToSymbol(accblas::g_stamps, &buf, sizeof(buf));
}
#endif
