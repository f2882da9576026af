// TRSV/TRSM: solve T X = B for the upper or lower triangle T of a full
// (LU-packed) n x n matrix A, k right-hand sides, in f32 or df64 arithmetic.
//
// Replaces the two Pallas kernels of accblas_tpu/ops/trsv.py:
//   `_extract_leaf_diag.kern` (:119) -> `leaf_diag` below: gathers the
//     kLeaf x kLeaf diagonal tiles of A as f32, zero past n (the identity
//     past n is added by the batched inversion, ops/trsv.py
//     `_masked_tri_inverse`). It moves n * kLeaf elements each way, a few
//     microseconds; one block per tile with row-contiguous loads suffices.
//   `_trsv_kernel` (:244) -> `trsv_offdiag` + `trsv_diag`, chained by
//     `accblas_trsv_sweep`.
//
// The TPU kernel walks the live triangle blocks on a sequential grid and
// carries the solved x and the running correction in VMEM scratch. Blocks
// of a CUDA grid run in parallel and in no order, so here the order lives
// on the stream instead: one C entry point walks the nb block rows in
// dependency order (the upper triangle from the bottom up) and, for each,
// launches
//   (a) `trsv_offdiag`: corr[row] = sum over solved columns c of
//       A[row, c] * x[c], one warp per row of the block row and one CTA per
//       (8 rows, kChunk columns, KP right-hand sides); every CTA writes its
//       partial sums to scratch, so there are no atomics and results repeat;
//   (b) `trsv_diag`: one CTA per KP right-hand sides folds the partials in a
//       fixed order, forms rhs - corr, and substitutes through the diagonal
//       block a leaf at a time with the pre-inverted leaves, then publishes
//       x (hi and lo words for df64) to device scratch and writes the
//       result, cast to the storage of the output. Its leaf steps form a
//       serial chain inside one CTA, so they are written for latency: the
//       CTA first asks for its whole diagonal block and leaf inverses in L2
//       (prefetch); then each leaf row is split over kGroup threads, and
//       each thread loads all of its columns into registers before it sums
//       them, so that all of a leaf's loads are in flight at once.
// Stream order makes each block row's x visible to the launches after it.
//
// What bounds it: the triangle is read once, n(n+1)/2 elements, about 2
// flops each (f32), so the solve is bound by device-memory bytes: 537 MB
// of f32 at n = 16384 is 0.16 ms at 3.35 TB/s. This first design is
// further bound by its serial chain: 2 * nb launches, and n / kLeaf
// dependent leaf steps, kBlock / kLeaf of them in each one-CTA diagonal
// step; the off-diagonal launches stream the triangle at about 2 TB/s and
// the leaf steps take most of the time (PERF.md). (A first form of the
// diagonal step gave each leaf row to one warp, one dependent load per
// step: 122 us per block row at n = 16384, 90% of the solve.) kBlock = 512
// keeps the off-diagonal launches wide (64 row-warps x up to n / kChunk
// column chunks) while the one-CTA diagonal step stays short (512^2 / 2
// elements); kLeaf = 64 keeps each leaf inverse at 16 KB. Both were chosen
// for this card, not taken from the TPU's tuning.
//
// Arithmetic: f32 sums of f32 products; df64 carries x and the sums as
// (hi, lo) pairs: exact products of A with x_hi (two_prod), f32 products
// with x_lo, two_sum accumulation, df_add across warps and chunks.

#include "reduce.cuh"

namespace accblas {
namespace {

constexpr int kBlock = 512;          // rows of a block row (ops/trsv.py BLOCK)
constexpr int kLeaf = 64;            // diagonal leaf (ops/trsv.py LEAF)
constexpr int kNleaf = kBlock / kLeaf;
constexpr int kChunk = 2048;         // columns per off-diagonal CTA (ops/trsv.py _CHUNK)
constexpr int kWarps = 8;            // rows per off-diagonal CTA, one warp each
constexpr int kDiagThreads = 512;    // threads of the one-CTA diagonal step
constexpr int kGroup = kDiagThreads / kLeaf;  // threads per leaf row in it
constexpr int kDeps = (kBlock - kLeaf) / kGroup;  // the most columns one thread sums
constexpr int kLeafThreads = 256;    // threads per leaf tile of the gather

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

template <class SA>
__global__ void __launch_bounds__(kLeafThreads)
    leaf_diag(const SA* __restrict__ A, int64_t n, float* __restrict__ d) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kLeaf;
  float* tile = d + static_cast<int64_t>(blockIdx.x) * kLeaf * kLeaf;
  for (int e = threadIdx.x; e < kLeaf * kLeaf; e += kLeafThreads) {
    const int64_t r = base + e / kLeaf;
    const int64_t c = base + e % kLeaf;
    tile[e] = (r < n && c < n) ? load_f32(A[r * n + c]) : 0.f;
  }
}

// (a) partial corrections of block row rows [row0, row0 + kBlock) over the
// columns [c0, c1) of this CTA's chunk, for right-hand sides [p0, p0 + KP)
template <class SA, bool DF64, int KP>
__global__ void __launch_bounds__(kWarps * 32)
    trsv_offdiag(const SA* __restrict__ A, int64_t n, int64_t npad,
                 const float* __restrict__ xhi, const float* __restrict__ xlo, int64_t k,
                 int64_t row0, int64_t col0, int64_t col1, float* __restrict__ part_hi,
                 float* __restrict__ part_lo, int vec_ok) {
  constexpr int V = 16 / sizeof(SA);
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t row = row0 + r;
  const int64_t c0 = col0 + static_cast<int64_t>(blockIdx.y) * kChunk;
  const int64_t c1 = c0 + kChunk < col1 ? c0 + kChunk : col1;
  const int64_t p0 = static_cast<int64_t>(blockIdx.z) * KP;
  DotAcc<DF64> acc[KP];
  auto add = [&](float a, int64_t c) {
#pragma unroll
    for (int q = 0; q < KP; ++q) {
      if (p0 + q < k) {
        const int64_t i = (p0 + q) * npad + c;
        acc[q].add(a, xhi[i], DF64 ? xlo[i] : 0.f);
      }
    }
  };
  if (row < n) {  // rows past n keep zero partials
    const SA* arow = A + row * n;
    if (vec_ok) {
#pragma unroll 4
      for (int64_t j = c0 / V + lane; j < c1 / V; j += 32) {
        const Pack<SA, V> pk = load_pack<SA, V>(arow + j * V);
#pragma unroll
        for (int e = 0; e < V; ++e) add(load_f32(pk.v[e]), j * V + e);
      }
    } else {
      for (int64_t c = c0 + lane; c < c1; c += 32) add(load_f32(arow[c]), c);
    }
  }
#pragma unroll
  for (int q = 0; q < KP; ++q) {
    const val_t<DF64> v = warp_reduce<kRed<DF64>>(acc[q].value());
    if (lane == 0 && p0 + q < k) {
      const int64_t o = (static_cast<int64_t>(blockIdx.y) * k + p0 + q) * kBlock + r;
      part_hi[o] = hi_of(v);
      if constexpr (DF64) part_lo[o] = lo_of(v);
    }
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// sum over the kGroup consecutive lanes of a leaf row's group; valid in the
// group's first lane
template <bool DF64>
__device__ __forceinline__ val_t<DF64> group_reduce(val_t<DF64> v) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) v = combine<kRed<DF64>>(v, shfl_down(v, off));
  return v;
}

// (b) the diagonal step of block row bi for right-hand sides [p0, p0 + KP)
template <class SA, bool DF64, int KP>
__global__ void __launch_bounds__(kDiagThreads)
    trsv_diag(const SA* __restrict__ A, int64_t n, int64_t npad, const float* __restrict__ inv,
              const float* __restrict__ bt, int64_t k, int64_t bi, int nchunks,
              const float* __restrict__ part_hi, const float* __restrict__ part_lo,
              float* __restrict__ xhi, float* __restrict__ xlo, void* out, int out_st,
              int lower) {
  // v holds rhs - corr, and a leaf's x once that leaf is solved
  __shared__ float vh[KP][kBlock], vl[KP][kBlock];
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * KP;
  const int64_t row0 = bi * kBlock;
  const int g = threadIdx.x % kGroup;   // the thread's place in its row's group
  const int il = threadIdx.x / kGroup;  // its row within a leaf
  const float* linv = inv + bi * kNleaf * kLeaf * kLeaf;

  // ask for the diagonal block and its leaf inverses in L2 at once: the
  // leaf steps below then wait on L2, not on device memory
  const int64_t rows = n - row0 < kBlock ? n - row0 : kBlock;
  const int lines = static_cast<int>((rows * sizeof(SA) + 127) / 128);
  for (int e = threadIdx.x; e < rows * lines; e += kDiagThreads) {
    prefetch_l2(reinterpret_cast<const char*>(A + (row0 + e / lines) * n + row0) +
                (e % lines) * 128);
  }
  for (int e = threadIdx.x; e < kNleaf * kLeaf * kLeaf * 4 / 128; e += kDiagThreads) {
    prefetch_l2(reinterpret_cast<const char*>(linv) + e * 128);
  }

  for (int e = threadIdx.x; e < KP * kBlock; e += kDiagThreads) {
    const int q = e / kBlock, r = e % kBlock;
    val_t<DF64> v = make_val<DF64>(0.f, 0.f);
    if (p0 + q < k) {
      val_t<DF64> corr = make_val<DF64>(0.f, 0.f);
      for (int c = 0; c < nchunks; ++c) {
        const int64_t o = (c * k + p0 + q) * kBlock + r;
        corr = combine<kRed<DF64>>(corr, make_val<DF64>(part_hi[o], DF64 ? part_lo[o] : 0.f));
      }
      v = sub<DF64>(make_val<DF64>(bt[(p0 + q) * npad + row0 + r], 0.f), corr);
    }
    vh[q][r] = hi_of(v);
    vl[q][r] = lo_of(v);
  }
  __syncthreads();

  // each leaf row belongs to a group of kGroup threads, which split its
  // columns; all kDiagThreads threads load at once
  for (int t = 0; t < kNleaf; ++t) {
    const int s = lower ? t : kNleaf - 1 - t;
    const int i = s * kLeaf + il;
    // the leaf's rows minus the solved leaves of this block
    const int d0 = lower ? 0 : (s + 1) * kLeaf;
    const int d1 = lower ? s * kLeaf : kBlock;
    if (d1 > d0) {
      // every load first, into registers, so that they are all in flight
      // together; then the sums
      const int64_t row = row0 + i;
      const bool live = row < n;
      const SA* arow = A + (live ? row : 0) * n + row0;
      float av[kDeps];
#pragma unroll
      for (int u = 0; u < kDeps; ++u) {
        const int c = d0 + g + u * kGroup;
        av[u] = (live && c < d1 && row0 + c < n) ? load_f32(arow[c]) : 0.f;
      }
      DotAcc<DF64> acc[KP];
#pragma unroll
      for (int u = 0; u < kDeps; ++u) {
        const int c = d0 + g + u * kGroup;
        if (c < d1) {
#pragma unroll
          for (int q = 0; q < KP; ++q) acc[q].add(av[u], vh[q][c], vl[q][c]);
        }
      }
#pragma unroll
      for (int q = 0; q < KP; ++q) {
        const val_t<DF64> dep = group_reduce<DF64>(acc[q].value());
        if (g == 0) {
          const val_t<DF64> v = sub<DF64>(make_val<DF64>(vh[q][i], vl[q][i]), dep);
          vh[q][i] = hi_of(v);
          vl[q][i] = lo_of(v);
        }
      }
      __syncthreads();
    }
    // x_j = sum_i inv[j][i] * r_i through the pre-inverted leaf, j = il
    const float* li = linv + (s * kLeaf + il) * kLeaf;
    float w[kLeaf / kGroup];
#pragma unroll
    for (int u = 0; u < kLeaf / kGroup; ++u) w[u] = li[g + u * kGroup];
    DotAcc<DF64> acc[KP];
#pragma unroll
    for (int u = 0; u < kLeaf / kGroup; ++u) {
      const int c = s * kLeaf + g + u * kGroup;
#pragma unroll
      for (int q = 0; q < KP; ++q) acc[q].add(w[u], vh[q][c], vl[q][c]);
    }
    val_t<DF64> x[KP];
#pragma unroll
    for (int q = 0; q < KP; ++q) x[q] = group_reduce<DF64>(acc[q].value());
    __syncthreads();  // every group has read the leaf's r
    if (g == 0) {
#pragma unroll
      for (int q = 0; q < KP; ++q) {
        vh[q][i] = hi_of(x[q]);
        vl[q][i] = lo_of(x[q]);
      }
    }
    __syncthreads();
  }

  // publish x for the block rows after this one, and store the result
  for (int e = threadIdx.x; e < KP * kBlock; e += kDiagThreads) {
    const int q = e / kBlock, r = e % kBlock;
    if (p0 + q >= k) continue;
    const int64_t row = row0 + r;
    xhi[(p0 + q) * npad + row] = vh[q][r];
    if constexpr (DF64) xlo[(p0 + q) * npad + row] = vl[q][r];
    if (row < n) {
      store_code(out, row * k + p0 + q, out_st, DF64 ? __fadd_rn(vh[q][r], vl[q][r]) : vh[q][r]);
    }
  }
}

template <class SA, bool DF64, int KP>
cudaError_t sweep(const SA* A, int64_t n, int64_t nb, const float* inv, const float* bt,
                  int64_t k, float* xhi, float* xlo, float* part_hi, float* part_lo, void* out,
                  int out_st, int lower, int vec_ok, cudaStream_t s) {
  const int64_t npad = nb * kBlock;
  const unsigned panels = static_cast<unsigned>((k + KP - 1) / KP);
  for (int64_t step = 0; step < nb; ++step) {
    const int64_t bi = lower ? step : nb - 1 - step;
    const int64_t row0 = bi * kBlock;
    // the solved columns: all blocks before a lower row, after an upper one
    const int64_t col0 = lower ? 0 : row0 + kBlock;
    const int64_t col1 = lower ? row0 : n;
    const int nchunks = col1 > col0 ? static_cast<int>((col1 - col0 + kChunk - 1) / kChunk) : 0;
    if (nchunks > 0) {
      trsv_offdiag<SA, DF64, KP><<<dim3(kBlock / kWarps, nchunks, panels), kWarps * 32, 0, s>>>(
          A, n, npad, xhi, xlo, k, row0, col0, col1, part_hi, part_lo, vec_ok);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    trsv_diag<SA, DF64, KP><<<panels, kDiagThreads, 0, s>>>(
        A, n, npad, inv, bt, k, bi, nchunks, part_hi, part_lo, xhi, xlo, out, out_st, lower);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace accblas

// A: n x n row-major (storage a_st); d: m x kLeaf x kLeaf floats receiving
// the diagonal leaf tiles, m * kLeaf >= n. Returns cudaGetLastError().
extern "C" int accblas_leaf_diag(const void* A, int a_st, int64_t n, float* d, int64_t m,
                                 void* stream) {
  using namespace accblas;
  return with_storage(a_st, [&](auto ta) {
    using SA = typename decltype(ta)::type;
    leaf_diag<SA><<<static_cast<unsigned>(m), kLeafThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(static_cast<const SA*>(A), n, d);
    return cudaGetLastError();
  });
}

// A: n x n row-major (storage a_st), nb = ceil(n / kBlock) block rows,
// npad = nb * kBlock. inv: (nb * kBlock / kLeaf, kLeaf, kLeaf) leaf inverses
// (identity past n); bt: (k, npad) f32 right-hand sides, zero past n.
// xhi (and xlo for df64): (k, npad) f32 scratch for the published x;
// part_hi/part_lo: (ceil(npad / kChunk), k, kBlock) f32 scratch.
// out: (n, k) row-major in storage out_st. vec_ok: A 16-byte aligned and n a
// multiple of the vector width. Launches 2 * nb - 1 kernels on `stream`;
// returns the first launch error, or 0.
extern "C" int accblas_trsv_sweep(const void* A, int a_st, int64_t n, int64_t nb,
                                  const float* inv, const float* bt, int64_t k, float* xhi,
                                  float* xlo, float* part_hi, float* part_lo, void* out,
                                  int out_st, int lower, int df, int vec_ok, void* stream) {
  using namespace accblas;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_storage(a_st, [&](auto ta) {
    using SA = typename decltype(ta)::type;
    const SA* a = static_cast<const SA*>(A);
    if (df) {
      return k == 1 ? sweep<SA, true, 1>(a, n, nb, inv, bt, k, xhi, xlo, part_hi, part_lo, out,
                                         out_st, lower, vec_ok, s)
                    : sweep<SA, true, 4>(a, n, nb, inv, bt, k, xhi, xlo, part_hi, part_lo, out,
                                         out_st, lower, vec_ok, s);
    }
    return k == 1 ? sweep<SA, false, 1>(a, n, nb, inv, bt, k, xhi, xlo, part_hi, part_lo, out,
                                        out_st, lower, vec_ok, s)
                  : sweep<SA, false, 4>(a, n, nb, inv, bt, k, xhi, xlo, part_hi, part_lo, out,
                                        out_st, lower, vec_ok, s);
  });
}
