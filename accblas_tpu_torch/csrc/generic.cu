// Three kernels written once against Range (range.cuh), each instantiated at
// f32 arithmetic (over f32 or bf16 storage, or any other storage type) and at
// df64 arithmetic: the accessor's claim that one body serves every
// (storage, arithmetic) pair, measured on the card.
//
// Replace the Pallas kernels the JAX package's tests write against Range:
//   generic_axpy   tests/test_generic_kernel.py:21 (generic_axpy_kernel)
//   generic_gemv   tests/test_generic_kernel.py:68 (generic_gemv_kernel, its
//                  fold _reduce_last at :57)
//   window_sum     tests/test_accessor.py:165 (the strided-window sum)
// The TPU kernels hold whole operands in VMEM and fold in one grid step. On
// the H100 the least time of all three is their bytes (each operand read
// once; df64's ~20 flops an element need less). These are the simple
// forms: scalar loads, neighbouring threads on neighbouring columns, sums
// in a fixed order so that every run gives the same bits. They reach
// 30-85% of the bytes bound (PERF.md): the GEMV's order scatters a lane's
// reads over its row, where csrc/gemv.cu streams 16-byte loads.
//
// The GEMV's sum is _reduce_last's pairwise halving (column j meets j + w/2),
// zero-padded to the next power of two: lane t of a row's warp folds the
// columns t + 32k by halving over k (a binary counter fed in bit-reversed k
// order builds exactly that tree), then the warp folds its lanes by
// halving over t. The window sum folds the zero-padded (M, N) window, read
// as (K, B, T) (thread t of block b holds q = kBT + bT + t), over k in each
// thread, over t in each block, then over the B block sums in a second
// launch: no atomics. ops/generic.py's plain versions spell out the same
// orders.

#include "range.cuh"
#include "reduce.cuh"

namespace accblas {
namespace {

constexpr int kThreads = 256;      // AXPY, GEMV and window blocks
constexpr int kRowsPerBlock = kThreads / 32;  // GEMV rows a block, one a warp
constexpr int kMaxThreads = 1024;  // the window's second launch
constexpr int kLevels = 20;        // a thread folds at most 2^19 values
constexpr int kChunkLog2 = 4;      // values a thread loads before it folds them
constexpr int kChunk = 1 << kChunkLog2;
constexpr int kUnroll = 4;         // AXPY columns a thread has in flight

template <class Ar, class St>
using in_t = range_t<Ar, const St>;

// bit-reversal of the low `bits` bits of k
__device__ __forceinline__ int64_t bit_reverse(int64_t k, int bits) {
  return bits == 0 ? 0 : static_cast<int64_t>(__brev(static_cast<unsigned>(k)) >> (32 - bits));
}

// a binary counter of partial sums: level l holds the sum of 2^l pushes,
// an earlier one on the left of each add
template <class Ar>
struct Counter {
  Ar level[kLevels];
  unsigned count = 0;

  __device__ __forceinline__ void push(Ar v) {
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      if (!((count >> l) & 1u)) {
        level[l] = v;
        break;
      }
      v = level[l] + v;
    }
    ++count;
  }
  // after a power-of-two count of pushes, the one full level
  __device__ __forceinline__ Ar result() const {
    Ar r{};
#pragma unroll
    for (int l = 0; l < kLevels; ++l) {
      if (count == (1u << l)) r = level[l];
    }
    return r;
  }
};

// the pairwise fold of value(0), ..., value(2^log2_count - 1), as a binary
// counter fed in that order builds it: kChunk values at a time, loaded
// together and folded by an unrolled tree (an aligned subtree of the
// counter's), then pushed as one
template <class Ar, class F>
__device__ __forceinline__ Ar pairwise_fold(int log2_count, F value) {
  Counter<Ar> c;
  if (log2_count < kChunkLog2) {
    for (int64_t p = 0; p < (int64_t{1} << log2_count); ++p) c.push(value(p));
    return c.result();
  }
  for (int64_t q = 0; q < (int64_t{1} << (log2_count - kChunkLog2)); ++q) {
    Ar v[kChunk];
#pragma unroll
    for (int r = 0; r < kChunk; ++r) v[r] = value(q * kChunk + r);
#pragma unroll
    for (int w = 1; w < kChunk; w <<= 1) {
#pragma unroll
      for (int r = 0; r < kChunk; r += 2 * w) v[r] = v[r] + v[r + w];
    }
    c.push(v[0]);
  }
  return c.result();
}

// halving fold over the block's threads (blockDim.x a power of two): thread t
// takes t + s for s = T/2, ..., 1, in shared memory down to one warp, then
// by shuffles. The result is valid in thread 0. Once a kernel (one static
// shared buffer).
template <class Ar>
__device__ __forceinline__ Ar block_fold(Ar v) {
  __shared__ Ar sh[kMaxThreads];
  const int t = threadIdx.x;
  const int n = blockDim.x;
  sh[t] = v;
  __syncthreads();
  int s = n / 2;
  for (; s >= 32; s >>= 1) {
    if (t < s) sh[t] = sh[t] + sh[t + s];
    __syncthreads();
  }
  if (t < 32) {
    const unsigned mask = n >= 32 ? 0xffffffffu : (1u << n) - 1u;
    v = warp_fold(sh[t], 2 * s, Add{}, mask);
  }
  return v;
}

// o(i, j) = x(i, j) * alpha + y(i, j), grid-stride over rows (y) and columns
// (x), kUnroll columns a thread in flight: all read before any is written
template <class Ar, class SI, class SO>
__global__ void __launch_bounds__(kThreads)
    generic_axpy(in_t<Ar, SI> x, in_t<Ar, SI> y, range_t<Ar, SO> o, float alpha) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = blockIdx.y; i < o.length(0); i += gridDim.y) {
    for (int64_t j0 = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         j0 < o.length(1); j0 += kUnroll * step) {
      Ar v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t j = j0 + u * step;
        if (j < o.length(1)) v[u] = x(i, j) * alpha + y(i, j);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u * step < o.length(1)) o(i, j0 + u * step) = v[u];
      }
    }
  }
}

// o(i, 0) = (sum_j a(i, j) * x(0, j)) * alpha + r(i, 0) * beta, one warp a
// row: lane t (of `lanes`, a power of two) folds the columns t + k*lanes of
// the row's zero-padded width lanes << log2_per
template <class Ar, class SI, class SO>
__global__ void __launch_bounds__(kThreads)
    generic_gemv(in_t<Ar, SI> a, in_t<Ar, SI> x, in_t<Ar, SO> r, range_t<Ar, SO> o,
                 float alpha, float beta, int lanes, int log2_per) {
  const int64_t n = a.length(1);
  const int lane = threadIdx.x & 31;
  const int64_t rows_per_grid = static_cast<int64_t>(gridDim.x) * kRowsPerBlock;
  for (int64_t i = blockIdx.x * int64_t{kRowsPerBlock} + (threadIdx.x >> 5); i < a.length(0);
       i += rows_per_grid) {
    const Ar own = pairwise_fold<Ar>(log2_per, [&](int64_t p) {
      const int64_t j = lane + bit_reverse(p, log2_per) * lanes;
      return lane < lanes && j < n ? a(i, j) * x(0, j) : Ar{};
    });
    const Ar val = warp_fold(own, lanes, Add{});
    if (lane == 0) o(i, 0) = val * alpha + r(i, 0) * beta;
  }
}

// the window's zero-padded (M, N) = (M, 2^log2_n) elements, flat index
// q = kBT + bT + t: block b's sum over its (k, t), stored to partial[b]
template <class Ar, class SI>
__global__ void __launch_bounds__(kThreads)
    window_sum_blocks(in_t<Ar, SI> w, Ar* partial, int log2_n, int log2_per) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t cols = int64_t{1} << log2_n;
  const Ar own = pairwise_fold<Ar>(log2_per, [&](int64_t p) {
    const int64_t q = g + bit_reverse(p, log2_per) * stride;
    const int64_t i = q >> log2_n, j = q & (cols - 1);
    return i < w.length(0) && j < w.length(1) ? static_cast<Ar>(w(i, j)) : Ar{};
  });
  const Ar v = block_fold(own);
  if (threadIdx.x == 0) partial[blockIdx.x] = v;
}

// the B block sums folded by halving over b; o is the (1, 1) output range
template <class Ar>
__global__ void __launch_bounds__(kMaxThreads)
    window_sum_final(const Ar* partial, range_t<Ar, float> o) {
  const Ar v = block_fold(partial[threadIdx.x]);
  if (threadIdx.x == 0) o(0, 0) = v;
}

}  // namespace
}  // namespace accblas

// x, y: (rows, cols) of storage st_in with row strides sx, sy; o of st_out
extern "C" int accblas_generic_axpy(const void* x, int64_t sx, const void* y, int64_t sy,
                                    int st_in, void* o, int64_t so, int st_out, int64_t rows,
                                    int64_t cols, int ar, float alpha, unsigned grid_x,
                                    unsigned grid_y, void* stream) {
  using namespace accblas;
  return with_arith(ar, [&](auto ta) {
    using Ar = typename decltype(ta)::type;
    return with_storage(st_in, [&](auto ti) {
      using SI = typename decltype(ti)::type;
      return with_storage(st_out, [&](auto to) {
        using SO = typename decltype(to)::type;
        in_t<Ar, SI> rx(static_cast<const SI*>(x), rows, cols, sx);
        in_t<Ar, SI> ry(static_cast<const SI*>(y), rows, cols, sy);
        range_t<Ar, SO> ro(static_cast<SO*>(o), rows, cols, so);
        generic_axpy<Ar, SI, SO><<<dim3(grid_x, grid_y), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(rx, ry, ro, alpha);
        return cudaGetLastError();
      });
    });
  });
}

// a: (m, n) of st_in, row stride sa; x: n contiguous of st_in; r, o: m
// contiguous of st_out; lanes * 2^log2_per = the zero-padded width
extern "C" int accblas_generic_gemv(const void* a, int64_t sa, const void* x, const void* r,
                                    void* o, int st_in, int st_out, int64_t m, int64_t n,
                                    int ar, float alpha, float beta, int lanes, int log2_per,
                                    unsigned grid, void* stream) {
  using namespace accblas;
  return with_arith(ar, [&](auto ta) {
    using Ar = typename decltype(ta)::type;
    return with_storage(st_in, [&](auto ti) {
      using SI = typename decltype(ti)::type;
      return with_storage(st_out, [&](auto to) {
        using SO = typename decltype(to)::type;
        in_t<Ar, SI> ra(static_cast<const SI*>(a), m, n, sa);
        in_t<Ar, SI> rx(static_cast<const SI*>(x), 1, n, n);
        in_t<Ar, SO> rr(static_cast<const SO*>(r), m, 1, 1);
        range_t<Ar, SO> ro(static_cast<SO*>(o), m, 1, 1);
        generic_gemv<Ar, SI, SO><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            ra, rx, rr, ro, alpha, beta, lanes, log2_per);
        return cudaGetLastError();
      });
    });
  });
}

// the (m, n) window at (row0, col0) of a parent of storage st with row
// stride `stride`; blocks * threads * 2^log2_per = M * 2^log2_n, blocks a
// power of two <= 1024; partial holds `blocks` values of the arithmetic type
extern "C" int accblas_window_sum(const void* parent, int st, int64_t stride, int64_t row0,
                                  int64_t col0, int64_t m, int64_t n, int ar, float* out,
                                  void* partial, int log2_n, int blocks, int threads,
                                  int log2_per, void* stream) {
  using namespace accblas;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_arith(ar, [&](auto ta) {
    using Ar = typename decltype(ta)::type;
    return with_storage(st, [&](auto ts) {
      using S = typename decltype(ts)::type;
      // the parent's extent does not matter to the window: only its stride
      const in_t<Ar, S> p(static_cast<const S*>(parent), row0 + m, stride, stride);
      window_sum_blocks<Ar, S><<<blocks, threads, 0, s>>>(p.window(row0, col0, m, n),
                                                         static_cast<Ar*>(partial), log2_n,
                                                         log2_per);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      window_sum_final<Ar><<<1, blocks, 0, s>>>(static_cast<const Ar*>(partial),
                                                range_t<Ar, float>(out, 1, 1, 1));
      return cudaGetLastError();
    });
  });
}
