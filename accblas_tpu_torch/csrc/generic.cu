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
// once, each output written once; df64's ~20 flops an element need less).
// Every sum runs in a fixed order, so that every run gives the same bits;
// ops/generic.py's plain versions spell out the same orders.
//
// All three read V neighbouring stored values with one aligned access
// (Range's row.load<V>/row.stream<V>: 16 bytes of storage, at most 32 bytes
// of Ar values, so V = 4 for f32, 8 for bf16 and 4 for either under df64).
//
// AXPY, elementwise and so free of order: the grid walks tiles of kThreads
// x kAxpySteps x V columns of one row, the tile's base taken once; a thread
// reads its kAxpySteps V-wide steps of x and y past L1 (row.stream<V>,
// neighbouring threads on neighbouring 16 bytes) before it writes any, then
// writes each step's V results with one evict-first vector store
// (row.store_stream<V>: 32 bytes, two 16-byte stores, for bf16 in and f32
// out). A row's last tile, where narrower, masks its ragged step.
//
// The GEMV and the window sum keep V fold slots a thread. A and the window, read once, go through
// row.stream<V> (no L1 line), so that A's stream does not evict x. Both
// load kSteps vector steps before they add one, and fold them in a binary
// counter sized to the run (kLevelsVec levels: the host checks the depth).
// The wrappers launch the V = 1 instantiation of the same body (kLevelsOne
// levels) where an operand's base or row stride is not a multiple of V
// elements, or where a row is deeper than kLevelsVec holds.
//
// The GEMV's sum is _reduce_last's pairwise halving (column j meets j + w/2),
// zero-padded to the next power of two w. One warp takes a row, and column
// j = (k * lanes + t) * V + v: lane t keeps V slots, slot v folds its k by
// halving (a binary counter fed in bit-reversed k order builds exactly that
// tree), then the warp halves over t with V shuffles a level, then the lane
// halves over v. The high bits of j go first: that is the halving tree.
//
// The window sum folds the zero-padded (M, N) window read flat as (K, B, T)
// (flat index q = kBT + bT + t), halving over k, then t, then b. Thread
// `thread` of block b holds t = thread * V + v as slot v: its slots fold
// over k, the block halves over its threads, then each thread over its
// slots. Each block stores its sum; the last block to finish (a ticket
// counter in a scratch buffer, after __threadfence) folds the B block sums
// by halving over b, and its ticket resets the counter for the next call on
// the stream. One launch, no atomics on the values.

#include "range.cuh"
#include "reduce.cuh"

namespace accblas {
namespace {

constexpr int kThreads = 256;      // AXPY blocks, and T: window threads times V
constexpr int kGemvWarps = 4;      // GEMV warps a block, one row a warp
constexpr int kMaxBlocks = kScratchBlocks;  // window blocks B: the last one folds them
constexpr int kStepsLog2 = 4;      // vector steps a thread loads before it adds one
constexpr int kSteps = 1 << kStepsLog2;
constexpr int kLevelsVec = 8;      // counter levels of the vector instantiations
constexpr int kLevelsOne = 20;     // and of the V = 1 ones: 2^(L-1) pushes of kSteps
constexpr int kAxpySteps = 8;      // AXPY vector steps a thread loads before it writes one

template <class Ar, class St>
using in_t = range_t<Ar, const St>;

// stored values a vector read takes: 16 bytes of storage, at most 32 bytes
// of Ar values (ops/generic.py vector_width)
template <class Ar, class St>
__host__ __device__ constexpr int vec_of() {
  return 16 / sizeof(St) < 32 / sizeof(Ar) ? 16 / sizeof(St) : 32 / sizeof(Ar);
}

// bit-reversal of the low `bits` bits of k
__device__ __forceinline__ int bit_reverse(int k, int bits) {
  return bits == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - bits));
}

// V binary counters of partial sums that count together: level l of slot v
// holds the sum of 2^l pushes, an earlier one on the left of each add
template <class Ar, int V, int L>
struct Counter {
  Ar level[L][V];
  unsigned count = 0;

  __device__ __forceinline__ void push(Ar (&v)[V]) {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (!((count >> l) & 1u)) {
#pragma unroll
        for (int s = 0; s < V; ++s) level[l][s] = v[s];
        break;
      }
#pragma unroll
      for (int s = 0; s < V; ++s) v[s] = level[l][s] + v[s];
    }
    ++count;
  }
  // after a power-of-two count of pushes, the one full level
  __device__ __forceinline__ void result(Ar (&out)[V]) const {
#pragma unroll
    for (int s = 0; s < V; ++s) out[s] = Ar{};
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (count == (1u << l)) {
#pragma unroll
        for (int s = 0; s < V; ++s) out[s] = level[l][s];
      }
    }
  }
};

// slot v of `out` is the pairwise fold of value(0)[v], ...,
// value(2^log2_count - 1)[v], as a binary counter fed in that order builds
// it: load(p0, vals) fills the kSteps values p0, p0 + 1, ... at once (loads
// in flight together), an unrolled tree folds them (an aligned subtree of
// the counter's; a value past a count below kSteps is never added to one
// within it), and the counter takes the result
template <class Ar, int V, int L, class F>
__device__ __forceinline__ void pairwise_fold(int log2_count, F load, Ar (&out)[V]) {
  Counter<Ar, V, L> c;
  const int count = 1 << log2_count;
  for (int p0 = 0; p0 < count; p0 += kSteps) {
    Ar vals[kSteps][V];
    load(p0, vals);
#pragma unroll
    for (int w = 1; w < kSteps; w <<= 1) {
      if (w < count) {
#pragma unroll
        for (int r = 0; r < kSteps; r += 2 * w) {
#pragma unroll
          for (int s = 0; s < V; ++s) vals[r][s] = vals[r][s] + vals[r + w][s];
        }
      }
    }
    c.push(vals[0]);
  }
  c.result(out);
}

// halving over the first `slots` (a power of two <= V) of a thread's slots:
// v takes v + w for w = slots/2, ..., 1; the sum is v[0]
template <class Ar, int V>
__device__ __forceinline__ Ar slot_fold(Ar (&v)[V], int slots) {
#pragma unroll
  for (int w = V / 2; w > 0; w >>= 1) {
    if (w < slots) {
#pragma unroll
      for (int s = 0; s < w; ++s) v[s] = v[s] + v[s + w];
    }
  }
  return v[0];
}

// halving over the block's threads (blockDim.x a power of two) of each slot:
// thread t takes t + h for h = n/2, ..., 1, in shared memory (`sh`, V n
// values) down to one warp, then by shuffles; then over the slots. The sum
// is valid in thread 0.
template <class Ar, int V>
__device__ __forceinline__ Ar block_fold(Ar (&v)[V], int slots, Ar* sh) {
  const int t = threadIdx.x;
  const int n = blockDim.x;
#pragma unroll
  for (int s = 0; s < V; ++s) sh[s * n + t] = v[s];
  __syncthreads();
  int h = n / 2;
  for (; h >= 32; h >>= 1) {
    if (t < h) {
#pragma unroll
      for (int s = 0; s < V; ++s) sh[s * n + t] = sh[s * n + t] + sh[s * n + t + h];
    }
    __syncthreads();
  }
  if (t < 32) {
    const unsigned mask = n >= 32 ? 0xffffffffu : (1u << n) - 1u;
#pragma unroll
    for (int s = 0; s < V; ++s) v[s] = sh[s * n + t];
    for (; h > 0; h >>= 1) {
#pragma unroll
      for (int s = 0; s < V; ++s) v[s] = v[s] + shfl_down(v[s], h, mask);
    }
  }
  return slot_fold(v, slots);
}

// a block sum another block wrote in this launch: read from L2, never L1
__device__ __forceinline__ float load_l2(const float* p) { return __ldcg(p); }
__device__ __forceinline__ DF load_l2(const DF* p) {
  const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
  return DF{v.x, v.y};
}

// columns an AXPY tile takes: a block's kAxpySteps steps of V
template <int V>
constexpr int kAxpyTile = kThreads * kAxpySteps * V;

// o(i, j) = x(i, j) * alpha + y(i, j), a tile of one row a block (grid-stride
// over the tiles, row by row): step s of thread t is columns (s kThreads +
// t) V .. + V - 1 of the tile, all read before any is written
template <int V, class Ar, class SI, class SO>
__global__ void __launch_bounds__(kThreads)
    generic_axpy(in_t<Ar, SI> x, in_t<Ar, SI> y, range_t<Ar, SO> o, float alpha) {
  constexpr int kTile = kAxpyTile<V>;
  const int64_t cols = o.length(1);
  const int64_t per_row = (cols + kTile - 1) / kTile;
  const int64_t tiles = o.length(0) * per_row;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t i = t / per_row;
    const int64_t c0 = (t - i * per_row) * kTile;
    const int width = static_cast<int>(cols - c0 < kTile ? cols - c0 : kTile);
    const auto xr = x.window(i, c0, 1, width).row(0);
    const auto yr = y.window(i, c0, 1, width).row(0);
    const auto orow = o.window(i, c0, 1, width).row(0);
    if (width == kTile) {
      // the steps' stored values in flight, each widened only where used
      using Row = std::remove_const_t<decltype(xr)>;
      Pack<SI, V> xp[kAxpySteps], yp[kAxpySteps];
#pragma unroll
      for (int s = 0; s < kAxpySteps; ++s) {
        const int c = (s * kThreads + threadIdx.x) * V;
        xp[s] = xr.template stream_pack<V>(c);
        yp[s] = yr.template stream_pack<V>(c);
      }
#pragma unroll
      for (int s = 0; s < kAxpySteps; ++s) {
        Ar xv[V], yv[V], v[V];
        Row::widen(xp[s], xv);
        Row::widen(yp[s], yv);
#pragma unroll
        for (int u = 0; u < V; ++u) v[u] = xv[u] * alpha + yv[u];
        orow.store_stream((s * kThreads + threadIdx.x) * V, v);
      }
    } else {  // a row's narrower last tile: whole steps by vector, the ragged one by element
      Ar xv[kAxpySteps][V], yv[kAxpySteps][V];
#pragma unroll
      for (int s = 0; s < kAxpySteps; ++s) {
        const int c = (s * kThreads + threadIdx.x) * V;
        if (c + V <= width) {
          xr.stream(c, xv[s]);
          yr.stream(c, yv[s]);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u) {
            xv[s][u] = c + u < width ? static_cast<Ar>(xr(c + u)) : Ar{};
            yv[s][u] = c + u < width ? static_cast<Ar>(yr(c + u)) : Ar{};
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kAxpySteps; ++s) {
        const int c = (s * kThreads + threadIdx.x) * V;
        Ar v[V];
#pragma unroll
        for (int u = 0; u < V; ++u) v[u] = xv[s][u] * alpha + yv[s][u];
        if (c + V <= width) {
          orow.store_stream(c, v);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u) {
            if (c + u < width) orow(c + u) = v[u];
          }
        }
      }
    }
  }
}

// o(i, 0) = (sum_j a(i, j) * x(0, j)) * alpha + r(i, 0) * beta, one warp a
// row: lane t (of `lanes`, a power of two) holds columns (k lanes + t) V + v
// of the row's zero-padded width (2^log2_per lanes V, or `slots` < V when
// the width is below V)
template <int V, int L, class Ar, class SI, class SO>
__global__ void __launch_bounds__(32 * kGemvWarps)
    generic_gemv(in_t<Ar, SI> a, in_t<Ar, SI> x, in_t<Ar, SO> r, range_t<Ar, SO> o,
                 float alpha, float beta, int lanes, int log2_per, int slots) {
  const int n = static_cast<int>(a.length(1));
  const int lane = threadIdx.x & 31;
  const int per = 1 << log2_per;
  const auto xr = x.row(0);
  const int64_t rows_per_grid = static_cast<int64_t>(gridDim.x) * kGemvWarps;
  for (int64_t i = blockIdx.x * int64_t{kGemvWarps} + (threadIdx.x >> 5); i < a.length(0);
       i += rows_per_grid) {
    const auto arow = a.row(i);
    Ar own[V];
    pairwise_fold<Ar, V, L>(log2_per, [&](int p0, Ar (&v)[kSteps][V]) {
      // the chunk's steps are k0 + t per / live, t < live: the last one's
      // columns decide whether every read lies in the row
      const int live = per < kSteps ? per : kSteps;
      const int k_last = bit_reverse(p0, log2_per) + per - per / live;
      if (lane < lanes && (k_last * lanes + lane + 1) * V <= n) {
        // kSteps vector reads in flight; a step past the count reads a
        // live step's columns, and the fold never adds it to a live one
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const int c = (bit_reverse((p0 + s) & (per - 1), log2_per) * lanes + lane) * V;
          Ar av[V], xv[V];
          arow.stream(c, av);
          xr.load(c, xv);
#pragma unroll
          for (int u = 0; u < V; ++u) v[s][u] = av[u] * xv[u];
        }
      } else {  // the ragged end of a row, or a width below the warp's
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          const int c = (bit_reverse(p0 + s, log2_per) * lanes + lane) * V;
#pragma unroll
          for (int u = 0; u < V; ++u) {
            const int j = c + u;
            v[s][u] = lane < lanes && p0 + s < per && j < n ? arow(j) * xr(j) : Ar{};
          }
        }
      }
    }, own);
    for (int h = lanes / 2; h > 0; h >>= 1) {
#pragma unroll
      for (int u = 0; u < V; ++u) own[u] = own[u] + shfl_down(own[u], h);
    }
    const Ar val = slot_fold(own, slots);
    if (lane == 0) o(i, 0) = val * alpha + r(i, 0) * beta;
  }
}

// the sum of the window's zero-padded (M, N) = (M, 2^log2_n) elements read
// as (K, B, T) = (2^log2_per, gridDim.x, 2^log2_t): block b's sum over its
// (k, t) to partial[b]; the last block to finish folds the B sums into o,
// the (1, 1) output range. `ticket` is 0 before the launch and after it.
template <int V, int L, class Ar, class St>
__global__ void __launch_bounds__(kThreads)
    window_sum(in_t<Ar, St> w, Ar* partial, unsigned* ticket, range_t<Ar, float> o,
               int log2_n, int log2_t, int log2_per, int slots) {
  __shared__ Ar sh[kMaxBlocks];
  __shared__ bool last;
  const int64_t m = w.length(0);
  const int n = static_cast<int>(w.length(1));
  const int per = 1 << log2_per;
  const int64_t bt = static_cast<int64_t>(gridDim.x) << log2_t;
  const int64_t own_q = (static_cast<int64_t>(blockIdx.x) << log2_t) + threadIdx.x * V;
  const int64_t col_mask = (int64_t{1} << log2_n) - 1;
  // a thread's steps read one column (bt a multiple of N) or, where a step
  // is less than a row, columns at most N - bt past its first
  const bool cols_in = slots == V && (own_q & col_mask) + (bt < col_mask + 1 ? col_mask + 1 - bt
                                                                             : 0) + V <= n;
  Ar own[V];
  pairwise_fold<Ar, V, L>(log2_per, [&](int p0, Ar (&v)[kSteps][V]) {
    // the chunk's steps are k0 + t per / live, t < live: the last one has
    // the last row
    const int live = per < kSteps ? per : kSteps;
    const int64_t k_last = bit_reverse(p0, log2_per) + per - per / live;
    if (cols_in && (k_last * bt + own_q) >> log2_n < m) {
      // kSteps vector reads in flight, the step's row and column computed
      // once; a step past the count reads a live step's, never added
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int64_t q = bit_reverse((p0 + s) & (per - 1), log2_per) * bt + own_q;
        w.row(q >> log2_n).stream(static_cast<int>(q & col_mask), v[s]);
      }
    } else {  // the ragged edge, or slots spanning rows of a narrow window
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int64_t q = bit_reverse(p0 + s, log2_per) * bt + own_q + u;
          const int64_t i = q >> log2_n, j = q & col_mask;
          v[s][u] = u < slots && p0 + s < per && i < m && j < n ? static_cast<Ar>(w(i, j))
                                                                : Ar{};
        }
      }
    }
  }, own);
  const Ar sum = block_fold(own, slots, sh);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = sum;
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;  // the last resets it to 0
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll 8
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += blockDim.x) {
    sh[b] = load_l2(partial + b);
  }
  __syncthreads();
  for (int h = gridDim.x / 2; h > 0; h >>= 1) {
    for (int b = threadIdx.x; b < h; b += blockDim.x) sh[b] = sh[b] + sh[b + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) o(0, 0) = sh[0];
}

}  // namespace
}  // namespace accblas

// The size in bytes of the scratch buffer accblas_window_sum takes.
extern "C" int accblas_scratch_bytes() { return static_cast<int>(accblas::kScratchBytes); }

// x, y: (rows, cols) of storage st_in with row strides sx, sy; o of st_out;
// v = 1, or the pair's vector width with the bases and row strides of x, y
// and o multiples of it. The grid is one block a tile, at most 2^20.
extern "C" int accblas_generic_axpy(const void* x, int64_t sx, const void* y, int64_t sy,
                                    int st_in, void* o, int64_t so, int st_out, int64_t rows,
                                    int64_t cols, int ar, float alpha, int v, void* stream) {
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
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        auto launch = [&](auto kern, int tile) {
          const int64_t tiles = rows * ((cols + tile - 1) / tile);
          const unsigned grid = static_cast<unsigned>(tiles < (1 << 20) ? tiles : 1 << 20);
          kern<<<grid, kThreads, 0, s>>>(rx, ry, ro, alpha);
        };
        constexpr int kV = vec_of<Ar, SI>();
        if (v == kV) {
          launch(generic_axpy<kV, Ar, SI, SO>, kAxpyTile<kV>);
        } else if (v == 1) {
          launch(generic_axpy<1, Ar, SI, SO>, kAxpyTile<1>);
        } else {
          return cudaErrorInvalidValue;
        }
        return cudaGetLastError();
      });
    });
  });
}

// a: (m, n) of st_in, row stride sa; x: n contiguous of st_in; r, o: m
// contiguous of st_out; lanes * 2^log2_per * v = the zero-padded width
// (`slots` of the v values a lane holds count, fewer than v only below v
// columns); v = 1, or the pair's vector width with a, sa and x aligned to it
extern "C" int accblas_generic_gemv(const void* a, int64_t sa, const void* x, const void* r,
                                    void* o, int st_in, int st_out, int64_t m, int64_t n,
                                    int ar, float alpha, float beta, int lanes, int log2_per,
                                    int slots, int v, void* stream) {
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
        const cudaStream_t s = static_cast<cudaStream_t>(stream);
        const int64_t blocks = (m + kGemvWarps - 1) / kGemvWarps;  // one row a warp
        const unsigned grid = static_cast<unsigned>(blocks < (1 << 20) ? blocks : 1 << 20);
        constexpr int kV = vec_of<Ar, SI>();
        if (v == kV) {
          generic_gemv<kV, kLevelsVec><<<grid, 32 * kGemvWarps, 0, s>>>(
              ra, rx, rr, ro, alpha, beta, lanes, log2_per, slots);
        } else if (v == 1) {
          generic_gemv<1, kLevelsOne><<<grid, 32 * kGemvWarps, 0, s>>>(
              ra, rx, rr, ro, alpha, beta, lanes, log2_per, slots);
        } else {
          return cudaErrorInvalidValue;
        }
        return cudaGetLastError();
      });
    });
  });
}

// the (m, n) window at (row0, col0) of a parent of storage st with row
// stride `stride`, read as (K, B, T) = (2^log2_per, blocks, 2^log2_t) with
// K B T = M 2^log2_n, blocks a power of two <= kMaxBlocks; v = 1, or the
// pair's vector width with the window's base and the stride aligned to it.
// scratch: accblas_scratch_bytes() bytes (the block sums, then the ticket
// counter), its ticket 0 (and left at 0)
extern "C" int accblas_window_sum(const void* parent, int st, int64_t stride, int64_t row0,
                                  int64_t col0, int64_t m, int64_t n, int ar, float* out,
                                  void* scratch, int log2_n, int blocks, int log2_t,
                                  int log2_per, int v, void* stream) {
  using namespace accblas;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* ticket = scratch_ticket(scratch);
  if (blocks > kMaxBlocks) return cudaErrorInvalidValue;
  return with_arith(ar, [&](auto ta) {
    using Ar = typename decltype(ta)::type;
    return with_storage(st, [&](auto ts) {
      using S = typename decltype(ts)::type;
      // the parent's extent does not matter to the window: only its stride
      const in_t<Ar, S> p(static_cast<const S*>(parent), row0 + m, stride, stride);
      const auto win = p.window(row0, col0, m, n);
      Ar* partial = static_cast<Ar*>(scratch);
      const range_t<Ar, float> o(out, 1, 1, 1);
      const int t = 1 << log2_t;
      constexpr int kV = vec_of<Ar, S>();
      if (v == kV) {
        window_sum<kV, kLevelsVec><<<blocks, t >= kV ? t / kV : 1, 0, s>>>(
            win, partial, ticket, o, log2_n, log2_t, log2_per, t < kV ? t : kV);
      } else if (v == 1) {
        window_sum<1, kLevelsOne><<<blocks, t, 0, s>>>(win, partial, ticket, o, log2_n,
                                                       log2_t, log2_per, 1);
      } else {
        return cudaErrorInvalidValue;
      }
      return cudaGetLastError();
    });
  });
}
