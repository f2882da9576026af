// Column sums of a contiguous row-major (m, n) matrix in f32:
// out[0, j] = sum_i float(a[i, j]), for every storage type of accessor.cuh.
//
// Replaces conv_kernel, scripts/probe_r4a.py:93 (its pallas_call at :113):
// the f8e4m3 -> f32 convert stream of the TPU probe, which folds each
// (bm, bn) block over its rows and carries a (1, bn) partial through the
// row blocks in order (rows on the minor grid axis). The TPU grid runs in
// order on one core; here the row blocks run side by side, so the carry
// becomes two launches: colsum_partial sums each chunk of `rows` rows into
// a row of partials, colsum_fold adds those rows in chunk order. No float
// atomics: the bits do not depend on the schedule.
//
// Order of the sum, spelled out again by ops/colsum.py's plain version: in
// each chunk, s = ((0 + a[r0, j]) + a[r0 + 1, j]) + ... in row order; then
// out[j] = ((0 + p[0, j]) + p[1, j]) + ... in chunk order. Both start from
// +0, so no sum is ever -0 and a zero pad row adds nothing.
//
// Bound on the H100: the bytes, each element of A read once (m n bytes at
// f8, 0.1803 ms at 24576^2 over 3.35 TB/s); one add an element is far below
// the f32 rate. The simple design: a thread owns 16 bytes of adjacent
// columns (16 at f8, 4 at f32), one 16-byte load a row, neighbouring threads
// on neighbouring addresses, kUnroll rows in flight before their adds. The
// partials cost 2 * 4 n bytes a chunk beside the chunk's rows * n bytes of A.
// Where the 16-byte load is not aligned (n * sizeof(St) % 16 != 0, or a
// base pointer off 16 bytes), the same kernel loads element by element.
// No wgmma or TMA.

#include "accessor.cuh"

namespace accblas {
namespace {

constexpr int kThreads = 256;  // threads a block, both launches
constexpr int kUnroll = 8;     // rows a thread has loaded before it adds them

// one row's V adjacent values at p (columns j0 .. j0 + V - 1) as floats:
// one aligned 16-byte load, or V scalar loads masked at the row's end
template <class St, int V, bool VEC>
__device__ __forceinline__ void load_row(const St* p, int64_t left, float (&f)[V]) {
  if constexpr (VEC) {
    const Pack<St, V> t = load_pack<St, V>(p);
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = load_f32(t.v[v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) f[v] = v < left ? load_f32(p[v]) : 0.0f;
  }
}

// partial[c, j] = the sum of a[i, j] over the chunk c's rows
// [c * rows, min((c + 1) * rows, m)), in row order; block (x, c) covers
// the columns [x * kThreads * V, (x + 1) * kThreads * V)
template <class St, bool VEC>
__global__ void __launch_bounds__(kThreads)
    colsum_partial(const St* __restrict__ a, int64_t m, int64_t n, int64_t rows,
                   float* __restrict__ partial) {
  constexpr int V = 16 / sizeof(St);
  const int64_t j0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (j0 >= n) return;
  const int64_t r0 = static_cast<int64_t>(blockIdx.y) * rows;
  const int64_t r1 = r0 + rows < m ? r0 + rows : m;
  const int64_t left = n - j0;
  float s[V];
#pragma unroll
  for (int v = 0; v < V; ++v) s[v] = 0.0f;
  const St* p = a + r0 * n + j0;
  int64_t i = r0;
  for (; i + kUnroll <= r1; i += kUnroll, p += kUnroll * n) {
    float f[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_row<St, V, VEC>(p + u * n, left, f[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int v = 0; v < V; ++v) s[v] = s[v] + f[u][v];
    }
  }
  for (; i < r1; ++i, p += n) {
    float f[V];
    load_row<St, V, VEC>(p, left, f);
#pragma unroll
    for (int v = 0; v < V; ++v) s[v] = s[v] + f[v];
  }
  float* out = partial + static_cast<int64_t>(blockIdx.y) * n + j0;
  if constexpr (VEC) {
    // n % V == 0 and V % 4 == 0 here, so the row of partials is 16-byte aligned
#pragma unroll
    for (int v = 0; v < V; v += 4) {
      *reinterpret_cast<float4*>(out + v) = make_float4(s[v], s[v + 1], s[v + 2], s[v + 3]);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if (v < left) out[v] = s[v];
    }
  }
}

// out[j] = the sum of partial[c, j] over the chunks c in order, a thread a
// column, kUnroll chunks loaded before their adds
__global__ void __launch_bounds__(kThreads)
    colsum_fold(const float* __restrict__ partial, int64_t chunks, int64_t n,
                float* __restrict__ out) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n) return;
  const float* p = partial + j;
  float s = 0.0f;
  int64_t c = 0;
  for (; c + kUnroll <= chunks; c += kUnroll, p += kUnroll * n) {
    float f[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) f[u] = p[u * n];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s = s + f[u];
  }
  for (; c < chunks; ++c, p += n) s = s + *p;
  out[j] = s;
}

}  // namespace
}  // namespace accblas

// a: (m, n) contiguous of storage st, m, n >= 1; chunks = ceil(m / rows) <=
// 65535; partial: chunks * n floats; out: n floats. vec != 0 takes the
// 16-byte loads, which need a 16-byte aligned a and n * sizeof(st) % 16 == 0.
// Two launches on `stream`.
extern "C" int accblas_col_sums(const void* a, int st, int64_t m, int64_t n, int64_t rows,
                                int vec, float* partial, float* out, void* stream) {
  using namespace accblas;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t chunks = (m + rows - 1) / rows;
  return with_storage(st, [&](auto ts) {
    using St = typename decltype(ts)::type;
    constexpr int64_t cols = kThreads * (16 / sizeof(St));  // columns a block
    const dim3 grid(static_cast<unsigned>((n + cols - 1) / cols), static_cast<unsigned>(chunks));
    const St* pa = static_cast<const St*>(a);
    if (vec) {
      colsum_partial<St, true><<<grid, kThreads, 0, s>>>(pa, m, n, rows, partial);
    } else {
      colsum_partial<St, false><<<grid, kThreads, 0, s>>>(pa, m, n, rows, partial);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    colsum_fold<<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        partial, chunks, n, out);
    return cudaGetLastError();
  });
}
