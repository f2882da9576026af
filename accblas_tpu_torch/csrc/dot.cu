// DOT: (hi, lo) = init + sum_i x[i] * y[i], in the arithmetic of a tier, in
// one launch.
//
// Replaces the Pallas kernel `_dot_kernel` (accblas_tpu/ops/dot.py, launched
// by `_dot_call`). On the H100 the least time is the bytes of x and y over
// device memory (a bf16 pair is 4 bytes per 2 flops, far below the card's
// flop-to-byte ratio), so the design keeps enough bytes in flight and the
// host's share small:
// - every thread walks a grid-stride loop over a fixed grid, kThreads a
//   block and kMaxBlocks blocks where the work fills them: the grid fixes
//   the order of the sum, and so its bits, whatever the card;
// - it loads kSteps 16-byte steps of x and y (past L1: read once) before it
//   adds the first, then adds them in the order a step at a time would;
// - each block writes its partial to a scratch buffer; the last block to
//   finish (a ticket counter after __threadfence) folds the partials and
//   adds `init`: one launch a call, no atomics on the values, the same bits
//   on every run. Its ticket leaves the counter at 0 for the next call.
// The TPU kernel carried its accumulator across a sequential grid; the fold
// here keeps the order of the former second pass, `dot_finish`: 1024
// threads holding one partial each (0 past the grid), 32-lane shuffle-down
// trees, then a tree over the 32 warp sums (block_reduce).
//
// x and y are read through the device accessor (range.cuh), as the JAX
// kernel reads them through Ranges: each as a (n / V, V) range whose row i
// is vector step i (the 64-bit product is row(i)'s, so n may pass 2^31),
// read past L1 as stored values (row.stream_pack<V>) and widened to f32 as
// they are added (Row::widen); the tail, and every element of unaligned
// operands, as a (1, n) range, one element r.get(0, j) at a time. The Ranges
// are built in the kernel from the restrict-qualified pointers it is
// given, so the loads keep their provenance and the host call its 8
// arguments. The partials, the ticket and (hi, lo) are the kernel's own
// scratch and result words, as the JAX kernel's hi_ref and lo_ref are.
//
// Tiers (accessor.cuh Tier): f32 sums of f32 products; bf16/f16 with every
// product and every add of a thread's pairwise partial sum rounded to that
// type, the threads' partials then folded in f32 and the total rounded once
// (the reference kernel's lanes and final f32 fold); df64 fast (Kahan chains
// over f32 products) and precise (two_sum chains over exact two_prod
// products), whose partials combine with df_add.

#include "range.cuh"
#include "reduce.cuh"

namespace accblas {
namespace {

constexpr int kThreads = 256;           // threads a block
constexpr int kMaxBlocks = kScratchBlocks;  // blocks at most: one partial each in the scratch
constexpr int kFoldThreads = 1024;      // the fold's threads, one partial each (dot_finish's)
constexpr int kSteps = 8;               // vector steps a thread loads before it adds one

// the arithmetic of the cross-thread reduction: f32 for the bf16/f16 tiers
// (their rounding is per thread, and once at the end), the tier's own else
template <int TIER>
constexpr int kFold = (TIER == TIER_BF16 || TIER == TIER_F16) ? int(TIER_F32) : TIER;

// the last block's fold of the grid's partials, in dot_finish's order:
// kFoldThreads virtual threads, t holding partial t (0 from t = nblocks on),
// a shuffle-down tree in each of their warps (this block's warps take them
// in turn), a tree over the warp sums, then init; the result's words to hi
// and lo (a fixed tier's lo, 0, only where lo is given)
template <int TIER>
__device__ __forceinline__ void fold_partials(const float* partials, int nblocks, float init,
                                              float* hi, float* lo) {
  constexpr int F = kFold<TIER>;
  constexpr int kWarps = kFoldThreads / 32;
  __shared__ value_t<F> warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  for (int w = threadIdx.x >> 5; w < kWarps; w += blockDim.x >> 5) {
    const int b = w * 32 + lane;
    value_t<F> v{};
    if (b < nblocks) {
      const float2 p = __ldcg(reinterpret_cast<const float2*>(partials) + b);
      if constexpr (is_df_tier(F)) {
        v = combine<F>(v, DF{p.x, p.y});
      } else {
        v = combine<F>(v, p.x);
      }
    }
    v = warp_reduce<F>(v);
    if (lane == 0) warp_sum[w] = v;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const value_t<F> v = warp_reduce<F>(warp_sum[lane]);
  if (lane == 0) {
    if constexpr (is_df_tier(TIER)) {
      const DF r = df_add(v, DF{init, 0.f});
      *hi = r.hi;
      *lo = r.lo;
    } else {
      *hi = round_ar<TIER>(__fadd_rn(round_ar<TIER>(init), v));
      if (lo) *lo = 0.f;
    }
  }
}

template <class SX, class SY, int TIER>
__global__ void __launch_bounds__(kThreads)
    dot_reduce(const SX* __restrict__ x, const SY* __restrict__ y, int64_t n, int vec_ok,
               float init, float* __restrict__ partials, unsigned* ticket, float* hi,
               float* lo) {
  constexpr int V = vec_width<SX, SY>();
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nth = static_cast<int64_t>(gridDim.x) * blockDim.x;
  ThreadAcc<TIER, V> acc;

  // vector body: V elements of each operand a step, kSteps steps in flight
  const int64_t nvec = vec_ok ? n / V : 0;
  const range_t<float, const SX> xv(x, nvec, V, V);
  const range_t<float, const SY> yv(y, nvec, V, V);
  using XRow = row_t<float, const SX>;
  using YRow = row_t<float, const SY>;
  int64_t i = tid;
  for (; i + (kSteps - 1) * nth < nvec; i += kSteps * nth) {
    Pack<SX, V> px[kSteps];
    Pack<SY, V> py[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      px[s] = xv.row(i + s * nth).template stream_pack<V>(0);
      py[s] = yv.row(i + s * nth).template stream_pack<V>(0);
    }
    acc.template add_steps<kSteps, XRow, YRow>(px, py);
  }
  for (; i < nvec; i += nth) {
    float xs[V], ys[V];
    xv.row(i).template stream<V>(0, xs);
    yv.row(i).template stream<V>(0, ys);
    acc.add_vec(xs, ys);
  }
  // tail (or everything, for unaligned operands), one element at a time
  const range_t<float, const SX> x1(x, 1, n, n);
  const range_t<float, const SY> y1(y, 1, n, n);
  for (int64_t j = nvec * V + tid; j < n; j += nth) acc.add(0, x1.get(0, j), y1.get(0, j));

  const value_t<TIER> v = block_reduce<kFold<TIER>>(acc.result());
  __shared__ bool last;
  if (threadIdx.x == 0) {
    if constexpr (is_df_tier(TIER)) {
      partials[2 * blockIdx.x] = v.hi;
      partials[2 * blockIdx.x + 1] = v.lo;
    } else {
      partials[2 * blockIdx.x] = v;
      partials[2 * blockIdx.x + 1] = 0.f;
    }
    __threadfence();
    last = atomicInc(ticket, gridDim.x - 1) == gridDim.x - 1;  // the last resets it to 0
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  fold_partials<TIER>(partials, gridDim.x, init, hi, lo);
}

}  // namespace
}  // namespace accblas

// The size in bytes of the scratch buffer accblas_dot takes.
extern "C" int accblas_scratch_bytes() { return static_cast<int>(accblas::kScratchBytes); }

// x, y: n elements; codes = x's storage code | y's << 4 | tier << 8 | vec_ok
// << 12, vec_ok set where both pointers are 16-byte aligned. scratch:
// accblas_scratch_bytes() bytes, its ticket 0 (and left at 0). hi, lo: the
// result's words (lo may be null for the fixed tiers, whose lo is 0). The
// grid is the work's blocks of kThreads vector steps, at most kMaxBlocks.
// Returns cudaGetLastError() after the launch.
extern "C" int accblas_dot(const void* x, const void* y, int64_t n, int codes, float init,
                           void* scratch, float* hi, float* lo, void* stream) {
  using namespace accblas;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec_ok = (codes >> 12) & 1;
  return with_storage(codes & 15, [&](auto tx) {
    return with_storage((codes >> 4) & 15, [&](auto ty) {
      return with_tier((codes >> 8) & 15, [&](auto tt) {
        using SX = typename decltype(tx)::type;
        using SY = typename decltype(ty)::type;
        constexpr int TIER = decltype(tt)::value;
        const int64_t work = vec_ok ? n / vec_width<SX, SY>() : n;
        const int64_t want = (work + kThreads - 1) / kThreads;
        const unsigned blocks = static_cast<unsigned>(
            want < 1 ? 1 : want > kMaxBlocks ? kMaxBlocks : want);
        dot_reduce<SX, SY, TIER><<<blocks, kThreads, 0, s>>>(
            static_cast<const SX*>(x), static_cast<const SY*>(y), n, vec_ok, init,
            static_cast<float*>(scratch), scratch_ticket(scratch), hi, lo);
        return cudaGetLastError();
      });
    });
  });
}
