// DOT: (hi, lo) = init + sum_i x[i] * y[i], in the arithmetic of a tier.
//
// Replaces the Pallas kernel `_dot_kernel` (accblas_tpu/ops/dot.py, launched
// by `_dot_call`). On the H100 the kernel is bound by device-memory bytes:
// a bf16 pair is 4 bytes per 2 flops, far below the card's flop-to-byte
// ratio. The design therefore only has to keep enough bytes in flight:
// every thread streams 16-byte vector loads of x and y in a grid-stride
// loop over a fixed grid (one wave of blocks), and all arithmetic stays in
// registers. The TPU kernel carried its accumulator across a sequential
// grid; here blocks run in parallel, so each block writes one partial and a
// second one-block pass folds the partials in a fixed order and adds
// `init`. No atomics: the result has the same bits on every run.
//
// Tiers (accessor.cuh Tier): f32 sums of f32 products; bf16/f16 with every
// product and every add of a thread's pairwise partial sum rounded to that
// type, the threads' partials then folded in f32 and the total rounded once
// (the reference kernel's lanes and final f32 fold); df64 fast (Kahan chains
// over f32 products) and precise (two_sum chains over exact two_prod
// products), whose partials combine with df_add.

#include "reduce.cuh"

namespace accblas {
namespace {

constexpr int kThreads = 256;        // threads per block of the first pass
constexpr int kFinishThreads = 1024; // one block folds all partials

// the arithmetic of the cross-thread reduction: f32 for the bf16/f16 tiers
// (their rounding is per thread, and once at the end), the tier's own else
template <int TIER>
constexpr int kFold = (TIER == TIER_BF16 || TIER == TIER_F16) ? int(TIER_F32) : TIER;

template <class SX, class SY, int TIER>
__global__ void __launch_bounds__(kThreads)
    dot_partials(const SX* __restrict__ x, const SY* __restrict__ y, int64_t n, int vec_ok,
                 float* __restrict__ partials) {
  constexpr int V = vec_width<SX, SY>();
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t nth = static_cast<int64_t>(gridDim.x) * blockDim.x;
  ThreadAcc<TIER, V> acc;

  // vector body: V elements of each operand per step
  const int64_t nvec = vec_ok ? n / V : 0;
  for (int64_t i = tid; i < nvec; i += nth) {
    float xv[V], yv[V];
    unpack(load_pack<SX, V>(x + i * V), xv);
    unpack(load_pack<SY, V>(y + i * V), yv);
    acc.add_vec(xv, yv);
  }
  // tail (or everything, for unaligned operands), one element at a time
  for (int64_t i = nvec * V + tid; i < n; i += nth) acc.add(0, load_f32(x[i]), load_f32(y[i]));

  const value_t<TIER> v = block_reduce<kFold<TIER>>(acc.result());
  if (threadIdx.x == 0) {
    if constexpr (is_df_tier(TIER)) {
      partials[2 * blockIdx.x] = v.hi;
      partials[2 * blockIdx.x + 1] = v.lo;
    } else {
      partials[2 * blockIdx.x] = v;
      partials[2 * blockIdx.x + 1] = 0.f;
    }
  }
}

template <int TIER>
__global__ void __launch_bounds__(kFinishThreads)
    dot_finish(const float* __restrict__ partials, int64_t nblocks, float init,
               float* __restrict__ out) {
  constexpr int F = kFold<TIER>;
  value_t<F> v{};
  for (int64_t b = threadIdx.x; b < nblocks; b += blockDim.x) {
    if constexpr (is_df_tier(F)) {
      v = combine<F>(v, DF{partials[2 * b], partials[2 * b + 1]});
    } else {
      v = combine<F>(v, partials[2 * b]);
    }
  }
  v = block_reduce<F>(v);
  if (threadIdx.x == 0) {
    if constexpr (is_df_tier(TIER)) {
      const DF r = df_add(v, DF{init, 0.f});
      out[0] = r.hi;
      out[1] = r.lo;
    } else {
      out[0] = round_ar<TIER>(__fadd_rn(round_ar<TIER>(init), v));
      out[1] = 0.f;
    }
  }
}

}  // namespace
}  // namespace accblas

// x, y: n elements of storage codes x_st / y_st. partials: 2 * nblocks
// floats of scratch. out: 2 floats, (hi, lo). vec_ok: both pointers are
// 16-byte aligned. Returns cudaGetLastError() after the launches.
extern "C" int accblas_dot(const void* x, int x_st, const void* y, int y_st, int64_t n,
                           int tier, int vec_ok, float init, float* partials, int64_t nblocks,
                           float* out, void* stream) {
  using namespace accblas;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_storage(x_st, [&](auto tx) {
    return with_storage(y_st, [&](auto ty) {
      return with_tier(tier, [&](auto tt) {
        using SX = typename decltype(tx)::type;
        using SY = typename decltype(ty)::type;
        constexpr int TIER = decltype(tt)::value;
        dot_partials<SX, SY, TIER><<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
            static_cast<const SX*>(x), static_cast<const SY*>(y), n, vec_ok, partials);
        dot_finish<TIER><<<1, kFinishThreads, 0, s>>>(partials, nblocks, init, out);
        return cudaGetLastError();
      });
    });
  });
}
