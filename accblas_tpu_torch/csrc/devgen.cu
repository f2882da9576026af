// The benchmark data draw: JAX's threefry2x32 (partitionable layout) over a
// flat range of elements, turned into float32 uniforms on the card.
//
// Not a port of a Pallas kernel: the JAX package draws its data with
// jax.random (accblas_tpu/utils/devgen.py:58-82, utils/sr.py:116), which XLA
// lowers to threefry2x32. This kernel draws the same bits, so the port's
// operands are the JAX package's. Its plain versions are the torch forms of
// accblas_tpu_torch/utils/threefry.py; the numpy forms there and the native
// host library replay it bit for bit.
//
// Element i of a draw hashes the 64-bit counter start + i, split into
// (hi, lo) words, under a key passed by value; its 32 random bits are the
// xor of the two output words. A float in [1, 2) takes their top 23 bits as
// mantissa; minus 1, times (hi - lo), plus lo, then max(lo, .) makes the
// uniform. Three outputs:
//   kF32:     a, b uniform(-1, 1) under keys ka, kb; out0 = fl32(a + 2^-24 b)
//   kDF64:    out0 = hi = fl32(a + 2^-24 b), out1 = lo = (a - hi) + 2^-24 b
//   kUniform: out0 = uniform(lo, hi) under ka
// Every float step rounds once (__fmul_rn, __fadd_rn: never contracted),
// and the integer steps are exact, so the bits equal the replays'.
//
// Bound on the H100: integer work. A threefry block is about 70 32-bit
// operations (20 rounds of add, rotate, xor; 5 key injections of two adds;
// the output words' xor), and a uniform two more (shift, or); kF32 and
// kDF64 take two blocks an element, against 4 or 8 bytes written. The
// rotations and xors (SHF, LOP3) run only on the integer ALU pipe, 64 lanes
// an SM a clock, while the adds can issue on the FMA pipe beside it
// (IMAD), so the ALU's 43 operations a block and uniform set the least
// time: ~11-21 operations a byte, far above the card's ~5 a byte of memory
// rate. The design is the simplest that keeps the lanes busy: one
// grid-stride pass, one element a thread a step, the rotations as funnel
// shifts, no shared memory and no loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace accblas {
namespace {

enum Mode { kF32 = 0, kDF64 = 1, kUniform = 2 };

struct Key {
  uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// threefry2x32 of the counter (x0, x1): the 32 random bits x0 ^ x1
__device__ __forceinline__ uint32_t threefry_bits(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
  x0 += k.k0;
  x1 += k.k1;
#define ACCBLAS_ROUND(r) \
  x0 += x1;              \
  x1 = rotl(x1, r) ^ x0;
#define ACCBLAS_ROUNDS_A ACCBLAS_ROUND(13) ACCBLAS_ROUND(15) ACCBLAS_ROUND(26) ACCBLAS_ROUND(6)
#define ACCBLAS_ROUNDS_B ACCBLAS_ROUND(17) ACCBLAS_ROUND(29) ACCBLAS_ROUND(16) ACCBLAS_ROUND(24)
  ACCBLAS_ROUNDS_A
  x0 += k.k1;
  x1 += k2 + 1u;
  ACCBLAS_ROUNDS_B
  x0 += k2;
  x1 += k.k0 + 2u;
  ACCBLAS_ROUNDS_A
  x0 += k.k0;
  x1 += k.k1 + 3u;
  ACCBLAS_ROUNDS_B
  x0 += k.k1;
  x1 += k2 + 4u;
  ACCBLAS_ROUNDS_A
  x0 += k2;
  x1 += k.k0 + 5u;
#undef ACCBLAS_ROUNDS_B
#undef ACCBLAS_ROUNDS_A
#undef ACCBLAS_ROUND
  return x0 ^ x1;
}

// jax.random.uniform's float32 map of 32 random bits to [lo, lo + scale)
__device__ __forceinline__ float to_uniform(uint32_t bits, float lo, float scale) {
  const float f = __fadd_rn(__uint_as_float((bits >> 9) | 0x3F800000u), -1.0f);
  return fmaxf(lo, __fadd_rn(__fmul_rn(f, scale), lo));
}

template <int M>
__global__ void __launch_bounds__(256)
    devgen_draw(float* __restrict__ out0, float* __restrict__ out1, uint64_t start, int64_t n,
                Key ka, Key kb, float lo, float scale) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += step) {
    const uint64_t c = start + static_cast<uint64_t>(i);
    const uint32_t chi = static_cast<uint32_t>(c >> 32), clo = static_cast<uint32_t>(c);
    const float a = to_uniform(threefry_bits(ka, chi, clo), lo, scale);
    if (M == kUniform) {
      out0[i] = a;
      continue;
    }
    const float b = to_uniform(threefry_bits(kb, chi, clo), lo, scale);
    const float sb = __fmul_rn(b, 0x1p-24f);  // exact: a power of two
    const float hi = __fadd_rn(a, sb);
    out0[i] = hi;
    if (M == kDF64) out1[i] = __fadd_rn(__fadd_rn(a, -hi), sb);
  }
}

}  // namespace
}  // namespace accblas

// Draw elements [start, start + n) into out0 (and out1 for mode kDF64) on
// `stream`. Modes kF32 and kDF64 draw uniform(-1, 1) under both keys (the
// caller passes lo = -1, scale = 2); kUniform draws uniform(lo, lo + scale)
// under ka. Returns the launch's cudaError_t.
extern "C" int accblas_devgen(float* out0, float* out1, uint64_t start, int64_t n, int mode,
                              uint32_t ka0, uint32_t ka1, uint32_t kb0, uint32_t kb1, float lo,
                              float scale, void* stream) {
  using namespace accblas;
  if (n <= 0) return cudaSuccess;
  constexpr int threads = 256;
  // enough blocks to fill every SM several times over; the stride covers
  // the rest
  const int64_t want = (n + threads - 1) / threads;
  const unsigned blocks = static_cast<unsigned>(want < 132 * 32 ? want : 132 * 32);
  const Key ka{ka0, ka1}, kb{kb0, kb1};
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kF32:
      devgen_draw<kF32><<<blocks, threads, 0, s>>>(out0, out1, start, n, ka, kb, lo, scale);
      break;
    case kDF64:
      devgen_draw<kDF64><<<blocks, threads, 0, s>>>(out0, out1, start, n, ka, kb, lo, scale);
      break;
    case kUniform:
      devgen_draw<kUniform><<<blocks, threads, 0, s>>>(out0, out1, start, n, ka, kb, lo, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
