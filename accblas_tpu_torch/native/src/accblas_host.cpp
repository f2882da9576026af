// accblas_tpu_torch native host runtime: the host-side C++ layer of the
// benchmark harness, after accblas_tpu/native/src/accblas_host.cpp, with one
// addition (ab_master_f64) and std::thread in place of OpenMP (a host can
// have the OpenMP runtime without its compiler support: -fopenmp then fails
// for want of libgomp.spec).
//
// - data generation (reference cuda/matrix_helper.cuh:28-75): the
//   counter-based splitmix64 stream of accblas_tpu_torch/utils/prng.py;
// - the fp64 master of the device draw of accblas_tpu_torch/utils/devgen.py
//   (ab_master_f64), so the host replays a multi-GiB operand in seconds;
// - precision conversion (cuda/matrix_helper.cuh:93-103) and the error
//   reductions (cuda/utils.cuh:281-332), with long double accumulation.
//
// Generation is bit-identical to the numpy paths (tests/test_torch_native.py).
// Plain C ABI for ctypes. Built by accblas_tpu_torch/native/host.py with
// g++ -O3 -pthread -ffp-contract=off: no multiply-add contraction, so every
// floating-point operation rounds as numpy's does.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <cfloat>
#include <thread>
#include <vector>

namespace {

// f(begin, end) over [0, n) in contiguous chunks, one per hardware thread
// and at least `grain` long; chunks a thread cannot be started for run here.
template <class F>
void parallel_for(int64_t n, F f, int64_t grain = 65536) {
    const int64_t hw = std::max(1u, std::thread::hardware_concurrency());
    const int64_t t = std::max<int64_t>(1, std::min<int64_t>(hw, n / grain));
    const int64_t chunk = (n + t - 1) / t;
    std::vector<std::thread> pool;
    for (int64_t b = chunk; b < n; b += chunk) {
        const int64_t e = std::min(n, b + chunk);
        try {
            pool.emplace_back(f, b, e);
        } catch (...) {
            f(b, e);
        }
    }
    f(0, std::min(n, chunk));
    for (auto& th : pool) th.join();
}

// the sum over [0, n) of term(i) in long double: partial sums per chunk,
// added in chunk order
template <class T>
double sum_ld(int64_t n, T term) {
    const int64_t parts = 64;
    const int64_t chunk = (n + parts - 1) / parts;
    std::vector<long double> partial(parts, 0.0L);
    parallel_for(parts, [&](int64_t p0, int64_t p1) {
        for (int64_t p = p0; p < p1; ++p) {
            long double s = 0.0L;
            for (int64_t i = p * chunk; i < std::min(n, (p + 1) * chunk); ++i) s += term(i);
            partial[p] = s;
        }
    }, 1);
    long double total = 0.0L;
    for (long double s : partial) total += s;
    return (double)total;
}

}  // namespace

extern "C" {

static inline uint64_t splitmix64(uint64_t x) {
    uint64_t z = x + 0x9E3779B97F4A7C15ULL;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

static inline uint64_t key_at(uint64_t idx, uint64_t seed, uint64_t rnd) {
    return idx * 0x9E3779B97F4A7C15ULL + seed + rnd * 0xD1342543DE82EF95ULL;
}

static inline double uniform_at(uint64_t idx, uint64_t seed, uint64_t rnd,
                                double lo, double hi) {
    uint64_t bits = splitmix64(key_at(idx, seed, rnd));
    double u = (double)(bits >> 11) * (1.0 / 9007199254740992.0); // 2^-53
    return lo + u * (hi - lo);
}

// uniform(-1, 1) float32 on the 2^-23 grid from the top 24 bits (devgen's draw)
static inline float draw_f32(uint64_t idx, uint64_t stream, uint64_t rnd) {
    uint64_t bits = splitmix64(key_at(idx, stream, rnd));
    return (float)(bits >> 40) * 0x1p-23f - 1.0f;
}

// Generate a rows x stride row-major float64 matrix; the [rows, cols] view is
// filled with uniform(lo, hi) values filtered to be normal in float32 range
// (reference subnormal filter, cuda/matrix_helper.cuh:42-45); stride padding
// is zeroed.
void ab_gen_mtx(double* out, int64_t rows, int64_t cols, int64_t stride,
                uint64_t seed, double lo, double hi) {
    parallel_for(rows, [=](int64_t r0, int64_t r1) {
        for (int64_t r = r0; r < r1; ++r) {
            double* rowp = out + r * stride;
            for (int64_t c = 0; c < cols; ++c) {
                uint64_t idx = (uint64_t)(r * cols + c);
                uint64_t rnd = 0;
                double v = uniform_at(idx, seed, rnd, lo, hi);
                while (!std::isfinite(v) || std::fabs(v) < (double)FLT_MIN) {
                    v = uniform_at(idx, seed, ++rnd, lo, hi);
                }
                rowp[c] = v;
            }
            for (int64_t c = cols; c < stride; ++c) rowp[c] = 0.0;
        }
    });
}

// The fp64 master a + 2^-24 b of elements [start, start + n) of a stream,
// a and b its two float32 draws (rounds 0 and 1).
void ab_master_f64(double* out, int64_t start, int64_t n, uint64_t stream) {
    parallel_for(n, [=](int64_t i0, int64_t i1) {
        for (int64_t i = i0; i < i1; ++i) {
            uint64_t idx = (uint64_t)(start + i);
            double a = (double)draw_f32(idx, stream, 0);
            double b = (double)draw_f32(idx, stream, 1);
            out[i] = a + 0x1p-24 * b;
        }
    });
}

// ||a - b||_1 with long double accumulation.
double ab_abs_diff_norm1(const double* a, const double* b, int64_t n) {
    return sum_ld(n, [=](int64_t i) { return fabsl((long double)a[i] - (long double)b[i]); });
}

// ||a||_1 with long double accumulation.
double ab_norm1(const double* a, int64_t n) {
    return sum_ld(n, [=](int64_t i) { return fabsl((long double)a[i]); });
}

void ab_convert_f64_f32(const double* in, float* out, int64_t n) {
    parallel_for(n, [=](int64_t i0, int64_t i1) {
        for (int64_t i = i0; i < i1; ++i) out[i] = (float)in[i];
    });
}

// float64 -> bfloat16 (round to nearest even), emitted as uint16 bit patterns.
void ab_convert_f64_bf16(const double* in, uint16_t* out, int64_t n) {
    parallel_for(n, [=](int64_t i0, int64_t i1) {
        for (int64_t i = i0; i < i1; ++i) {
            float f = (float)in[i];
            uint32_t bits;
            std::memcpy(&bits, &f, 4);
            uint32_t lsb = (bits >> 16) & 1u;
            bits += 0x7FFFu + lsb; // RNE
            out[i] = (uint16_t)(bits >> 16);
        }
    });
}

int ab_version() { return 2; }

} // extern "C"
