// The accessor on the device: a Range over a ReducedRowMajor<Ar, St>, the
// counterpart of accessor/range.py and of the reference's
// gko::acc::range<reduced_row_major<2, Ar, St>>.
//
// A Range is a storage pointer, an extent (rows, cols) and a row stride,
// passed to a kernel by value. r(i, j) reads storage St and gives the
// arithmetic type Ar (load_f32, then DF{v, 0} when Ar is DF); r(i, j) = v
// rounds Ar to St and writes (df_to_f32 first when Ar is DF, then
// store_f32, round to nearest even). A Range over const St is read-only: a
// store through it does not compile. r.window(row0, col0, m, n) is the
// (m, n) window of a parent at (row0, col0), a Range with the parent's row
// stride: the BlockSpec composition of the JAX package's strided Range.
//
// The port's addition beside Ginkgo's reduced_row_major: r.row(i) takes a
// row's base once (the one 64-bit product i * stride), so a loop over the
// row's columns indexes it with 32-bit offsets, and row.load<V>(j, v) reads
// the V stored values at columns j..j+V-1 as one aligned access (load_pack
// of accessor.cuh), each widened to Ar as a single read is; row.stream<V>
// is the same read with no L1 line allocated, for values read once
// (row.stream_pack<V> and Row::widen its two halves); Row::widen_paired
// widens a pack of f8 values two at a time, the same values.
// row.store<V>(j, v) rounds V values to St as a single store does and writes
// them at columns j..j+V-1 as one aligned access (store_pack; V x sizeof(St)
// bytes, two 16-byte stores for 8 f32 values); row.store_stream<V> is the
// same store marked evict-first, for values written once. A Row over const
// St refuses either at compile time. A vector access needs the address of
// column j to be a multiple of V elements: for every row, the range's base
// and its row stride both multiples of V elements.
//
// For the tuned kernels of the main path (dot.cu, gemv.cu, trsv.cu), three
// more: row.pack<V>(j) is load<V>'s first half, the V stored values as read
// through L1 (Row::widen the second), for a kernel that keeps many such
// reads in flight before it widens one; row.from(c) is the same row from
// column c on (a Row whose column 0 is column c), a 64-bit move of its
// base, so that a loop walks a row of any length with the 32-bit offsets
// of one step, or a tile with constant ones; r.get(i, j) is the value
// r(i, j) reads, with no Ref in between (read through a Ref, the DOT's
// element loop left ptxas scheduling its f32 tier with up to 16 more
// registers, 48 for bf16 storage against 32, and a third fewer blocks an
// SM on unaligned operands; PERF.md). A vector of n >= 2^31
// elements is read as a (rows, W) range, as the JAX DOT reads its (rows,
// 128) rows: row(i) takes the 64-bit product, the columns stay 32-bit.
//
// Range<ReducedRowMajor<Ar, Coded>> is a range whose storage type is known
// only at run time: it carries the storage code (accessor.cuh Storage)
// beside its pointer, and r(i, j) and r(i, j) = v dispatch on it as
// load_code and store_code do, with the same casts. It serves the
// epilogues, which touch one value per output row: the GEMV's res and
// result and the sweep's result are read and written through it rather
// than instantiating each kernel once more per output storage.
//
// With DF's operators (df64.cuh) a kernel body written once against Ranges
// runs at f32 or df64 arithmetic over any storage type (csrc/generic.cu).
#pragma once

#include <type_traits>

#include "accessor.cuh"
#include "df64.cuh"

namespace accblas {

// arithmetic codes (ops/generic.py AR_CODE)
enum Arith : int { AR_F32 = 0, AR_DF64 = 1 };

// the two ends of the cast: a float read from storage widened to Ar, and
// an Ar value rounded to the float that store_f32 then rounds to St
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(DF v) { return df_to_f32(v); }

template <class Ar>
struct Widen;
template <>
struct Widen<float> {
  __device__ __forceinline__ static float from(float v) { return v; }
};
template <>
struct Widen<DF> {
  __device__ __forceinline__ static DF from(float v) { return df_from(v); }
};

// the accessor's (arithmetic, storage) pair; const St for a read-only range
template <class Ar, class St>
struct ReducedRowMajor {
  using arithmetic_type = Ar;
  using storage_type = St;
};

template <class Accessor>
class Range {
 public:
  using Ar = typename Accessor::arithmetic_type;
  using St = typename Accessor::storage_type;

  // one element: converts to Ar on read, rounds to St on assignment
  class Ref {
   public:
    __device__ __forceinline__ explicit Ref(St* p) : p_(p) {}
    __device__ __forceinline__ operator Ar() const { return Widen<Ar>::from(load_f32(*p_)); }
    __device__ __forceinline__ const Ref& operator=(Ar v) const {
      static_assert(!std::is_const_v<St>, "store through a const Range");
      store_f32(p_, to_float(v));
      return *this;
    }
    // r(i, j) = s(k, l) between two ranges of one type copies the value
    __device__ __forceinline__ const Ref& operator=(const Ref& v) const {
      return *this = static_cast<Ar>(v);
    }

   private:
    St* p_;
  };

  // one row, its base taken once: columns are 32-bit offsets from it
  class Row {
   public:
    __device__ __forceinline__ explicit Row(St* p) : p_(p) {}
    Row() = default;  // unset, for an array of rows assigned one by one
    __device__ __forceinline__ Ref operator()(int j) const { return Ref(p_ + j); }
    // columns j..j+V-1 as one aligned access (j's address a multiple of V
    // elements), each value widened to Ar
    template <int V>
    __device__ __forceinline__ void load(int j, Ar (&v)[V]) const {
      widen(pack<V>(j), v);
    }
    // its first half: the V stored values as read (Row::widen the second)
    template <int V>
    __device__ __forceinline__ Pack<std::remove_const_t<St>, V> pack(int j) const {
      return load_pack<std::remove_const_t<St>, V>(p_ + j);
    }
    // the same row from column c on: its column 0 is this row's column c
    __device__ __forceinline__ Row from(int64_t c) const { return Row(p_ + c); }
    // the same read of values read once: no L1 line allocated
    template <int V>
    __device__ __forceinline__ void stream(int j, Ar (&v)[V]) const {
      widen(stream_pack<V>(j), v);
    }
    // its two halves: the V stored values as read, and their widening to
    // Ar, for a kernel that keeps many reads in flight as stored values
    template <int V>
    __device__ __forceinline__ Pack<std::remove_const_t<St>, V> stream_pack(int j) const {
      return load_pack_stream<std::remove_const_t<St>, V>(p_ + j);
    }
    template <int V>
    __device__ __forceinline__ static void widen(const Pack<std::remove_const_t<St>, V>& pack,
                                                 Ar (&v)[V]) {
#pragma unroll
      for (int u = 0; u < V; ++u) v[u] = Widen<Ar>::from(load_f32(pack.v[u]));
    }
    // widen's values with f8 storage converted two at a time (load_f32x2),
    // the same values; any other storage as widen
    template <int V>
    __device__ __forceinline__ static void widen_paired(
        const Pack<std::remove_const_t<St>, V>& pack, Ar (&v)[V]) {
      if constexpr (is_f8<std::remove_const_t<St>> && V % 2 == 0) {
#pragma unroll
        for (int u = 0; u < V; u += 2) {
          const float2 f = load_f32x2(&pack.v[u]);
          v[u] = Widen<Ar>::from(f.x);
          v[u + 1] = Widen<Ar>::from(f.y);
        }
      } else {
        widen(pack, v);
      }
    }
    // columns j..j+V-1 set to v, each value rounded to St as r(i, j) = v
    // rounds it, written as one aligned access (j's address a multiple of V
    // elements)
    template <int V>
    __device__ __forceinline__ void store(int j, const Ar (&v)[V]) const {
      static_assert(!std::is_const_v<St>, "store through a const Range");
      store_pack<St, V>(p_ + j, narrow(v));
    }
    // the same store of values written once: evict-first (st.global.cs)
    template <int V>
    __device__ __forceinline__ void store_stream(int j, const Ar (&v)[V]) const {
      static_assert(!std::is_const_v<St>, "store through a const Range");
      store_pack_stream<St, V>(p_ + j, narrow(v));
    }

   private:
    template <int V>
    __device__ __forceinline__ static Pack<std::remove_const_t<St>, V> narrow(
        const Ar (&v)[V]) {
      Pack<std::remove_const_t<St>, V> pack;
#pragma unroll
      for (int u = 0; u < V; ++u) store_f32(&pack.v[u], to_float(v[u]));
      return pack;
    }

    St* p_;
  };

  __host__ __device__ Range(St* data, int64_t rows, int64_t cols, int64_t stride)
      : data_(data), rows_(rows), cols_(cols), stride_(stride) {}

  __device__ __forceinline__ Ref operator()(int64_t i, int64_t j) const {
    return Ref(data_ + i * stride_ + j);
  }
  // the value r(i, j) reads, with no Ref in between
  __device__ __forceinline__ Ar get(int64_t i, int64_t j) const {
    return Widen<Ar>::from(load_f32(data_[i * stride_ + j]));
  }
  __device__ __forceinline__ Row row(int64_t i) const { return Row(data_ + i * stride_); }
  __host__ __device__ int64_t length(int d) const { return d == 0 ? rows_ : cols_; }
  __host__ __device__ int64_t stride() const { return stride_; }
  __host__ __device__ Range window(int64_t row0, int64_t col0, int64_t rows,
                                   int64_t cols) const {
    return Range(data_ + row0 * stride_ + col0, rows, cols, stride_);
  }

 private:
  St* data_;
  int64_t rows_, cols_, stride_;
};

template <class Ar, class St>
using range_t = Range<ReducedRowMajor<Ar, St>>;

// a row of such a range, as row(i) gives it
template <class Ar, class St>
using row_t = typename range_t<Ar, St>::Row;

// the storage type of a range whose storage is chosen at run time (const
// Coded: read-only)
struct Coded {};

// Range<ReducedRowMajor<Ar, Coded>> and its const form: a pointer, the
// storage code of what it points to, an extent and a row stride
template <class Ar, class C>
class CodedRange {
  using Ptr = std::conditional_t<std::is_const_v<C>, const void*, void*>;

 public:
  // one element: converts to Ar on read, rounds to the coded storage on
  // assignment
  class Ref {
   public:
    __device__ __forceinline__ Ref(Ptr p, int64_t i, int st) : p_(p), i_(i), st_(st) {}
    __device__ __forceinline__ operator Ar() const {
      return Widen<Ar>::from(load_code(p_, i_, st_));
    }
    __device__ __forceinline__ const Ref& operator=(Ar v) const {
      static_assert(!std::is_const_v<C>, "store through a const Range");
      store_code(p_, i_, st_, to_float(v));
      return *this;
    }

   private:
    Ptr p_;
    int64_t i_;
    int st_;
  };

  __host__ __device__ CodedRange(Ptr data, int st, int64_t rows, int64_t cols, int64_t stride)
      : data_(data), st_(st), rows_(rows), cols_(cols), stride_(stride) {}

  __device__ __forceinline__ Ref operator()(int64_t i, int64_t j) const {
    return Ref(data_, i * stride_ + j, st_);
  }

 private:
  Ptr data_;
  int st_;
  int64_t rows_, cols_, stride_;
};

template <class Ar>
class Range<ReducedRowMajor<Ar, Coded>> : public CodedRange<Ar, Coded> {
 public:
  using CodedRange<Ar, Coded>::CodedRange;
};
template <class Ar>
class Range<ReducedRowMajor<Ar, const Coded>> : public CodedRange<Ar, const Coded> {
 public:
  using CodedRange<Ar, const Coded>::CodedRange;
};

// host-side dispatch from an arithmetic code to the type
template <class F>
cudaError_t with_arith(int code, F&& f) {
  switch (code) {
    case AR_F32: return f(Tag<float>{});
    case AR_DF64: return f(Tag<DF>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace accblas
