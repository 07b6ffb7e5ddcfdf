// A CSR matrix times dense rows, for Hopper (sm_90a); plain C interface for
// ctypes.
//
// Not a port of a TPU kernel: the JAX package's sparse layer multiplies in
// plain XLA, a gather of X's rows and a segment_sum over the sorted entries
// (heat_tpu/sparse/_planes.py:488-580, :756-792).  The port's plain version
// (heat_tpu_torch/sparse/_planes.py::_csr_spmm_plain) makes the product rows
// a block at a time and sums each row's run with torch.segment_reduce: about
// ten passes over a (block, width) temporary.  cuSPARSE's SpMM is faster but
// not bitwise repeatable on the card (its CSC route gave other bits on a
// second run), and the layer's rule is that every result is.  This kernel
// computes
//
//   out[r, :] = (accumulate ? out[r, :] : 0) + sum_e w[e] * x[col[e], :],
//   e over [ptr[r], ptr[r + 1]) in order,
//
// reading each entry once and writing each output row once, with no atomics:
// the sums are added in one fixed order, the same on every run.
//
// Design.  One warp per row.  For width >= 2 a lane owns one output column
// (in chunks of 32) and walks the row's entries in order: an entry's column
// index and weight are one broadcast load for the warp, its row of x one
// coalesced load (128 bytes for 32 float columns).  For width 1 (a
// matrix-vector product, a row sum) lane l adds entries l, l + 32, ... in
// order and the lanes meet in a fixed butterfly of shuffles.
//
// Value types.  Every type the port stores: float32/64, complex64/128 (a
// pair of reals, a complex multiply-add), float16 and bfloat16 (products
// and sums in float32, rounded once to the type at the end), the integers
// int8/16/32/64 and uint8 (narrow ones summed in 32 bits and cut to their
// width at the end, the same wrapped value as a sum in their own width) and
// bool (the product is an AND, the sum an OR, as torch's bool arithmetic).
// Each entry point's suffix names its type; Traits<T> holds its accumulator.
//
// What bounds it: the gather of x's rows, nnz * width * itemsize bytes (34.4
// GB for 2^28 entries of 32 float columns: 10.3 ms at 3.35 TB/s), beside one
// read of the planes (12 bytes an entry), of x and one write of the output.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <typename R>
struct Complex {
  R re, im;
};

struct Bool8 {  // torch's bool: one byte, 0 or 1
  uint8_t v;
};

// Traits<T>: the accumulator type A of values stored as T, the widening
// load, the product and the rounding back to T.
template <typename T>
struct Traits {
  using A = T;
  __device__ static A load(T v) { return v; }
  __device__ static A mul(A a, A b) { return a * b; }
  __device__ static T store(A v) { return v; }
};

template <>
struct Traits<__half> {
  using A = float;
  __device__ static A load(__half v) { return __half2float(v); }
  __device__ static A mul(A a, A b) { return a * b; }
  __device__ static __half store(A v) { return __float2half_rn(v); }
};

template <>
struct Traits<__nv_bfloat16> {
  using A = float;
  __device__ static A load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static A mul(A a, A b) { return a * b; }
  __device__ static __nv_bfloat16 store(A v) { return __float2bfloat16_rn(v); }
};

template <typename T, typename W>
struct NarrowInt {
  using A = W;
  __device__ static A load(T v) { return (A)v; }
  __device__ static A mul(A a, A b) { return a * b; }
  __device__ static T store(A v) { return (T)v; }
};

template <>
struct Traits<int8_t> : NarrowInt<int8_t, uint32_t> {};
template <>
struct Traits<uint8_t> : NarrowInt<uint8_t, uint32_t> {};
template <>
struct Traits<int16_t> : NarrowInt<int16_t, uint32_t> {};

template <>
struct Traits<Bool8> {
  using A = uint32_t;  // the count of true products
  __device__ static A load(Bool8 v) { return v.v; }
  __device__ static A mul(A a, A b) { return a & b; }
  __device__ static Bool8 store(A v) { return Bool8{(uint8_t)(v != 0)}; }
};

template <typename R>
struct Traits<Complex<R>> {
  using A = Complex<R>;
  __device__ static A load(A v) { return v; }
  __device__ static A mul(A a, A b) { return A{a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re}; }
  __device__ static A store(A v) { return v; }
};

template <typename A>
__device__ A zero() {
  return A(0);
}
template <>
__device__ Complex<float> zero<Complex<float>>() {
  return Complex<float>{0.f, 0.f};
}
template <>
__device__ Complex<double> zero<Complex<double>>() {
  return Complex<double>{0.0, 0.0};
}

template <typename A>
__device__ A add(A a, A b) {
  return a + b;
}
template <typename R>
__device__ Complex<R> add(Complex<R> a, Complex<R> b) {
  return Complex<R>{a.re + b.re, a.im + b.im};
}

template <typename A>
__device__ A shfl_down(A v, int off) {
  return __shfl_down_sync(0xffffffffu, v, off);
}
template <typename R>
__device__ Complex<R> shfl_down(Complex<R> v, int off) {
  return Complex<R>{__shfl_down_sync(0xffffffffu, v.re, off), __shfl_down_sync(0xffffffffu, v.im, off)};
}

template <typename T>
__device__ void put(T* o, typename Traits<T>::A acc, int accumulate) {
  using Tr = Traits<T>;
  *o = Tr::store(accumulate ? add(Tr::load(*o), acc) : acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) spmm_rows_kernel(const int64_t* __restrict__ ptr,
                                                             const int32_t* __restrict__ col,
                                                             const T* __restrict__ w, const T* __restrict__ x,
                                                             int64_t ldx, T* __restrict__ out, int64_t ldo,
                                                             int64_t n_rows, int64_t width, int accumulate) {
  using Tr = Traits<T>;
  using A = typename Tr::A;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int64_t start = ptr[row], stop = ptr[row + 1];
  for (int64_t j = lane; j < width; j += 32) {
    A acc = zero<A>();
#pragma unroll 4
    for (int64_t e = start; e < stop; ++e) {
      acc = add(acc, Tr::mul(Tr::load(w[e]), Tr::load(x[(int64_t)col[e] * ldx + j])));
    }
    put(out + row * ldo + j, acc, accumulate);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) spmv_rows_kernel(const int64_t* __restrict__ ptr,
                                                             const int32_t* __restrict__ col,
                                                             const T* __restrict__ w, const T* __restrict__ x,
                                                             int64_t ldx, T* __restrict__ out, int64_t ldo,
                                                             int64_t n_rows, int accumulate) {
  using Tr = Traits<T>;
  using A = typename Tr::A;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // a whole warp leaves together: the shuffles below see full warps
  const int64_t stop = ptr[row + 1];
  A acc = zero<A>();
  for (int64_t e = ptr[row] + lane; e < stop; e += 32) {
    acc = add(acc, Tr::mul(Tr::load(w[e]), Tr::load(x[(int64_t)col[e] * ldx])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = add(acc, shfl_down(acc, off));
  }
  if (lane == 0) put(out + row * ldo, acc, accumulate);
}

template <typename T>
int launch(const void* ptr, const void* col, const void* w, const void* x, int64_t ldx, void* out, int64_t ldo,
           int64_t n_rows, int64_t width, int accumulate, cudaStream_t stream) {
  if (n_rows <= 0 || width <= 0) return 0;
  const dim3 grid((unsigned int)((n_rows + kWarps - 1) / kWarps));
  const int64_t* p = static_cast<const int64_t*>(ptr);
  const int32_t* c = static_cast<const int32_t*>(col);
  const T* wv = static_cast<const T*>(w);
  const T* xv = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (width == 1) {
    spmv_rows_kernel<T><<<grid, kThreads, 0, stream>>>(p, c, wv, xv, ldx, o, ldo, n_rows, accumulate);
  } else {
    spmm_rows_kernel<T><<<grid, kThreads, 0, stream>>>(p, c, wv, xv, ldx, o, ldo, n_rows, width, accumulate);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One entry point a value type, named by its suffix.  Integer sums are
// exact in any order (they wrap as torch's integer arithmetic does).
#define HEAT_CSR_SPMM(SUFFIX, T)                                                                                  \
  extern "C" int heat_csr_spmm_##SUFFIX(const void* ptr, const void* col, const void* w, const void* x,        \
                                        int64_t ldx, void* out, int64_t ldo, int64_t n_rows, int64_t width,     \
                                        int accumulate, cudaStream_t stream) {                                   \
    return launch<T>(ptr, col, w, x, ldx, out, ldo, n_rows, width, accumulate, stream);                        \
  }

HEAT_CSR_SPMM(f16, __half)
HEAT_CSR_SPMM(bf16, __nv_bfloat16)
HEAT_CSR_SPMM(f32, float)
HEAT_CSR_SPMM(f64, double)
HEAT_CSR_SPMM(c64, Complex<float>)
HEAT_CSR_SPMM(c128, Complex<double>)
HEAT_CSR_SPMM(i8, int8_t)
HEAT_CSR_SPMM(u8, uint8_t)
HEAT_CSR_SPMM(i16, int16_t)
HEAT_CSR_SPMM(i32, int32_t)
HEAT_CSR_SPMM(i64, long long)
HEAT_CSR_SPMM(b8, Bool8)
