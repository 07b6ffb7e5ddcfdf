// A CSR matrix times dense rows, for Hopper (sm_90a); plain C interface for
// ctypes.
//
// Not a port of a TPU kernel: the JAX package's sparse layer multiplies in
// plain XLA, a gather of X's rows and a segment_sum over the sorted entries
// (heat_tpu/sparse/_planes.py:488-505, :756-792).  The port's plain version
// (heat_tpu_torch/sparse/_planes.py::_csr_spmm_plain) makes the product rows
// a block at a time and sums each row's run with torch.segment_reduce.
// cuSPARSE's SpMM is not bitwise repeatable on the card (its CSC route gave
// other bits on a second run), and the layer's rule is that every result
// is.  This kernel computes
//
//   out[r, :] = (accumulate ? out[r, :] : 0) + sum_e w[e] * x[col[e], :],
//   e over [ptr[r], ptr[r + 1]),
//
// with no atomics: each row's products are added in one fixed order, the
// same on every run, and every row is written (out may come from
// torch.empty).  Three routes, chosen in Python by
// sparse/_planes.py::csr_spmm_route and passed in: never one because
// another failed.
//
// What bounds it.  Bytes once (the planes, 12 bytes an entry in float32,
// the pointers, x and the output) give 0.72 ms at one column and 1.96 ms at
// 32 float columns for 2^24 rows and 2^28 entries at 3.35 TB/s.  But a
// random graph gathers a row of x for every entry: whole 32-byte sectors,
// nnz * max(32, width * itemsize) bytes -- 34.4 GB at 32 float columns,
// 10.3 ms, and 11.6 ms with the planes and the output (the gather floor);
// 8.6 GB at one column if every gather missed L2.  On an H100 a missed
// 4-byte gather costs about 64 bytes of HBM traffic, and random gathers
// keep only 25-30 MB of x in the 50 MB L2: at one column a 67 MB x holds
// the spmv route near 6 ms, where x of 17 MB takes 2.4 (PERF.md).  The
// gathers depend on the planes, which depend on the pointers: a design
// that waits on that chain row by row is latency-bound, so each route keeps
// many gathers in flight.
//
// spmv (width 1).  A block of 256 threads takes 256 consecutive rows.
// Their entries are contiguous: the block streams col and w in coalesced
// loads (ld.global.cs, evicted first), each thread with 8 gathers of x in
// flight under an L2 evict-last policy (meant to keep x in L2 while the
// planes stream past; measured, it neither helps nor costs at 17 or 67 MB),
// and stages the products in shared memory, a chunk of 16 KB at a time;
// then the row's thread adds its products in entry order.  Rows longer than
// a chunk are walked chunk by chunk, in order.  Order: sum_e p_e from 0 in
// entry order, p_e rounded to the accumulator type, then out + sum.
//
// rows (2 <= width, width * itemsize <= 512).  A row of x is covered by L
// lanes of V elements (16-byte loads where x and out start on 16-byte
// boundaries and their rows are a multiple of 16 bytes apart, else one
// element), so a warp takes G = 32 / L consecutive rows at once, one a
// group of L lanes: at 32 float columns, 8 lanes of 16 bytes and 4 rows.
// Persistent warps stride over these tasks.  A group loads its row's
// (col, w) once, coalesced, 4 entries a lane (lane q entries q, q + L,
// ...); shuffles hand them round, and each lane keeps up to 8 gathers of x
// in flight before the adds (min(8, L)).  While a task's gathers are in
// flight, the next task's pointers are already loading.  Order: each
// column in entry order, then out + sum: the products of a column are
// never split between lanes.
//
// wide (width * itemsize > 512: the dense-route SpGEMM's 4096 columns).  A
// block takes one row, stages its (col, w) in shared memory once (1024
// entries at a time; a longer row is staged again for each pass of
// columns), and each thread owns V columns of a pass of 256 V, with 8
// gathers in flight.  Order: each column in entry order, then out + sum.
//
// Value types.  Every type the port stores: float32/64, complex64/128 (a
// pair of reals, a complex multiply-add), float16 and bfloat16 (products
// and sums in float32, rounded once to the type at the end), the integers
// int8/16/32/64 and uint8 (narrow ones summed in 32 bits and cut to their
// width at the end, the same wrapped value as a sum in their own width) and
// bool (the product is an AND, the sum an OR, as torch's bool arithmetic).
// Each entry point's suffix names its type; Traits<T> holds its accumulator.
// Offsets are int64 (col * ldx passes 2^31).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;              // gathers a thread keeps in flight
constexpr int kStageBytes = 16384;      // spmv: products staged a chunk
constexpr int kWideStage = 1024;        // wide: entries staged at a time

template <typename R>
struct alignas(2 * sizeof(R)) Complex {
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

// a value of any type with every bit 0 (0, 0.0, false, 0 + 0i)
template <typename T>
__device__ __forceinline__ T zero() {
  T v;
  memset(&v, 0, sizeof(T));
  return v;
}

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) { return a > b ? a : b; }

template <typename A>
__device__ __forceinline__ A add(A a, A b) {
  return a + b;
}
template <typename R>
__device__ __forceinline__ Complex<R> add(Complex<R> a, Complex<R> b) {
  return Complex<R>{a.re + b.re, a.im + b.im};
}

// lane src's value of any type of 1 to 16 bytes, shuffled by its bits
template <typename T>
__device__ __forceinline__ T shfl_idx(T v, int src) {
  if constexpr (sizeof(T) <= 4) {
    uint32_t b = 0;
    memcpy(&b, &v, sizeof(T));
    b = __shfl_sync(0xffffffffu, b, src);
    memcpy(&v, &b, sizeof(T));
  } else {
    unsigned long long b[sizeof(T) / 8];
    memcpy(b, &v, sizeof(T));
#pragma unroll
    for (int i = 0; i < (int)(sizeof(T) / 8); ++i) b[i] = __shfl_sync(0xffffffffu, b[i], src);
    memcpy(&v, b, sizeof(T));
  }
  return v;
}

// Loads of read-once data (the planes, the pointers): streamed, evicted
// first (ld.global.cs).
template <typename T>
__device__ __forceinline__ T ld_stream(const T* p) {
  T v;
  if constexpr (sizeof(T) == 1) {
    uint32_t r;
    asm("ld.global.cs.u8 %0, [%1];" : "=r"(r) : "l"(p));
    const uint8_t b = (uint8_t)r;
    memcpy(&v, &b, 1);
  } else if constexpr (sizeof(T) == 2) {
    uint16_t r;
    asm("ld.global.cs.u16 %0, [%1];" : "=h"(r) : "l"(p));
    memcpy(&v, &r, 2);
  } else if constexpr (sizeof(T) == 4) {
    uint32_t r;
    asm("ld.global.cs.b32 %0, [%1];" : "=r"(r) : "l"(p));
    memcpy(&v, &r, 4);
  } else if constexpr (sizeof(T) == 8) {
    uint64_t r;
    asm("ld.global.cs.b64 %0, [%1];" : "=l"(r) : "l"(p));
    memcpy(&v, &r, 8);
  } else {
    static_assert(sizeof(T) == 16, "1, 2, 4, 8 or 16 bytes");
    uint64_t r[2];
    asm("ld.global.cs.v2.b64 {%0, %1}, [%2];" : "=l"(r[0]), "=l"(r[1]) : "l"(p));
    memcpy(&v, r, 16);
  }
  return v;
}

// An L2 policy that keeps lines past others (createpolicy, sm_80+), and a
// load under it: spmv's gathers of x.
__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

template <typename T>
__device__ __forceinline__ T ld_keep(const T* p, uint64_t policy) {
  T v;
  if constexpr (sizeof(T) == 1) {
    uint32_t r;
    asm("ld.global.L2::cache_hint.u8 %0, [%1], %2;" : "=r"(r) : "l"(p), "l"(policy));
    const uint8_t b = (uint8_t)r;
    memcpy(&v, &b, 1);
  } else if constexpr (sizeof(T) == 2) {
    uint16_t r;
    asm("ld.global.L2::cache_hint.u16 %0, [%1], %2;" : "=h"(r) : "l"(p), "l"(policy));
    memcpy(&v, &r, 2);
  } else if constexpr (sizeof(T) == 4) {
    uint32_t r;
    asm("ld.global.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(r) : "l"(p), "l"(policy));
    memcpy(&v, &r, 4);
  } else if constexpr (sizeof(T) == 8) {
    uint64_t r;
    asm("ld.global.L2::cache_hint.b64 %0, [%1], %2;" : "=l"(r) : "l"(p), "l"(policy));
    memcpy(&v, &r, 8);
  } else {
    static_assert(sizeof(T) == 16, "1, 2, 4, 8 or 16 bytes");
    uint64_t r[2];
    asm("ld.global.L2::cache_hint.v2.b64 {%0, %1}, [%2], %3;" : "=l"(r[0]), "=l"(r[1]) : "l"(p), "l"(policy));
    memcpy(&v, r, 16);
  }
  return v;
}

template <typename T>
__device__ __forceinline__ void put(T* o, typename Traits<T>::A acc, int accumulate) {
  using Tr = Traits<T>;
  *o = Tr::store(accumulate ? add(Tr::load(*o), acc) : acc);
}

// V consecutive elements of a row: one 16-byte access where V > 1 (the
// gate has checked the alignment), else one element.
template <typename T, int V>
struct alignas(V == 1 ? alignof(T) : sizeof(T) * V) Vec {
  T v[V];
};

// the row's elements [j, j + V) of which `left` lie before its end; the rest 0
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_cols(const T* p, int64_t left) {
  Vec<T, V> r;
  if (V == 1 || left >= V) {
    r = *reinterpret_cast<const Vec<T, V>*>(p);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = k < left ? p[k] : zero<T>();
  }
  return r;
}

template <typename T, int V>
__device__ __forceinline__ void put_cols(T* o, const typename Traits<T>::A (&acc)[V], int64_t left, int accumulate) {
  using Tr = Traits<T>;
  if (V == 1 || left >= V) {
    Vec<T, V> r;
    if (accumulate) r = *reinterpret_cast<const Vec<T, V>*>(o);
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = Tr::store(accumulate ? add(Tr::load(r.v[k]), acc[k]) : acc[k]);
    *reinterpret_cast<Vec<T, V>*>(o) = r;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (k < left) put(o + k, acc[k], accumulate);
    }
  }
}

// ---------------------------------------------------------------- spmv
template <typename T>
__global__ void __launch_bounds__(kThreads) spmv_kernel(const int64_t* __restrict__ ptr,
                                                        const int32_t* __restrict__ col, const T* __restrict__ w,
                                                        const T* __restrict__ x, int64_t ldx, T* __restrict__ out,
                                                        int64_t ldo, int64_t n_rows, int accumulate) {
  using Tr = Traits<T>;
  using A = typename Tr::A;
  constexpr int kChunk = kStageBytes / (int)sizeof(A);
  __shared__ int64_t s_ptr[kThreads + 1];
  __shared__ alignas(16) unsigned char s_bytes[kStageBytes];
  A* s_prod = reinterpret_cast<A*>(s_bytes);
  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * kThreads;
  const int rows = (int)lmin(kThreads, n_rows - r0);
  for (int i = tid; i <= rows; i += kThreads) s_ptr[i] = ld_stream(ptr + r0 + i);
  __syncthreads();
  const int64_t first = s_ptr[0], last = s_ptr[rows];
  const int64_t lo = tid < rows ? s_ptr[tid] : 0, hi = tid < rows ? s_ptr[tid + 1] : 0;
  const uint64_t keep = evict_last_policy();
  A acc = zero<A>();
  for (int64_t c0 = first; c0 < last; c0 += kChunk) {
    const int n = (int)lmin(kChunk, last - c0);
    for (int base = 0; base < n; base += kThreads * kUnroll) {
      int32_t c[kUnroll];
      T wv[kUnroll], xv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        c[u] = i < n ? ld_stream(col + c0 + i) : 0;
        wv[u] = i < n ? ld_stream(w + c0 + i) : zero<T>();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        xv[u] = i < n ? ld_keep(x + (int64_t)c[u] * ldx, keep) : zero<T>();
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < n) s_prod[i] = Tr::mul(Tr::load(wv[u]), Tr::load(xv[u]));
      }
    }
    __syncthreads();
    const int64_t a = lmax(lo, c0), b = lmin(hi, c0 + n);
    for (int64_t e = a; e < b; ++e) acc = add(acc, s_prod[e - c0]);
    __syncthreads();
  }
  if (tid < rows) put(out + (r0 + tid) * ldo, acc, accumulate);
}

// ---------------------------------------------------------------- rows
constexpr int kSlots = 4;  // rows: entries of its row a lane holds, a chunk of kSlots * L

// the pointers [s, t) of a group's row in a task (rows past the last: empty)
__device__ __forceinline__ void row_pointers(const int64_t* __restrict__ ptr, int64_t task, int64_t n_tasks,
                                             int groups, int g, int64_t n_rows, int64_t& s, int64_t& t) {
  const int64_t row = lmin(task * groups + g, n_rows);
  s = task < n_tasks ? ld_stream(ptr + row) : 0;
  t = task < n_tasks ? ld_stream(ptr + lmin(row + 1, n_rows)) : 0;
}

// lanes: L, the lanes covering a row of x (a power of 2, at most 32); a
// warp's task is G = 32 / L consecutive rows, group g of L lanes row g
// (no __launch_bounds__: with one, ptxas trades spills for occupancy here)
template <typename T, int V>
__global__ void rows_kernel(const int64_t* __restrict__ ptr,
                                                        const int32_t* __restrict__ col, const T* __restrict__ w,
                                                        const T* __restrict__ x, int64_t ldx, T* __restrict__ out,
                                                        int64_t ldo, int64_t n_rows, int64_t width, int accumulate,
                                                        int lanes) {
  using Tr = Traits<T>;
  using A = typename Tr::A;
  const int lane = threadIdx.x & 31;
  const int shift = __ffs(lanes) - 1;  // lanes is a power of 2
  const int groups = 32 >> shift, g = lane >> shift, q = lane & (lanes - 1);
  const int64_t n_tasks = (n_rows + groups - 1) / groups, stride = (int64_t)gridDim.x * kWarps;
  int64_t task = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= n_tasks) return;  // a whole warp leaves together: the shuffles below see full warps

  int64_t s, t, s_next, t_next;
  row_pointers(ptr, task, n_tasks, groups, g, n_rows, s, t);
  for (; task < n_tasks; task += stride) {
    // the next task's pointers load while this task's gathers are in flight
    row_pointers(ptr, task + stride, n_tasks, groups, g, n_rows, s_next, t_next);
    const int64_t len = t - s, row = task * groups + g;
    int64_t steps = len;  // the task's longest row
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) steps = lmax(steps, __shfl_xor_sync(0xffffffffu, (long long)steps, off));
    for (int64_t j0 = 0; j0 < width; j0 += (int64_t)lanes * V) {
      const int64_t j = j0 + (int64_t)q * V, left = width - j;
      A acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = zero<A>();
      for (int64_t e0 = 0; e0 < steps; e0 += kSlots * lanes) {
        // the chunk [e0, e0 + kSlots L) of the group's row: lane q holds entries q, q + L, ...
        int32_t c[kSlots];
        T wv[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const int64_t e = s + e0 + q + (int64_t)k * lanes;
          c[k] = e < t ? ld_stream(col + e) : 0;
          wv[k] = e < t ? ld_stream(w + e) : zero<T>();
        }
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          if (e0 + (int64_t)k * lanes >= steps) break;
          for (int l0 = 0; l0 < lanes; l0 += kUnroll) {
            // entries e0 + k L + l0 + u of every group's row, up to 8 gathers a lane in flight
            Vec<T, V> xv[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int l = l0 + u;
              const int32_t cu = shfl_idx(c[k], (g << shift) + (l & (lanes - 1)));
              if (l < lanes && e0 + k * lanes + l < len && left > 0) {
                xv[u] = load_cols<T, V>(x + (int64_t)cu * ldx + j, left);
              }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
              const int l = l0 + u;
              const A wu = Tr::load(shfl_idx(wv[k], (g << shift) + (l & (lanes - 1))));
              if (l < lanes && e0 + k * lanes + l < len && left > 0) {
#pragma unroll
                for (int v = 0; v < V; ++v) acc[v] = add(acc[v], Tr::mul(wu, Tr::load(xv[u].v[v])));
              }
            }
          }
        }
      }
      if (row < n_rows && left > 0) put_cols<T, V>(out + row * ldo + j, acc, left, accumulate);
    }
    s = s_next;
    t = t_next;
  }
}

// ---------------------------------------------------------------- wide
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) wide_kernel(const int64_t* __restrict__ ptr,
                                                        const int32_t* __restrict__ col, const T* __restrict__ w,
                                                        const T* __restrict__ x, int64_t ldx, T* __restrict__ out,
                                                        int64_t ldo, int64_t n_rows, int64_t width, int accumulate) {
  using Tr = Traits<T>;
  using A = typename Tr::A;
  __shared__ int32_t s_col[kWideStage];
  __shared__ alignas(16) unsigned char s_bytes[kWideStage * sizeof(T)];
  T* s_w = reinterpret_cast<T*>(s_bytes);
  const int tid = threadIdx.x;
  for (int64_t r = blockIdx.x; r < n_rows; r += gridDim.x) {
    const int64_t s = ptr[r], t = ptr[r + 1];
    const bool once = t - s <= kWideStage;  // staged once for every pass of columns
    if (once) {
      for (int i = tid; i < t - s; i += kThreads) {
        s_col[i] = ld_stream(col + s + i);
        s_w[i] = ld_stream(w + s + i);
      }
    }
    __syncthreads();
    for (int64_t j0 = 0; j0 < width; j0 += (int64_t)kThreads * V) {
      const int64_t j = j0 + (int64_t)tid * V, left = width - j;
      A acc[V];
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = zero<A>();
      for (int64_t e0 = s; e0 < t; e0 += kWideStage) {
        const int m = (int)lmin(kWideStage, t - e0);
        if (!once) {
          __syncthreads();
          for (int i = tid; i < m; i += kThreads) {
            s_col[i] = ld_stream(col + e0 + i);
            s_w[i] = ld_stream(w + e0 + i);
          }
          __syncthreads();
        }
        if (left <= 0) continue;
        for (int i0 = 0; i0 < m; i0 += kUnroll) {
          Vec<T, V> xv[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (i0 + u < m) xv[u] = load_cols<T, V>(x + (int64_t)s_col[i0 + u] * ldx + j, left);
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (i0 + u < m) {
              const A wu = Tr::load(s_w[i0 + u]);
#pragma unroll
              for (int k = 0; k < V; ++k) acc[k] = add(acc[k], Tr::mul(wu, Tr::load(xv[u].v[k])));
            }
          }
        }
      }
      if (left > 0) put_cols<T, V>(out + r * ldo + j, acc, left, accumulate);
    }
    __syncthreads();  // before the next row is staged
  }
}

// ---------------------------------------------------------------- launch
// blocks of `kernel` the card holds at once (its SMs times the blocks an SM
// holds), as a persistent grid
template <typename K>
int resident_blocks(K kernel, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  *out = sms * (per_sm > 0 ? per_sm : 1);
  return (int)e;
}

bool aligned(const void* p, size_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

template <typename T, int V>
int launch_wider(int route, const int64_t* p, const int32_t* c, const T* wv, const T* xv, int64_t ldx, T* o,
                 int64_t ldo, int64_t n_rows, int64_t width, int accumulate, cudaStream_t stream) {
  int resident = 0;
  if (route == 1) {
    int err = resident_blocks(rows_kernel<T, V>, &resident);
    if (err) return err;
    int lanes = 1;
    while (lanes < 32 && (int64_t)lanes * V < width) lanes <<= 1;
    const int64_t want = (n_rows + kWarps - 1) / kWarps;
    const unsigned grid = (unsigned)(want < resident ? want : resident);
    rows_kernel<T, V><<<grid, kThreads, 0, stream>>>(p, c, wv, xv, ldx, o, ldo, n_rows, width, accumulate, lanes);
  } else {
    int err = resident_blocks(wide_kernel<T, V>, &resident);
    if (err) return err;
    const unsigned grid = (unsigned)(n_rows < resident ? n_rows : resident);
    wide_kernel<T, V><<<grid, kThreads, 0, stream>>>(p, c, wv, xv, ldx, o, ldo, n_rows, width, accumulate);
  }
  return 0;
}

// route: 0 spmv, 1 rows, 2 wide; vec16: rows of x and out read and written
// in 16-byte pieces (x, out, ldx and ldo 16-byte aligned)
template <typename T>
int launch(const void* ptr, const void* col, const void* w, const void* x, int64_t ldx, void* out, int64_t ldo,
           int64_t n_rows, int64_t width, int accumulate, int route, int vec16, cudaStream_t stream) {
  if (n_rows <= 0 || width <= 0) return 0;
  if (!aligned(x, alignof(T)) || !aligned(w, alignof(T)) || !aligned(out, alignof(T))) return (int)cudaErrorInvalidValue;
  const int64_t* p = static_cast<const int64_t*>(ptr);
  const int32_t* c = static_cast<const int32_t*>(col);
  const T* wv = static_cast<const T*>(w);
  const T* xv = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  constexpr int kV = sizeof(T) < 16 ? 16 / (int)sizeof(T) : 1;
  int err = 0;
  if (route == 0) {
    if (width != 1) return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((n_rows + kThreads - 1) / kThreads);
    spmv_kernel<T><<<grid, kThreads, 0, stream>>>(p, c, wv, xv, ldx, o, ldo, n_rows, accumulate);
  } else if (route == 1 || route == 2) {
    if (vec16 && !(aligned(x, 16) && aligned(out, 16) && (ldx * (int64_t)sizeof(T)) % 16 == 0 &&
                   (ldo * (int64_t)sizeof(T)) % 16 == 0)) {
      return (int)cudaErrorInvalidValue;
    }
    err = vec16 ? launch_wider<T, kV>(route, p, c, wv, xv, ldx, o, ldo, n_rows, width, accumulate, stream)
                : launch_wider<T, 1>(route, p, c, wv, xv, ldx, o, ldo, n_rows, width, accumulate, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// One entry point a value type, named by its suffix.  Integer sums are
// exact in any order (they wrap as torch's integer arithmetic does).
#define HEAT_CSR_SPMM(SUFFIX, T)                                                                                  \
  extern "C" int heat_csr_spmm_##SUFFIX(const void* ptr, const void* col, const void* w, const void* x,        \
                                        int64_t ldx, void* out, int64_t ldo, int64_t n_rows, int64_t width,     \
                                        int accumulate, int route, int vec16, cudaStream_t stream) {             \
    return launch<T>(ptr, col, w, x, ldx, out, ldo, n_rows, width, accumulate, route, vec16, stream);          \
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
