// Gram matrix G = x^T x of a tall float32 matrix for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces the TPU kernel heat_tpu/core/kernels.py::_syrk_kernel (the Pallas
// kernel behind heat_tpu's `gram_syrk`, the Gram pass of hierarchical SVD).
// On one rank's padded chunk x (rows, n), n <= 512, it computes the (n, n)
// float32 G = sum over rows r < n_true of x[r]^T x[r]; rows at or past n_true
// are padding and add nothing, so no separate tail product is needed.
//
// What bounds it: G needs one read of x (4 n bytes a row) and n (n + 1) / 2
// multiply-adds a row, n/4 of them a byte.  Through the tensor cores that is
// far below the card's balance, so one read of x is the floor (at 2^25 x 128:
// 17.2 GB, 5.13 ms at 3.35 TB/s).  This first kernel multiplies in IEEE f32 on
// the CUDA cores, whose 67 TFLOP/s put a floor of its own above that one
// (8.3 ms at that shape): it is right and simple first, and moving the
// products onto the tensor cores (3xTF32 or bf16x3) is the work of a later
// change.  What the design does:
//   - Symmetry.  Only the upper-triangle 64 x 64 tiles of G are computed; in a
//     diagonal tile the warp whose 32 x 32 quadrant lies below the diagonal
//     idles.  A second kernel mirrors the upper triangle, so G is exactly
//     symmetric.
//   - Reuse.  Each stage of 32 rows of the tile's two column blocks is copied
//     into shared memory once (cp.async, two stages in flight); each thread
//     keeps an 8 x 4 block of the tile in registers, 32 multiply-adds for three
//     16-byte shared loads.  The blocks of one run of rows are launched side by
//     side, so that a column block read by two tiles can come from L2 the
//     second time.
//   - Split over rows.  Blocks run in no order: the grid is (tiles, runs of
//     rows), one block per tile and run.  Where the TPU carried a Kahan-
//     compensated sum from one sequential grid step to the next, a block here
//     keeps f32 partial sums over at most 256 rows and adds them into f64
//     accumulators, so the error does not grow with the number of rows.
//   - Fixed order.  The second kernel adds the blocks' f64 partials in block
//     order.  There are no float atomics, so two launches are bitwise equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;         // side of an output tile
constexpr int kK = 32;         // rows of x per stage
constexpr int kThreads = 128;  // four warps, each owning a 32 x 32 quadrant of the tile
constexpr int kFlush = 8;      // stages (256 rows) summed in f32 before the f64 add

// the t-th upper-triangle tile (ti <= tj) of an nt x nt grid of tiles, row by row
__device__ __forceinline__ void tile_of(int t, int nt, int& ti, int& tj) {
  ti = 0;
  while (t >= nt - ti) {
    t -= nt - ti;
    ++ti;
  }
  tj = ti + t;
}

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy 16 (or 4) bytes into shared memory; with valid false nothing is read
// and the destination is zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one stage: rows [r, r + kK) of columns [c0, c0 + kT) into dst, zeros past
// r_end (n_true or the end of this block's run) and past column n
template <bool kVec>
__device__ __forceinline__ void load_stage(float (*dst)[kT], const float* __restrict__ x, int64_t r,
                                           int64_t r_end, int n, int c0) {
  if (kVec) {  // n % 4 == 0 and x 16-byte aligned: whole float4s are in or out
#pragma unroll
    for (int it = 0; it < kK * kT / 4 / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int row = e / (kT / 4), c = (e % (kT / 4)) * 4;
      const int64_t gr = r + row;
      const bool ok = gr < r_end && c0 + c < n;
      cp_async16(&dst[row][c], ok ? x + gr * n + c0 + c : x, ok);
    }
  } else {
#pragma unroll 4
    for (int it = 0; it < kK * kT / kThreads; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int row = e / kT, c = e % kT;
      const int64_t gr = r + row;
      const bool ok = gr < r_end && c0 + c < n;
      cp_async4(&dst[row][c], ok ? x + gr * n + c0 + c : x, ok);
    }
  }
}

// partial[run][tile] (kT x kT, f64) = sum over this run's rows of the tile's
// x[r, i0 + a] * x[r, j0 + b]
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
syrk_partial_kernel(const float* __restrict__ x, int64_t n_true, int n, int nt, int64_t rows_per_run,
                    double* __restrict__ partial) {
  __shared__ __align__(16) float as[2][kK][kT];
  __shared__ __align__(16) float bs[2][kK][kT];
  int ti, tj;
  tile_of(blockIdx.x, nt, ti, tj);
  const bool diag = ti == tj;
  const int i0 = ti * kT, j0 = tj * kT;
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_run;
  const int64_t r1 = r0 + rows_per_run < n_true ? r0 + rows_per_run : n_true;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qa = (warp >> 1) * 32, qb = (warp & 1) * 32;           // the warp's quadrant
  const int a0 = qa + (lane >> 3) * 8, b0 = qb + (lane & 7) * 4;   // the thread's 8 x 4 block
  const bool idle = diag && qa > qb;  // below the diagonal: the mirror of the quadrant above it

  float acc[8][4];
  double dacc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.f;
      dacc[i][j] = 0.0;
    }

  const int64_t nstages = r1 > r0 ? (r1 - r0 + kK - 1) / kK : 0;
  if (nstages > 0) {
    load_stage<kVec>(as[0], x, r0, r1, n, i0);
    if (!diag) load_stage<kVec>(bs[0], x, r0, r1, n, j0);
    cp_async_commit();
  }
  for (int64_t s = 0; s < nstages; ++s) {
    const int buf = (int)(s & 1);
    if (s + 1 < nstages) {
      const int64_t r = r0 + (s + 1) * kK;
      load_stage<kVec>(as[buf ^ 1], x, r, r1, n, i0);
      if (!diag) load_stage<kVec>(bs[buf ^ 1], x, r, r1, n, j0);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (!idle) {
      const float(*A)[kT] = as[buf];
      const float(*B)[kT] = diag ? as[buf] : bs[buf];
#pragma unroll 8
      for (int k = 0; k < kK; ++k) {
        const float4 p0 = *reinterpret_cast<const float4*>(&A[k][a0]);
        const float4 p1 = *reinterpret_cast<const float4*>(&A[k][a0 + 4]);
        const float4 q = *reinterpret_cast<const float4*>(&B[k][b0]);
        const float av[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
        const float bv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if ((s + 1) % kFlush == 0 || s + 1 == nstages) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dacc[i][j] += (double)acc[i][j];
            acc[i][j] = 0.f;
          }
      }
    }
    __syncthreads();  // this buffer is consumed before stage s + 2 is copied into it
  }
  if (idle) return;  // never read: the reduction takes the upper triangle only
  double* out = partial + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * (kT * kT);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(a0 + i) * kT + b0 + j] = dacc[i][j];
}

// G[gi, gj] = G[gj, gi] = sum over runs, in order, of the partials of gi <= gj
__global__ void syrk_reduce_kernel(const double* __restrict__ partial, int64_t nruns, int nt, int ntiles,
                                   int n, float* __restrict__ g) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per_run = (int64_t)ntiles * kT * kT;
  if (q >= per_run) return;
  const int t = (int)(q / (kT * kT)), a = (int)(q % (kT * kT)) / kT, b = (int)(q % kT);
  int ti, tj;
  tile_of(t, nt, ti, tj);
  const int gi = ti * kT + a, gj = tj * kT + b;
  if (gi >= n || gj >= n || gi > gj) return;
  double s = 0.0;
  for (int64_t r = 0; r < nruns; ++r) s += partial[r * per_run + q];
  const float v = (float)s;
  g[(int64_t)gi * n + gj] = v;
  g[(int64_t)gj * n + gi] = v;
}

}  // namespace

extern "C" {

// Blocks of the Gram kernel one SM holds at once (0 on error); the grid
// should not exceed this times the SM count.
int64_t heat_syrk_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, syrk_partial_kernel<true>, kThreads, 0) != cudaSuccess)
    return 0;
  return n;
}

// G (n, n) f32 = x[:n_true]^T x[:n_true].  x (rows, n) is contiguous f32 on the
// device with rows >= n_true and 1 <= n <= 512; block y of the grid takes rows
// [y * rows_per_run, (y + 1) * rows_per_run), nruns * rows_per_run >= n_true;
// partial is f64 scratch of nruns * tiles * 64 * 64, tiles the number of
// upper-triangle 64 x 64 tiles of G (nt (nt + 1) / 2, nt = ceil(n / 64)).  Launches on
// `stream` and does not synchronise.  Returns the CUDA error code (0 on
// success).
int heat_syrk_f32(const void* x, int64_t n_true, int64_t n, void* partial, int64_t nruns, int64_t rows_per_run,
                  void* g, void* stream) {
  if (n < 1 || n > 512 || n_true < 0 || nruns < 1 || nruns > 65535 || rows_per_run < 1 ||
      nruns * rows_per_run < n_true)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  double* pp = static_cast<double*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nt = (int)((n + kT - 1) / kT), ntiles = nt * (nt + 1) / 2, ni = (int)n;
  const dim3 grid((unsigned)ntiles, (unsigned)nruns);
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    syrk_partial_kernel<true><<<grid, kThreads, 0, s>>>(xp, n_true, ni, nt, rows_per_run, pp);
  else
    syrk_partial_kernel<false><<<grid, kThreads, 0, s>>>(xp, n_true, ni, nt, rows_per_run, pp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t outs = (int64_t)ntiles * kT * kT;
  syrk_reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, s>>>(pp, nruns, nt, ntiles, ni, static_cast<float*>(g));
  return (int)cudaGetLastError();
}

}  // extern "C"
