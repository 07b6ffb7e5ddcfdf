// Gram matrix G = x^T x of a tall float32 matrix for Hopper (sm_90a), the
// products on the tensor cores in 3xTF32; plain C interface for ctypes.
//
// Replaces the TPU kernel heat_tpu/core/kernels.py::_syrk_kernel (the Pallas
// kernel behind heat_tpu's `gram_syrk`, the Gram pass of hierarchical SVD).
// On one rank's padded chunk x (rows, n), n <= 512, it computes the (n, n)
// float32 G = sum over rows r < n_true of x[r]^T x[r]; rows at or past n_true
// are padding and add nothing, so no separate tail product is needed.
//
// What bounds it: G needs one read of x (4 n bytes a row) and n (n + 1) / 2
// multiply-adds a row over the upper triangle.  At 2^25 x 128 the read is
// 17.2 GB, 5.13 ms at 3.35 TB/s: the bound.  The products run on the tensor
// cores in 3xTF32 (tf32x3.cuh), three TF32 products each: 3 m n (n + 1)
// FLOP, whose floor at 495 TFLOP/s is 3.36 ms, under the read; the design
// before this one multiplied in f32 on the CUDA cores, whose floor (8.27 ms)
// lay above it.  So the kernel is byte-bound, and the design reads x from
// device memory once, in full rows:
//   - Units.  For 64 < n <= 128 one block of three warpgroups owns all three
//     upper 64 x 64 tiles of G over its run of rows, (0, 0), (0, 1) and
//     (1, 1), one warpgroup each, so each row of x crosses HBM once.  Other
//     widths keep a grid of tiles, one warpgroup a block: a tile (i, j)
//     reads its column blocks i and j.
//   - No transpose in wgmma's .tf32 form: both operands of x^T x are
//     MN-major as x lies.  Each landed stage of 64 rows is split, through
//     registers, into K-major (rows contiguous) TF32 big and small planes,
//     one pair per column block, which are both A and B of the tile's
//     m64n64k8 products, read by wgmma from shared memory.  A thread splits
//     4 rows of a column into one 16-byte word of each plane, and
//     neighbouring threads take neighbouring columns, so neither the read
//     nor the write conflicts in the banks.
//   - mma.sync m16n8k8 (K6's route), with each thread loading its fragments
//     from the landed stage in place and splitting them in registers, was
//     slower on the card: every element is split again by each warp that
//     reads it (PERF.md).
//   - A cp.async ring of 3 raw stages (two in flight ahead of the one
//     split) and double-buffered planes: a stage's wgmma group runs while
//     the next stage is split; a warpgroup waits for it one stage later.
//     Stages of 64 rows fill shared memory; stages of 32 rows (a ring of 4)
//     paid their two barriers twice as often and were slower.
//   - Precision.  The tensor core's f32 accumulation truncates, so each
//     stage is its own short chain from zero (8 k8 slabs x 3 products),
//     added in IEEE f32; the f32 sums go into f64 accumulators every 4
//     stages (256 rows), so the error does not grow with the number of
//     rows.  (Adding every chain into f64 at once was slower: the
//     f32-to-f64 conversion runs at 16 a clock per SM.)  The chain is read only after
//     a full wait: reading one chain while another runs made ptxas
//     serialize every wgmma (warning C7514).
//   - Split over rows.  Blocks run in no order: the grid is (units, runs of
//     rows).  Each block writes its tiles' f64 partials; a second kernel adds
//     them over the runs in a fixed order and mirrors the upper triangle, so
//     G is exactly symmetric.  There are no float atomics, so two launches
//     are bitwise equal.
//   - Rows past the run's end (or n_true) and columns past n arrive as
//     zeros (the copies read nothing there).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kT = 64;                    // side of an output tile
constexpr int kK = 64;                    // rows of x per stage
constexpr int kRing = 3;                  // raw stages in shared memory
constexpr int kFlush = 4;                 // stages (256 rows) summed in f32 before the f64 add
constexpr int kLdRaw = 2 * kT + 4;        // raw stage row (floats), 16-byte aligned
constexpr int kRawBytes = kK * kLdRaw * 4;         // 33792
constexpr int kPlaneBytes = kT * kK * 4;           // one 64-column block x 64 rows: 16 KB
constexpr int kBlockBytes = 2 * kPlaneBytes;       // its big and small planes
constexpr int kPlanesBytes = 2 * kBlockBytes;      // two column blocks
constexpr int kSmemBytes = kRing * kRawBytes + 2 * kPlanesBytes;  // 232448, all a block may have

// the t-th upper-triangle tile (ti <= tj) of an nt x nt grid of tiles, row by row
__device__ __forceinline__ void tile_of(int t, int nt, int& ti, int& tj) {
  ti = 0;
  while (t >= nt - ti) {
    t -= nt - ti;
    ++ti;
  }
  tj = ti + t;
}

// partial[run][tile] (kT x kT, f64) = sum over this run's rows of the tile's
// x[r, i0 + a] * x[r, j0 + b].  NWG = 3: the three tiles of n <= 128, one per
// warpgroup; NWG = 1: tile blockIdx.x of the upper triangle.
template <int NWG, bool kVec>
__global__ void __launch_bounds__(128 * NWG, 1)
syrk_partial_kernel(const float* __restrict__ x, int64_t n_true, int n, int nt, int64_t rows_per_run,
                    double* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kThreads = 128 * NWG;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // the column blocks this block reads (nb of them: cb0, then cb1), and the
  // tile of this warpgroup: its rows are the stage's block ca, its columns
  // block cb
  int cb0, cb1, nb, ca, cb, tile;
  if (NWG == 3) {
    cb0 = 0;
    cb1 = 1;
    nb = 2;
    tile = wg;
    ca = wg == 2 ? 1 : 0;
    cb = wg == 0 ? 0 : 1;
  } else {
    int ti, tj;
    tile_of(blockIdx.x, nt, ti, tj);
    cb0 = ti;
    cb1 = tj;
    nb = ti == tj ? 1 : 2;
    tile = blockIdx.x;
    ca = 0;
    cb = nb - 1;
  }
  const int64_t r0 = (int64_t)blockIdx.y * rows_per_run;
  const int64_t r1 = r0 + rows_per_run < n_true ? r0 + rows_per_run : n_true;
  const int64_t nstages = r1 > r0 ? (r1 - r0 + kK - 1) / kK : 0;

  auto raw = [&](int s) { return reinterpret_cast<float*>(smem + (s % kRing) * kRawBytes); };
  auto planes = [&](int p, int blk) { return smem + kRing * kRawBytes + p * kPlanesBytes + blk * kBlockBytes; };

  // rows [r, r + kK) of the column blocks into raw stage `s`, zeros past r1
  // and n; every call commits a group (empty past the end), so the waits
  // below count alike
  auto load = [&](int64_t s) {
    if (s < nstages) {
      const int64_t r = r0 + s * kK;
      float* dst = raw((int)s);
      const int cols = nb * kT;  // 64 or 128
      if (kVec) {  // n % 4 == 0 and x 16-byte aligned: whole float4s are in or out
        for (int e = tid; e < kK * cols / 4; e += kThreads) {
          const int row = nb == 2 ? e >> 5 : e >> 4, c = (e & (cols / 4 - 1)) * 4;
          const int gc = (c < kT ? cb0 : cb1) * kT + c % kT;
          const int64_t gr = r + row;
          const bool ok = gr < r1 && gc < n;
          tf32x3::cp16(dst + row * kLdRaw + c, ok ? x + gr * n + gc : x, ok ? 16u : 0u);
        }
      } else {
        for (int e = tid; e < kK * cols; e += kThreads) {
          const int row = nb == 2 ? e >> 7 : e >> 6, c = e & (cols - 1);
          const int gc = (c < kT ? cb0 : cb1) * kT + c % kT;
          const int64_t gr = r + row;
          const bool ok = gr < r1 && gc < n;
          tf32x3::cp4(dst + row * kLdRaw + c, ok ? x + gr * n + gc : x, ok ? 4u : 0u);
        }
      }
    }
    tf32x3::commit();
  };

  // raw stage s split into plane buffer p: element (row k, column c of block
  // b) at cm_off(c, k) of block b's big and small planes (K-major: rows of x
  // are the depth).  A thread takes 4 rows of one column at a time and
  // stores them as one 16-byte word in each plane; neighbouring threads take
  // neighbouring columns, so neither side conflicts in the banks.
  auto split = [&](int s, int p) {
    const float* src = raw(s);
    const int cols = nb * kT;
    for (int u = tid; u < cols * (kK / 4); u += kThreads) {
      const int c = u & (cols - 1), k = (u / cols) * 4;  // cols is 64 or 128
      uint32_t b[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32x3::split(src[(k + e) * kLdRaw + c], b[e], l[e]);
      unsigned char* pl = planes(p, c >> 6) + tf32x3::cm_off(c & (kT - 1), k);
      *reinterpret_cast<uint4*>(pl) = make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(pl + kPlaneBytes) = make_uint4(l[0], l[1], l[2], l[3]);
    }
  };

  double dacc[32];
  float acc[32], facc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    dacc[e] = 0.0;
    acc[e] = 0.f;
    facc[e] = 0.f;
  }

#pragma unroll 1
  for (int s = 0; s < kRing - 1; ++s) load(s);

  // stage s: split into plane buffer s % 2 while stage s - 1's chain runs,
  // then add that chain into the f32 sums and start stage s's from zero;
  // every kFlush stages the f32 sums go into f64.  Only a complete chain's
  // accumulator is ever read (after a full wait), so ptxas does not
  // serialize the wgmma.
#pragma unroll 1
  for (int64_t s = 0; s < nstages; ++s) {
    const int p = (int)(s & 1);
    tf32x3::wait<kRing - 2>();  // stage s has landed (this thread's copies)
    __syncthreads();            // every copy of stage s has landed; stage s - 2's chain is done
    split((int)s, p);
    tf32x3::fence_async_smem();
    __syncthreads();  // the planes of stage s are ready; raw stage s - 1 is free
    load(s + kRing - 1);
    tf32x3::wg_wait<0>();  // stage s - 1's chain
    tf32x3::wg_pin(acc);
#pragma unroll
    for (int e = 0; e < 32; ++e) facc[e] += acc[e];
    if (s % kFlush == 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        dacc[e] += (double)facc[e];
        facc[e] = 0.f;
      }
    }
    const unsigned char* pa = planes(p, ca);
    const unsigned char* pb = planes(p, cb);
    tf32x3::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kK / 8; ++kk)
      tf32x3::wg_mma3_ss(acc, tf32x3::wg_desc(pa + kk * 2048, 128, 256),
                         tf32x3::wg_desc(pa + kPlaneBytes + kk * 2048, 128, 256),
                         tf32x3::wg_desc(pb + kk * 2048, 128, 256),
                         tf32x3::wg_desc(pb + kPlaneBytes + kk * 2048, 128, 256), kk == 0 ? 0 : 1);
    tf32x3::wg_commit();
  }
  tf32x3::wg_wait<0>();
  tf32x3::wg_pin(acc);
  if (nstages > 0) {
#pragma unroll
    for (int e = 0; e < 32; ++e) dacc[e] += (double)(facc[e] + acc[e]);
  }
  tf32x3::wait<0>();

  double* out = partial + ((int64_t)blockIdx.y * (NWG == 3 ? 3 : gridDim.x) + tile) * (kT * kT);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int a = 16 * warp + g + 8 * (e >> 1), b = 8 * i + 2 * t + (e & 1);
      out[a * kT + b] = dacc[4 * i + e];
    }
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

template <int NWG, bool kVec>
cudaError_t launch_partial(const float* x, int64_t n_true, int n, int nt, int units, int64_t nruns,
                           int64_t rows_per_run, double* partial, cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(syrk_partial_kernel<NWG, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  syrk_partial_kernel<NWG, kVec><<<dim3((unsigned)units, (unsigned)nruns), 128 * NWG, kSmemBytes, s>>>(
      x, n_true, n, nt, rows_per_run, partial);
  return cudaGetLastError();
}

// one block of three warpgroups for 64 < n <= 128, else one tile a block
bool grouped(int64_t n) { return n > kT && n <= 2 * kT; }

}  // namespace

extern "C" {

// Blocks of the Gram kernel for width n that one SM holds at once (0 on
// error); the grid should not exceed this times the SM count.
int64_t heat_syrk_blocks_per_sm(int64_t n) {
  int b = 0;
  cudaError_t err;
  if (grouped(n)) {
    err = cudaFuncSetAttribute(syrk_partial_kernel<3, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, syrk_partial_kernel<3, true>, 384, kSmemBytes);
  } else {
    err = cudaFuncSetAttribute(syrk_partial_kernel<1, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, syrk_partial_kernel<1, true>, 128, kSmemBytes);
  }
  return err == cudaSuccess ? b : 0;
}

// Blocks of one run of rows for width n: 1 (the three tiles of 64 < n <= 128
// in one block) or the number of upper-triangle tiles.
int64_t heat_syrk_units(int64_t n) {
  const int64_t nt = (n + kT - 1) / kT;
  return grouped(n) ? 1 : nt * (nt + 1) / 2;
}

// G (n, n) f32 = x[:n_true]^T x[:n_true].  x (rows, n) is contiguous f32 on the
// device with rows >= n_true and 1 <= n <= 512; run y of the grid takes rows
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
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t err;
  if (grouped(n))
    err = vec ? launch_partial<3, true>(xp, n_true, ni, nt, 1, nruns, rows_per_run, pp, s)
              : launch_partial<3, false>(xp, n_true, ni, nt, 1, nruns, rows_per_run, pp, s);
  else
    err = vec ? launch_partial<1, true>(xp, n_true, ni, nt, ntiles, nruns, rows_per_run, pp, s)
              : launch_partial<1, false>(xp, n_true, ni, nt, ntiles, nruns, rows_per_run, pp, s);
  if (err != cudaSuccess) return (int)err;
  const int64_t outs = (int64_t)ntiles * kT * kT;
  syrk_reduce_kernel<<<(unsigned)((outs + 255) / 256), 256, 0, s>>>(pp, nruns, nt, ntiles, ni, static_cast<float*>(g));
  return (int)cudaGetLastError();
}

}  // extern "C"
