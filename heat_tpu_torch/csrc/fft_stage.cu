// One complex DFT stage over the leading axis, for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces two TPU kernels of heat_tpu/fft/_leading.py, which compute the same
// contraction and differ only in how they lay out the result:
//   K3 _stage_kernel_factory (entries _stage_fused_pallas, _stage_fused_pallas_blocked):
//      the result as two (M, n) planes;
//   K4 _pair_kernel_factory (entries _stage_pair_fused, _entry_pair_fused):
//      the result as one (M, 2n) cat-layout tensor, re bins then im bins.
// Here both are one kernel: the caller gives the two output pointers, their
// row stride and their element stride, so a launch may also write straight
// into a complex64 result (re and im adjacent).
//
// What it computes: for every output row r < M and bin k < n,
//   out_re[r, k] = sum_j a_re[j, col(r)] C[j, k] - a_im[j, col(r)] S[j, k]
//   out_im[r, k] = sum_j a_re[j, col(r)] S[j, k] + a_im[j, col(r)] C[j, k]
// with W = [C | S] the (K, 2n) stage matrix of heat_tpu's _w_cat (cos and
// sign * sin, the norm folded in).  col(r) = (r / mb) * bs + r % mb addresses
// the operand: mb = M, bs = 0 for separate (K, M) planes; mb = m, bs = 2m for
// the re and im column blocks of a (K, B, 2m) cat tensor, never copied.  Each
// plane is read with an element stride (1, or 2 for the real and imaginary
// parts of a complex64 tensor read in place).
//
// What bounds it: the TPU kernel splits f32 into three bf16 products for its
// matrix unit; counted so on this card's tensor cores the stage at 512^3 (K = n
// = 512, M = 131072) is 0.83 ms of operations against 0.32 ms of bytes, so by
// operations.  This first kernel multiplies in IEEE f32 on the CUDA cores
// (at least as accurate as bf16x3), whose 67 TFLOP/s put its own floor at 4.1
// ms there: it is right and simple first; 3xTF32 on the tensor cores is a later
// change.  What the design does:
//   - Tiles.  A block owns 128 rows x 64 bins of the result and walks K in
//     steps of 8: the operand's re and im tiles (8 x 128) and the stage
//     matrix's C and S tiles (8 x 64) are staged in shared memory, double
//     buffered, the next step's global loads in flight while this one is
//     multiplied.  Each thread keeps an 8 x 4 block of both outputs in
//     registers: 128 multiply-adds for six 16-byte shared loads.  The
//     registers are capped at 128 a thread so that two blocks share an SM
//     (a few spills; measured faster than one block with 143 registers).
//   - L2.  The bin tiles of one row tile are adjacent in the launch order, so
//     the operand tile they share comes from device memory once and from L2
//     after; the stage matrix (2 MB at n = 512) stays in L2.
//   - No atomics.  Each output is summed by one thread in a fixed order of j,
//     so a second launch is bitwise equal to the first.
//   - Ragged shapes.  Rows past M, bins past n and depths past K are masked
//     (zero-filled tiles, guarded stores); a row tile may straddle two
//     blocks of a cat operand, since every row computes its own column.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // output rows per block
constexpr int kBN = 64;   // output bins per block
constexpr int kBK = 8;    // contraction depth per step
constexpr int kTM = 8;    // rows per thread
constexpr int kTN = 4;    // bins per thread
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);  // 256

template <int kEsIn, int kEsOut>
__global__ void __launch_bounds__(kThreads, 2)
stage_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im, int64_t lda, int64_t mb,
             int64_t bs, int64_t K, int64_t M, int64_t n, int64_t n_tiles, const float* __restrict__ w,
             float* __restrict__ o_re, float* __restrict__ o_im, int64_t ldo) {
  __shared__ __align__(16) float sre[2][kBK][kBM];
  __shared__ __align__(16) float sim[2][kBK][kBM];
  __shared__ __align__(16) float sc[2][kBK][kBN];
  __shared__ __align__(16) float ss[2][kBK][kBN];

  const int64_t tile_n = blockIdx.x % n_tiles;
  const int64_t tile_m = blockIdx.x / n_tiles;
  const int64_t r0 = tile_m * kBM;
  const int64_t k0 = tile_n * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % (kBN / kTN);  // bin group
  const int ty = tid / (kBN / kTN);  // row group

  // operand loads: each thread fills column ac of rows aj, aj + 2, aj + 4, aj + 6
  const int ac = tid % kBM, aj = tid / kBM;
  const int64_t ar = r0 + ac;
  const bool a_ok = ar < M;
  const int64_t acol = a_ok ? ((ar / mb) * bs + ar % mb) * kEsIn : 0;
  const float* pre = a_re + acol;
  const float* pim = a_im + acol;
  // stage-matrix loads: column wc of rows wj and wj + 4, in both halves
  const int wc = tid % kBN, wj = tid / kBN;
  const int64_t wk = k0 + wc;
  const bool w_ok = wk < n;
  const int64_t ldw = 2 * n;

  float acc_re[kTM][kTN], acc_im[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      acc_re[i][j] = 0.f;
      acc_im[i][j] = 0.f;
    }

  float ra[4], ri[4], rc[2], rs[2];
  auto load = [&](int64_t kb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t j = kb + aj + 2 * i;
      const bool ok = a_ok && j < K;
      ra[i] = ok ? __ldg(pre + j * lda) : 0.f;
      ri[i] = ok ? __ldg(pim + j * lda) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int64_t j = kb + wj + 4 * i;
      const bool ok = w_ok && j < K;
      rc[i] = ok ? __ldg(w + j * ldw + wk) : 0.f;
      rs[i] = ok ? __ldg(w + j * ldw + n + wk) : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      sre[buf][aj + 2 * i][ac] = ra[i];
      sim[buf][aj + 2 * i][ac] = ri[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sc[buf][wj + 4 * i][wc] = rc[i];
      ss[buf][wj + 4 * i][wc] = rs[i];
    }
  };

  const int64_t steps = (K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int64_t t = 0; t < steps; ++t) {
    const int buf = (int)(t & 1);
    if (t + 1 < steps) load((t + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p0 = *reinterpret_cast<const float4*>(&sre[buf][kk][ty * kTM]);
      const float4 p1 = *reinterpret_cast<const float4*>(&sre[buf][kk][ty * kTM + 4]);
      const float4 q0 = *reinterpret_cast<const float4*>(&sim[buf][kk][ty * kTM]);
      const float4 q1 = *reinterpret_cast<const float4*>(&sim[buf][kk][ty * kTM + 4]);
      const float4 cv = *reinterpret_cast<const float4*>(&sc[buf][kk][tx * kTN]);
      const float4 sv = *reinterpret_cast<const float4*>(&ss[buf][kk][tx * kTN]);
      const float xr[kTM] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float xi[kTM] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      const float c[kTN] = {cv.x, cv.y, cv.z, cv.w};
      const float s[kTN] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          acc_re[i][j] = fmaf(xr[i], c[j], acc_re[i][j]);
          acc_re[i][j] = fmaf(-xi[i], s[j], acc_re[i][j]);
          acc_im[i][j] = fmaf(xr[i], s[j], acc_im[i][j]);
          acc_im[i][j] = fmaf(xi[i], c[j], acc_im[i][j]);
        }
    }
    if (t + 1 < steps) store(buf ^ 1);  // buf ^ 1 was last read before the previous barrier
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t r = r0 + ty * kTM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int64_t k = k0 + tx * kTN + j;
      if (k >= n) continue;
      o_re[r * ldo + k * kEsOut] = acc_re[i][j];
      o_im[r * ldo + k * kEsOut] = acc_im[i][j];
    }
  }
}

template <int kEsIn, int kEsOut>
cudaError_t launch(const float* a_re, const float* a_im, int64_t lda, int64_t mb, int64_t bs, int64_t K,
                   int64_t M, int64_t n, const float* w, float* o_re, float* o_im, int64_t ldo, cudaStream_t s) {
  const int64_t n_tiles = (n + kBN - 1) / kBN;
  const int64_t blocks = n_tiles * ((M + kBM - 1) / kBM);
  stage_kernel<kEsIn, kEsOut><<<(unsigned)blocks, kThreads, 0, s>>>(a_re, a_im, lda, mb, bs, K, M, n, n_tiles, w,
                                                                      o_re, o_im, ldo);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One DFT stage over the leading axis (see the note above).  a_re / a_im
// point at element (0, 0) of the re and im operands, lda is the distance
// between their rows j and es_in (1 or 2) the distance between neighbouring
// columns, all in floats; column col(r) = (r / mb) * bs + r % mb.  w is the
// contiguous (K, 2n) stage matrix.  o_re / o_im point at output (0, 0), ldo
// is the row stride and es_out (1 or 2) the bin stride, in floats.  Launches
// on `stream` and does not synchronise.  Returns the CUDA error code (0 on
// success).
int heat_fft_stage_f32(const void* a_re, const void* a_im, int64_t lda, int64_t es_in, int64_t mb, int64_t bs,
                       int64_t K, int64_t M, int64_t n, const void* w, void* o_re, void* o_im, int64_t ldo,
                       int64_t es_out, void* stream) {
  if (K < 1 || M < 1 || n < 1 || mb < 1 || bs < 0 || lda < 1 || (es_in != 1 && es_in != 2) ||
      (es_out != 1 && es_out != 2))
    return (int)cudaErrorInvalidValue;
  if (((n + kBN - 1) / kBN) * ((M + kBM - 1) / kBM) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* ar = static_cast<const float*>(a_re);
  const float* ai = static_cast<const float*>(a_im);
  const float* wp = static_cast<const float*>(w);
  float* orp = static_cast<float*>(o_re);
  float* oip = static_cast<float*>(o_im);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (es_in == 1 && es_out == 1) return (int)launch<1, 1>(ar, ai, lda, mb, bs, K, M, n, wp, orp, oip, ldo, s);
  if (es_in == 1) return (int)launch<1, 2>(ar, ai, lda, mb, bs, K, M, n, wp, orp, oip, ldo, s);
  if (es_out == 1) return (int)launch<2, 1>(ar, ai, lda, mb, bs, K, M, n, wp, orp, oip, ldo, s);
  return (int)launch<2, 2>(ar, ai, lda, mb, bs, K, M, n, wp, orp, oip, ldo, s);
}

}  // extern "C"
