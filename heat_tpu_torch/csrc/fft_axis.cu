// Fused last-axis DFT pass for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel heat_tpu/fft/_pallas_fft.py::_axis_pass_fn (its inner
// `kernel`, entry fused_axis_pass): the DFT of every row of a (batch, n) pair of
// planes, n = n1 * n2 with n1 <= 128 (the largest divisor of n up to 128) and
// n2 <= 8.  With the row read as x[j2, j1] (j = j1 + n1 j2) and the output index
// k = k2 + n2 k1:
//   stage A   Y[k2, j1] = sum_j2 x[j2, j1] W_n2^(j2 k2)     radix-n2 butterflies
//   twiddle   Y[k2, j1] *= W_n^(j1 k2)
//   stage B   X[k2 + n2 k1] = sum_j1 Y[k2, j1] W_n1^(j1 k1)  an n1-point DFT
// The constants are the reference's own (its _consts, as f32), the sign of the
// exponent (forward or inverse) is in them.  The TPU kernel left its result in
// (k2, k1) order and transposed it outside; this kernel writes X in its final
// order.  A real input (no imaginary plane) reads one plane only.
//
// What bounds it: the arithmetic.  At (2^19, 1024) complex the rows are 4.3 GB
// in and 4.3 GB out (2.6 ms at 3.35 TB/s), while stage B is an n1-point DFT as
// a dense product, 8 n n1 flops a row: 5.5e11 flops, 8.2 ms at the CUDA cores'
// 67 TFLOP/s in f32.  This first kernel is right and simple first; moving stage
// B onto the tensor cores (3xTF32) is a later change.  What the design does:
//   - One block per tile of 64 / n2 rows, so that stage B multiplies a
//     (64, n1) tile.  The tile is read from device memory once, coalesced,
//     into shared memory, and written once, coalesced, from shared memory.
//   - Stage A and the twiddle in registers: a thread owns a column (row b,
//     j1), reads its n2 values, and writes the n2 results back in place.
//   - Stage B from shared memory: the W_n1 matrix streams through in steps
//     of 16 rows (it stays in L2); each thread keeps a 4 x 8 block of the
//     (64, n1) result, both planes, in registers.
//   - The result goes back to shared memory at its final position k2 + n2 k1
//     before the store, so the store is coalesced.
//   - No atomics: each output is summed by one thread in a fixed order, so a
//     second launch is bitwise equal to the first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;  // rows of stage B per block: (64 / n2) batch rows x n2
constexpr int kBK = 16;    // rows of W_n1 per shared-memory step
constexpr int kMaxN1 = 128;

template <int N2>
size_t smem_floats(int n1) {
  const size_t n = (size_t)N2 * n1;
  return 2 * (size_t)(kRows / N2) * n + 2 * (size_t)kBK * n1 + 2 * n + 2 * N2 * N2;
}

template <int N2, bool kIm>
__global__ void __launch_bounds__(kThreads)
axis_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im, int64_t es_in, int64_t B, int n1,
            const float* __restrict__ c2re, const float* __restrict__ c2im, const float* __restrict__ twr,
            const float* __restrict__ twi, const float* __restrict__ w1re, const float* __restrict__ w1im,
            float* __restrict__ o_re, float* __restrict__ o_im, int64_t es_out) {
  constexpr int TB = kRows / N2;
  constexpr int R = TB * N2;
  extern __shared__ __align__(16) float smem[];
  const int n = N2 * n1;
  float* xs_re = smem;
  float* xs_im = xs_re + TB * n;
  float* wc_re = xs_im + TB * n;
  float* wc_im = wc_re + kBK * n1;
  float* tw_re = wc_im + kBK * n1;
  float* tw_im = tw_re + n;
  float* c_re = tw_im + n;
  float* c_im = c_re + N2 * N2;

  const int tid = threadIdx.x;
  const int64_t b0 = (int64_t)blockIdx.x * TB;

  // the tile, read once; rows past B are zeros and are never stored
  for (int idx = tid; idx < TB * n; idx += kThreads) {
    const int b = idx / n, j = idx - b * n;
    const int64_t gb = b0 + b;
    float vr = 0.f, vi = 0.f;
    if (gb < B) {
      const int64_t off = (gb * n + j) * es_in;
      vr = __ldg(in_re + off);
      if (kIm) vi = __ldg(in_im + off);
    }
    xs_re[idx] = vr;
    xs_im[idx] = vi;
  }
  for (int idx = tid; idx < n; idx += kThreads) {
    tw_re[idx] = __ldg(twr + idx);
    tw_im[idx] = __ldg(twi + idx);
  }
  if (tid < N2 * N2) {
    c_re[tid] = __ldg(c2re + tid);
    c_im[tid] = __ldg(c2im + tid);
  }
  __syncthreads();

  // stage A and the twiddle: a thread owns the column (b, j1)
  for (int col = tid; col < TB * n1; col += kThreads) {
    const int b = col / n1, j1 = col - b * n1;
    const int base = b * n + j1;
    float vr[N2], vi[N2];
#pragma unroll
    for (int j2 = 0; j2 < N2; ++j2) {
      vr[j2] = xs_re[base + j2 * n1];
      vi[j2] = xs_im[base + j2 * n1];
    }
#pragma unroll
    for (int k2 = 0; k2 < N2; ++k2) {
      float ar = 0.f, ai = 0.f;
#pragma unroll
      for (int j2 = 0; j2 < N2; ++j2) {
        const float cr = c_re[j2 * N2 + k2], ci = c_im[j2 * N2 + k2];
        ar += vr[j2] * cr - vi[j2] * ci;
        ai += vr[j2] * ci + vi[j2] * cr;
      }
      const float tr = tw_re[k2 * n1 + j1], ti = tw_im[k2 * n1 + j1];
      xs_re[base + k2 * n1] = ar * tr - ai * ti;
      xs_im[base + k2 * n1] = ar * ti + ai * tr;
    }
  }
  __syncthreads();

  // stage B: Z[rho, k1] = sum_j1 Y[rho, j1] W[j1, k1], rho = b n2 + k2, Y at
  // xs[rho * n1 + j1]; thread (ty, tx) owns rows ty + 16 i and bins tx + 16 c
  const int ty = tid / 16, tx = tid % 16;
  int rr[4], kc[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) rr[i] = min(ty + 16 * i, R - 1);
#pragma unroll
  for (int c = 0; c < 8; ++c) kc[c] = min(tx + 16 * c, n1 - 1);
  float acc_re[4][8], acc_im[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc_re[i][c] = 0.f;
      acc_im[i][c] = 0.f;
    }
  for (int j0 = 0; j0 < n1; j0 += kBK) {
    const int depth = min(kBK, n1 - j0);
    for (int idx = tid; idx < depth * n1; idx += kThreads) {
      wc_re[idx] = __ldg(w1re + (int64_t)j0 * n1 + idx);
      wc_im[idx] = __ldg(w1im + (int64_t)j0 * n1 + idx);
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < depth; ++jj) {
      const int j = j0 + jj;
      float yr[4], yi[4], wr[8], wi[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        yr[i] = xs_re[rr[i] * n1 + j];
        yi[i] = xs_im[rr[i] * n1 + j];
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        wr[c] = wc_re[jj * n1 + kc[c]];
        wi[c] = wc_im[jj * n1 + kc[c]];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc_re[i][c] = fmaf(yr[i], wr[c], acc_re[i][c]);
          acc_re[i][c] = fmaf(-yi[i], wi[c], acc_re[i][c]);
          acc_im[i][c] = fmaf(yr[i], wi[c], acc_im[i][c]);
          acc_im[i][c] = fmaf(yi[i], wr[c], acc_im[i][c]);
        }
    }
    __syncthreads();  // wc is refilled, and after the last step xs is overwritten
  }

  // the result at its final position k = k2 + n2 k1 of row b
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rho = ty + 16 * i;
    if (rho >= R) continue;
    const int b = rho / N2, k2 = rho - b * N2;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int k1 = tx + 16 * c;
      if (k1 >= n1) continue;
      const int pos = b * n + k2 + N2 * k1;
      xs_re[pos] = acc_re[i][c];
      xs_im[pos] = acc_im[i][c];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < TB * n; idx += kThreads) {
    const int b = idx / n, j = idx - b * n;
    const int64_t gb = b0 + b;
    if (gb >= B) continue;
    const int64_t off = (gb * n + j) * es_out;
    o_re[off] = xs_re[idx];
    o_im[off] = xs_im[idx];
  }
}

template <int N2, bool kIm>
cudaError_t launch(const float* in_re, const float* in_im, int64_t es_in, int64_t B, int n1, const float* c2re,
                   const float* c2im, const float* twr, const float* twi, const float* w1re, const float* w1im,
                   float* o_re, float* o_im, int64_t es_out, cudaStream_t s) {
  const size_t smem = smem_floats<N2>(n1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(axis_kernel<N2, kIm>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (B + kRows / N2 - 1) / (kRows / N2);
  axis_kernel<N2, kIm><<<(unsigned)blocks, kThreads, smem, s>>>(in_re, in_im, es_in, B, n1, c2re, c2im, twr, twi,
                                                                w1re, w1im, o_re, o_im, es_out);
  return cudaGetLastError();
}

template <int N2>
cudaError_t launch_n2(const float* in_re, const float* in_im, int64_t es_in, int64_t B, int n1, const float* c2re,
                      const float* c2im, const float* twr, const float* twi, const float* w1re, const float* w1im,
                      float* o_re, float* o_im, int64_t es_out, cudaStream_t s) {
  if (in_im != nullptr)
    return launch<N2, true>(in_re, in_im, es_in, B, n1, c2re, c2im, twr, twi, w1re, w1im, o_re, o_im, es_out, s);
  return launch<N2, false>(in_re, in_im, es_in, B, n1, c2re, c2im, twr, twi, w1re, w1im, o_re, o_im, es_out, s);
}

}  // namespace

extern "C" {

// The DFT of every row of a (B, n1 * n2) plane pair, 2 <= n1 <= 128,
// 1 <= n2 <= 8.  in_re / in_im point at element (0, 0) of the planes, es_in
// (1 or 2) is the element stride in floats; in_im may be NULL for a real
// input.  c2re / c2im are the (n2, n2) stage-A constants [j2][k2], twr / twi
// the (n2, n1) twiddle [k2][j1], w1re / w1im the (n1, n1) stage-B matrix, all
// contiguous f32.  o_re / o_im point at output element (0, 0) with element
// stride es_out (1 or 2), X in the order k = k2 + n2 k1.  Launches on `stream`
// and does not synchronise.  Returns the CUDA error code (0 on success).
int heat_fft_axis_f32(const void* in_re, const void* in_im, int64_t es_in, int64_t B, int64_t n1, int64_t n2,
                      const void* c2re, const void* c2im, const void* twr, const void* twi, const void* w1re,
                      const void* w1im, void* o_re, void* o_im, int64_t es_out, void* stream) {
  if (B < 1 || n1 < 2 || n1 > kMaxN1 || n2 < 1 || n2 > 8 || (es_in != 1 && es_in != 2) ||
      (es_out != 1 && es_out != 2))
    return (int)cudaErrorInvalidValue;
  if ((B + kRows / n2 - 1) / (kRows / n2) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* ir = static_cast<const float*>(in_re);
  const float* ii = static_cast<const float*>(in_im);
  const float* a = static_cast<const float*>(c2re);
  const float* b = static_cast<const float*>(c2im);
  const float* c = static_cast<const float*>(twr);
  const float* d = static_cast<const float*>(twi);
  const float* e = static_cast<const float*>(w1re);
  const float* f = static_cast<const float*>(w1im);
  float* orp = static_cast<float*>(o_re);
  float* oip = static_cast<float*>(o_im);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)n1;
  switch (n2) {
    case 1: return (int)launch_n2<1>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, s);
    case 2: return (int)launch_n2<2>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, s);
    case 3: return (int)launch_n2<3>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, s);
    case 4: return (int)launch_n2<4>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, s);
    case 5: return (int)launch_n2<5>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, s);
    case 6: return (int)launch_n2<6>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, s);
    case 7: return (int)launch_n2<7>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, s);
    default: return (int)launch_n2<8>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, s);
  }
}

}  // extern "C"
