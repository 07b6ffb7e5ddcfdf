// Combine of the raw exit products plus the Hermitian extension of a real 3-D
// FFT, for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel heat_tpu/fft/_leading.py::_ext_fused_kernel_factory
// (entry _ext_fused_pallas), the last step of the real 3-D fftn.  Its inputs
// are the exit stage's raw products zr, zi of shape (m, n1, 2 n2) (re bins in
// columns [0, n2), im bins in [n2, 2 n2)) and the Nyquist planes nyr, nyi
// (n1, n2); its output the full (n0 = 2m, n1, n2) spectrum:
//   rows p < m   the combined half spectrum  re = zr[.., k] - zi[.., n2 + k],
//                                           im = zr[.., n2 + k] + zi[.., k];
//   row  p = m   the Nyquist plane;
//   rows p > m   source row n0 - p with both trailing axes mapped
//                k -> (n - k) % n and im negated.
// The TPU kernel reversed the trailing axes through bf16 permutation matrix
// products, because its compiler could not lower the reversal; here it is an
// exact indexed copy.
//
// What bounds it: bytes.  At 512^3 it must read 1.07 GB and write 1.07 GB
// (0.64 ms at 3.35 TB/s) and does no arithmetic to speak of.  What the design
// does:
//   - One thread per source element (p, i, k) with p <= m: it reads the four
//     values of its bin once, writes row p and, for 0 < p < m, the mirrored
//     element of row n0 - p.  Every input is read once and every output
//     written once.
//   - Neighbouring threads take neighbouring k, so reads are coalesced and
//     the mirrored writes of a warp land, reversed, in the same sectors.
//   - The output may be two planes or one complex64 tensor (element stride
//     2), which is the result fftn returns: no interleave pass follows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int kEsOut>
__global__ void __launch_bounds__(kThreads)
ext_kernel(const float* __restrict__ zr, const float* __restrict__ zi, const float* __restrict__ nyr,
           const float* __restrict__ nyi, int64_t m, int64_t n1, int64_t n2, float* __restrict__ o_re,
           float* __restrict__ o_im) {
  const int64_t q = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t plane = n1 * n2;
  if (q >= (m + 1) * plane) return;
  const int64_t k = q % n2;
  const int64_t i = (q / n2) % n1;
  const int64_t p = q / plane;
  if (p == m) {
    const int64_t o = (m * plane + i * n2 + k) * kEsOut;
    o_re[o] = nyr[i * n2 + k];
    o_im[o] = nyi[i * n2 + k];
    return;
  }
  const int64_t src = (p * n1 + i) * 2 * n2;
  const float re = zr[src + k] - zi[src + n2 + k];
  const float im = zr[src + n2 + k] + zi[src + k];
  const int64_t o = (p * plane + i * n2 + k) * kEsOut;
  o_re[o] = re;
  o_im[o] = im;
  if (p > 0) {
    const int64_t pm = 2 * m - p;
    const int64_t im2 = i == 0 ? 0 : n1 - i;
    const int64_t km = k == 0 ? 0 : n2 - k;
    const int64_t om = (pm * plane + im2 * n2 + km) * kEsOut;
    o_re[om] = re;
    o_im[om] = -im;
  }
}

}  // namespace

extern "C" {

// The full (2m, n1, n2) spectrum from the raw exit products zr, zi (m, n1,
// 2 n2) and the Nyquist planes nyr, nyi (n1, n2), all contiguous f32.  o_re /
// o_im point at output element (0, 0, 0) and es_out (1 or 2) is the element
// stride in floats.  Launches on `stream` and does not synchronise.  Returns
// the CUDA error code (0 on success).
int heat_fft_ext_f32(const void* zr, const void* zi, const void* nyr, const void* nyi, int64_t m, int64_t n1,
                     int64_t n2, void* o_re, void* o_im, int64_t es_out, void* stream) {
  if (m < 1 || n1 < 1 || n2 < 1 || (es_out != 1 && es_out != 2)) return (int)cudaErrorInvalidValue;
  const int64_t blocks = ((m + 1) * n1 * n2 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(zr);
  const float* b = static_cast<const float*>(zi);
  const float* c = static_cast<const float*>(nyr);
  const float* d = static_cast<const float*>(nyi);
  float* ore = static_cast<float*>(o_re);
  float* oim = static_cast<float*>(o_im);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (es_out == 1)
    ext_kernel<1><<<(unsigned)blocks, kThreads, 0, s>>>(a, b, c, d, m, n1, n2, ore, oim);
  else
    ext_kernel<2><<<(unsigned)blocks, kThreads, 0, s>>>(a, b, c, d, m, n1, n2, ore, oim);
  return (int)cudaGetLastError();
}

}  // extern "C"
