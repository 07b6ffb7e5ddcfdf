// Threefry-2x32 over a range of counters, in one pass, for Hopper (sm_90a);
// plain C interface for ctypes.
//
// Not a port of a TPU kernel: the JAX package draws its random numbers with
// XLA's threefry (jax.random.uniform, heat_tpu/core/random.py:150), which the
// port's plain version (heat_tpu_torch/core/random.py::_threefry2x32)
// computes as about 130 torch passes over int32 tensors.  This kernel
// computes the same bits in registers and writes each result once.
//
// Counter i of [start, start + n) is hashed in JAX's partitionable layout:
// the words (i >> 32, i & 0xffffffff) under the key (k0, k1), 20 rounds with
// rotations (13, 15, 26, 6) / (17, 29, 16, 24) and a key injection after
// every four.  The kernel writes either both words (as int32 bit patterns) or
// the float32 uniform of jax.random.uniform before scaling:
// ((w0 ^ w1) >> 9 | 0x3F800000) as a float, minus 1.  Bitwise equal to the
// plain version.
//
// What bounds it: about 76 integer operations a counter (an add, a funnel
// shift and an xor in each of the 20 rounds, the key additions, the
// mantissa), at 64 32-bit integer lanes an SM; the float32 output is 4 bytes
// a counter, a quarter of that time at the HBM rate.  Each thread hashes four
// counters 256 apart (four independent chains in flight, and each store
// instruction of a warp writes 128 contiguous bytes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kPerBlock = kThreads * kPerThread;

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2, int r3) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3) ^ x0;
}

__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
}

// Writes the words into w0/w1 when uniform is null, else the float32 uniform.
__global__ void __launch_bounds__(kThreads) threefry_kernel(uint32_t k0, uint32_t k1, int64_t start, int64_t n,
                                                            uint32_t* __restrict__ w0, uint32_t* __restrict__ w1,
                                                            float* __restrict__ uniform) {
  const int64_t base = (int64_t)blockIdx.x * kPerBlock + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t e = base + j * kThreads;
    if (e >= n) break;
    const uint64_t i = (uint64_t)(start + e);
    uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
    threefry(k0, k1, x0, x1);
    if (uniform != nullptr) {
      uniform[e] = __uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u) - 1.0f;
    } else {
      w0[e] = x0;
      w1[e] = x1;
    }
  }
}

}  // namespace

extern "C" {

// Hash counters [start, start + n) under (k0, k1) on `stream` (no
// synchronise): both words into w0 and w1 (n uint32 each) when uniform is
// null, else the float32 uniform into uniform (n floats).  Returns the CUDA
// error code (0 on success).
int heat_threefry2x32(uint32_t k0, uint32_t k1, int64_t start, int64_t n, void* w0, void* w1, void* uniform,
                      void* stream) {
  if (n < 1 || start < 0 || (uniform == nullptr && (w0 == nullptr || w1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n + kPerBlock - 1) / kPerBlock;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  threefry_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      k0, k1, start, n, static_cast<uint32_t*>(w0), static_cast<uint32_t*>(w1), static_cast<float*>(uniform));
  return (int)cudaGetLastError();
}

}  // extern "C"
