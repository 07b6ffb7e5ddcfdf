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
// What bounds it: at (2^19, 1024) complex the rows are 4.3 GB in and 4.3 GB
// out (2.56 ms at 3.35 TB/s), while stage B is an n1-point DFT as a dense
// product, 8 n n1 flops a row: 5.5e11 flops.  Stage B runs on the tensor
// cores in 3xTF32 (tf32x3.cuh), whose floor at the card's 495 TF32 TFLOP/s is
// 3.33 ms; the design it replaces multiplied in f32 on the CUDA cores (floor
// 8.77 ms).  So the operations bound it, with the bytes close behind.  What
// the design does:
//   - A block of 8 warps owns up to 64 (n1 > 64), 128 (n1 > 32) or 256 rows
//     of stage B, (batch rows) x n2, so that the warps tile the (rows, n1)
//     product as 32 x 32 each: the smaller n1, the more rows share each step
//     of W_n1.  Two blocks share an SM, so one block's reads and writes
//     overlap the other's products.
//   - Stage A and the twiddle on the CUDA cores, in registers: a thread owns
//     a column (row b, j1), reads its n2 values straight from device memory
//     (neighbouring threads on neighbouring j1; a complex64 input as 8-byte
//     (re, im) pairs), and writes Y into shared memory in the layout the
//     fragments want, rows padded to 4 mod 32 floats.  The stage-A
//     constants sit in shared memory, the twiddle is read through L1.
//   - Stage B, Y (rows x n1) W_n1 (n1 x n1, complex), on the tensor cores with
//     mma.sync m16n8k8 in 3xTF32, both operands split in registers as their
//     fragments are loaded.  W_n1 (at most 128 KB of re and im, in L2)
//     streams through a ring of 3 cp.async stages of 8 rows, rows padded to
//     8 mod 32; its first two stages are in flight while stage A runs.  Each
//     k8 step's complex product is summed from zero and added in IEEE f32
//     (tf32x3::cmma3).  Splitting W_n1 where it lands instead (a 2-stage
//     ring, to keep two blocks an SM) measured slower on the card, and so
//     did stage B with wgmma (fft_stage.cu's design: one block an SM, so
//     no block's reads overlap another's products).
//   - n1 need not be a multiple of 8 (127, 125, 6): the depth and the bins
//     are padded to n1p, a multiple of 8, with zeros in both operands (Y's
//     pad columns written as zeros, W's pad rows and columns copied as
//     zeros), and the stores are masked.
//   - The result goes back to shared memory at its final position k2 + n2 k1
//     before the store, so the store is coalesced (8-byte (re, im) pairs
//     into a complex64 result).
//   - No atomics: each output is summed by one thread in a fixed order, so a
//     second launch is bitwise equal to the first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 8;  // rows of W_n1 per ring stage
constexpr int kStages = 3;
constexpr int kMaxN1 = 128;

enum : int { kWVec = 1, kPairIn = 2, kPairOut = 4 };

// the shape of a block's work for a given n1
struct Tile {
  int n1p;     // n1 rounded up to a multiple of 8
  int warps_n; // warps across the bins (32 each)
  int rows;    // stage-B rows the warps cover: 32 * kWarps / warps_n
  int ys;      // Y row stride, 4 mod 32 floats
  int ws;      // W_n1 ring row stride, 8 mod 32 floats
};

__host__ __device__ inline Tile tile_of(int n1) {
  Tile t;
  t.n1p = (n1 + 7) / 8 * 8;
  t.warps_n = t.n1p <= 32 ? 1 : t.n1p <= 64 ? 2 : 4;
  t.rows = 32 * kWarps / t.warps_n;
  t.ys = (t.n1p - 4 + 31) / 32 * 32 + 4;
  t.ws = (t.n1p - 8 + 31) / 32 * 32 + 8;
  return t;
}

__host__ __device__ inline int batch_rows(int n1, int n2) { return tile_of(n1).rows / n2; }

size_t smem_bytes(int n1) {
  const Tile t = tile_of(n1);
  return sizeof(float) * (2 * (size_t)t.rows * t.ys + (size_t)kStages * 2 * kBK * t.ws + 2 * 64);
}

template <int N2, bool kIm>
__global__ void __launch_bounds__(kThreads, 2)
axis_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im, int64_t es_in, int64_t B, int n1,
            const float* __restrict__ c2re, const float* __restrict__ c2im, const float* __restrict__ twr,
            const float* __restrict__ twi, const float* __restrict__ w1re, const float* __restrict__ w1im,
            float* __restrict__ o_re, float* __restrict__ o_im, int64_t es_out, int flags) {
  extern __shared__ __align__(16) float smem[];
  const Tile tl = tile_of(n1);
  const int n1p = tl.n1p, ys = tl.ys, ws = tl.ws;
  const int TB = tl.rows / N2;  // batch rows of this block
  const int R = TB * N2;        // stage-B rows in use
  const int n = N2 * n1;
  float* y_re = smem;
  float* y_im = y_re + tl.rows * ys;
  float* ring = y_im + tl.rows * ys;
  float* c_re = ring + kStages * 2 * kBK * ws;  // the stage-A constants
  float* c_im = c_re + N2 * N2;

  const int tid = threadIdx.x;
  const int64_t b0 = (int64_t)blockIdx.x * TB;

  // W_n1 rows [8 s, 8 s + 8) into ring stage buf, re then im
  const bool w_vec = flags & kWVec;
  auto load_w = [&](int s, int buf) {
    const int kb = s * kBK;
    float* sw = ring + buf * 2 * kBK * ws;
    if (w_vec) {
      const int groups = n1p / 4;
      for (int idx = tid; idx < kBK * groups; idx += kThreads) {
        const int j = idx / groups, c = 4 * (idx % groups);
        const int left = n1 - c;
        const uint32_t bytes = kb + j < n1 ? 4u * (left > 4 ? 4 : left) : 0u;
        const int64_t off = bytes ? (int64_t)(kb + j) * n1 + c : 0;
        tf32x3::cp16(sw + j * ws + c, w1re + off, bytes);
        tf32x3::cp16(sw + kBK * ws + j * ws + c, w1im + off, bytes);
      }
    } else {
      for (int idx = tid; idx < kBK * n1p; idx += kThreads) {
        const int j = idx / n1p, c = idx % n1p;
        const uint32_t bytes = kb + j < n1 && c < n1 ? 4u : 0u;
        const int64_t off = bytes ? (int64_t)(kb + j) * n1 + c : 0;
        tf32x3::cp4(sw + j * ws + c, w1re + off, bytes);
        tf32x3::cp4(sw + kBK * ws + j * ws + c, w1im + off, bytes);
      }
    }
  };
  const int steps = n1p / kBK;
  load_w(0, 0);
  tf32x3::commit();
  if (steps > 1) load_w(1, 1);
  tf32x3::commit();
  if (tid < N2 * N2) {
    c_re[tid] = __ldg(c2re + tid);
    c_im[tid] = __ldg(c2im + tid);
  }
  __syncthreads();

  // stage A and the twiddle: a thread owns the column (b, j1); rows past B are
  // zeros and are never stored
  const bool pair_in = kIm && (flags & kPairIn);
  for (int col = tid; col < TB * n1; col += kThreads) {
    const int b = col / n1, j1 = col - b * n1;
    const int64_t gb = b0 + b;
    float vr[N2], vi[N2];
#pragma unroll
    for (int j2 = 0; j2 < N2; ++j2) {
      vr[j2] = 0.f;
      vi[j2] = 0.f;
      if (gb < B) {
        const int64_t e = gb * n + j1 + n1 * j2;
        if (pair_in) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(in_re + 2 * e));
          vr[j2] = v.x;
          vi[j2] = v.y;
        } else {
          vr[j2] = __ldg(in_re + e * es_in);
          if (kIm) vi[j2] = __ldg(in_im + e * es_in);
        }
      }
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
      const float tr = __ldg(twr + k2 * n1 + j1), ti = __ldg(twi + k2 * n1 + j1);
      const int at = (b * N2 + k2) * ys + j1;
      y_re[at] = ar * tr - ai * ti;
      y_im[at] = ar * ti + ai * tr;
    }
  }
  // the depth pad: Y's columns [n1, n1p) are zeros (W's pad rows arrive as zeros)
  for (int idx = tid; idx < R * (n1p - n1); idx += kThreads) {
    const int rho = idx / (n1p - n1), c = n1 + idx % (n1p - n1);
    y_re[rho * ys + c] = 0.f;
    y_im[rho * ys + c] = 0.f;
  }

  // stage B: Z[rho, k1] = sum_j1 Y[rho, j1] W[j1, k1]; warp (wr, wc) owns rows
  // 32 wr + [0, 32) and bins 32 wc + [0, 32)
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wc = warp % tl.warps_n, wr = warp / tl.warps_n;
  const int row0 = 32 * wr, bin0 = 32 * wc;
  float acc_re[2][4][4], acc_im[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_re[mt][nt][e] = 0.f;
        acc_im[mt][nt][e] = 0.f;
      }
  for (int s = 0; s < steps; ++s) {
    const int buf = s % kStages;
    tf32x3::wait<1>();
    __syncthreads();  // stage s of the ring is in (and, at s = 0, all of Y)
    if (s + 2 < steps) load_w(s + 2, (s + 2) % kStages);
    tf32x3::commit();
    const float* sw = ring + buf * 2 * kBK * ws;
    const int kb = s * kBK;
    uint32_t rb[2][4], rs[2][4], ib[2][4], is[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      if (row0 + 16 * mt >= R) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = (row0 + 16 * mt + g + 8 * (e & 1)) * ys + kb + t + 4 * (e >> 1);
        tf32x3::split(y_re[at], rb[mt][e], rs[mt][e]);
        tf32x3::split(y_im[at], ib[mt][e], is[mt][e]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = bin0 + 8 * nt;
      if (col >= n1p) continue;
      const float* p = sw + t * ws + col + g;
      uint32_t wrb0, wrs0, wrb1, wrs1, wib0, wis0, wib1, wis1;
      tf32x3::split(p[0], wrb0, wrs0);
      tf32x3::split(p[4 * ws], wrb1, wrs1);
      tf32x3::split(p[kBK * ws], wib0, wis0);
      tf32x3::split(p[kBK * ws + 4 * ws], wib1, wis1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (row0 + 16 * mt >= R) continue;
        tf32x3::cmma3(acc_re[mt][nt], acc_im[mt][nt], rb[mt], rs[mt], ib[mt], is[mt], wrb0, wrb1, wrs0, wrs1, wib0,
                      wib1, wis0, wis1);
      }
    }
  }
  tf32x3::wait<0>();
  __syncthreads();  // Y is read by all; its room takes the result

  // the result at its final position k = k2 + n2 k1 of row b
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rho = row0 + 16 * mt + g + 8 * h;
        if (rho >= R) continue;
        const int b = rho / N2, k2 = rho - b * N2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k1 = bin0 + 8 * nt + 2 * t + e;
          if (k1 >= n1) continue;
          const int pos = b * n + k2 + N2 * k1;
          y_re[pos] = acc_re[mt][nt][2 * h + e];
          y_im[pos] = acc_im[mt][nt][2 * h + e];
        }
      }
  __syncthreads();
  const bool pair_out = flags & kPairOut;
  for (int idx = tid; idx < TB * n; idx += kThreads) {
    const int b = idx / n, j = idx - b * n;
    const int64_t gb = b0 + b;
    if (gb >= B) continue;
    const int64_t e = gb * n + j;
    if (pair_out) {
      *reinterpret_cast<float2*>(o_re + 2 * e) = make_float2(y_re[idx], y_im[idx]);
    } else {
      o_re[e * es_out] = y_re[idx];
      o_im[e * es_out] = y_im[idx];
    }
  }
}

template <int N2, bool kIm>
cudaError_t launch(const float* in_re, const float* in_im, int64_t es_in, int64_t B, int n1, const float* c2re,
                   const float* c2im, const float* twr, const float* twi, const float* w1re, const float* w1im,
                   float* o_re, float* o_im, int64_t es_out, int flags, cudaStream_t s) {
  const size_t smem = smem_bytes(n1);
  cudaError_t err = cudaFuncSetAttribute(axis_kernel<N2, kIm>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = batch_rows(n1, N2);
  const int64_t blocks = (B + rows - 1) / rows;
  axis_kernel<N2, kIm><<<(unsigned)blocks, kThreads, smem, s>>>(in_re, in_im, es_in, B, n1, c2re, c2im, twr, twi,
                                                                w1re, w1im, o_re, o_im, es_out, flags);
  return cudaGetLastError();
}

template <int N2>
cudaError_t launch_n2(const float* in_re, const float* in_im, int64_t es_in, int64_t B, int n1, const float* c2re,
                      const float* c2im, const float* twr, const float* twi, const float* w1re, const float* w1im,
                      float* o_re, float* o_im, int64_t es_out, int flags, cudaStream_t s) {
  if (in_im != nullptr)
    return launch<N2, true>(in_re, in_im, es_in, B, n1, c2re, c2im, twr, twi, w1re, w1im, o_re, o_im, es_out, flags,
                            s);
  return launch<N2, false>(in_re, in_im, es_in, B, n1, c2re, c2im, twr, twi, w1re, w1im, o_re, o_im, es_out, flags,
                           s);
}

bool aligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

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
  const int rows = batch_rows((int)n1, (int)n2);
  if ((B + rows - 1) / rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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
  int flags = 0;
  if (n1 % 4 == 0 && aligned(e, 16) && aligned(f, 16)) flags |= kWVec;
  if (ii != nullptr && es_in == 2 && ii == ir + 1 && aligned(ir, 8)) flags |= kPairIn;
  if (es_out == 2 && oip == orp + 1 && aligned(orp, 8)) flags |= kPairOut;
  const int m = (int)n1;
  switch (n2) {
    case 1: return (int)launch_n2<1>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, flags, s);
    case 2: return (int)launch_n2<2>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, flags, s);
    case 3: return (int)launch_n2<3>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, flags, s);
    case 4: return (int)launch_n2<4>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, flags, s);
    case 5: return (int)launch_n2<5>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, flags, s);
    case 6: return (int)launch_n2<6>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, flags, s);
    case 7: return (int)launch_n2<7>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, flags, s);
    default: return (int)launch_n2<8>(ir, ii, es_in, B, m, a, b, c, d, e, f, orp, oip, es_out, flags, s);
  }
}

}  // extern "C"
