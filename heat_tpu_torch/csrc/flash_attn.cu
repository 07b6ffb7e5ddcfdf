// Forward flash attention, float32, for sm_90a.
//
// Replaces the TPU kernel that heat_tpu/nn/attention.py::_local_flash calls,
// JAX's packaged jax.experimental.pallas.ops.tpu.flash_attention (forward):
//
//   out[q, h, :] = sum_k softmax_k(scale * <q_h, k_h>) v[k, h, :]
//
// over the keys k that query q may attend: (q < n_true) == (k < n_true) (the
// segment ids that isolate the padded tail) and, under causal, k <= q.
// Every row has at least one such key (itself), so padding rows come out as
// the TPU kernel's do.  q, k and v are (s, h, d) tensors read in place
// through their element strides; out is (s, h, d), contiguous.
//
// Bound on this card: the two products over the causal half, 2 s^2 h d
// FLOP; bytes (q, k, v and out once each) are far below them.  This first
// design keeps exact float32 on the CUDA cores (the TPU kernel multiplies in
// one bf16 pass): one block of 256 threads per (query tile of 64, head), the
// query tile transposed in shared memory, key and value tiles of 64 staged
// through shared memory, each thread holding a 4 x 4 patch of the score
// tile and a 4 x d/16 patch of the output.  A running max m and denominator
// l per row are rescaled per key tile (online softmax); the output is
// divided by l once at the end.  Key tiles wholly above the diagonal
// (causal), or wholly in the other segment, are skipped.  No atomics: a
// repeat is bitwise equal.  Query tiles are launched last-first, so under
// causal the longest rows start first.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // queries per block
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;   // 16 x 16: ty picks 4 queries, tx 4 keys
constexpr int kLd = kBQ + 4;    // row length of the transposed tiles (floats)

template <int DP>
struct Layout {
  static constexpr int q = DP * kLd;   // Q^T, [DP][kLd]
  static constexpr int k = DP * kLd;   // K^T, [DP][kLd]
  static constexpr int v = kBK * DP;   // V, [kBK][DP]
  static constexpr int p = kBK * kLd;  // P^T, [kBK][kLd]
  static constexpr int bytes = 4 * (q + k + v + p);
  static constexpr int cols = DP / 16; // output columns per thread
};

// the output column of a thread's e-th accumulator: groups of four
// neighbouring columns (one float4) where d allows it
template <int DP>
__device__ __forceinline__ int out_col(int tx, int e) {
  constexpr int cols = Layout<DP>::cols;
  if constexpr (cols >= 4) {
    return (e / 4) * 64 + tx * 4 + (e % 4);
  } else {
    return tx * cols + e;
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_fwd(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int64_t s, int64_t h, int d,
    int64_t qs, int64_t qh, int64_t qd, int64_t ks, int64_t kh, int64_t kd,
    int64_t vs, int64_t vh, int64_t vd, float scale, int64_t n_true, int causal) {
  using L = Layout<DP>;
  constexpr int kCols = L::cols;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + L::q;
  float* Vs = Kt + L::k;
  float* Pt = Vs + L::v;

  const int64_t tiles = (s + kBQ - 1) / kBQ;
  const int64_t tile = tiles - 1 - static_cast<int64_t>(blockIdx.x) / h;
  const int64_t head = static_cast<int64_t>(blockIdx.x) % h;
  const int64_t q0 = tile * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const float* qh_ = q + head * qh;
  const float* kh_ = k + head * kh;
  const float* vh_ = v + head * vh;

  for (int idx = tid; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    const int64_t row = q0 + r;
    Qt[c * kLd + r] = (row < s && c < d) ? qh_[row * qs + c * qd] : 0.f;
  }

  // the key tiles this query tile needs
  const int64_t q_last = (q0 + kBQ < s ? q0 + kBQ : s) - 1;
  int64_t k_begin = 0;
  int64_t k_end = causal ? q_last + 1 : s;
  if (q_last < n_true) {
    k_end = k_end < n_true ? k_end : n_true;  // real queries attend no padding
  } else if (q0 >= n_true) {
    k_begin = (n_true / kBK) * kBK;  // padding attends no real key
  }

  float m[4], l[4], o[4][kCols];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) o[a][e] = 0.f;
  }
  const int64_t i0 = q0 + ty * 4;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the last tile's K, V and P are read
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      const int64_t row = k0 + r;
      const bool in = row < s && c < d;
      Kt[c * kLd + r] = in ? kh_[row * ks + c * kd] : 0.f;
      Vs[r * DP + c] = in ? vh_[row * vs + c * vd] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sc[a][b] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + c * kLd + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(Kt + c * kLd + tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) sc[a][b] = fmaf(qv[a], kv[b], sc[a][b]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int64_t i = i0 + a;
      const bool q_pad = i >= n_true;
      float mx = -INFINITY;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int64_t j = k0 + tx * 4 + b;
        const bool ok = j < s && ((j >= n_true) == q_pad) && (!causal || j <= i);
        sc[a][b] = ok ? sc[a][b] * scale : -INFINITY;
        mx = fmaxf(mx, sc[a][b]);
      }
      // the 16 threads of a row are one half-warp: lanes differing in tx
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet adds nothing
      const float corr = expf(m[a] - base);
      float rs = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        sc[a][b] = expf(sc[a][b] - base);
        rs += sc[a][b];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = l[a] * corr + rs;
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e) o[a][e] *= corr;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      *reinterpret_cast<float4*>(Pt + (tx * 4 + b) * kLd + ty * 4) =
          make_float4(sc[0][b], sc[1][b], sc[2][b], sc[3][b]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(Pt + j * kLd + ty * 4);
      const float pv[4] = {pj.x, pj.y, pj.z, pj.w};
      const float* vrow = Vs + j * DP;
      if constexpr (kCols >= 4) {
#pragma unroll
        for (int g = 0; g < kCols / 4; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + g * 64 + tx * 4);
          const float vs4[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[a][g * 4 + e] = fmaf(pv[a], vs4[e], o[a][g * 4 + e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const float ve = vrow[tx * kCols + e];
#pragma unroll
          for (int a = 0; a < 4; ++a) o[a][e] = fmaf(pv[a], ve, o[a][e]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int64_t i = i0 + a;
    if (i >= s) continue;
    float* orow = out + (i * h + head) * d;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int c = out_col<DP>(tx, e);
      if (c < d) orow[c] = o[a][e] / l[a];
    }
  }
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, int64_t s, int64_t h, int d,
                   const int64_t* st, float scale, int64_t n_true, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<DP>::bytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (s + kBQ - 1) / kBQ * h;
  flash_fwd<DP><<<static_cast<unsigned>(blocks), kThreads, Layout<DP>::bytes, stream>>>(
      q, k, v, out, s, h, d, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, n_true,
      causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: (s, h, d) float32 with element strides (qs, qh, qd, ks, kh, kd,
// vs, vh, vd); out: (s, h, d) float32, contiguous.  1 <= d <= 256 and
// ceil(s / 64) * h < 2^31 (the wrapper's gate).  Returns the CUDA error of
// the launch (0 on success); does not synchronise.
int heat_flash_attn_f32(const float* q, const float* k, const float* v, float* out, int64_t s, int64_t h,
                        int64_t d, int64_t qs, int64_t qh, int64_t qd, int64_t ks, int64_t kh, int64_t kd,
                        int64_t vs, int64_t vh, int64_t vd, float scale, int64_t n_true, int causal,
                        void* stream) {
  const int64_t st[9] = {qs, qh, qd, ks, kh, kd, vs, vh, vd};
  const int dd = static_cast<int>(d);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (d <= 16) return launch<16>(q, k, v, out, s, h, dd, st, scale, n_true, causal, cs);
  if (d <= 32) return launch<32>(q, k, v, out, s, h, dd, st, scale, n_true, causal, cs);
  if (d <= 64) return launch<64>(q, k, v, out, s, h, dd, st, scale, n_true, causal, cs);
  if (d <= 128) return launch<128>(q, k, v, out, s, h, dd, st, scale, n_true, causal, cs);
  return launch<256>(q, k, v, out, s, h, dd, st, scale, n_true, causal, cs);
}

}  // extern "C"
