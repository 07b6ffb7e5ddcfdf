// Backward of flash attention, float32, for sm_90a: three kernels, exact f32
// FMAs on the CUDA cores.
//
// Replaces the two backward TPU kernels of JAX's packaged flash attention,
// jax/experimental/pallas/ops/tpu/flash_attention.py, which
// heat_tpu/nn/attention.py::_local_flash reaches under jax.grad:
// _flash_attention_bwd_dkv (kernel _flash_attention_dkv_kernel) and
// _flash_attention_bwd_dq (kernel _flash_attention_dq_kernel), and the sum
// _flash_attention_bwd computes outside them:
//
//   di[h, i] = sum_c o[i, h, c] do[i, h, c]                       (flash_bwd_di)
//   P[i, j]  = exp(scale <q_i, k_j> - lse[h, i])  (0 where j is masked)
//   dP[i, j] = <do_i, v_j>,  dS = P o (dP - di)
//   dV = P^T dO,  dK = scale dS^T Q                               (flash_bwd_dkv)
//   dQ = scale dS K                                               (flash_bwd_dq)
//
// under the forward's masks: query i attends key j iff (i < n_true) ==
// (j < n_true) and, under causal, j <= i.  lse is the forward's log-sum-exp
// per (head, query) (flash_attn.cu writes it), so P is recomputed, never
// stored.  q, k, v and do are (s, h, d) tensors read in place through their
// element strides (do may have stride 0 where autograd expanded a scalar's
// gradient); dq, dk, dv are written contiguous (s, h, d).
//
// What bounds it: products, not bytes.  dkv takes four products over the
// attended pairs (S, dP, dV, dK) and dq three (S, dP, dQ): at (16384, 8, 64),
// causal, each product is 2 (s^2 / 2) d h = 1.37e11 FLOP, so the pair does
// seven (9.6e11 FLOP) where the least work is five: recomputing S and dP in
// both kernels is the price of having each block own its output rows.  On
// the CUDA cores (67 TFLOP/s f32) the seven cannot go under 14.4 ms; the
// bytes (q, k, v, o, do read once, three gradients written) are about 0.2 GB,
// 0.06 ms.  The design is the simple one:
//   - One block of 256 threads owns a tile of key rows (dkv) or of query rows
//     (dq) and loops over the other side's tiles, as the TPU kernels' grids
//     do; the gradient rows it owns stay in registers until the end.  No
//     atomics and a fixed order of every sum: a repeat is bitwise equal.
//   - Each tile is staged in shared memory with rows padded by one float, so
//     a warp's reads of a row (broadcast) and of 16 rows at one depth (one
//     bank each) are free of conflicts; the threads form a 16 x 16 grid and
//     each keeps a small block of every product (4 x 4 at d <= 64).
//   - P (dkv) and dS (both) pass through shared memory between the score
//     products and the output products; nothing but the gradients is
//     written to device memory.
//   - Head dimensions are padded to 64, 128 or 256 with zeros (templates);
//     at d > 128 the key tiles are 32 long, to fit 227 KB.
//   - Masks are applied element by element on every tile; under causal and
//     with a padded tail, the loops start and stop at the first and last
//     tile that holds an attended pair.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads

// rows [r0, r0 + T) of head `head` of the strided (s, h, d) tensor x into sm
// (T rows of DP + 1 floats), zeros past s and d
template <int T, int DP>
__device__ __forceinline__ void load_tile(float* sm, const float* __restrict__ x, int64_t r0, int64_t head, int64_t s,
                                          int d, int64_t xs, int64_t xh, int64_t xd) {
  const float* xh_ = x + head * xh;
  for (int e = threadIdx.x; e < T * DP; e += kThreads) {
    const int r = e / DP, c = e % DP;
    const int64_t row = r0 + r;
    sm[r * (DP + 1) + c] = (row < s && c < d) ? xh_[row * xs + c * xd] : 0.f;
  }
}

// x[i][j] = <a1 row r_i, b1 row c_j> and y[i][j] = <a2 row r_i, b2 row c_j>
// over DP depths, rows r_i = ty RM + i, c_j = tx + 16 j; all four tiles have
// rows of DP + 1 floats
template <int RM, int CN, int DP>
__device__ __forceinline__ void two_scores(float (&x)[RM][CN], float (&y)[RM][CN], const float* a1, const float* b1,
                                           const float* a2, const float* b2, int ty, int tx) {
  constexpr int L = DP + 1;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) x[i][j] = y[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < DP; ++c) {
    float ra[RM], rb[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) ra[i] = a1[(ty * RM + i) * L + c];
#pragma unroll
    for (int j = 0; j < CN; ++j) rb[j] = b1[(tx + 16 * j) * L + c];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) x[i][j] = fmaf(ra[i], rb[j], x[i][j]);
#pragma unroll
    for (int i = 0; i < RM; ++i) ra[i] = a2[(ty * RM + i) * L + c];
#pragma unroll
    for (int j = 0; j < CN; ++j) rb[j] = b2[(tx + 16 * j) * L + c];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) y[i][j] = fmaf(ra[i], rb[j], y[i][j]);
  }
}

// acc[i][j] += sum_t m[r_i][t] b[t][c_j], t < C: m has rows of C + 1 floats,
// b rows of DP + 1; rows r_i = ty RM + i, columns c_j = tx + 16 j
template <int RM, int C, int DP>
__device__ __forceinline__ void accumulate(float (&acc)[RM][DP / 16], const float* m, const float* b, int ty, int tx) {
  constexpr int CD = DP / 16;
#pragma unroll 4
  for (int t = 0; t < C; ++t) {
    float rm[RM], rb[CD];
#pragma unroll
    for (int i = 0; i < RM; ++i) rm[i] = m[(ty * RM + i) * (C + 1) + t];
#pragma unroll
    for (int j = 0; j < CD; ++j) rb[j] = b[t * (DP + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CD; ++j) acc[i][j] = fmaf(rm[i], rb[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool attends(int64_t i, int64_t j, int64_t s, int64_t n_true, int causal) {
  return i < s && j < s && ((i >= n_true) == (j >= n_true)) && (!causal || j <= i);
}

// the rows [rows, rows + n) of a (s, h, d) tensor, contiguous, from acc (times mul)
template <int RM, int DP>
__device__ __forceinline__ void store_rows(float* __restrict__ out, const float (&acc)[RM][DP / 16], int64_t r0,
                                           int64_t head, int64_t s, int64_t h, int d, float mul, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t row = r0 + ty * RM + i;
    if (row >= s) continue;
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < d) out[(row * h + head) * d + c] = acc[i][j] * mul;
    }
  }
}

// di[head, row] = sum_c o[row, head, c] do[row, head, c]: a warp per (row, head)
__global__ void __launch_bounds__(kThreads) flash_bwd_di(const float* __restrict__ o, const float* __restrict__ g,
                                                         float* __restrict__ di, int64_t s, int64_t h, int d,
                                                         int64_t os, int64_t oh, int64_t od, int64_t gs, int64_t gh,
                                                         int64_t gd) {
  const int64_t w = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= s * h) return;
  const int64_t row = w / h, head = w % h;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(o[row * os + head * oh + c * od], g[row * gs + head * gh + c * gd], acc);
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) di[head * s + row] = acc;
}

template <int DP, int BK, int BQ>
struct DkvCfg {
  static constexpr int bytes = 4 * ((2 * BK + 2 * BQ) * (DP + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
};

// dK and dV of key tile blockIdx.x / h (BK keys) and head blockIdx.x % h,
// looping over the query tiles that attend it
template <int DP, int BK, int BQ>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ dk, float* __restrict__ dv,
    int64_t s, int64_t h, int d, int64_t qs, int64_t qh, int64_t qd, int64_t ks, int64_t kh, int64_t kd, int64_t vs,
    int64_t vh, int64_t vd, int64_t gs, int64_t gh, int64_t gd, float scale, int64_t n_true, int causal) {
  constexpr int L = DP + 1, RM = BK / 16, CN = BQ / 16, CD = DP / 16;
  extern __shared__ float sm[];
  float* const ks_ = sm;
  float* const vs_ = ks_ + BK * L;
  float* const qs_ = vs_ + BK * L;
  float* const gs_ = qs_ + BQ * L;
  float* const ps_ = gs_ + BQ * L;       // P^T: BK x (BQ + 1)
  float* const ds_ = ps_ + BK * (BQ + 1);  // dS^T
  float* const lse_ = ds_ + BK * (BQ + 1);
  float* const di_ = lse_ + BQ;

  const int64_t head = blockIdx.x % h, k0 = (int64_t)(blockIdx.x / h) * BK;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  load_tile<BK, DP>(ks_, k, k0, head, s, d, ks, kh, kd);
  load_tile<BK, DP>(vs_, v, k0, head, s, d, vs, vh, vd);

  // the queries that attend some key of the tile
  int64_t qb = causal ? k0 : 0, qe = s;
  const int64_t k_last = (k0 + BK < s ? k0 + BK : s) - 1;
  if (k_last < n_true) {
    qe = qe < n_true ? qe : n_true;  // real keys: real queries only
  } else if (k0 >= n_true) {
    qb = qb > n_true ? qb : n_true;  // padding keys: padding queries only
  }

  float gk[RM][CD], gv[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) gk[i][j] = gv[i][j] = 0.f;

#pragma unroll 1
  for (int64_t q0 = qb; q0 < qe; q0 += BQ) {
    __syncthreads();  // the previous tile's Q, dO, P and dS are consumed
    load_tile<BQ, DP>(qs_, q, q0, head, s, d, qs, qh, qd);
    load_tile<BQ, DP>(gs_, g, q0, head, s, d, gs, gh, gd);
    for (int e = tid; e < BQ; e += kThreads) {
      const int64_t row = q0 + e;
      lse_[e] = row < s ? lse[head * s + row] : 0.f;
      di_[e] = row < s ? di[head * s + row] : 0.f;
    }
    __syncthreads();
    float x[RM][CN], y[RM][CN];
    two_scores<RM, CN, DP>(x, y, ks_, qs_, vs_, gs_, ty, tx);  // S^T and dP^T
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int r = ty * RM + i, c = tx + 16 * j;
        const float p = attends(q0 + c, k0 + r, s, n_true, causal) ? expf(x[i][j] * scale - lse_[c]) : 0.f;
        ps_[r * (BQ + 1) + c] = p;
        ds_[r * (BQ + 1) + c] = p * (y[i][j] - di_[c]);
      }
    __syncthreads();
    accumulate<RM, BQ, DP>(gv, ps_, gs_, ty, tx);  // dV += P^T dO
    accumulate<RM, BQ, DP>(gk, ds_, qs_, ty, tx);  // dK += dS^T Q
  }
  store_rows<RM, DP>(dk, gk, k0, head, s, h, d, scale, ty, tx);
  store_rows<RM, DP>(dv, gv, k0, head, s, h, d, 1.f, ty, tx);
}

template <int DP, int BQ, int BK>
struct DqCfg {
  static constexpr int bytes = 4 * ((2 * BQ + 2 * BK) * (DP + 1) + BQ * (BK + 1) + 2 * BQ);
};

// dQ of query tile (launched last-first, so under causal the longest rows
// start first) and head blockIdx.x % h, looping over the key tiles it attends
template <int DP, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, const float* __restrict__ g,
    const float* __restrict__ lse, const float* __restrict__ di, float* __restrict__ dq, int64_t s, int64_t h, int d,
    int64_t qs, int64_t qh, int64_t qd, int64_t ks, int64_t kh, int64_t kd, int64_t vs, int64_t vh, int64_t vd,
    int64_t gs, int64_t gh, int64_t gd, float scale, int64_t n_true, int causal) {
  constexpr int L = DP + 1, RM = BQ / 16, CN = BK / 16, CD = DP / 16;
  extern __shared__ float sm[];
  float* const qs_ = sm;
  float* const gs_ = qs_ + BQ * L;
  float* const ks_ = gs_ + BQ * L;
  float* const vs_ = ks_ + BK * L;
  float* const ds_ = vs_ + BK * L;  // dS: BQ x (BK + 1)
  float* const lse_ = ds_ + BQ * (BK + 1);
  float* const di_ = lse_ + BQ;

  const int64_t tiles = (s + BQ - 1) / BQ;
  const int64_t head = blockIdx.x % h, q0 = (tiles - 1 - (int64_t)(blockIdx.x / h)) * BQ;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  load_tile<BQ, DP>(qs_, q, q0, head, s, d, qs, qh, qd);
  load_tile<BQ, DP>(gs_, g, q0, head, s, d, gs, gh, gd);
  for (int e = tid; e < BQ; e += kThreads) {
    const int64_t row = q0 + e;
    lse_[e] = row < s ? lse[head * s + row] : 0.f;
    di_[e] = row < s ? di[head * s + row] : 0.f;
  }

  // the keys that some query of the tile attends (as the forward's key_range)
  const int64_t last = (q0 + BQ < s ? q0 + BQ : s) - 1;
  int64_t kb = 0, ke = causal ? last + 1 : s;
  if (last < n_true) {
    ke = ke < n_true ? ke : n_true;
  } else if (q0 >= n_true) {
    kb = n_true;
  }

  float gq[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CD; ++j) gq[i][j] = 0.f;

#pragma unroll 1
  for (int64_t k0 = kb; k0 < ke; k0 += BK) {
    __syncthreads();  // the previous tile's K and dS are consumed
    load_tile<BK, DP>(ks_, k, k0, head, s, d, ks, kh, kd);
    load_tile<BK, DP>(vs_, v, k0, head, s, d, vs, vh, vd);
    __syncthreads();
    float x[RM][CN], y[RM][CN];
    two_scores<RM, CN, DP>(x, y, qs_, ks_, gs_, vs_, ty, tx);  // S and dP
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int r = ty * RM + i, c = tx + 16 * j;
        const float p = attends(q0 + r, k0 + c, s, n_true, causal) ? expf(x[i][j] * scale - lse_[r]) : 0.f;
        ds_[r * (BK + 1) + c] = p * (y[i][j] - di_[r]);
      }
    __syncthreads();
    accumulate<RM, BK, DP>(gq, ds_, ks_, ty, tx);  // dQ += dS K
  }
  store_rows<RM, DP>(dq, gq, q0, head, s, h, d, scale, ty, tx);
}

template <int DP, int BK, int BQ>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* g, const float* lse,
                       const float* di, float* dk, float* dv, int64_t s, int64_t h, int d, const int64_t* st,
                       float scale, int64_t n_true, int causal, cudaStream_t stream) {
  constexpr int bytes = DkvCfg<DP, BK, BQ>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv<DP, BK, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((s + BK - 1) / BK * h);
  flash_bwd_dkv<DP, BK, BQ><<<blocks, kThreads, bytes, stream>>>(q, k, v, g, lse, di, dk, dv, s, h, d, st[0], st[1],
                                                                  st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                                                                  st[9], st[10], st[11], scale, n_true, causal);
  return cudaGetLastError();
}

template <int DP, int BQ, int BK>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* g, const float* lse,
                      const float* di, float* dq, int64_t s, int64_t h, int d, const int64_t* st, float scale,
                      int64_t n_true, int causal, cudaStream_t stream) {
  constexpr int bytes = DqCfg<DP, BQ, BK>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq<DP, BQ, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((s + BQ - 1) / BQ * h);
  flash_bwd_dq<DP, BQ, BK><<<blocks, kThreads, bytes, stream>>>(q, k, v, g, lse, di, dq, s, h, d, st[0], st[1], st[2],
                                                                 st[3], st[4], st[5], st[6], st[7], st[8], st[9],
                                                                 st[10], st[11], scale, n_true, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o, g: (s, h, d) float32 with element strides (os, oh, od, gs, gh, gd);
// di: (h, s) float32.  Returns the CUDA error of the launch (0 on success);
// does not synchronise.
int heat_flash_bwd_di(const float* o, const float* g, float* di, int64_t s, int64_t h, int64_t d, int64_t os,
                      int64_t oh, int64_t od, int64_t gs, int64_t gh, int64_t gd, void* stream) {
  if (s < 1 || h < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (s * h + kThreads / 32 - 1) / (kThreads / 32);
  flash_bwd_di<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(o, g, di, s, h, (int)d, os, oh,
                                                                                    od, gs, gh, gd);
  return (int)cudaGetLastError();
}

// q, k, v, g: (s, h, d) float32; st: their element strides, three each, in
// that order; lse, di: (h, s) float32; dk, dv: (s, h, d) float32, contiguous.
// 1 <= d <= 256 and ceil(s / 32) h < 2^31 (the wrapper's gate).  Returns the
// CUDA error of the launch (0 on success); does not synchronise.
int heat_flash_bwd_dkv(const float* q, const float* k, const float* v, const float* g, const float* lse,
                       const float* di, float* dk, float* dv, int64_t s, int64_t h, int64_t d, const int64_t* st,
                       float scale, int64_t n_true, int causal, void* stream) {
  if (s < 1 || h < 1 || d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int dd = (int)d;
  if (d <= 64) return (int)launch_dkv<64, 64, 64>(q, k, v, g, lse, di, dk, dv, s, h, dd, st, scale, n_true, causal, cs);
  if (d <= 128)
    return (int)launch_dkv<128, 64, 64>(q, k, v, g, lse, di, dk, dv, s, h, dd, st, scale, n_true, causal, cs);
  return (int)launch_dkv<256, 32, 64>(q, k, v, g, lse, di, dk, dv, s, h, dd, st, scale, n_true, causal, cs);
}

// as heat_flash_bwd_dkv, writing dq: (s, h, d) float32, contiguous
int heat_flash_bwd_dq(const float* q, const float* k, const float* v, const float* g, const float* lse,
                      const float* di, float* dq, int64_t s, int64_t h, int64_t d, const int64_t* st, float scale,
                      int64_t n_true, int causal, void* stream) {
  if (s < 1 || h < 1 || d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int dd = (int)d;
  if (d <= 64) return (int)launch_dq<64, 64, 64>(q, k, v, g, lse, di, dq, s, h, dd, st, scale, n_true, causal, cs);
  if (d <= 128) return (int)launch_dq<128, 64, 64>(q, k, v, g, lse, di, dq, s, h, dd, st, scale, n_true, causal, cs);
  return (int)launch_dq<256, 64, 32>(q, k, v, g, lse, di, dq, s, h, dd, st, scale, n_true, causal, cs);
}

}  // extern "C"
