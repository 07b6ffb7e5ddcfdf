// Backward of flash attention, float32, for sm_90a: di, then dK/dV and dQ by
// one of two routes, on the tensor cores in 3xTF32 or on the CUDA cores.
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
// both kernels is the price of having each block own its output rows.  The
// bytes (q, k, v, o, do read once, three gradients written) are about 0.2
// GB, 0.06 ms.  Two routes, chosen by the wrapper's gate
// (nn/_flash.py::bwd_route): tc for d <= 64, cuda_core for 64 < d <= 256.
//
// The tc route (flash_bwd_prep, flash_bwd_dkv_tc, flash_bwd_dq_tc): the
// seven products on the tensor cores in 3xTF32 (tf32x3.cuh), f32-class; their
// floor at 495 TFLOP/s is 5.83 ms at that shape, where the CUDA cores' (67
// TFLOP/s) is 14.4 ms.  What the design does:
//   - wgmma's .tf32 form has no transpose, so every B operand must sit
//     K-major in shared memory.  A pre-pass (flash_bwd_prep) reads q, k, v
//     and do once through their strides and writes their TF32 big and small
//     planes into the wrapper's scratch: all four natural (rows x depths),
//     q, k and do also transposed (depths x rows, rows permuted perm8 within
//     groups of 8); sp = s rounded up to 128, zeros past s and d.  Each
//     64 x 64 tile of a plane is stored whole in the layout the descriptors
//     read, so one bulk copy (cp.async.bulk, completed on an mbarrier) moves
//     it; the pre-pass also copies lse and di into rows padded to sp.
//   - Tiles are streamed by bulk copies that one thread issues.  A first
//     design in which every thread issued 16-byte cp.async copies spent about
//     a third of each step stalled on issuing them (clock64 stamps); the bulk
//     copies run beside the products.
//   - dkv: a warpgroup owns 64 keys, two a block sharing the streamed query
//     tiles.  K and V are its A operands in shared memory.  Per query tile
//     of 64, four ring items: Q (B of S^T = K Q^T), dO with the tile's lse
//     and di (B of dP^T = V dO^T), dO^T (B of dV += P^T dO) and Q^T (B of
//     dK += dS^T Q).  P^T and dS^T go from the score accumulators straight
//     into A fragments in registers: a thread's accumulator holds queries
//     (2t, 2t + 1) of each group of 8, the A fragment wants depths (t, t + 4),
//     which the perm8 rows of the transposed planes supply (as K7 does for
//     P).  The sequence S^T, dP^T -> P^T, dS^T -> dV chain -> dK chain keeps
//     at most dK, dV, dS^T, the A fragments and one chain live (224
//     registers, no spills; dq 168).
//   - dq: a warpgroup owns 64 queries, two a block; Q and dO are its A
//     operands; per key tile of 64, three ring items: K (B of S = Q K^T), V
//     (B of dP = dO V^T) and K^T (B of dQ += dS K).
//   - Precision, as K7: the tensor core's f32 accumulation truncates, so
//     every chain is short and starts from zero (a score over 64 depths, an
//     output product over one 64-row tile: 24 wgmma each), and is added to
//     the running dK, dV or dQ in IEEE f32; dP - di, the exp and P in f32
//     (P = exp2f(scale log2(e) s - log2(e) lse), which costs less than expf
//     and differs from it by about an ulp).  Every split into big and small
//     rounds with integer operations as cvt.rna does (rna_int), at four
//     times the conversion's rate.
//   - A ring of 3 items of 32 KB, two ahead, beside the two warpgroups' A
//     operands (128 KB): 226 KB of shared memory, one block an SM.
//   - Masks only where needed: tiles wholly masked by causality or by the
//     segment are skipped by the block and by each warpgroup; only tiles that
//     cross the diagonal, the segment boundary or the end are masked element
//     by element.  dq's query tiles are launched last-first (under causal the
//     longest rows start first); dkv's first key tiles hold the most queries.
//   - No atomics, one fixed order of every sum: a repeat is bitwise equal.
//
// The cuda_core route (flash_bwd_dkv, flash_bwd_dq), for 64 < d <= 256 (it
// takes d <= 64 too, to be compared with the tc route): exact f32 FMAs on the
// CUDA cores.
//   - One block of 256 threads owns a tile of key rows (dkv) or of query rows
//     (dq) and loops over the other side's tiles, as the TPU kernels' grids
//     do; the gradient rows it owns stay in registers until the end.
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

#include "tf32x3.cuh"

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


// ---------------------------------------------------------------------------
// The tc route: 3xTF32 on the tensor cores (wgmma m64n64k8)
// ---------------------------------------------------------------------------
constexpr int kTcRows = 64;                    // rows a warpgroup owns, and rows of a streamed tile
constexpr int kTcWG = 2;                       // warpgroups a block
constexpr int kTcThreads = 128 * kTcWG;
constexpr int kTcBlockRows = kTcRows * kTcWG;  // rows a block owns; sp is a multiple of it
constexpr int kTcD = 64;                       // head dimension of the route (d <= 64, zero-padded)
constexpr int kTile = kTcRows * kTcD;          // floats of a 64 x 64 tile
constexpr int kPlane = kTile * 4;              // its bytes: 16 KB
constexpr int kItem = 2 * kPlane;              // its big and small planes
constexpr int kTcR = 3;                        // ring items
constexpr int kRowBytes = kTcRows * 4;         // a query tile's lse (or di)
constexpr int kDkvSlot = kItem + 2 * kRowBytes;
constexpr int kDkvTcBytes = kTcWG * 2 * kItem + kTcR * kDkvSlot + 8 * (kTcR + 1);  // 230944, with the mbarriers
constexpr int kDqTcBytes = kTcWG * 2 * kItem + kTcR * kItem + 8 * (kTcR + 1);      // 229408
constexpr int kPrepThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;  // P = 2^(scale log2(e) s - log2(e) lse): exp2f, cheaper than expf

// the planes of the pre-pass: natural (rows x depths) of q, k, v, do;
// transposed (depths x rows), rows permuted perm8, of q, k, do; each big then
// small, each (h, sp / 64) tiles of 64 x 64 floats laid out for the
// descriptors (tf32x3::cm_off); then lse and di, (h, sp), zeros past s
enum Plane { kQ = 0, kK = 1, kV = 2, kG = 3, kQt = 4, kKt = 5, kGt = 6, kPlanes = 7 };

// position p of a group of 8 rows in a transposed plane holds row perm8(p):
// the score accumulator's columns 2t and 2t + 1 are then the A fragment's
// depths t and t + 4
__device__ __forceinline__ int perm8(int p) { return ((p & 3) << 1) | (p >> 2); }

__device__ __forceinline__ uint64_t desc(const unsigned char* p) { return tf32x3::wg_desc(p, 128, 256); }

// x rounded to TF32 as cvt.rna rounds a finite float (half of the 13 dropped
// bits' range added to the bits, then cleared), in two integer operations:
// the conversion runs at a quarter of their rate, and the split of the A
// fragments is most of the CUDA-core work between the products
__device__ __forceinline__ uint32_t rna_int(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = big + small, both TF32 (tf32x3::split's split, by rna_int)
__device__ __forceinline__ void split_int(float x, uint32_t& big, uint32_t& small) {
  big = rna_int(x);
  small = rna_int(x - __uint_as_float(big));
}

// --- bulk copies (cp.async.bulk, the TMA's one-dimensional form) on
// mbarriers: one thread moves a whole 16 KB plane, so the others never stall
// on issuing copies
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(tf32x3::smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(tf32x3::smem_addr(bar)), "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` of bar has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(tf32x3::smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) global -> shared,
// counted on bar
__device__ __forceinline__ void bulk(void* dst, const float* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   tf32x3::smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(tf32x3::smem_addr(bar))
               : "memory");
}
// a tile's big and small planes into dst (bytes still to be expected on bar)
__device__ __forceinline__ void bulk_tile(unsigned char* dst, const float* planes, int pl, int64_t plane, int64_t tile,
                                          uint64_t* bar) {
  bulk(dst, planes + 2 * pl * plane + tile * kTile, kPlane, bar);
  bulk(dst + kPlane, planes + (2 * pl + 1) * plane + tile * kTile, kPlane, bar);
}

struct PrepSrc {
  const float* x[4];  // q, k, v, do
  int64_t st[12];     // their element strides, three each
};

// float e of a tile laid out for the descriptors holds (row, depth) =
// (tile_row(e), tile_col(e)): the inverse of tf32x3::cm_off / 4
__device__ __forceinline__ int tile_row(int e) { return ((e >> 6) & 7) * 8 + ((e >> 2) & 7); }
__device__ __forceinline__ int tile_col(int e) { return ((e >> 9) & 7) * 8 + ((e >> 5) & 1) * 4 + (e & 3); }

// The pre-pass: rows [64 blockIdx.x, + 64) of head blockIdx.y of tensor
// blockIdx.z (q, k, v, do) split into TF32 planes, natural and (but v)
// transposed with rows permuted, each a tile laid out for the descriptors;
// zeros past s and d.  The v blocks also copy lse and di of their rows.
__global__ void __launch_bounds__(kPrepThreads) flash_bwd_prep(PrepSrc src, const float* __restrict__ lse,
                                                               const float* __restrict__ di, int64_t s, int64_t sp,
                                                               int d, float* __restrict__ planes) {
  __shared__ float tile[kTcRows][kTcD + 4];  // rows of 68: both reads below are free of bank conflicts
  const int z = blockIdx.z;
  const int64_t r0 = (int64_t)blockIdx.x * kTcRows, head = blockIdx.y, h = gridDim.y;
  const int64_t plane = h * sp * kTcD;
  const int64_t xs = src.st[3 * z], xd = src.st[3 * z + 2];
  const float* x = src.x[z] + head * src.st[3 * z + 1];
  const int64_t at = (head * (sp / kTcRows) + blockIdx.x) * kTile;  // the tile's first float in each plane
  for (int e = threadIdx.x; e < kTile; e += kPrepThreads) {
    const int r = e / kTcD, c = e % kTcD;
    const int64_t row = r0 + r;
    tile[r][c] = (row < s && c < d) ? x[row * xs + c * xd] : 0.f;
  }
  if (z == kV) {
    float* const pad = planes + 2 * kPlanes * plane;
    for (int e = threadIdx.x; e < 2 * kTcRows; e += kPrepThreads) {
      const int64_t row = r0 + e % kTcRows;
      pad[(e / kTcRows) * h * sp + head * sp + row] = row < s ? (e < kTcRows ? lse : di)[head * s + row] : 0.f;
    }
  }
  __syncthreads();
  float* const nb = planes + 2 * z * plane + at;
  float* const tb = planes + 2 * (z == kG ? kGt : kQt + z) * plane + at;
  for (int e = threadIdx.x; e < kTile; e += kPrepThreads) {
    const int r = tile_row(e), c = tile_col(e);
    uint32_t b, l;
    split_int(tile[r][c], b, l);
    nb[e] = __uint_as_float(b);
    nb[plane + e] = __uint_as_float(l);
    if (z != kV) {  // transposed: row c of the plane is depth c, its column p the row perm8(p) of the group
      split_int(tile[(c & ~7) | perm8(c & 7)][r], b, l);
      tb[e] = __uint_as_float(b);
      tb[plane + e] = __uint_as_float(l);
    }
  }
}

// acc = A B^T over 64 depths from zero, both operands from shared memory:
// 8 k8 slabs, three TF32 products each
__device__ __forceinline__ void chain_ss(float (&acc)[32], const unsigned char* a, const unsigned char* b) {
  tf32x3::wg_fence();
#pragma unroll
  for (int kk = 0; kk < kTcD / 8; ++kk)
    tf32x3::wg_mma3_ss(acc, desc(a + kk * 2048), desc(a + kPlane + kk * 2048), desc(b + kk * 2048),
                       desc(b + kPlane + kk * 2048), kk == 0 ? 0 : 1);
  tf32x3::wg_commit();
  tf32x3::wg_wait<0>();
  tf32x3::wg_pin(acc);
}

// acc = A B over one 64-row tile from zero, A from registers (big ab, small
// as), B from shared memory
__device__ __forceinline__ void chain_rs(float (&acc)[32], const uint32_t (&ab)[8][4], const uint32_t (&as)[8][4],
                                         const unsigned char* b) {
  tf32x3::wg_fence();
#pragma unroll
  for (int kk = 0; kk < kTcRows / 8; ++kk)
    tf32x3::wg_mma3<1>(acc, ab[kk], as[kk], desc(b + kk * 2048), desc(b + kPlane + kk * 2048), kk == 0 ? 0 : 1);
  tf32x3::wg_commit();
  tf32x3::wg_wait<0>();
  tf32x3::wg_pin(acc);
}

// an accumulator (rows m, columns k of the next product) as A fragments, big
// and small: depth t of slab kk is column 8 kk + 2t, depth t + 4 column 8 kk
// + 2t + 1
__device__ __forceinline__ void to_a(const float (&acc)[32], uint32_t (&ab)[8][4], uint32_t (&as)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)  // registers (0, 1, 2, 3): accumulator entries (0, 2, 1, 3)
      split_int(acc[4 * kk + (j == 1 ? 2 : j == 2 ? 1 : j)], ab[kk][j], as[kk][j]);
}

// the queries [qb, qe) that attend some key of [k0, k0 + kn)
__device__ __forceinline__ void query_range(int64_t k0, int64_t kn, int64_t s, int64_t n_true, int causal,
                                            int64_t& qb, int64_t& qe) {
  const int64_t last = (k0 + kn < s ? k0 + kn : s) - 1;
  qb = causal ? k0 : 0;
  qe = k0 < s ? s : 0;
  if (last < n_true) {
    qe = qe < n_true ? qe : n_true;  // real keys: real queries only
  } else if (k0 >= n_true) {
    qb = qb > n_true ? qb : n_true;  // padding keys: padding queries only
  }
}

// the keys [kb, ke) that some query of [q0, q0 + qn) attends
__device__ __forceinline__ void key_range(int64_t q0, int64_t qn, int64_t s, int64_t n_true, int causal,
                                          int64_t& kb, int64_t& ke) {
  const int64_t last = (q0 + qn < s ? q0 + qn : s) - 1;
  kb = 0;
  ke = q0 >= s ? 0 : causal ? last + 1 : s;
  if (last < n_true) {
    ke = ke < n_true ? ke : n_true;
  } else if (q0 >= n_true) {
    kb = n_true;
  }
}

// every (query, key) of the 64 x 64 tile at (i0, j0) attended: no element mask
__device__ __forceinline__ bool whole_tile(int64_t i0, int64_t j0, int64_t s, int64_t n_true, int causal) {
  return i0 + kTcRows <= s && j0 + kTcRows <= s && !(causal && j0 + kTcRows - 1 > i0) &&
         ((i0 + kTcRows <= n_true && j0 + kTcRows <= n_true) || (i0 >= n_true && j0 >= n_true));
}

// rows [r0, r0 + 64) of a (s, h, d) tensor, contiguous, from the warpgroup's
// accumulator (times mul): a thread holds rows 16 warp + g (+ 8), columns 8 i
// + 2t (+ 1)
__device__ __forceinline__ void store_acc(float* __restrict__ out, const float (&acc)[32], int64_t r0, int64_t head,
                                          int64_t s, int64_t h, int d, float mul, int warp, int g, int t) {
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int64_t row = r0 + 16 * warp + g + 8 * rh;
    if (row >= s) continue;
    float* orow = out + (row * h + head) * d;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * i + 2 * t + e;
        if (col < d) orow[col] = acc[4 * i + 2 * rh + e] * mul;
      }
  }
}

// dK and dV of keys [128 (blockIdx.x / h), + 128) (64 a warpgroup) and head
// blockIdx.x % h, looping over the query tiles that attend them
__global__ void __launch_bounds__(kTcThreads, 1) flash_bwd_dkv_tc(
    const float* __restrict__ planes, float* __restrict__ dk, float* __restrict__ dv, int64_t s, int64_t sp,
    int64_t h, int d, float scale, int64_t n_true, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const ring = smem + kTcWG * 2 * kItem;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(ring + kTcR * kDkvSlot);  // the ring's, then K and V's
  const int64_t plane = h * sp * kTcD, tiles = sp / kTcRows;
  const float* const lse_p = planes + 2 * kPlanes * plane;
  const float* const di_p = lse_p + h * sp;
  const int64_t head = (int64_t)blockIdx.x % h, kb0 = (int64_t)(blockIdx.x / h) * kTcBlockRows;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t kw0 = kb0 + kTcRows * wg;  // the warpgroup's first key
  const float scale2 = scale * kLog2e;
  unsigned char* const ka = smem + wg * 2 * kItem;  // its K (A of S^T), then V (A of dP^T)
  unsigned char* const va = ka + kItem;

  int64_t q_begin, q_end, w_begin, w_end;
  query_range(kb0, kTcBlockRows, s, n_true, causal, q_begin, q_end);
  q_begin = (q_begin / kTcRows) * kTcRows;
  query_range(kw0, kTcRows, s, n_true, causal, w_begin, w_end);
  const int64_t items = q_end > q_begin ? (q_end - q_begin + kTcRows - 1) / kTcRows * 4 : 0;

  // item it of query tile it / 4, into slot it % R: Q (c = 0), dO and the
  // tile's lse and di (1), dO^T (2), Q^T (3); issued by thread 0
  auto load = [&](int64_t it) {
    if (it >= items) return;
    const int64_t q0 = q_begin + (it >> 2) * kTcRows;
    const int c = (int)(it & 3);
    unsigned char* dst = ring + (int)(it % kTcR) * kDkvSlot;
    uint64_t* bar = bars + it % kTcR;
    mbar_expect(bar, c == 1 ? kDkvSlot : kItem);
    bulk_tile(dst, planes, c == 0 ? kQ : c == 1 ? kG : c == 2 ? kGt : kQt, plane, head * tiles + q0 / kTcRows, bar);
    if (c == 1) {
      bulk(dst + kItem, lse_p + head * sp + q0, kRowBytes, bar);
      bulk(dst + kItem + kRowBytes, di_p + head * sp + q0, kRowBytes, bar);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kTcR; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // K and V of both warpgroups
    mbar_expect(bars + kTcR, kTcWG * 2 * kItem);
    for (int w = 0; w < kTcWG; ++w) {
      bulk_tile(smem + w * 2 * kItem, planes, kK, plane, head * tiles + kb0 / kTcRows + w, bars + kTcR);
      bulk_tile(smem + w * 2 * kItem + kItem, planes, kV, plane, head * tiles + kb0 / kTcRows + w, bars + kTcR);
    }
    for (int i = 0; i < kTcR - 1; ++i) load(i);
  }
  __syncthreads();  // the mbarriers are initialised
  mbar_wait(bars + kTcR, 0);

  // st: S^T, then P^T, then each output chain; dpt: dP^T, then dS^T; ab/as:
  // P^T's, then dS^T's A fragments
  float st[32], dpt[32], gk[32], gv[32];
  uint32_t ab[8][4], as[8][4];
#pragma unroll
  for (int e = 0; e < 32; ++e) gk[e] = gv[e] = 0.f;

#pragma unroll 1
  for (int64_t it = 0; it < items; ++it) {
    __syncthreads();  // item it - 1 is consumed: its slot takes item it + R - 1
    if (tid == 0) {
      tf32x3::fence_async_smem();
      load(it + kTcR - 1);
    }
    const int64_t q0 = q_begin + (it >> 2) * kTcRows;
    const int c = (int)(it & 3);
    if (q0 >= w_end || q0 + kTcRows <= w_begin) continue;  // no query of this tile for this warpgroup
    const unsigned char* slot = ring + (int)(it % kTcR) * kDkvSlot;
    mbar_wait(bars + it % kTcR, (uint32_t)((it / kTcR) & 1));  // item it has landed
    if (c == 0) {
      chain_ss(st, ka, slot);  // S^T = K Q^T
    } else if (c == 1) {
      chain_ss(dpt, va, slot);  // dP^T = V dO^T
      // P^T = exp(scale S^T - lse) and dS^T = P^T (dP^T - di), in place, in
      // f32; masks only on tiles that need them
      const float* lse_ = reinterpret_cast<const float*>(slot + kItem);
      const float* di_ = lse_ + kTcRows;
      const bool whole = whole_tile(q0, kw0, s, n_true, causal);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * i + 2 * t + (e & 1);
          const int64_t key = kw0 + 16 * warp + g + 8 * (e >> 1);
          const bool ok = whole || attends(q0 + qc, key, s, n_true, causal);
          const float p = ok ? exp2f(fmaf(st[4 * i + e], scale2, -lse_[qc] * kLog2e)) : 0.f;
          st[4 * i + e] = p;
          dpt[4 * i + e] = p * (dpt[4 * i + e] - di_[qc]);
        }
      to_a(st, ab, as);
    } else if (c == 2) {
      chain_rs(st, ab, as, slot);  // this tile's P^T dO
#pragma unroll
      for (int e = 0; e < 32; ++e) gv[e] += st[e];
    } else {
      to_a(dpt, ab, as);
      chain_rs(st, ab, as, slot);  // this tile's dS^T Q
#pragma unroll
      for (int e = 0; e < 32; ++e) gk[e] += st[e];
    }
  }
  // every issued copy has landed before the block's shared memory goes
  if (tid == 0)
    for (int64_t it = items > kTcR ? items - kTcR : 0; it < items; ++it)
      mbar_wait(bars + it % kTcR, (uint32_t)((it / kTcR) & 1));
  store_acc(dk, gk, kw0, head, s, h, d, scale, warp, g, t);
  store_acc(dv, gv, kw0, head, s, h, d, 1.f, warp, g, t);
}

// dQ of queries [128 tile, + 128) (64 a warpgroup; tiles launched
// last-first) and head blockIdx.x % h, looping over the key tiles they attend
__global__ void __launch_bounds__(kTcThreads, 1) flash_bwd_dq_tc(
    const float* __restrict__ planes, const float* __restrict__ lse, const float* __restrict__ di,
    float* __restrict__ dq, int64_t s, int64_t sp, int64_t h, int d, float scale, int64_t n_true, int causal) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const ring = smem + kTcWG * 2 * kItem;
  uint64_t* const bars = reinterpret_cast<uint64_t*>(ring + kTcR * kItem);  // the ring's, then Q and dO's
  const int64_t plane = h * sp * kTcD, tiles = sp / kTcRows;
  const int64_t head = (int64_t)blockIdx.x % h;
  const int64_t qb0 = (sp / kTcBlockRows - 1 - (int64_t)(blockIdx.x / h)) * kTcBlockRows;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t qw0 = qb0 + kTcRows * wg;  // the warpgroup's first query
  unsigned char* const qa = smem + wg * 2 * kItem;  // its Q (A of S), then dO (A of dP)
  unsigned char* const ga = qa + kItem;

  int64_t k_begin, k_end, w_begin, w_end;
  key_range(qb0, kTcBlockRows, s, n_true, causal, k_begin, k_end);
  k_begin = (k_begin / kTcRows) * kTcRows;
  key_range(qw0, kTcRows, s, n_true, causal, w_begin, w_end);
  const int64_t items = k_end > k_begin ? (k_end - k_begin + kTcRows - 1) / kTcRows * 3 : 0;

  // item it of key tile it / 3, into slot it % R: K (c = 0), V (1), K^T (2);
  // issued by thread 0
  auto load = [&](int64_t it) {
    if (it >= items) return;
    const int64_t k0 = k_begin + (it / 3) * kTcRows;
    const int c = (int)(it % 3);
    uint64_t* bar = bars + it % kTcR;
    mbar_expect(bar, kItem);
    bulk_tile(ring + (int)(it % kTcR) * kItem, planes, c == 0 ? kK : c == 1 ? kV : kKt, plane,
              head * tiles + k0 / kTcRows, bar);
  };
  if (tid == 0) {
    for (int i = 0; i <= kTcR; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(bars + kTcR, kTcWG * 2 * kItem);
    for (int w = 0; w < kTcWG; ++w) {
      bulk_tile(smem + w * 2 * kItem, planes, kQ, plane, head * tiles + qb0 / kTcRows + w, bars + kTcR);
      bulk_tile(smem + w * 2 * kItem + kItem, planes, kG, plane, head * tiles + qb0 / kTcRows + w, bars + kTcR);
    }
    for (int i = 0; i < kTcR - 1; ++i) load(i);
  }
  const float scale2 = scale * kLog2e;
  float lse2[2], di_r[2];  // of this thread's rows 16 warp + g (+ 8): lse log2(e), di
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int64_t row = qw0 + 16 * warp + g + 8 * rh;
    lse2[rh] = row < s ? lse[head * s + row] * kLog2e : 0.f;
    di_r[rh] = row < s ? di[head * s + row] : 0.f;
  }
  __syncthreads();  // the mbarriers are initialised
  mbar_wait(bars + kTcR, 0);

  float sc[32], dp[32], gq[32];  // sc: S, then the dQ chain; dp: dP, then dS
  uint32_t ab[8][4], as[8][4];
#pragma unroll
  for (int e = 0; e < 32; ++e) gq[e] = 0.f;

#pragma unroll 1
  for (int64_t it = 0; it < items; ++it) {
    __syncthreads();  // item it - 1 is consumed: its slot takes item it + R - 1
    if (tid == 0) {
      tf32x3::fence_async_smem();
      load(it + kTcR - 1);
    }
    const int64_t k0 = k_begin + (it / 3) * kTcRows;
    const int c = (int)(it % 3);
    if (k0 >= w_end || k0 + kTcRows <= w_begin) continue;  // no key of this tile for this warpgroup
    const unsigned char* slot = ring + (int)(it % kTcR) * kItem;
    mbar_wait(bars + it % kTcR, (uint32_t)((it / kTcR) & 1));  // item it has landed
    if (c == 0) {
      chain_ss(sc, qa, slot);  // S = Q K^T
    } else if (c == 1) {
      chain_ss(dp, ga, slot);  // dP = dO V^T
      const bool whole = whole_tile(qw0, k0, s, n_true, causal);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rh = e >> 1;
          const int64_t row = qw0 + 16 * warp + g + 8 * rh;
          const bool ok = whole || attends(row, k0 + 8 * i + 2 * t + (e & 1), s, n_true, causal);
          const float p = ok ? exp2f(fmaf(sc[4 * i + e], scale2, -lse2[rh])) : 0.f;
          dp[4 * i + e] = p * (dp[4 * i + e] - di_r[rh]);
        }
      to_a(dp, ab, as);
    } else {
      chain_rs(sc, ab, as, slot);  // this tile's dS K
#pragma unroll
      for (int e = 0; e < 32; ++e) gq[e] += sc[e];
    }
  }
  // every issued copy has landed before the block's shared memory goes
  if (tid == 0)
    for (int64_t it = items > kTcR ? items - kTcR : 0; it < items; ++it)
      mbar_wait(bars + it % kTcR, (uint32_t)((it / kTcR) & 1));
  store_acc(dq, gq, qw0, head, s, h, d, scale, warp, g, t);
}

int64_t tc_rows(int64_t s) { return (s + kTcBlockRows - 1) / kTcBlockRows * kTcBlockRows; }

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

// Floats of scratch the tc route needs for (s, h): 14 planes of h sp 64
// floats and lse and di of h sp each, sp = s rounded up to 128.
int64_t heat_flash_bwd_tc_scratch(int64_t s, int64_t h) { return (2 * kPlanes * kTcD + 2) * h * tc_rows(s); }

// The tc route's pre-pass: q, k, v, g (s, h, d) float32 with element strides
// st (three each, in that order) and lse, di (h, s) float32 into the scratch
// (at least heat_flash_bwd_tc_scratch(s, h) floats, 16-byte aligned).
// 1 <= d <= 64, s / 64 < 2^31 and h < 2^16.  Returns the CUDA error of the
// launch (0 on success); does not synchronise.
int heat_flash_bwd_prep(const float* q, const float* k, const float* v, const float* g, const float* lse,
                        const float* di, int64_t s, int64_t h, int64_t d, const int64_t* st, float* scratch,
                        void* stream) {
  if (s < 1 || h < 1 || h > 65535 || d < 1 || d > kTcD) return (int)cudaErrorInvalidValue;
  PrepSrc src;
  src.x[0] = q;
  src.x[1] = k;
  src.x[2] = v;
  src.x[3] = g;
  for (int i = 0; i < 12; ++i) src.st[i] = st[i];
  const int64_t sp = tc_rows(s);
  flash_bwd_prep<<<dim3((unsigned)(sp / kTcRows), (unsigned)h, 4), kPrepThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(src, lse, di, s, sp, (int)d, scratch);
  return (int)cudaGetLastError();
}

// The tc route's dK and dV from the pre-pass's scratch: dk, dv (s, h, d)
// float32, contiguous.  1 <= d <= 64.  Returns the CUDA error of the launch
// (0 on success); does not synchronise.
int heat_flash_bwd_dkv_tc(const float* scratch, float* dk, float* dv, int64_t s, int64_t h, int64_t d, float scale,
                          int64_t n_true, int causal, void* stream) {
  if (s < 1 || h < 1 || d < 1 || d > kTcD) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dkv_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvTcBytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t sp = tc_rows(s);
  flash_bwd_dkv_tc<<<(unsigned)(sp / kTcBlockRows * h), kTcThreads, kDkvTcBytes,
                     static_cast<cudaStream_t>(stream)>>>(scratch, dk, dv, s, sp, h, (int)d, scale, n_true, causal);
  return (int)cudaGetLastError();
}

// The tc route's dQ from the pre-pass's scratch and lse, di (h, s) float32:
// dq (s, h, d) float32, contiguous.  As heat_flash_bwd_dkv_tc otherwise.
int heat_flash_bwd_dq_tc(const float* scratch, const float* lse, const float* di, float* dq, int64_t s, int64_t h,
                         int64_t d, float scale, int64_t n_true, int causal, void* stream) {
  if (s < 1 || h < 1 || d < 1 || d > kTcD) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqTcBytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t sp = tc_rows(s);
  flash_bwd_dq_tc<<<(unsigned)(sp / kTcBlockRows * h), kTcThreads, kDqTcBytes,
                    static_cast<cudaStream_t>(stream)>>>(scratch, lse, di, dq, s, sp, h, (int)d, scale, n_true,
                                                         causal);
  return (int)cudaGetLastError();
}
}  // extern "C"
