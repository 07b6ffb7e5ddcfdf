// Forward flash attention, float32, for sm_90a: the products on the tensor
// cores in 3xTF32.
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
// What bounds it: the two products over the causal half, 2 s^2 h d FLOP (at
// (16384, 8, 64): 2.75e11); the bytes (q, k, v and out once each, 17 MB at
// that shape) are far below them.  The TPU kernel multiplies in one bf16
// pass (0.28 ms at 989 TFLOP/s).  Here each product is three TF32 products
// on the tensor cores (tf32x3.cuh), f32-class: their floor at 495 TFLOP/s is
// 1.67 ms, where the design before this one, exact f32 FMAs on the CUDA
// cores, could not go under 4.10 ms.  The exp work (about 1.07e9 expf at
// that shape) is far below the products.  What the design does:
//   - A pre-pass (flash_prep) reads k and v once through their strides and
//     writes their TF32 big and small planes into the wrapper's scratch: K as
//     (h, sp, DP) (keys x depths) and V transposed as (h, DP, sp) (columns x
//     keys), sp = s rounded up to 64 keys and DP = d rounded up to 64, zeros
//     past s and d.  Both then land in shared memory as the K-major B
//     operands that wgmma's .tf32 form needs (it has no transpose), with
//     16-byte cp.async copies and no split in the main loop.
//   - A warpgroup owns 64 queries, two warpgroups a block (one where
//     d > 64), sharing its K and V tiles; Q is split once per block into
//     TF32 planes in shared memory and is wgmma's A operand from there, so
//     S = Q K^T is m64n64k8 with both operands in shared memory.  (One
//     warpgroup a block at d = 64 was slower on the card, and a warpgroup
//     that overlapped its softmax of tile j with its P V of tile j - 1 was
//     no faster: PERF.md.)
//   - P from the score accumulator into the A fragment of O = P V without a
//     shuffle: a thread's accumulator holds keys (2t, 2t + 1) of each group of
//     8, the A fragment wants depths (t, t + 4), so the pre-pass stores key
//     perm8(p) at position p of each group of 8 in V's planes.  P is split
//     into big and small in registers.
//   - Precision.  The tensor core's f32 accumulation truncates, and its error
//     grows with the length of a chain on one accumulator.  So every chain
//     is short and starts from zero: S over 64 depths (24 wgmma), added in
//     IEEE f32 where d > 64; P V over one key tile (24 wgmma), added to the
//     running output in IEEE f32 after the online-softmax rescale (m, l and
//     corr in f32, as before).
//   - A ring of R items of 32 KB (a 64 x 64 chunk of K or V, big and small;
//     R = 4 at d <= 64, else 3) fed by cp.async, R - 1 items ahead: per key
//     tile, DP / 64 chunks of K then the block's 64 columns of V.  Wider heads (d > 64) split the
//     output's columns over blockIdx.y (one block per 64 columns, each
//     recomputing S): a (64 x 256) output with its chain would not fit one
//     warpgroup's registers.
//   - Masks only where needed: key tiles wholly above the diagonal (causal)
//     or wholly in the other segment are skipped, by the block and by each
//     warpgroup; only tiles that cross the diagonal, the segment boundary or
//     the end of the sequence are masked element by element.  Query tiles
//     are launched last-first, so under causal the longest rows start first.
//   - No atomics: a repeat is bitwise equal.
//   - For the backward (flash_attn_bwd.cu), the first column block of each
//     row also writes lse = m + log l, the log-sum-exp of the row's scaled
//     scores, into an (h, s) float32 buffer; a null pointer skips it, so a
//     forward without a gradient writes nothing more.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kBQ = 64;               // queries per warpgroup
constexpr int kBK = 64;               // keys per tile
constexpr int kC = 64;                // depths (Q K^T) or output columns (P V) per ring item
constexpr int kPlane = kBK * kC * 4;  // one 64 x 64 f32 plane: 16 KB
constexpr int kItem = 2 * kPlane;     // its big and small planes
constexpr int kPrepThreads = 256;

template <int ND, int NWG, int R>
struct Cfg {
  static constexpr int DP = ND * kC;             // padded head dimension
  static constexpr int threads = 128 * NWG;
  static constexpr int q_bytes = NWG * ND * kItem;  // Q's planes, per warpgroup and depth chunk
  static constexpr int bytes = q_bytes + R * kItem;
};

// position p of a group of 8 keys in V's planes holds key perm8(p): the score
// accumulator's columns 2t and 2t + 1 are then the A fragment's depths t and
// t + 4
__device__ __forceinline__ int perm8(int p) { return ((p & 3) << 1) | (p >> 2); }

__device__ __forceinline__ uint64_t desc(const unsigned char* p) { return tf32x3::wg_desc(p, 128, 256); }

// The pre-pass: k and v of (key tile blockIdx.x, head blockIdx.y) split into
// TF32 planes: kb/ks (h, sp, dp), vb/vs (h, dp, sp) with keys permuted within
// groups of 8; zeros past s and d.
__global__ void __launch_bounds__(kPrepThreads) flash_prep(const float* __restrict__ k, const float* __restrict__ v,
                                                           int64_t s, int64_t sp, int dp, int d, int64_t ks,
                                                           int64_t kh, int64_t kd, int64_t vs, int64_t vh,
                                                           int64_t vd, float* __restrict__ kb, float* __restrict__ ksm,
                                                           float* __restrict__ vb, float* __restrict__ vsm) {
  __shared__ float tile[kBK][kC + 1];
  const int64_t k0 = (int64_t)blockIdx.x * kBK, head = blockIdx.y;
  const float* kh_ = k + head * kh;
  const float* vh_ = v + head * vh;
  for (int e = threadIdx.x; e < kBK * dp; e += kPrepThreads) {
    const int r = e / dp, c = e % dp;
    const int64_t row = k0 + r;
    uint32_t b, l;
    tf32x3::split((row < s && c < d) ? kh_[row * ks + c * kd] : 0.f, b, l);
    const int64_t o = (head * sp + row) * dp + c;
    kb[o] = __uint_as_float(b);
    ksm[o] = __uint_as_float(l);
  }
  for (int c0 = 0; c0 < dp; c0 += kC) {  // V through shared memory, 64 columns at a time
    __syncthreads();
    for (int e = threadIdx.x; e < kBK * kC; e += kPrepThreads) {
      const int r = e / kC, c = e % kC;
      const int64_t row = k0 + r;
      tile[r][c] = (row < s && c0 + c < d) ? vh_[row * vs + (c0 + c) * vd] : 0.f;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kBK * kC; e += kPrepThreads) {
      const int c = e / kBK, p = e % kBK;
      uint32_t b, l;
      tf32x3::split(tile[(p & ~7) | perm8(p & 7)][c], b, l);
      const int64_t o = (head * dp + c0 + c) * sp + k0 + p;
      vb[o] = __uint_as_float(b);
      vsm[o] = __uint_as_float(l);
    }
  }
}

// the keys [kb_, ke_) that queries [r0, r0 + rn) attend, as a range
__device__ __forceinline__ void key_range(int64_t r0, int64_t rn, int64_t s, int64_t n_true, int causal,
                                          int64_t& kb_, int64_t& ke_) {
  const int64_t last = (r0 + rn < s ? r0 + rn : s) - 1;
  kb_ = 0;
  ke_ = causal ? last + 1 : s;
  if (last < n_true) {
    ke_ = ke_ < n_true ? ke_ : n_true;  // real queries attend no padding
  } else if (r0 >= n_true) {
    kb_ = n_true;  // padding attends no real key
  }
}

template <int ND, int NWG, int R>
__global__ void __launch_bounds__(128 * NWG) flash_fwd(
    const float* __restrict__ q, const float* __restrict__ kb, const float* __restrict__ ksm,
    const float* __restrict__ vb, const float* __restrict__ vsm, float* __restrict__ out, float* __restrict__ lse,
    int64_t s, int64_t sp, int64_t h, int d, int64_t qs, int64_t qh, int64_t qd, float scale, int64_t n_true,
    int causal) {
  using C = Cfg<ND, NWG, R>;
  constexpr int DP = C::DP;
  constexpr int kRows = kBQ * NWG;  // queries per block
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* const qsm = smem;
  unsigned char* const ring = smem + C::q_bytes;

  const int64_t tiles = (s + kRows - 1) / kRows;
  const int64_t tile = tiles - 1 - (int64_t)blockIdx.x / h;
  const int64_t head = (int64_t)blockIdx.x % h;
  const int oc = blockIdx.y;  // the block's 64 output columns
  const int64_t q0 = tile * kRows;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t qw0 = q0 + kBQ * wg;  // the warpgroup's first query

  // Q, split into TF32 planes in shared memory: A of S = Q K^T
  const float* qh_ = q + head * qh;
  for (int e = tid; e < kRows * DP; e += C::threads) {
    const int r = e / DP, c = e % DP;
    const int64_t row = q0 + r;
    uint32_t b, l;
    tf32x3::split((row < s && c < d) ? qh_[row * qs + c * qd] : 0.f, b, l);
    unsigned char* p = qsm + ((r / kBQ) * ND + c / kC) * kItem + tf32x3::cm_off(r % kBQ, c % kC);
    *reinterpret_cast<float*>(p) = __uint_as_float(b);
    *reinterpret_cast<float*>(p + kPlane) = __uint_as_float(l);
  }
  tf32x3::fence_async_smem();  // read by wgmma after the first barrier below

  // the key tiles the block needs (the union of its warpgroups'), and this
  // warpgroup's keys
  int64_t k_begin, k_end, w_begin, w_end;
  key_range(q0, kRows, s, n_true, causal, k_begin, k_end);
  k_begin = (k_begin / kBK) * kBK;
  key_range(qw0, kBQ, s, n_true, causal, w_begin, w_end);
  const bool w_rows = qw0 < s;
  const int64_t nkt = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;

  float S[32], T[32], O[32], Ot[32];
  uint32_t pb[8][4], ps[8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2] = {1.f, 1.f};
#pragma unroll
  for (int e = 0; e < 32; ++e) O[e] = 0.f;

  // one 64-depth chunk of S = Q K^T into acc from zero: 8 k8 slabs, three
  // TF32 products each
  auto scores = [&](float(&acc)[32], const unsigned char* qa, const unsigned char* slot) {
    tf32x3::wg_fence();
#pragma unroll
    for (int kk = 0; kk < kC / 8; ++kk)
      tf32x3::wg_mma3_ss(acc, desc(qa + kk * 2048), desc(qa + kPlane + kk * 2048), desc(slot + kk * 2048),
                         desc(slot + kPlane + kk * 2048), kk == 0 ? 0 : 1);
    tf32x3::wg_commit();
    tf32x3::wg_wait<0>();
    tf32x3::wg_pin(acc);
  };
  // the online softmax of key tile k0's scores S, in f32, in place: S
  // becomes P, m and l move on, corr takes the rescale of the output so
  // far.  Masks only on tiles that cross the diagonal, the segment boundary
  // or the end.
  auto softmax = [&](int64_t k0) {
    const bool full = k0 + kBK <= s && qw0 + kBQ <= s && !(causal && k0 + kBK - 1 > qw0) &&
                      ((qw0 + kBQ <= n_true && k0 + kBK <= n_true) || (qw0 >= n_true && k0 >= n_true));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = S[4 * i + e] * scale;
        if (!full) {
          const int64_t row = qw0 + 16 * warp + g + 8 * (e >> 1);
          const int64_t j = k0 + 8 * i + 2 * t + (e & 1);
          const bool ok = j < s && ((j >= n_true) == (row >= n_true)) && (!causal || j <= row);
          x = ok ? x : -INFINITY;
        }
        S[4 * i + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      // the four threads of a row are lanes differing in t
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 1));
      mx[rh] = fmaxf(mx[rh], __shfl_xor_sync(0xffffffffu, mx[rh], 2));
      const float m_new = fmaxf(m[rh], mx[rh]);
      base[rh] = m_new == -INFINITY ? 0.f : m_new;  // a row with no key yet adds nothing
      corr[rh] = expf(m[rh] - base[rh]);
      m[rh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(S[4 * i + e] - base[e >> 1]);
        S[4 * i + e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      rs[rh] += __shfl_xor_sync(0xffffffffu, rs[rh], 1);
      rs[rh] += __shfl_xor_sync(0xffffffffu, rs[rh], 2);
      l[rh] = l[rh] * corr[rh] + rs[rh];
    }
  };
  // item it: chunk c < ND of K's depths, or (c == ND) the block's columns of
  // V, of key tile it / (ND + 1), big and small planes; into slot it % R.
  // Every call commits a group (empty past the end), so the waits below
  // count alike.
  const int64_t items = nkt * (ND + 1);
  auto load = [&](int64_t it) {
    if (it < items) {
      const int64_t k0 = k_begin + (it / (ND + 1)) * kBK;
      const int c = (int)(it % (ND + 1));
      const bool is_v = c == ND;
      const int64_t off = is_v ? (head * DP + oc * kC) * sp + k0 : (head * sp + k0) * DP + c * kC;
      const int64_t ld = is_v ? sp : DP;
      const float* big = is_v ? vb : kb;
      const float* small = is_v ? vsm : ksm;
      unsigned char* dst = ring + (int)(it % R) * kItem;
      for (int e = tid; e < kBK * kC / 4; e += C::threads) {
        const int r = (e & 7) | ((e >> 7) << 3), j = ((e >> 3) & 15) * 4;  // 8 rows of 16 bytes: 128 bytes a phase
        const int o = tf32x3::cm_off(r, j);
        const int64_t src = off + r * ld + j;
        tf32x3::cp16(dst + o, big + src, 16);
        tf32x3::cp16(dst + kPlane + o, small + src, 16);
      }
    }
    tf32x3::commit();
  };

#pragma unroll 1
  for (int i = 0; i < R - 1; ++i) load(i);
#pragma unroll 1
  for (int64_t it = 0; it < items; ++it) {
    tf32x3::wait<R - 2>();  // item it has landed (this thread's copies)
    tf32x3::fence_async_smem();
    __syncthreads();  // every thread's copies of it have landed; item it - 1 is consumed
    load(it + R - 1);  // into the slot of item it - 1
    const int64_t k0 = k_begin + (it / (ND + 1)) * kBK;
    const int c = (int)(it % (ND + 1));
    if (!w_rows || k0 >= w_end || k0 + kBK <= w_begin) continue;  // no key of this tile for this warpgroup
    const unsigned char* slot = ring + (int)(it % R) * kItem;
    if (c < ND) {
      const unsigned char* qa = qsm + (wg * ND + c) * kItem;
      if (ND == 1 || c == 0) {
        scores(S, qa, slot);
      } else {
        scores(T, qa, slot);
#pragma unroll
        for (int e = 0; e < 32; ++e) S[e] += T[e];
      }
      if (c < ND - 1) continue;
      softmax(k0);
      // P as the A fragments of P V: depth t is key 2t, depth t + 4 key 2t + 1
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        tf32x3::split(S[4 * kk + 0], pb[kk][0], ps[kk][0]);
        tf32x3::split(S[4 * kk + 2], pb[kk][1], ps[kk][1]);
        tf32x3::split(S[4 * kk + 1], pb[kk][2], ps[kk][2]);
        tf32x3::split(S[4 * kk + 3], pb[kk][3], ps[kk][3]);
      }
    } else {
      // this key tile's P V from a zero accumulator, added to the rescaled output in f32
      tf32x3::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 8; ++kk)
        tf32x3::wg_mma3<1>(Ot, pb[kk], ps[kk], desc(slot + kk * 2048), desc(slot + kPlane + kk * 2048),
                           kk == 0 ? 0 : 1);
      tf32x3::wg_commit();
      tf32x3::wg_wait<0>();
      tf32x3::wg_pin(Ot);
#pragma unroll
      for (int e = 0; e < 32; ++e) O[e] = O[e] * corr[(e >> 1) & 1] + Ot[e];
    }
  }
  tf32x3::wait<0>();

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int64_t row = qw0 + 16 * warp + g + 8 * rh;
    if (row >= s) continue;
    if (lse != nullptr && oc == 0 && t == 0) lse[head * s + row] = m[rh] + logf(l[rh]);
    float* orow = out + (row * h + head) * d;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = oc * kC + 8 * i + 2 * t + e;
        if (col < d) orow[col] = O[4 * i + 2 * rh + e] / l[rh];
      }
  }
}

template <int ND, int NWG, int R>
cudaError_t launch_fwd(const float* q, const float* kb, const float* ksm, const float* vb, const float* vsm,
                       float* out, float* lse, int64_t s, int64_t sp, int64_t h, int d, int64_t qs, int64_t qh,
                       int64_t qd, float scale, int64_t n_true, int causal, cudaStream_t stream) {
  using C = Cfg<ND, NWG, R>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd<ND, NWG, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((s + kBQ * NWG - 1) / (kBQ * NWG) * h), ND);
  flash_fwd<ND, NWG, R><<<grid, C::threads, C::bytes, stream>>>(q, kb, ksm, vb, vsm, out, lse, s, sp, h, d, qs, qh,
                                                                 qd, scale, n_true, causal);
  return cudaGetLastError();
}

int64_t padded_keys(int64_t s) { return (s + kBK - 1) / kBK * kBK; }
int padded_dim(int64_t d) { return (int)((d + kC - 1) / kC * kC); }

}  // namespace

extern "C" {

// Floats of scratch heat_flash_attn_f32 needs for (s, h, d): the four TF32
// planes of K and V.
int64_t heat_flash_attn_scratch(int64_t s, int64_t h, int64_t d) { return 4 * h * padded_keys(s) * padded_dim(d); }

// q, k, v: (s, h, d) float32 with element strides (qs, qh, qd, ks, kh, kd,
// vs, vh, vd); out: (s, h, d) float32, contiguous; lse: null, or (h, s)
// float32 for each row's log-sum-exp (the backward's); scratch: at least
// heat_flash_attn_scratch(s, h, d) floats.  1 <= d <= 256 and
// ceil(s / 64) * h < 2^31 (the wrapper's gate).  Returns the CUDA error of
// the launches (0 on success); does not synchronise.
int heat_flash_attn_f32(const float* q, const float* k, const float* v, float* out, float* lse, int64_t s, int64_t h,
                        int64_t d, int64_t qs, int64_t qh, int64_t qd, int64_t ks, int64_t kh, int64_t kd,
                        int64_t vs, int64_t vh, int64_t vd, float scale, int64_t n_true, int causal, float* scratch,
                        void* stream) {
  if (s < 1 || h < 1 || d < 1 || d > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int64_t sp = padded_keys(s);
  const int dp = padded_dim(d), dd = (int)d;
  const int64_t plane = h * sp * dp;
  float *kb = scratch, *ksm = scratch + plane, *vb = scratch + 2 * plane, *vsm = scratch + 3 * plane;
  flash_prep<<<dim3((unsigned)(sp / kBK), (unsigned)h), kPrepThreads, 0, cs>>>(k, v, s, sp, dp, dd, ks, kh, kd, vs, vh,
                                                                               vd, kb, ksm, vb, vsm);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (dp / kC) {
    case 1:
      return (int)launch_fwd<1, 2, 4>(q, kb, ksm, vb, vsm, out, lse, s, sp, h, dd, qs, qh, qd, scale, n_true, causal, cs);
    case 2:
      return (int)launch_fwd<2, 1, 3>(q, kb, ksm, vb, vsm, out, lse, s, sp, h, dd, qs, qh, qd, scale, n_true, causal, cs);
    case 3:
      return (int)launch_fwd<3, 1, 3>(q, kb, ksm, vb, vsm, out, lse, s, sp, h, dd, qs, qh, qd, scale, n_true, causal, cs);
    default:
      return (int)launch_fwd<4, 1, 3>(q, kb, ksm, vb, vsm, out, lse, s, sp, h, dd, qs, qh, qd, scale, n_true, causal, cs);
  }
}

}  // extern "C"
