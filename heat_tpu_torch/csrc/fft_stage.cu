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
// What bounds it: the operations.  At 512^3 (K = n = 512, M = 131072 for K3,
// 262144 for K4) a stage is 8 K M n = 2.75e11 (K3) or 5.50e11 (K4) flops
// against 0.32 / 0.64 ms of bytes.  The products run on the tensor cores in
// 3xTF32 (tf32x3.cuh): three TF32 products a flop, so the floor at the
// card's 495 TF32 TFLOP/s is 1.67 ms (K3) and 3.33 ms (K4); the design it
// replaces multiplied in f32 on the CUDA cores, whose floor is 4.1 / 8.2 ms.
// What the design does:
//   - Tiles.  A block of two warpgroups owns 128 rows x 64 bins of both
//     outputs; each warpgroup 64 rows x 64 bins, re and im, with wgmma
//     m64n64k8: per k8 step twelve of them (four real products of the
//     complex one, three TF32 passes each).
//   - Operands.  The operand (A) goes to wgmma from registers: each thread
//     loads its fragments from the shared tile and splits them into TF32
//     big and small parts there.  The stage matrix (B) is read by wgmma
//     from shared memory, K-major without swizzle: W is square and C and S
//     are symmetric, so row k of W holds bin k's depths contiguously, and
//     bins x 4 depths copy straight into 8 x 16-byte core matrices.  W is
//     split into big and small tiles once, where it lands (each thread
//     splits the elements it copied).
//   - A ring of 4 cp.async stages of 16 depths: the operand's re and im
//     tiles (16 x 128) and W's C and S tiles (64 x 16), two stages in flight
//     ahead of the one multiplied.  The copy width follows the pointers: 16
//     bytes where the base, lda, mb and bs allow (separate planes), 8 bytes
//     for the (re, im) pairs of a complex64 operand, read into an
//     interleaved tile, 4 bytes otherwise (views such as z[..., 1:]); W in
//     16-byte copies when n % 4 == 0, else 4-byte ones.
//   - Asynchrony.  A stage's wgmma group runs while the next stage is split
//     and its fragments loaded (double-buffered in registers by the
//     stage's parity); a warpgroup waits for group s - 1 only after issuing
//     group s.
//   - The sums.  The tensor core's own f32 accumulation truncates, and its
//     error grows with the length of a chain on one accumulator.  So the
//     products go into a temporary chain of 4 stages (48 wgmma), which is
//     then added to the f32 sums in IEEE arithmetic on the CUDA cores.
//   - The operand's rows are padded to 8 mod 32 floats, so that each
//     fragment load of a warp hits 32 banks (two 8-byte halves for the
//     interleaved tile).
//   - L2.  The bin tiles of one row tile are adjacent in the launch order, so
//     the operand tile they share comes from device memory once and from L2
//     after; the stage matrix (2 MB at n = 512) stays in L2.
//   - No atomics.  Each output is summed in a fixed order, so a second
//     launch is bitwise equal to the first.
//   - Ragged shapes.  Rows past M, bins past n and depths past K arrive as
//     zeros in both operands (the copies read nothing there) and the stores
//     are guarded; a row tile may straddle two blocks of a cat operand, since
//     every row computes its own column (16-byte copies only where mb and bs
//     are multiples of 4, so a group of 4 rows never straddles).
//   - The design before this one, mma.sync m16n8k8 from 8 warps of 32 x 32
//     with the same ring and split, measured slower on the card (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "tf32x3.cuh"

namespace {

constexpr int kBM = 128;  // rows per block: two warpgroups of 64
constexpr int kBN = 64;   // bins per block
constexpr int kBK = 16;   // depth per stage: two k8 slabs
constexpr int kStages = 4;   // two stages in flight ahead of the one multiplied, one still read by its group
constexpr int kThreads = 256;
constexpr int kLdA = kBM + 8;       // planar operand tile row (floats), 8 mod 32
constexpr int kLdA2 = 2 * kBM + 8;  // interleaved (re, im) operand tile row, 8 mod 32
constexpr int kABytes = 4 * 2 * kBK * kLdA;  // 17408, >= 4 kBK kLdA2
constexpr int kSlabBytes = kBN * 8 * 4;      // 64 bins x 8 depths of f32: 2048
constexpr int kPartBytes = 2 * kSlabBytes;   // two slabs a stage
constexpr int kWBytes = 4 * kPartBytes;      // C big, S big, C small, S small
constexpr int kStageBytes = kABytes + kWBytes;
constexpr size_t kSmemBytes = (size_t)kStages * kStageBytes;
static_assert(kABytes % 128 == 0 && kStageBytes % 128 == 0, "aligned tiles");

enum : int { kAVec = 1, kWVec = 2, kPairOut = 4 };

// W element (bin nb, depth jj) lies at tf32x3::cm_off(nb, jj) within a part
// of a stage: slabs of 64 bins x 8 depths
static_assert(kSlabBytes == 2048, "tf32x3::cm_off's slab");

template <bool kPair>
__global__ void __launch_bounds__(kThreads, 1)
stage_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im, int64_t lda, int64_t es, int64_t mb,
             int64_t bs, int64_t K, int64_t M, int64_t n, int64_t n_tiles, const float* __restrict__ w,
             float* __restrict__ o_re, float* __restrict__ o_im, int64_t ldo, int64_t es_out, int flags) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int64_t tile_n = blockIdx.x % n_tiles;
  const int64_t tile_m = blockIdx.x / n_tiles;
  const int64_t r0 = tile_m * kBM;
  const int64_t k0 = tile_n * kBN;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = 64 * (warp >> 2) + 16 * (warp & 3);  // the warp's 16 rows in the tile
  const bool a_vec = flags & kAVec, w_vec = flags & kWVec;
  const int64_t ldw = 2 * n;
  constexpr int kFlush = 4;  // stages a temporary chain spans before it is added in IEEE f32
  // the depth in whole chains of kFlush stages; the stages past K arrive as zeros
  const int64_t steps = (K + kFlush * kBK - 1) / (kFlush * kBK) * kFlush;

  const int ar = a_vec ? 4 * (tid % 32) : tid % kBM;
  const int aj = a_vec ? tid / 32 : tid / kBM;
  const int64_t gr = r0 + ar;
  const int64_t left = M - gr;
  const int a_rows = a_vec ? (int)(left < 0 ? 0 : left > 4 ? 4 : left) : (left > 0 ? 1 : 0);
  const int64_t acol = a_rows > 0 ? ((gr / mb) * bs + gr % mb) * es : 0;
  // W: bin wb (row k0 + wb of the symmetric W), depths 4 wq .. 4 wq + 3
  const int wb = tid % kBN, wq = tid / kBN;
  const bool w_ok = k0 + wb < n;
  const float* wrow_p = w + (w_ok ? (k0 + wb) * ldw : 0);

  auto a_tile = [&](int buf) { return reinterpret_cast<float*>(smem + buf * kStageBytes); };
  auto w_part = [&](int buf, int p) { return smem + buf * kStageBytes + kABytes + p * kPartBytes; };
  // W's part p (C big, S big, C small, S small), slab kk, as wgmma's B: core
  // matrices 128 bytes apart in k, 256 in n
  auto desc = [&](int buf, int p, int kk) { return tf32x3::wg_desc(w_part(buf, p) + kk * kSlabBytes, 128, 256); };

  auto load = [&](int64_t s, int buf) {
    const int64_t kb = s * kBK;
    float* sa = a_tile(buf);
    if (kPair) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int j = aj + 2 * i;
        const bool ok = a_rows > 0 && kb + j < K;
        tf32x3::cp8(sa + j * kLdA2 + 2 * ar, ok ? a_re + (kb + j) * lda + acol : a_re, ok ? 8u : 0u);
      }
    } else if (a_vec) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = aj + 8 * i;
        const uint32_t bytes = kb + j < K ? 4u * a_rows : 0u;
        const int64_t off = bytes ? (kb + j) * lda + acol : 0;
        tf32x3::cp16(sa + j * kLdA + ar, a_re + off, bytes);
        tf32x3::cp16(sa + kBK * kLdA + j * kLdA + ar, a_im + off, bytes);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) {
        const int j = aj + 2 * i;
        const uint32_t bytes = a_rows > 0 && kb + j < K ? 4u : 0u;
        const int64_t off = bytes ? (kb + j) * lda + acol : 0;
        tf32x3::cp4(sa + j * kLdA + ar, a_re + off, bytes);
        tf32x3::cp4(sa + kBK * kLdA + j * kLdA + ar, a_im + off, bytes);
      }
    }
    const int64_t j0 = kb + 4 * wq;
    const int64_t dl = K - j0;
    const int depth = w_ok ? (int)(dl < 0 ? 0 : dl > 4 ? 4 : dl) : 0;
    unsigned char* dc = w_part(buf, 0) + tf32x3::cm_off(wb, 4 * wq);
    unsigned char* ds = w_part(buf, 1) + tf32x3::cm_off(wb, 4 * wq);
    if (w_vec) {
      tf32x3::cp16(dc, depth ? wrow_p + j0 : w, 4u * depth);
      tf32x3::cp16(ds, depth ? wrow_p + n + j0 : w, 4u * depth);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = e < depth;
        tf32x3::cp4(dc + 4 * e, ok ? wrow_p + j0 + e : w, ok ? 4u : 0u);
        tf32x3::cp4(ds + 4 * e, ok ? wrow_p + n + j0 + e : w, ok ? 4u : 0u);
      }
    }
  };

  auto split_w = [&](int buf) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float* big = reinterpret_cast<float*>(w_part(buf, p) + tf32x3::cm_off(wb, 4 * wq));
      float* small = reinterpret_cast<float*>(w_part(buf, p + 2) + tf32x3::cm_off(wb, 4 * wq));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        uint32_t b, l;
        tf32x3::split(big[e], b, l);
        big[e] = __uint_as_float(b);
        small[e] = __uint_as_float(l);
      }
    }
  };

  float acc_re[32], acc_im[32], tr[32], ti[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    acc_re[e] = 0.f;
    acc_im[e] = 0.f;
    tr[e] = 0.f;
    ti[e] = 0.f;
  }

  // A fragments, double-buffered by the parity of the stage: a stage's
  // wgmma group may still read its registers while the next stage's load
  uint32_t rb[2][2][4], rs[2][2][4], ib[2][2][4], is[2][2][4];

  load(0, 0);
  tf32x3::commit();
  load(1, 1);
  tf32x3::commit();
  // stage s; Q = s % kFlush, known at compile time, so that no branch
  // separates a wgmma group from its wait (ptxas would wait for all groups
  // at such a merge)
  auto body = [&](int64_t s, auto q) {
    constexpr int Q = decltype(q)::value;
    constexpr int P = Q & 1;
    const int buf = (int)(s % kStages);
    tf32x3::wait<1>();  // stage s has landed
    split_w(buf);
    tf32x3::fence_async_smem();
    __syncthreads();  // stage s is split; stage s - 2's group is done in every warpgroup
    load(s + 2, (int)((s + 2) % kStages));  // past the depth it reads nothing
    tf32x3::commit();
    const float* sa = a_tile(buf);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 8 * kk + t + 4 * (e >> 1);
        const int r = wrow + g + 8 * (e & 1);
        float xr, xi;
        if (kPair) {
          const float2 v = *reinterpret_cast<const float2*>(sa + j * kLdA2 + 2 * r);
          xr = v.x;
          xi = v.y;
        } else {
          xr = sa[j * kLdA + r];
          xi = sa[kBK * kLdA + j * kLdA + r];
        }
        tf32x3::split(xr, rb[P][kk][e], rs[P][kk][e]);
        tf32x3::split(xi, ib[P][kk][e], is[P][kk][e]);
      }
    tf32x3::wg_pin(tr);
    tf32x3::wg_pin(ti);
    tf32x3::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t cb = desc(buf, 0, kk), sb = desc(buf, 1, kk), cs = desc(buf, 2, kk), ss = desc(buf, 3, kk);
      const int first = Q == 0 && kk == 0 ? 0 : 1;  // a chain starts from zero
      // re += ar C - ai S, im += ar S + ai C
      tf32x3::wg_mma3<1>(tr, rb[P][kk], rs[P][kk], cb, cs, first);
      tf32x3::wg_mma3<-1>(tr, ib[P][kk], is[P][kk], sb, ss, 1);
      tf32x3::wg_mma3<1>(ti, rb[P][kk], rs[P][kk], sb, ss, first);
      tf32x3::wg_mma3<1>(ti, ib[P][kk], is[P][kk], cb, cs, 1);
    }
    tf32x3::wg_commit();
    tf32x3::wg_wait<1>();  // stage s - 1's group is done: its registers and (after the next barrier) its buffer are free
    tf32x3::wg_pin(tr);
    tf32x3::wg_pin(ti);
  };
  for (int64_t s = 0; s < steps; s += kFlush) {
    body(s, std::integral_constant<int, 0>());
    body(s + 1, std::integral_constant<int, 1>());
    body(s + 2, std::integral_constant<int, 2>());
    body(s + 3, std::integral_constant<int, 3>());
    tf32x3::wg_wait<0>();
    tf32x3::wg_pin(tr);
    tf32x3::wg_pin(ti);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      acc_re[e] += tr[e];
      acc_im[e] += ti[e];
    }
  }
  tf32x3::wait<0>();

  const bool pair_out = flags & kPairOut;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t r = r0 + wrow + g + 8 * h;
      if (r >= M) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t k = k0 + 8 * i + 2 * t + e;
        if (k >= n) continue;
        const float re = acc_re[4 * i + 2 * h + e], im = acc_im[4 * i + 2 * h + e];
        if (pair_out) {
          *reinterpret_cast<float2*>(o_re + r * ldo + 2 * k) = make_float2(re, im);
        } else {
          o_re[r * ldo + k * es_out] = re;
          o_im[r * ldo + k * es_out] = im;
        }
      }
    }
}

template <bool kPair>
cudaError_t launch(const float* a_re, const float* a_im, int64_t lda, int64_t es, int64_t mb, int64_t bs, int64_t K,
                   int64_t M, int64_t n, const float* w, float* o_re, float* o_im, int64_t ldo, int64_t es_out,
                   int flags, cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(stage_kernel<kPair>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return err;
  const int64_t n_tiles = (n + kBN - 1) / kBN;
  const int64_t blocks = n_tiles * ((M + kBM - 1) / kBM);
  stage_kernel<kPair><<<(unsigned)blocks, kThreads, kSmemBytes, s>>>(a_re, a_im, lda, es, mb, bs, K, M, n, n_tiles,
                                                                     w, o_re, o_im, ldo, es_out, flags);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

extern "C" {

// One DFT stage over the leading axis (see the note above).  a_re / a_im
// point at element (0, 0) of the re and im operands, lda is the distance
// between their rows j and es_in (1 or 2) the distance between neighbouring
// columns, all in floats; column col(r) = (r / mb) * bs + r % mb.  w is the
// contiguous (K, 2n) stage matrix, square (K == n) with symmetric C and S
// blocks, as every DFT stage matrix is.  o_re / o_im point at output (0, 0),
// ldo is the row stride and es_out (1 or 2) the bin stride, in floats.
// Launches on `stream` and does not synchronise.  Returns the CUDA error code
// (0 on success).
int heat_fft_stage_f32(const void* a_re, const void* a_im, int64_t lda, int64_t es_in, int64_t mb, int64_t bs,
                       int64_t K, int64_t M, int64_t n, const void* w, void* o_re, void* o_im, int64_t ldo,
                       int64_t es_out, void* stream) {
  if (K < 1 || M < 1 || n < 1 || K != n || mb < 1 || bs < 0 || lda < 1 || (es_in != 1 && es_in != 2) ||
      (es_out != 1 && es_out != 2))
    return (int)cudaErrorInvalidValue;
  if (((n + kBN - 1) / kBN) * ((M + kBM - 1) / kBM) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* ar = static_cast<const float*>(a_re);
  const float* ai = static_cast<const float*>(a_im);
  const float* wp = static_cast<const float*>(w);
  float* orp = static_cast<float*>(o_re);
  float* oip = static_cast<float*>(o_im);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int flags = 0;
  if (es_in == 1 && lda % 4 == 0 && mb % 4 == 0 && bs % 4 == 0 && aligned(ar, 16) && aligned(ai, 16)) flags |= kAVec;
  if (n % 4 == 0 && aligned(wp, 16)) flags |= kWVec;
  if (es_out == 2 && oip == orp + 1 && ldo % 2 == 0 && aligned(orp, 8)) flags |= kPairOut;
  const bool pair_in = es_in == 2 && ai == ar + 1 && lda % 2 == 0 && aligned(ar, 8);
  if (pair_in) return (int)launch<true>(ar, ai, lda, es_in, mb, bs, K, M, n, wp, orp, oip, ldo, es_out, flags, s);
  return (int)launch<false>(ar, ai, lda, es_in, mb, bs, K, M, n, wp, orp, oip, ldo, es_out, flags, s);
}

}  // extern "C"
