// Fused Lloyd step of KMeans for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel heat_tpu/core/kernels.py::_lloyd_kernel (the Pallas
// kernel behind heat_tpu's `lloyd_update`).  On one rank's padded chunk of
// points x (rows, f) and the centres c (k, f) it computes, in one pass:
//   - the half-distance |c_j|^2 - 2 x.c_j in IEEE f32 (fmaf chains, no TF32),
//   - the nearest centre with first-index tie-break (strict <),
//   - per-cluster sums (k, f), member counts (k,) and the inertia
//     sum over valid rows of |x|^2 + min_j half-distance,
//   - optionally the int64 label of every row.
// Rows at or past n_true are padding: they add nothing to any sum.
//
// What bounds it: the step reads x once from HBM (4 f bytes a point) and does
// 2 k f flops a point, k/2 flops a byte: far below the H100's f32 balance of
// ~20 flops a byte, so one read of x is the floor.  Both routes keep every
// other operand on chip (the centres and |c|^2 in shared memory) and find
// each point's nearest centre from registers, one thread a point (two in
// the tc route at up to 32 features).
//
// Two routes, chosen by the caller (core/kernels.py::lloyd_route) and
// checked here:
//   - tc (f a multiple of 4, at most 8 output tiles of 16 features x 8
//     clusters, x 16-byte aligned; the KMeans path's 16 x 8 is one tile):
//     each warp owns 64 points at a time (two a lane, sharing each centre's
//     loads; 32 at 64 or 128 features) and waits only on itself.  Its
//     points arrive by cp.async in a three-stage ring of its own (two
//     batches in flight while it computes a third, two stages at 128
//     features; rows swizzled in 16-byte chunks so that both the row reads
//     and the fragment reads are free of bank conflicts).  The per-cluster
//     sums are one-hot products on the tensor cores (mma.sync m16n8k8
//     TF32), 32 points at a time: A = the features split into three TF32
//     planes (big, mid, small by truncation: exact for f32, and no
//     conversion instruction), B = the one-hot matrix of the labels
//     (exact), so every product term is exact;
//     each output tile takes three chains of 4 mma (4 steps of 8 points, one
//     chain a plane, independent so that their latencies overlap) from zero,
//     adds them in IEEE f32 and that into the warp's f64 accumulators.  Counts
//     are the one-hot fragments' own (exact integers); the inertia is
//     summed per lane in f64, then over the lanes in order.  No block
//     barrier in the loop.
//   - walk (every other shape the gate takes): one block stages a tile of
//     256 points, lists them by cluster (warp match, per-warp counts, a warp
//     scan) and one owner thread per output column adds its cluster's
//     points in index order.  Five block barriers a tile.
//
// Both are deterministic, with no float atomics: every sum is taken in a
// fixed order into f64 accumulators (warps in warp order, then a second
// kernel adds the per-block partials in block order).  A run is bitwise
// reproducible, and counts in f64 stay exact far past the 2^24 at which f32
// stops counting.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

// Per-phase cycle stamps (clock64), compiled in only where HEAT_LLOYD_PHASES
// is defined (lloyd_phases.cu): each thread adds the cycles between stamps to
// its phase's register, and at the end adds its registers into the block's
// row of `cycles` (blocks x kPhases, 64-bit integer atomics).  The timed
// build is a measurement only; nothing on the main path calls it.
constexpr int kPhases = 7;
#ifdef HEAT_LLOYD_PHASES
#define PHASE_INIT()                  \
  long long ph_[kPhases] = {};        \
  long long ph_t_ = clock64()
#define PHASE(p)                      \
  do {                                \
    const long long now_ = clock64(); \
    ph_[p] += now_ - ph_t_;           \
    ph_t_ = now_;                     \
  } while (0)
#define PHASE_FLUSH(cycles)                                                                          \
  do {                                                                                               \
    if (cycles != nullptr)                                                                           \
      for (int p_ = 0; p_ < kPhases; ++p_)                                                           \
        atomicAdd(cycles + (int64_t)blockIdx.x * kPhases + p_, (unsigned long long)ph_[p_]);         \
  } while (0)
#else
#define PHASE_INIT() \
  do {               \
  } while (0)
#define PHASE(p) \
  do {           \
  } while (0)
#define PHASE_FLUSH(cycles) \
  do {                      \
  } while (0)
#endif

namespace {

// phases of the stamps.  walk: staging, distances and argmin, match/count
// (with the inertia's warp sum), scan, list, column sums, the waits at block
// barriers.  tc: the cp.async wait and the next batch's copies, distances
// and argmin, labels and inertia, (no scan), the fragments' loads and
// split, the mma chains with the counts and their f64 flush, __syncwarp.
enum { kStage, kDistances, kCount, kScan, kList, kSums, kBarrier };

// ---------------------------------------------------------------- route tc
constexpr int kTcWarps = 4;  // warps per block, each on its own points
constexpr int kTcThreads = 32 * kTcWarps;
// points a lane owns at a time (two share each centre's loads; at 64 and
// 128 features one, for registers)
__host__ __device__ constexpr int tc_points(int fb) { return fb <= 32 ? 2 : 1; }
// batches in a warp's ring: 3 (two in flight while one is computed), 2 at
// 128 features (where 3 would not fit in shared memory)
__host__ __device__ constexpr int tc_stages(int fb) { return fb <= 64 ? 3 : 2; }
constexpr int kTcMaxTiles = 8;  // output tiles of 16 features x 8 clusters

// the feature width of a tc row: 16, 32, 64 or 128 (16 per tensor-core M tile)
inline int tc_bucket(int64_t f) { return f <= 16 ? 16 : f <= 32 ? 32 : f <= 64 ? 64 : 128; }
inline int tc_tiles(int64_t f, int64_t k) { return (tc_bucket(f) / 16) * (int)((k + 7) / 8); }

// doubles of one warp's accumulators: [tile][4][32] sums, k counts, inertia,
// rounded up to keep what follows 16-byte aligned
__host__ __device__ inline int tc_warp_doubles(int tiles, int k) { return (tiles * 128 + k + 1 + 1) & ~1; }

// Shared memory of one tc block, in this order: the warps' f64 accumulators;
// centres (k, FB) zero past f; |c|^2 (k, rounded up to 4); the warps' rings
// (tc_stages batches of 32 tc_points rows of FB floats each).
inline size_t tc_smem_bytes(int fb, int f, int k) {
  return 8 * (size_t)kTcWarps * tc_warp_doubles(tc_tiles(f, k), k) +
         4 * ((size_t)k * fb + ((k + 3) & ~3) + (size_t)kTcWarps * tc_stages(fb) * 32 * tc_points(fb) * fb);
}

// Physical 16-byte chunk of chunk cc in row r of a ring stage (CB chunks a
// row).  Row reads (lane = row, a float4 each) and the mma fragments' reads
// (lane (g, t) at rows t, t + 4 of a step, features g, g + 8 of a tile) each
// reach 8 distinct chunks of a 128-byte line in every quarter-warp: no bank
// conflicts either way.
template <int CB>
__device__ __forceinline__ int swz(int r, int cc) {
  if constexpr (CB == 4) return cc ^ ((r & 2) | ((r >> 2) & 1));
  else return cc ^ (((r & 3) << 1) | ((r >> 2) & 1));
}

// x = big + mid + small, each exact in TF32: big and mid keep the top 11
// significant bits of x and of what big left (truncated: a mask, no
// conversion), small the at most 2 bits left; both subtractions are exact
__device__ __forceinline__ void split3(float x, uint32_t& big, uint32_t& mid, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  const float r = x - __uint_as_float(big);
  mid = __float_as_uint(r) & 0xffffe000u;
  small = __float_as_uint(r - __uint_as_float(mid));
}

template <int FB>
__global__ void __launch_bounds__(kTcThreads, FB <= 32 ? 4 : FB <= 64 ? 2 : 1)
lloyd_tc_kernel(const float* __restrict__ x, const float* __restrict__ c, int64_t rows, int64_t n_true, int f,
                int k, double* __restrict__ partial, int64_t* __restrict__ labels,
                unsigned long long* __restrict__ cycles) {
  constexpr int CB = FB / 4;  // 16-byte chunks a row
  constexpr int MT = FB / 16;  // feature tiles
  constexpr int kTcStages = tc_stages(FB);
  constexpr int kTcPoints = tc_points(FB);
  constexpr int kTcBatch = 32 * kTcPoints;
  extern __shared__ float4 smem4[];
  const int NT = (k + 7) / 8, tiles = MT * NT;
  const int dw = tc_warp_doubles(tiles, k);
  double* dbase = reinterpret_cast<double*>(smem4);
  float* cs = reinterpret_cast<float*>(dbase + kTcWarps * dw);  // 16-byte aligned: float4 reads
  float* c2 = cs + k * FB;
  float* rings = c2 + ((k + 3) & ~3);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  double* acc = dbase + wid * dw;  // [tile][e][lane]
  double* cnt = acc + tiles * 128;
  double* inert = cnt + k;
  float* ring = rings + wid * kTcStages * kTcBatch * FB;

  for (int q = lane; q < dw; q += 32) acc[q] = 0.0;
  for (int e = threadIdx.x; e < k * FB; e += kTcThreads) {
    const int j = e / FB, d = e - j * FB;
    cs[e] = d < f ? c[(int64_t)j * f + d] : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += kTcThreads) {
    float s = 0.f;
    for (int d = 0; d < f; ++d) s = fmaf(cs[j * FB + d], cs[j * FB + d], s);
    c2[j] = s;
  }
  __syncthreads();

  // batch b (rows kTcBatch b ..) into ring stage st: this lane copies chunk cc of
  // rows rl, rl + 32 / CB, ... (consecutive lanes, consecutive 16 bytes);
  // chunks past f or past the last row are zero-filled (nothing read)
  constexpr int kRowStep = 32 / CB;
  const int rl = lane / CB, cc = lane % CB;
  const bool lane_in_f = 4 * cc < f;
  const int src_lane = rl * f + 4 * cc, src_step = kRowStep * f;
  auto fetch = [&](int64_t b, int st) {
    float* dst = ring + st * kTcBatch * FB;
    const int nrow = (int)(rows - b * kTcBatch < kTcBatch ? rows - b * kTcBatch : kTcBatch);
    const float* src = x + b * kTcBatch * f + src_lane;
#pragma unroll
    for (int i = 0; i < kTcPoints * CB; ++i) {
      const int r = rl + i * kRowStep;
      const bool ok = lane_in_f && r < nrow;
      tf32x3::cp16(dst + r * FB + 4 * swz<CB>(r, cc), ok ? src + i * src_step : x, ok ? 16u : 0u);
    }
  };

  const int64_t nb = (rows + kTcBatch - 1) / kTcBatch;
  const int64_t G = (int64_t)gridDim.x * kTcWarps;
  int64_t b = (int64_t)blockIdx.x * kTcWarps + wid;
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (b + s * G < nb) fetch(b + s * G, s);
    tf32x3::commit();
  }
  PHASE_INIT();
  int st = 0;
  double inert_lane = 0.0;  // this lane's points' inertia terms, in batch order
  for (; b < nb; b += G) {
    tf32x3::wait<kTcStages - 2>();
    PHASE(kStage);
    __syncwarp();  // every lane's copies of this batch landed; the stage read last is free
    PHASE(kBarrier);
    {
      const int64_t bn = b + (kTcStages - 1) * G;
      if (bn < nb) fetch(bn, st == 0 ? kTcStages - 1 : st - 1);
      tf32x3::commit();
    }
    PHASE(kStage);
    const float* xs = ring + st * kTcBatch * FB;
    st = st + 1 == kTcStages ? 0 : st + 1;

    // this lane's points (rows lane and lane + 32 of the batch), from their rows of the stage
    float xr[kTcPoints][FB], x2[kTcPoints], best[kTcPoints];
    int bj[kTcPoints];
#pragma unroll
    for (int p = 0; p < kTcPoints; ++p) {
#pragma unroll
      for (int cc = 0; cc < CB; ++cc) {
        const float4 v = *reinterpret_cast<const float4*>(xs + (lane + 32 * p) * FB + 4 * swz<CB>(lane, cc));
        xr[p][4 * cc] = v.x;
        xr[p][4 * cc + 1] = v.y;
        xr[p][4 * cc + 2] = v.z;
        xr[p][4 * cc + 3] = v.w;
      }
      x2[p] = 0.f;
#pragma unroll
      for (int i = 0; i < FB; ++i) x2[p] = fmaf(xr[p][i], xr[p][i], x2[p]);
      best[p] = INFINITY;
      bj[p] = 0;
    }
    for (int j = 0; j < k; ++j) {
      const float4* cj = reinterpret_cast<const float4*>(cs + j * FB);
      float dot[kTcPoints];
#pragma unroll
      for (int p = 0; p < kTcPoints; ++p) dot[p] = 0.f;
#pragma unroll
      for (int i = 0; i < FB / 4; ++i) {
        const float4 v = cj[i];
#pragma unroll
        for (int p = 0; p < kTcPoints; ++p) {
          dot[p] = fmaf(xr[p][4 * i], v.x, dot[p]);
          dot[p] = fmaf(xr[p][4 * i + 1], v.y, dot[p]);
          dot[p] = fmaf(xr[p][4 * i + 2], v.z, dot[p]);
          dot[p] = fmaf(xr[p][4 * i + 3], v.w, dot[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < kTcPoints; ++p) {
        const float h = c2[j] - 2.f * dot[p];
        if (h < best[p]) {
          best[p] = h;
          bj[p] = j;
        }
      }
    }
    PHASE(kDistances);
    int mylab[kTcPoints];  // -1: no valid point
#pragma unroll
    for (int p = 0; p < kTcPoints; ++p) {
      const int64_t row = b * kTcBatch + 32 * p + lane;
      mylab[p] = -1;
      if (row < rows) {
        if (labels != nullptr) labels[row] = bj[p];
        if (row < n_true) {
          mylab[p] = bj[p];
          inert_lane += (double)(x2[p] + best[p]);
        }
      }
    }
    PHASE(kCount);

#pragma unroll 1
    for (int half = 0; half < kTcPoints; ++half) {
      const float* xh = xs + half * 32 * FB;
      // the labels of the points this lane's B fragments cover: t and t + 4 of each step of 8
      int la[4], lb[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        la[s] = __shfl_sync(0xffffffffu, mylab[half], 8 * s + t);
        lb[s] = __shfl_sync(0xffffffffu, mylab[half], 8 * s + t + 4);
      }
      PHASE(kCount);

      // sums of these 32 points: per feature tile, A = (16 features x 8
      // points) in three planes, B = one-hot (8 points x 8 clusters)
#pragma unroll 1
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t ab[4][4], am[4][4], as[4][4];
        const int ja = 16 * mt + g, jb = ja + 8;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int ra = 8 * s + t, rb = ra + 4;
          const float v0 = xh[ra * FB + 4 * swz<CB>(ra, ja >> 2) + (ja & 3)];
          const float v1 = xh[ra * FB + 4 * swz<CB>(ra, jb >> 2) + (jb & 3)];
          const float v2 = xh[rb * FB + 4 * swz<CB>(rb, ja >> 2) + (ja & 3)];
          const float v3 = xh[rb * FB + 4 * swz<CB>(rb, jb >> 2) + (jb & 3)];
          split3(v0, ab[s][0], am[s][0], as[s][0]);
          split3(v1, ab[s][1], am[s][1], as[s][1]);
          split3(v2, ab[s][2], am[s][2], as[s][2]);
          split3(v3, ab[s][3], am[s][3], as[s][3]);
        }
        PHASE(kList);
        for (int nt = 0; nt < NT; ++nt) {
          const int cl = 8 * nt + g;
          // one chain a plane (three independent chains of 4 mma from zero),
          // then small + mid + big in IEEE f32
          float cs_[4], cm_[4], cb_[4];
          int members = 0;  // of cluster cl among this lane's 8 points
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const bool in0 = la[s] == cl, in1 = lb[s] == cl;
            const uint32_t b0 = in0 ? 0x3f800000u : 0u, b1 = in1 ? 0x3f800000u : 0u;
            members += in0 + in1;
            if (s == 0) {
              tf32x3::mma0(cs_, as[s], b0, b1);
              tf32x3::mma0(cm_, am[s], b0, b1);
              tf32x3::mma0(cb_, ab[s], b0, b1);
            } else {
              tf32x3::mma(cs_, as[s], b0, b1);
              tf32x3::mma(cm_, am[s], b0, b1);
              tf32x3::mma(cb_, ab[s], b0, b1);
            }
          }
          double* a = acc + (mt * NT + nt) * 128 + lane;
#pragma unroll
          for (int e = 0; e < 4; ++e) a[32 * e] += (double)((cs_[e] + cm_[e]) + cb_[e]);
          if (mt == 0) {  // the batch's count of cluster cl: the 4 lanes (g, t) together hold its 32 points
            members += __shfl_xor_sync(0xffffffffu, members, 1);
            members += __shfl_xor_sync(0xffffffffu, members, 2);
            if (t == 0 && cl < k) cnt[cl] += (double)members;
          }
        }
        PHASE(kSums);
      }
    }
  }
  tf32x3::wait<0>();
  PHASE_FLUSH(cycles);
  // the warp's inertia: its lanes' sums added in lane order
  double* lanes = reinterpret_cast<double*>(ring);  // the ring is free once every lane is past the loop
  __syncwarp();
  lanes[lane] = inert_lane;
  __syncwarp();
  if (lane == 0) {
    double sum = 0.0;
    for (int l = 0; l < 32; ++l) sum += lanes[l];
    inert[0] = sum;
  }
  __syncthreads();

  // the block's partial: the warps' accumulators added in warp order
  const int kf = k * f, w = kf + k + 1;
  for (int q = threadIdx.x; q < w; q += kTcThreads) {
    int at;  // offset within a warp's doubles
    if (q < kf) {
      const int j = q / f, d = q - j * f;
      const int e = 2 * ((d & 15) >> 3) + (j & 1);
      at = (((d >> 4) * NT + (j >> 3)) * 4 + e) * 32 + 4 * (d & 7) + ((j & 7) >> 1);
    } else {
      at = tiles * 128 + (q - kf);  // counts, then the inertia
    }
    double s = 0.0;
    for (int ww = 0; ww < kTcWarps; ++ww) s += dbase[ww * dw + at];
    partial[(int64_t)blockIdx.x * w + q] = s;
  }
}

// ---------------------------------------------------------------- route walk
constexpr int kTile = 256;  // points per tile == threads per block
constexpr int kWarps = kTile / 32;

// Shared memory of one walk block, in this order: centres (k, FB) zero past
// f; acc (f64, k*f sums | k counts | inertia); |c|^2 (k); the x tile (row
// stride FB + 1 keeps per-thread row reads free of bank conflicts); per-warp
// cluster counts and list offsets (kWarps, k); the tile's point list grouped
// by cluster; per-warp inertia sums.
inline size_t smem_bytes(int fb, int f, int k) {
  const size_t w = (size_t)k * f + k + 1;
  return 4 * (size_t)k * fb + 8 * w +
         4 * (k + (size_t)kTile * (fb + 1) + 2 * kWarps * k + kTile + kWarps);
}

template <int FB>
__global__ void __launch_bounds__(kTile, FB <= 16 ? 3 : FB <= 32 ? 2 : 1)
lloyd_walk_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int64_t rows, int64_t n_true, int f, int k,
                     double* __restrict__ partial, int64_t* __restrict__ labels,
                     unsigned long long* __restrict__ cycles) {
  extern __shared__ float4 smem4[];
  const int kf = k * f;
  const int w = kf + k + 1;  // columns: k*f sums, k counts, 1 inertia
  float* cs = reinterpret_cast<float*>(smem4);  // 16-byte aligned: float4 reads
  double* acc = reinterpret_cast<double*>(cs + k * FB);
  float* c2 = reinterpret_cast<float*>(acc + w);
  float* xs = c2 + k;
  int* wcnt = reinterpret_cast<int*>(xs + kTile * (FB + 1));
  int* woff = wcnt + kWarps * k;
  int* plist = woff + kWarps * k;
  float* wval = reinterpret_cast<float*>(plist + kTile);
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;

  for (int q = tid; q < w; q += kTile) acc[q] = 0.0;
  for (int e = tid; e < k * FB; e += kTile) {
    const int j = e / FB, d = e - j * FB;
    cs[e] = d < f ? c[(int64_t)j * f + d] : 0.f;
  }
  __syncthreads();
  for (int j = tid; j < k; j += kTile) {
    float s = 0.f;
    for (int d = 0; d < f; ++d) s = fmaf(cs[j * FB + d], cs[j * FB + d], s);
    c2[j] = s;
  }

  const int step_r = kTile / f, step_d = kTile % f;  // f <= 128 < kTile
  const int64_t ntiles = (rows + kTile - 1) / kTile;
  // the tile's cnt*f floats are contiguous; each thread loads its share into
  // registers, all loads in flight together.  Narrow rows are loaded one tile
  // ahead of the compute; wide ones (FB >= 64) would need too many registers.
  constexpr bool kPrefetch = FB <= 32;
  float buf[FB];
  auto load_tile = [&](int64_t tt) {
    const int64_t b = tt * kTile;
    const int n = (int)(rows - b < kTile ? rows - b : kTile) * f;
    const float* src = x + b * f;
#pragma unroll
    for (int i = 0; i < FB; ++i) {
      const int e = tid + i * kTile;
      buf[i] = e < n ? __ldg(src + e) : 0.f;
    }
  };
  if (kPrefetch && blockIdx.x < ntiles) load_tile(blockIdx.x);
  PHASE_INIT();
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t base = t * kTile;
    const int cnt = (int)(rows - base < kTile ? rows - base : kTile);
    const int nel = cnt * f;
    if (!kPrefetch) load_tile(t);
    PHASE(kStage);
    __syncthreads();  // the previous tile is consumed (and c2 is written)
    PHASE(kBarrier);
    int r = tid / f, d = tid - (tid / f) * f;
#pragma unroll
    for (int i = 0; i < FB; ++i) {
      if (tid + i * kTile < nel) xs[r * (FB + 1) + d] = buf[i];
      r += step_r;
      d += step_d;
      if (d >= f) {
        d -= f;
        ++r;
      }
    }
    for (int e = tid; e < kWarps * k; e += kTile) wcnt[e] = 0;
    PHASE(kStage);
    __syncthreads();
    PHASE(kBarrier);
    if (kPrefetch && t + gridDim.x < ntiles) load_tile(t + gridDim.x);
    PHASE(kStage);

    // nearest centre of this thread's point, from registers
    int mylab = -1;  // -1: no valid point
    float myval = 0.f;
    if (tid < cnt) {
      float xr[FB];
#pragma unroll
      for (int i = 0; i < FB; ++i) xr[i] = i < f ? xs[tid * (FB + 1) + i] : 0.f;
      float x2 = 0.f;
#pragma unroll
      for (int i = 0; i < FB; ++i) x2 = fmaf(xr[i], xr[i], x2);
      float best = INFINITY;
      int bj = 0;
      for (int j = 0; j < k; ++j) {
        const float4* cj = reinterpret_cast<const float4*>(cs + j * FB);
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < FB / 4; ++i) {
          const float4 v = cj[i];
          dot = fmaf(xr[4 * i], v.x, dot);
          dot = fmaf(xr[4 * i + 1], v.y, dot);
          dot = fmaf(xr[4 * i + 2], v.z, dot);
          dot = fmaf(xr[4 * i + 3], v.w, dot);
        }
        const float h = c2[j] - 2.f * dot;
        if (h < best) {
          best = h;
          bj = j;
        }
      }
      const int64_t row = base + tid;
      if (labels != nullptr) labels[row] = bj;
      if (row < n_true) {
        mylab = bj;
        myval = x2 + best;
      }
    }
    PHASE(kDistances);
    // this point's rank among its warp's points of the same cluster, and
    // the warp's count of that cluster
    const unsigned peers = __match_any_sync(0xffffffffu, mylab);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (mylab >= 0 && rank == 0) wcnt[wid * k + mylab] = __popc(peers);
    float v = myval;  // warp sum of the inertia terms, in a fixed order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) wval[wid] = v;
    PHASE(kCount);
    __syncthreads();
    PHASE(kBarrier);

    // list layout: clusters in order, each cluster's points in index order.
    // Warp 0 scans the per-warp counts in (cluster, warp) order into the
    // list offsets woff; cluster j's points are woff[j] .. the end of the
    // last warp's run.
    if (wid == 0) {
      const int n = kWarps * k, per = (n + 31) / 32;
      const int e0 = lane * per < n ? lane * per : n, e1 = e0 + per < n ? e0 + per : n;
      int sum = 0;
      for (int e = e0; e < e1; ++e) sum += wcnt[(e % kWarps) * k + e / kWarps];
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      int run = incl - sum;
      for (int e = e0; e < e1; ++e) {
        const int at = (e % kWarps) * k + e / kWarps;
        woff[at] = run;
        run += wcnt[at];
      }
    }
    PHASE(kScan);
    __syncthreads();
    PHASE(kBarrier);
    if (mylab >= 0) plist[woff[wid * k + mylab] + rank] = tid;
    PHASE(kList);
    __syncthreads();
    PHASE(kBarrier);

    // column sums over the tile, each column owned by one thread: work item
    // q < k*f sums feature q%f of cluster q/f over the cluster's list (and
    // counts the cluster when q%f == 0); the last thread adds the inertia
    for (int q = tid; q < kf; q += kTile) {
      const int j = q / f, dd = q - j * f;
      const int last = (kWarps - 1) * k + j;
      const int s0 = woff[j], s1 = woff[last] + wcnt[last];
      float s = 0.f;
      for (int i = s0; i < s1; ++i) s += xs[plist[i] * (FB + 1) + dd];
      acc[q] += (double)s;
      if (dd == 0) acc[kf + j] += (double)(s1 - s0);
    }
    if (tid == kTile - 1) {
      float s = 0.f;
      for (int ww = 0; ww < kWarps; ++ww) s += wval[ww];
      acc[kf + k] += (double)s;
    }
    PHASE(kSums);
  }
  PHASE_FLUSH(cycles);
  __syncthreads();
  for (int q = tid; q < w; q += kTile) partial[(int64_t)blockIdx.x * w + q] = acc[q];
}

// out[q] = sum over blocks b, in order, of partial[b, q]
__global__ void lloyd_reduce_kernel(const double* __restrict__ partial, int64_t nblocks, int w,
                                    double* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= w) return;
  double s = 0.0;
  for (int64_t b = 0; b < nblocks; ++b) s += partial[b * w + q];
  out[q] = s;
}

enum Route { kWalk = 0, kTc = 1 };

template <int FB>
struct Kernel {
  static void* fn(int route) {
    if (route == kTc) {
      if constexpr (FB >= 16) return (void*)lloyd_tc_kernel<FB>;
      return nullptr;
    }
    return (void*)lloyd_walk_kernel<FB>;
  }
};

// the walk route's feature bucket (8 .. 128), or the tc route's (16 .. 128)
int bucket(int64_t f, int route) {
  if (route == kTc) return tc_bucket(f);
  return f <= 8 ? 8 : f <= 16 ? 16 : f <= 32 ? 32 : f <= 64 ? 64 : 128;
}

size_t route_smem(int route, int fb, int f, int k) {
  return route == kTc ? tc_smem_bytes(fb, f, k) : smem_bytes(fb, f, k);
}

// whether the route takes f features and k centres (x's alignment aside)
bool route_takes(int route, int64_t f, int64_t k) {
  if (f < 1 || f > 128 || k < 1) return false;
  if (route == kWalk) return true;
  return route == kTc && f % 4 == 0 && tc_tiles(f, k) <= kTcMaxTiles;
}

template <int FB>
int blocks_per_sm(int route, int f, int k) {
  void* fn = Kernel<FB>::fn(route);
  const size_t smem = route_smem(route, FB, f, k);
  int n = 0;
  if (fn == nullptr ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, route == kTc ? kTcThreads : kTile, smem) != cudaSuccess)
    return 0;
  return n;
}

template <int FB>
cudaError_t launch(int route, const float* x, const float* c, int64_t rows, int64_t n_true, int f, int k,
                   double* partial, int64_t nblocks, double* out, int64_t* labels, unsigned long long* cycles,
                   cudaStream_t stream) {
  const size_t smem = route_smem(route, FB, f, k);
  void* fn = Kernel<FB>::fn(route);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (route == kTc)
    lloyd_tc_kernel<(FB >= 16 ? FB : 16)><<<(unsigned)nblocks, kTcThreads, smem, stream>>>(
        x, c, rows, n_true, f, k, partial, labels, cycles);
  else
    lloyd_walk_kernel<FB><<<(unsigned)nblocks, kTile, smem, stream>>>(x, c, rows, n_true, f, k, partial, labels,
                                                                     cycles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int w = k * f + k + 1;
  lloyd_reduce_kernel<<<(w + 255) / 256, 256, 0, stream>>>(partial, nblocks, w, out);
  return cudaGetLastError();
}

int step(const void* x, const void* c, int64_t rows, int64_t n_true, int64_t f, int64_t k, void* partial,
         int64_t nblocks, void* out, void* labels, int64_t route, void* stream, void* cycles) {
  const int r = (int)route;
  if ((r != kWalk && r != kTc) || !route_takes(r, f, k) || nblocks < 1 || rows < 0)
    return (int)cudaErrorInvalidValue;
  if (r == kTc && reinterpret_cast<uintptr_t>(x) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(c);
  double* pp = static_cast<double*>(partial);
  double* op = static_cast<double*>(out);
  int64_t* lp = static_cast<int64_t*>(labels);
  unsigned long long* cy = static_cast<unsigned long long*>(cycles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fi = (int)f, ki = (int)k;
  switch (bucket(f, r)) {
    case 8: return (int)launch<8>(r, xp, cp, rows, n_true, fi, ki, pp, nblocks, op, lp, cy, s);
    case 16: return (int)launch<16>(r, xp, cp, rows, n_true, fi, ki, pp, nblocks, op, lp, cy, s);
    case 32: return (int)launch<32>(r, xp, cp, rows, n_true, fi, ki, pp, nblocks, op, lp, cy, s);
    case 64: return (int)launch<64>(r, xp, cp, rows, n_true, fi, ki, pp, nblocks, op, lp, cy, s);
    default: return (int)launch<128>(r, xp, cp, rows, n_true, fi, ki, pp, nblocks, op, lp, cy, s);
  }
}

}  // namespace

extern "C" {

// Blocks of the Lloyd kernel's route (0 walk, 1 tc) one SM holds at once for
// f features and k centres (0 on error or where the route does not take the
// shape); the grid should not exceed this times the SM count.
int64_t heat_lloyd_blocks_per_sm(int64_t f, int64_t k, int64_t route) {
  const int r = (int)route;
  if ((r != kWalk && r != kTc) || !route_takes(r, f, k)) return 0;
  const int fi = (int)f, ki = (int)k;
  switch (bucket(f, r)) {
    case 8: return blocks_per_sm<8>(r, fi, ki);
    case 16: return blocks_per_sm<16>(r, fi, ki);
    case 32: return blocks_per_sm<32>(r, fi, ki);
    case 64: return blocks_per_sm<64>(r, fi, ki);
    default: return blocks_per_sm<128>(r, fi, ki);
  }
}

// One fused Lloyd step by the route (0 walk, 1 tc; the caller chooses, and a
// route that does not take the shape or, for tc, an x not 16-byte aligned is
// refused).  x (rows, f) and c (k, f) are contiguous f32 on the device;
// partial is f64 scratch of nblocks * (k*f + k + 1); out (k*f + k + 1) f64
// receives [sums (k, f) | counts (k) | inertia]; labels (rows,) int64 or null.
// Launches on `stream` and does not synchronise.  Returns the CUDA error code
// (0 on success).
int heat_lloyd_step_f32(const void* x, const void* c, int64_t rows, int64_t n_true, int64_t f, int64_t k,
                        void* partial, int64_t nblocks, void* out, void* labels, int64_t route, void* stream) {
  return step(x, c, rows, n_true, f, k, partial, nblocks, out, labels, route, stream, nullptr);
}

#ifdef HEAT_LLOYD_PHASES
// The same step in the stamped build, adding each block's cycles per phase
// into cycles (nblocks x kPhases uint64, zeroed by the caller).
int heat_lloyd_phases_f32(const void* x, const void* c, int64_t rows, int64_t n_true, int64_t f, int64_t k,
                          void* partial, int64_t nblocks, void* out, void* labels, int64_t route, void* stream,
                          void* cycles) {
  return step(x, c, rows, n_true, f, k, partial, nblocks, out, labels, route, stream, cycles);
}
#endif

}  // extern "C"
