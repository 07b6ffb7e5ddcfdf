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
// ~20 flops a byte, so one read of x is the floor.  The design keeps every
// other operand on chip: the centres and |c|^2 sit in shared memory, each
// tile of 256 points is staged once into shared memory with coalesced loads
// (all of a thread's loads issued together), and each thread finds its
// point's nearest centre from registers.
//
// The sums are deterministic, with no float atomics: each tile's points are
// listed by cluster in index order (warp match + per-warp counts), then one
// owner thread per output column adds its cluster's points in that order into
// an f64 accumulator; a second kernel adds the per-block partials in block
// order.  A run is bitwise reproducible, and counts in f64 stay exact far past
// the 2^24 at which f32 stops counting.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 256;  // points per tile == threads per block
constexpr int kWarps = kTile / 32;

// Shared memory of one block, in this order: centres (k, FB) zero past f;
// acc (f64, k*f sums | k counts | inertia); |c|^2 (k); the x tile (row stride
// FB + 1 keeps per-thread row reads free of bank conflicts); per-warp cluster
// counts and list offsets (kWarps, k); the tile's point list grouped by
// cluster; per-warp inertia sums.
inline size_t smem_bytes(int fb, int f, int k) {
  const size_t w = (size_t)k * f + k + 1;
  return 4 * (size_t)k * fb + 8 * w +
         4 * (k + (size_t)kTile * (fb + 1) + 2 * kWarps * k + kTile + kWarps);
}

template <int FB>
__global__ void __launch_bounds__(kTile, FB <= 16 ? 3 : FB <= 32 ? 2 : 1)
lloyd_partial_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int64_t rows, int64_t n_true, int f, int k,
                     double* __restrict__ partial, int64_t* __restrict__ labels) {
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
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int64_t base = t * kTile;
    const int cnt = (int)(rows - base < kTile ? rows - base : kTile);
    const int nel = cnt * f;
    if (!kPrefetch) load_tile(t);
    __syncthreads();  // the previous tile is consumed (and c2 is written)
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
    __syncthreads();
    if (kPrefetch && t + gridDim.x < ntiles) load_tile(t + gridDim.x);

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
    // this point's rank among its warp's points of the same cluster, and
    // the warp's count of that cluster
    const unsigned peers = __match_any_sync(0xffffffffu, mylab);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (mylab >= 0 && rank == 0) wcnt[wid * k + mylab] = __popc(peers);
    float v = myval;  // warp sum of the inertia terms, in a fixed order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) wval[wid] = v;
    __syncthreads();

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
    __syncthreads();
    if (mylab >= 0) plist[woff[wid * k + mylab] + rank] = tid;
    __syncthreads();

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
  }
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

template <int FB>
cudaError_t set_smem(int f, int k) {
  return cudaFuncSetAttribute(lloyd_partial_kernel<FB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(FB, f, k));
}

template <int FB>
int blocks_per_sm(int f, int k) {
  int n = 0;
  if (set_smem<FB>(f, k) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, lloyd_partial_kernel<FB>, kTile,
                                                    smem_bytes(FB, f, k)) != cudaSuccess)
    return 0;
  return n;
}

template <int FB>
cudaError_t launch(const float* x, const float* c, int64_t rows, int64_t n_true, int f, int k,
                   double* partial, int64_t nblocks, double* out, int64_t* labels,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(FB, f, k);
  cudaError_t err = set_smem<FB>(f, k);
  if (err != cudaSuccess) return err;
  lloyd_partial_kernel<FB><<<(unsigned)nblocks, kTile, smem, stream>>>(x, c, rows, n_true, f, k,
                                                                        partial, labels);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int w = k * f + k + 1;
  lloyd_reduce_kernel<<<(w + 255) / 256, 256, 0, stream>>>(partial, nblocks, w, out);
  return cudaGetLastError();
}

int feature_bucket(int64_t f) { return f <= 8 ? 8 : f <= 16 ? 16 : f <= 32 ? 32 : f <= 64 ? 64 : 128; }

}  // namespace

extern "C" {

// Blocks of the Lloyd kernel one SM holds at once for f features and k
// centres (0 on error); the grid should not exceed this times the SM count.
int64_t heat_lloyd_blocks_per_sm(int64_t f, int64_t k) {
  if (f < 1 || f > 128 || k < 1) return 0;
  const int fi = (int)f, ki = (int)k;
  switch (feature_bucket(f)) {
    case 8: return blocks_per_sm<8>(fi, ki);
    case 16: return blocks_per_sm<16>(fi, ki);
    case 32: return blocks_per_sm<32>(fi, ki);
    case 64: return blocks_per_sm<64>(fi, ki);
    default: return blocks_per_sm<128>(fi, ki);
  }
}

// One fused Lloyd step.  x (rows, f) and c (k, f) are contiguous f32 on the
// device; partial is f64 scratch of nblocks * (k*f + k + 1); out (k*f + k + 1)
// f64 receives [sums (k, f) | counts (k) | inertia]; labels (rows,) int64 or
// null.  Launches on `stream` and does not synchronise.  Returns the CUDA error
// code (0 on success).
int heat_lloyd_step_f32(const void* x, const void* c, int64_t rows, int64_t n_true, int64_t f,
                        int64_t k, void* partial, int64_t nblocks, void* out, void* labels,
                        void* stream) {
  if (f < 1 || f > 128 || k < 1 || nblocks < 1) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* cp = static_cast<const float*>(c);
  double* pp = static_cast<double*>(partial);
  double* op = static_cast<double*>(out);
  int64_t* lp = static_cast<int64_t*>(labels);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fi = (int)f, ki = (int)k;
  switch (feature_bucket(f)) {
    case 8: return (int)launch<8>(xp, cp, rows, n_true, fi, ki, pp, nblocks, op, lp, s);
    case 16: return (int)launch<16>(xp, cp, rows, n_true, fi, ki, pp, nblocks, op, lp, s);
    case 32: return (int)launch<32>(xp, cp, rows, n_true, fi, ki, pp, nblocks, op, lp, s);
    case 64: return (int)launch<64>(xp, cp, rows, n_true, fi, ki, pp, nblocks, op, lp, s);
    default: return (int)launch<128>(xp, cp, rows, n_true, fi, ki, pp, nblocks, op, lp, s);
  }
}

}  // extern "C"
