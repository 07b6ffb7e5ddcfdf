// 3xTF32 products on Hopper's tensor cores, and the cp.async copies that feed
// them: the helpers shared by fft_stage.cu (K3/K4, wgmma), fft_axis.cu (K6,
// mma.sync), flash_attn.cu (K7, wgmma), flash_attn_bwd.cu (K7-bwd's tc
// route, wgmma) and syrk.cu (K2, wgmma).
//
// 3xTF32: a float x is split into big = rna_tf32(x) and small =
// rna_tf32(x - big), each exact in TF32 (10 mantissa bits).  A product a b is
// taken as a_small b_big + a_big b_small + a_big b_big, summed in one f32
// accumulator by the tensor core, mma.sync m16n8k8 or wgmma m64n64k8 (the
// small x small term, about 2^-22 relative, is dropped).  Its error is about 2^-21 relative per product:
// f32-class, where one TF32 pass keeps about three decimal digits.  Both
// operands must be rounded with cvt.rna: the tensor core truncates the low
// 13 bits of whatever it is given, which costs about 1e-3.
//
// Fragment positions of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32,
// with g = lane / 4 and t = lane % 4 (PTX ISA, the .tf32 m16n8k8 figures):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

// x rounded to TF32, nearest with ties away from zero (cvt.rna), as the bits
// of an f32 whose low 13 bits are zero (the mask keeps that so whatever the
// conversion leaves there)
__device__ __forceinline__ uint32_t rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x = big + small, both TF32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = rna(x);
  small = rna(x - __uint_as_float(big));
}

// c += a b on the tensor cores, one TF32 pass
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a b on the tensor cores, one TF32 pass, from a zero accumulator
__device__ __forceinline__ void mma0(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// c += a b in 3xTF32: the two small terms first, then the big one
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma(c, as, bb0, bb1);
  mma(c, ab, bs0, bs1);
  mma(c, ab, bb0, bb1);
}

// The tensor core's f32 accumulation truncates, and its error grows with the
// length of a chain of mma on one accumulator (a K = 512 stage chained 768 of
// them and drifted several times as far).  So a complex product over one k8
// step is summed as a short chain of its own, six mma from zero, and added to
// the running sum in IEEE f32 on the CUDA cores (fft_stage.cu's wgmma chains
// span four 16-deep stages, 48 wgmma, the same way).
//   re += ar wr - ai wi,  im += ar wi + ai wr    (-wi by its sign bit, exactly)
__device__ __forceinline__ void cmma3(float (&re)[4], float (&im)[4], const uint32_t (&arb)[4],
                                      const uint32_t (&ars)[4], const uint32_t (&aib)[4], const uint32_t (&ais)[4],
                                      uint32_t wrb0, uint32_t wrb1, uint32_t wrs0, uint32_t wrs1, uint32_t wib0,
                                      uint32_t wib1, uint32_t wis0, uint32_t wis1) {
  const uint32_t neg = 0x80000000u;
  float tr[4], ti[4];
  mma0(tr, ars, wrb0, wrb1);
  mma(tr, arb, wrs0, wrs1);
  mma(tr, arb, wrb0, wrb1);
  mma3(tr, aib, ais, wib0 ^ neg, wib1 ^ neg, wis0 ^ neg, wis1 ^ neg);
  mma0(ti, ars, wib0, wib1);
  mma(ti, arb, wis0, wis1);
  mma(ti, arb, wib0, wib1);
  mma3(ti, aib, ais, wrb0, wrb1, wrs0, wrs1);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    re[e] += tr[e];
    im[e] += ti[e];
  }
}

// --- wgmma (warpgroup) forms, used by fft_stage.cu ---------------------------
//
// m64n64k8 with A from registers: each warp of the warpgroup holds a 16 x 8
// slice of A (rows 16 (warp % 4) + ...) in the m16n8k8 positions above, and
// its 16 rows of D as eight n8 tiles, D[4 i + e] in the C positions of tile i.
// B comes from shared memory K-major without swizzle: core matrices of 8 rows
// (n) x 16 bytes (4 k), rows 16 bytes apart; `lbo` is the byte distance of
// core matrices neighbouring in k, `sbo` in n.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = smem_addr(p);
  return ((addr >> 4) & 0x3fff) | (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32;
}

// d = sa a b + (scale_d ? d : 0); sa = +1 or -1 (a negated exactly)
template <int SA>
__device__ __forceinline__ void wg_mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, %38, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(SA));
}

// d = a b + (scale_d ? d : 0), both operands from shared memory (K-major, no
// swizzle, as above: A's core matrices are 8 rows (m) x 16 bytes (4 k))
__device__ __forceinline__ void wg_mma_ss(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += a b in 3xTF32 with both operands from shared memory: the big and small
// planes of A (ab, as) and of B (bb, bs)
__device__ __forceinline__ void wg_mma3_ss(float (&d)[32], uint64_t ab, uint64_t as, uint64_t bb, uint64_t bs,
                                           int scale_d) {
  wg_mma_ss(d, as, bb, scale_d);
  wg_mma_ss(d, ab, bs, 1);
  wg_mma_ss(d, ab, bb, 1);
}

// byte offset of element (row r, depth j) of a 64-row plane laid out for the
// descriptors above (lbo 128, sbo 256): slab j / 8 of 2048 bytes, core matrix
// (r / 8, (j % 8) / 4), row r % 8, column j % 4
__device__ __forceinline__ int cm_off(int r, int j) {
  return (j >> 3) * 2048 + (r >> 3) * 256 + ((j >> 2) & 1) * 128 + (r & 7) * 16 + (j & 3) * 4;
}

// d += a b in 3xTF32 on one warpgroup accumulator chain (scale_d = 0 starts it)
template <int SA>
__device__ __forceinline__ void wg_mma3(float (&d)[32], const uint32_t (&ab)[4], const uint32_t (&as)[4], uint64_t bb,
                                        uint64_t bs, int scale_d) {
  wg_mma<SA>(d, as, bb, scale_d);
  wg_mma<SA>(d, ab, bs, 1);
  wg_mma<SA>(d, ab, bb, 1);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of r above the wait that completes it
__device__ __forceinline__ void wg_pin(float (&r)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(r[e])::"memory");
}
// orders this thread's generic shared-memory writes before wgmma's reads
__device__ __forceinline__ void fence_async_smem() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Asynchronous copies global -> shared of 16, 8 or 4 bytes.  Only `bytes` of
// them are read (0 reads nothing) and the rest of the destination is zeroed,
// so masked rows and depths arrive as zeros.  The source must be aligned to
// the copy's width.
__device__ __forceinline__ void cp16(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp8(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tf32x3
