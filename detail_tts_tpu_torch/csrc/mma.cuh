// Warp-level building blocks shared by the bias-attention kernels (sm_90a):
// cp.async tile copies, ldmatrix and the m16n8k16 bf16 tensor-core product.
//
// Fragment layout of mma.sync.m16n8k16 (thread = lane, g = lane / 4,
// t4 = lane % 4):
//   A 16x16 (row):  a[0] (g, 2t4..+1), a[1] (g+8, 2t4..+1),
//                   a[2] (g, 8+2t4..+1), a[3] (g+8, 8+2t4..+1);
//   B 16x8  (col):  b[0] (k 2t4..+1, n g), b[1] (k 8+2t4..+1, n g);
//   C 16x8:         c[0..1] (g, 2t4..+1), c[2..3] (g+8, 2t4..+1).
// So the accumulators of two neighbouring 8-wide column blocks of a product
// are, rounded to bf16, the A operand of one 16-deep k-step of the next.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;       // rows of a q, k or v tile
constexpr int NTHREADS = 128;  // 4 warps x 16 rows
constexpr int WROWS = 16;      // rows per warp
constexpr float FLOOR = -1.0e4f;
// Row statistic of a row whose softmax sum is 0 (every key masked): large
// and finite, so exp2(z - lse) is exactly 0 in the backward.
constexpr float MASKED_LSE = 1.0e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with ``valid`` false the destination is zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 8-byte async copy (any 8-byte aligned address); zero-filled unless ``valid``.
__device__ __forceinline__ void cp_async_8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}
// 4-byte async copy (any 4-byte aligned address); zero-filled unless ``valid``.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b for one m16n8k16 tile: bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two bf16 of a 32-bit word (low half first) as floats.
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// 2^x on the special-function unit (ex2.approx, as exp2f), results below
// 2^-126 flushed to 0, without exp2f's fix-up of such results.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand of k-step kk from the accumulators of column blocks 2kk, 2kk+1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Async copy of rows [r0, r0 + ROWS) (columns [0, D)) of a row-major bf16
// matrix into a shared tile with row stride D + 8; rows past T are zero.
template <int D, int ROWS = TILE>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int r0,
                                          int t_len, long row_stride) {
  constexpr int LDT = D + 8;  // +16 bytes a row: ldmatrix rows hit distinct banks
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const bool valid = r0 + r < t_len;
    cp_async_16(dst + r * LDT + c, src + (long)(valid ? r0 + r : 0) * row_stride + c, valid);
  }
}

// A operand (16 rows of this warp, k-step kk) from a shared tile [row][ch].
template <int LDT>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int row0,
                                       int kk, int lane) {
  ldmatrix_x4(a, tile + (row0 + lane % 16) * LDT + kk * 16 + (lane / 16) * 8);
}

// B operands of X Y^T for column blocks 2n2, 2n2+1 at k-step kk, Y a shared
// tile [n][k] (keys for Q K^T): b[0], b[1] block 2n2; b[2], b[3] block 2n2+1.
template <int LDT>
__device__ __forceinline__ void load_b_nt(uint32_t (&b)[4], const bf16* tile, int n2,
                                          int kk, int lane) {
  ldmatrix_x4(b, tile + (n2 * 16 + (lane / 16) * 8 + lane % 8) * LDT + kk * 16 +
                     ((lane / 8) % 2) * 8);
}

// B operands of X Y for column blocks 2n2, 2n2+1 at k-step kk, Y a shared
// tile [k][n] (values for P V): the same fragments through .trans.
template <int LDT>
__device__ __forceinline__ void load_b_nn(uint32_t (&b)[4], const bf16* tile, int n2,
                                          int kk, int lane) {
  ldmatrix_x4_trans(b, tile + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LDT +
                           n2 * 16 + (lane / 16) * 8);
}

}  // namespace attn
