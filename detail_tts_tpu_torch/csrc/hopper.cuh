// Hopper (sm_90a) building blocks of the wgmma kernels (the serving kernel,
// the training forward and the training backward): mbarriers, TMA tile loads
// and stores, 1-D bulk copies, ldmatrix at a shared address, the fp32 bias
// box's swizzle, the wgmma products, and the host's tensor maps through the
// driver's encoder.
//
// Shared-memory operand layout of the wgmma products: tiles of 32-byte rows
// (16 bf16) written by TMA with the 32-byte swizzle (CU_TENSOR_MAP_SWIZZLE_32B),
// which is the descriptor's layout type 3.  A K-major operand (Q or K for
// Q K^T, k-step = one such tile) has its 8-row groups SBO = 256 bytes apart;
// an MN-major operand (V for P V) has its 8-key groups SBO = 256 bytes apart
// and its 16-channel atoms LBO bytes apart (one tile to the next).  The
// wgmma kernels at d = 96 take tiles of 64-byte rows with the 64-byte
// swizzle instead (desc_sw64); Boxes<D> gives each head dim's layout.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to TMA.
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The producer's arrival, announcing ``bytes`` of TMA writes to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Returns once the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// ------------------------------------------------------------------ TMA

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
// One box of a 3-D map at (c0, c1, c2) into this CTA's ``dst``; completes
// its bytes on ``bar``.  Elements out of the tensor read 0.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from global
// memory into this CTA's ``dst``; completes its bytes on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}
// One box of this CTA's ``src`` into a 3-D map at (c0, c1, c2); elements out
// of the tensor are not written.  Joins the thread's open bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's bulk groups are still reading
// shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// Waits until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// Makes this thread's writes to shared memory visible to TMA (the async
// proxy), before a barrier and the store that reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Barrier ``id`` (not 0, which __syncthreads takes) of ``threads`` threads.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------- ldmatrix

// Four 8 x 8 bf16 blocks from a shared-memory address (each lane gives the
// address of one block row), in the mma.sync / wgmma fragment layout.
__device__ __forceinline__ void ldmatrix_x4_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Float offset of (row, key) in an fp32 box of 32 keys (128-byte rows)
// written by TMA with the 128-byte swizzle: 16-byte chunk c of row r lives
// at c ^ (r & 7).  The fp32 bias tiles of the training forward and backward.
__device__ __forceinline__ int swz128(int row, int key) {
  return row * 32 + (((key >> 2) ^ (row & 7)) << 2) + (key & 3);
}

// ---------------------------------------------------------------- wgmma

// Descriptor of a tile of 32-byte rows with the 32-byte swizzle (layout
// type 3); ``lbo`` and ``sbo`` in bytes.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (3ull << 62);
}
// The same for 64-byte rows with the 64-byte swizzle (layout type 2;
// CU_TENSOR_MAP_SWIZZLE_64B): a K-major operand's 16-channel k-step starts
// 0 or 32 bytes into a row, its 8-row groups SBO = 512 bytes apart; an
// MN-major one has 32-channel atoms LBO bytes apart.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (2ull << 62);
}

// The head dims the wgmma kernels are built for: up to 64 (the trunk's 48)
// and 96 (the contextual embedder's).
constexpr bool wgmma_dim(int head_dim) { return head_dim <= 64 || head_dim == 96; }

// A bf16 tile of 64 rows of one head's D channels as TMA writes it: boxes
// of 16 channels (32-byte rows, 32-byte swizzle) up to d = 64, of 32
// channels (64-byte rows, 64-byte swizzle) at d = 96, where 32-byte rows
// made six TMA requests a row.  k_desc is k-step c (16 channels) as a
// K-major wgmma operand (Q or K of S = Q K^T), mn_desc k-step kk (16 rows)
// as an MN-major one (V of O += P V): an atom is one box, LBO a box.
template <int D>
struct Boxes {
  static constexpr int ROW = D == 96 ? 64 : 32;  // bytes of a box row
  static constexpr int BOX_CH = ROW / 2;         // channels of a box
  static constexpr int NBOX = D / BOX_CH;        // boxes of a tile
  static constexpr int BOX = 64 * ROW;           // bytes of a box
  static constexpr int TILE_BYTES = NBOX * BOX;  // a 64-row tile
  static constexpr CUtensorMapSwizzle SWIZZLE =
      ROW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;

  __device__ __forceinline__ static uint64_t k_desc(uint32_t a, int c) {
    if constexpr (ROW == 32) {
      return desc_sw32(a + c * BOX, 16, 256);
    } else {
      return desc_sw64(a + (c / 2) * BOX + (c % 2) * 32, 16, 8 * ROW);
    }
  }
  __device__ __forceinline__ static uint64_t mn_desc(uint32_t a, int kk) {
    if constexpr (ROW == 32) {
      return desc_sw32(a + kk * 16 * ROW, BOX, 8 * ROW);
    } else {
      return desc_sw64(a + kk * 16 * ROW, BOX, 8 * ROW);
    }
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint64_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+l"(r[i])::"memory");
}

// d (+)= A B^T for a 64 x 64 tile: A (64 x 16) and B (64 x 16), both K-major in
// shared memory; ``accumulate`` 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B^T for a 64 x 32 tile: A (64 x 16) and B (32 x 16), both K-major in
// shared memory; ``accumulate`` 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A B^T, both K-major in shared memory, for N = 32 or 64 columns.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate) {
  static_assert(N == 32 || N == 64, "wgmma_ss: N");
  if constexpr (N == 32) {
    wgmma_m64n32k16_ss(d, a, b, accumulate);
  } else {
    wgmma_m64n64k16_ss(d, a, b, accumulate);
  }
}

// d += A B for a 64 x 16 tile: A (64 x 16 bf16) in registers, B (16 x 16)
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B for a 64 x 32 tile: A (64 x 16 bf16) in registers, B (16 x 32)
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B for a 64 x 48 tile: A (64 x 16 bf16) in registers, B (16 x 48)
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n48k16_rs(float (&d)[24], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B for a 64 x 64 tile: A (64 x 16 bf16) in registers, B (16 x 64)
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B for a 64 x 96 tile: A (64 x 16 bf16) in registers, B (16 x 96)
// MN-major in shared memory (six 16-column atoms, LBO apart).
__device__ __forceinline__ void wgmma_m64n96k16_rs(float (&d)[48], const uint32_t (&a)[4],
                                                   uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, A (64 x 16) in registers, B (16 x N) MN-major, N = 16, 32, 48, 64
// or 96.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 16 || N == 32 || N == 48 || N == 64 || N == 96, "wgmma_rs: N");
  if constexpr (N == 16) {
    wgmma_m64n16k16_rs(d, a, b);
  } else if constexpr (N == 32) {
    wgmma_m64n32k16_rs(d, a, b);
  } else if constexpr (N == 48) {
    wgmma_m64n48k16_rs(d, a, b);
  } else if constexpr (N == 64) {
    wgmma_m64n64k16_rs(d, a, b);
  } else {
    wgmma_m64n96k16_rs(d, a, b);
  }
}

// ------------------------------------------------------------------ host

// cuTensorMapEncodeTiled of the driver, found through the runtime so that a
// library needs no -lcuda; nullptr where the driver has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// One 3-D tensor map: ``dims`` innermost first, the byte strides of the
// outer two, boxes ``box``.  Elements out of the tensor read 0 and are not
// written.  CUDA_ERROR_NOT_FOUND where the driver has no encoder.
inline CUresult encode_map_3d(CUtensorMap* map, CUtensorMapDataType type, void* base,
                              const cuuint64_t (&dims)[3], const cuuint64_t (&strides)[2],
                              const cuuint32_t (&box)[3], CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, type, 3, base, dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            swizzle == CU_TENSOR_MAP_SWIZZLE_128B ? CU_TENSOR_MAP_L2_PROMOTION_L2_256B
                                                  : CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The fp32 (H, T, T) bias as (T keys, T queries, H) in boxes of 32 keys x
// ``rows`` queries with the 128-byte swizzle (read through swz128).  T % 4
// == 0: a row's stride is then a multiple of 16 bytes.
inline CUresult encode_bias_f32_map(CUtensorMap* map, const float* bias, int t_len, int heads,
                                    int rows) {
  const cuuint64_t t = t_len;
  return encode_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, const_cast<float*>(bias),
                       {t, t, (cuuint64_t)heads}, {t * 4, t * t * 4},
                       {32, (cuuint32_t)rows, 1}, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace hopper
