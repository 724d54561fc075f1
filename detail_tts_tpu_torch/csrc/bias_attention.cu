// Bias-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Computes, per batch row b and head h,
//     out[b, :, h] = softmax2(q k^T * scale + bias[h]) v
// where softmax2 is a base-2 softmax (exp2), ``scale`` already carries
// log2(e) and ``bias`` is (H, T, T) in the log2 domain, shared over the batch.
//
// Replaces the three Pallas serving kernels of
// detail_tts_tpu/ops/pallas/attention.py: ``attention_packed_pairs``
// (_attn_paired_kernel), ``attention_packed`` (_attn_packed_kernel) and
// ``row_block_attention`` (_attn_kernel).  Those are one function in three
// lane layouts made for the TPU's 128-lane tiles; here q, k and v are read
// straight from the (B, T, 3C) qkv projection, channel order
// [head][q|k|v][ch], with no padding or transpose outside the kernel.
//
// What bounds it on the H100: at the diffusion trunk's shape (2B = 16,
// T = 1600, H = 16, d = 48) the work is ~1.26e11 tensor-core FLOP,
// ~6.6e8 exp2 on the special-function units and ~0.24 GB of compulsory
// traffic (qkv + bias + out); the exp2 count over the SFU rate is the
// largest of the three.  So the design keeps every logit on chip and
// exponentiates it once: the (B, H, T, T) logits never reach memory.
//
// bf16 (the serving path), FlashAttention-2 style on mma.sync:
// * one CTA of 4 warps owns 64 query rows of one (batch, head); each warp
//   owns 16 rows and keeps S, P and the output accumulator in registers
//   (m16n8k16 bf16 products, fp32 accumulate; P goes from the S
//   accumulator straight into the A operand of P.V);
// * K and V walk through shared memory in 64-key tiles, double-buffered
//   with cp.async so the next tile loads while this one is computed;
// * the bias is read from device memory straight into the accumulator's
//   register layout, issued before the wait on the K/V copies;
// * the grid puts the batch index fastest, so the CTAs that read one head's
//   bias tile run together and share it through L2 (the bias is the largest
//   input and is the same for every batch row).
// float32 (a test route) takes a plain scalar kernel through shared memory.
//
// Both: online-max softmax in fp32 with exp2f; P is rounded to the input
// type before P.V, as the Pallas kernel does.  The running max is floored
// at FLOOR (log2 domain), so a row whose every bias is <= -1e9 sums to 0 and
// is written as 0, as the Pallas kernels' no-max softmax gives; ordinary
// rows are unchanged.  Ragged T is masked in the kernel: keys past T get
// -inf and zero K/V rows, query rows past T are computed on zeros and not
// written.  No TMA or wgmma yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per CTA
constexpr int BK = 64;         // keys per tile
constexpr int NTHREADS = 128;  // 4 warps x 16 query rows
constexpr int WROWS = 16;      // query rows per warp
constexpr float FLOOR = -1.0e4f;

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------ bf16: mma.sync

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with ``valid`` false the destination is zero-filled.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Bias at (row, col) and (row, col + 1); 0 past T (those keys are masked).
__device__ __forceinline__ float2 bias_pair(const bf16* row, int col, int t_len,
                                            bool even) {
  if (even) {  // T even and col even: one aligned 4-byte load
    if (col < t_len) return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + col));
    return make_float2(0.f, 0.f);
  }
  return make_float2(col < t_len ? __bfloat162float(row[col]) : 0.f,
                     col + 1 < t_len ? __bfloat162float(row[col + 1]) : 0.f);
}

// Async copy of rows [r0, r0 + 64) of one head's q, k or v (columns [0, D))
// into a shared tile with row stride LDT; rows past T are zero-filled.
template <int D>
__device__ __forceinline__ void copy_tile(bf16* dst, const bf16* src, int r0,
                                          int t_len, long row_stride) {
  constexpr int LDT = D + 8;
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < BK * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const bool valid = r0 + r < t_len;
    cp_async_16(dst + r * LDT + c, src + (long)(valid ? r0 + r : 0) * row_stride + c, valid);
  }
}

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (BQ + 4 * BK) * (D + 8);  // Q + two K and two V tiles
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bias_attention_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                   bf16* __restrict__ out, int t_len, int heads, float scale) {
  constexpr int LDT = D + 8;  // +16 bytes a row: ldmatrix rows hit distinct banks
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int NO = D / 8;   // 8-wide column blocks of the output
  constexpr int NS = BK / 8;  // 8-wide key blocks of a tile
  const int b = blockIdx.x;   // batch fastest: CTAs sharing a bias tile run together
  const int q0 = blockIdx.y * BQ;
  const int h = blockIdx.z;
  const int C = heads * D;
  const long row_stride = 3L * C;
  const bf16* base = qkv + (long)b * t_len * row_stride + (long)h * 3 * D;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LDT;      // two buffers
  bf16* Vs = Ks + 2 * BK * LDT;  // two buffers

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // this thread's rows: g and g + 8 of the warp's 16
  const int t4 = lane % 4;  // and columns 2 * t4, 2 * t4 + 1 of each 8-block
  const int n_tiles = (t_len + BK - 1) / BK;

  copy_tile<D>(Qs, base, q0, t_len, row_stride);
  copy_tile<D>(Ks, base + D, 0, t_len, row_stride);
  copy_tile<D>(Vs, base + 2 * D, 0, t_len, row_stride);
  cp_async_commit();

  const int qr0 = q0 + warp * WROWS + g;
  const int qr1 = qr0 + 8;
  const bf16* bias_h = bias + (long)h * t_len * t_len;
  const bf16* brow0 = bias_h + (long)(qr0 < t_len ? qr0 : 0) * t_len;
  const bf16* brow1 = bias_h + (long)(qr1 < t_len ? qr1 : 0) * t_len;
  const bool even = (t_len % 2) == 0;

  uint32_t qa[KS][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = FLOOR, m1 = FLOOR;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;      // this thread's share of their row sums

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    float2 b0[NS], b1[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int col = k0 + n * 8 + 2 * t4;
      b0[n] = bias_pair(brow0, col, t_len, even);
      b1[n] = bias_pair(brow1, col, t_len, even);
    }
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      copy_tile<D>(Ks + nb * BK * LDT, base + D, k0 + BK, t_len, row_stride);
      copy_tile<D>(Vs + nb * BK * LDT, base + 2 * D, k0 + BK, t_len, row_stride);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        ldmatrix_x4(qa[kk], Qs + (warp * WROWS + lane % 16) * LDT + kk * 16 + (lane / 16) * 8);
      }
    }
    const bf16* Kt = Ks + (j & 1) * BK * LDT;
    const bf16* Vt = Vs + (j & 1) * BK * LDT;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, Kt + (n2 * 16 + (lane / 16) * 8 + lane % 8) * LDT + kk * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * n2], qa[kk], kb[0], kb[1]);
        mma_bf16(s[2 * n2 + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // log2-domain logits, keys past T masked; online softmax in fp32
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int col = k0 + n * 8 + 2 * t4;
      const bool v0 = col < t_len, v1 = col + 1 < t_len;
      s[n][0] = v0 ? fmaf(s[n][0], scale, b0[n].x) : -INFINITY;
      s[n][1] = v1 ? fmaf(s[n][1], scale, b0[n].y) : -INFINITY;
      s[n][2] = v0 ? fmaf(s[n][2], scale, b1[n].x) : -INFINITY;
      s[n][3] = v1 ? fmaf(s[n][3], scale, b1[n].y) : -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    // P, rounded to bf16, lands in the A-operand layout of P V: key blocks
    // 2k and 2k + 1 of S are k-step k of the product.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float p0 = exp2f(s[n][0] - mn0), p1 = exp2f(s[n][1] - mn0);
      const float p2 = exp2f(s[n][2] - mn1), p3 = exp2f(s[n][3] - mn1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vt + (kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LDT +
                                  n2 * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * n2], pa[kk], vb[0], vb[1]);
        mma_bf16(o[2 * n2 + 1], pa[kk], vb[2], vb[3]);
      }
    }
    __syncthreads();  // this tile's buffers are refilled two tiles on
  }

  // out = O / l, or 0 where the row sum is 0 (a fully masked row)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = h * D + n * 8 + 2 * t4;
    if (qr0 < t_len) {
      *reinterpret_cast<uint32_t*>(out + ((long)b * t_len + qr0) * C + col) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    }
    if (qr1 < t_len) {
      *reinterpret_cast<uint32_t*>(out + ((long)b * t_len + qr1) * C + col) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
    }
  }
}

// ------------------------------------------------------ float32: plain FMA

// Shared-memory layout (row strides padded against bank conflicts).
template <int D>
struct SimtLayout {
  static constexpr int LDT = D + 4;   // Q/K/V tile row
  static constexpr int LDS = BK + 4;  // score / probability row
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(float) * BQ * LDT;
  static constexpr size_t v_off = k_off + sizeof(float) * BK * LDT;
  static constexpr size_t s_off = v_off + sizeof(float) * BK * LDT;
  static constexpr size_t o_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t a_off = o_off + sizeof(float) * BQ * LDT;
  static constexpr size_t bytes = a_off + sizeof(float) * BQ;
};

// Copies rows [r0, r0 + 64) of one head's q, k or v into shared memory in
// 16-byte vectors; rows past T are zero.
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, int r0,
                                              int t_len, long row_stride) {
  constexpr int VPR = D / 4;
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR;
    const int c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < t_len) {
      val = *reinterpret_cast<const float4*>(src + (long)(r0 + r) * row_stride + c);
    }
    *reinterpret_cast<float4*>(dst + r * SimtLayout<D>::LDT + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bias_attention_simt(const float* __restrict__ qkv, const float* __restrict__ bias,
                    float* __restrict__ out, int t_len, int heads, float scale) {
  using L = SimtLayout<D>;
  const int b = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int h = blockIdx.z;
  const int C = heads * D;
  const long row_stride = 3L * C;
  const float* base = qkv + (long)b * t_len * row_stride + (long)h * 3 * D;
  const float* bias_h = bias + (long)h * t_len * t_len;

  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + L::q_off);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* rowf = reinterpret_cast<float*>(smem + L::a_off);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * WROWS;
  float* Sw = Ss + r0 * L::LDS;
  float* Ow = Os + r0 * L::LDT;
  const float* Qw = Qs + r0 * L::LDT;

  load_tile_f32<D>(Qs, base, q0, t_len, row_stride);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) Os[(i / D) * L::LDT + i % D] = 0.f;

  float m_run[WROWS];  // running max per row (equal in every lane)
  float l_run[WROWS];  // this lane's share of the row sum
#pragma unroll
  for (int r = 0; r < WROWS; ++r) {
    m_run[r] = FLOOR;
    l_run[r] = 0.f;
  }

  for (int k0 = 0; k0 < t_len; k0 += BK) {
    __syncthreads();  // the previous tile's K/V are no longer read
    load_tile_f32<D>(Ks, base + D, k0, t_len, row_stride);
    load_tile_f32<D>(Vs, base + 2 * D, k0, t_len, row_stride);
    __syncthreads();

    // S = Q K^T, then P (in place) by an online softmax, base 2
    for (int r = 0; r < WROWS; ++r) {
      const int qrow = q0 + r0 + r;
      float s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = lane + 32 * j;
        const int col = k0 + c;
        float v = -INFINITY;
        if (col < t_len) {
          float acc = 0.f;
          for (int d = 0; d < D; ++d) acc = fmaf(Qw[r * L::LDT + d], Ks[c * L::LDT + d], acc);
          v = acc * scale;
          if (qrow < t_len) v += bias_h[(long)qrow * t_len + col];
        }
        s[j] = v;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      const float p0 = exp2f(s[0] - m_new);
      const float p1 = exp2f(s[1] - m_new);
      l_run[r] = l_run[r] * alpha + p0 + p1;
      Sw[r * L::LDS + lane] = p0;
      Sw[r * L::LDS + lane + 32] = p1;
      if (lane == 0) rowf[r0 + r] = alpha;
    }
    __syncwarp();

    // O = alpha * O + P V for this warp's rows
    for (int r = 0; r < WROWS; ++r) {
      for (int c = lane; c < D; c += 32) {
        float acc = Ow[r * L::LDT + c] * rowf[r0 + r];
        for (int k = 0; k < BK; ++k) acc = fmaf(Sw[r * L::LDS + k], Vs[k * L::LDT + c], acc);
        Ow[r * L::LDT + c] = acc;
      }
    }
    __syncwarp();
  }

  // out = O / l, or 0 where the row sum is 0 (a fully masked row)
#pragma unroll
  for (int r = 0; r < WROWS; ++r) {
    float l = l_run[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) rowf[r0 + r] = l > 0.f ? 1.f / l : 0.f;
  }
  __syncwarp();
  for (int i = lane; i < WROWS * D; i += 32) {
    const int r = i / D;
    const int c = i % D;
    const int qrow = q0 + r0 + r;
    if (qrow < t_len) {
      out[((long)b * t_len + qrow) * C + (long)h * D + c] = Ow[r * L::LDT + c] * rowf[r0 + r];
    }
  }
}

// ------------------------------------------------------------------ launch

template <int D>
cudaError_t launch(int dtype, const void* qkv, const void* bias, void* out, int batch,
                   int t_len, int heads, float scale, cudaStream_t stream) {
  const dim3 grid(batch, (t_len + BQ - 1) / BQ, heads);
  if (dtype == 0) {
    const int smem = (int)mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        bias_attention_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    bias_attention_mma<D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
        static_cast<bf16*>(out), t_len, heads, scale);
  } else {
    const int smem = (int)SimtLayout<D>::bytes;
    cudaError_t err = cudaFuncSetAttribute(
        bias_attention_simt<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    bias_attention_simt<D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(bias),
        static_cast<float*>(out), t_len, heads, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32.  qkv (B, T, 3 * H * D), bias (H, T, T)
// and out (B, T, H * D) are contiguous, 16-byte aligned and of that type;
// scale = sm_scale * log2(e); bias is in the log2 domain.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int bias_attention_fwd(const void* qkv, const void* bias, void* out,
                                  int batch, int t_len, int heads, int head_dim,
                                  float scale, int dtype, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return (int)launch<16>(dtype, qkv, bias, out, batch, t_len, heads, scale, s);
    case 32: return (int)launch<32>(dtype, qkv, bias, out, batch, t_len, heads, scale, s);
    case 48: return (int)launch<48>(dtype, qkv, bias, out, batch, t_len, heads, scale, s);
    case 64: return (int)launch<64>(dtype, qkv, bias, out, batch, t_len, heads, scale, s);
    case 80: return (int)launch<80>(dtype, qkv, bias, out, batch, t_len, heads, scale, s);
    case 96: return (int)launch<96>(dtype, qkv, bias, out, batch, t_len, heads, scale, s);
    case 112: return (int)launch<112>(dtype, qkv, bias, out, batch, t_len, heads, scale, s);
    case 128: return (int)launch<128>(dtype, qkv, bias, out, batch, t_len, heads, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* bias_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
