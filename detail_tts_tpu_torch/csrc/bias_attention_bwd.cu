// Bias-attention backward for Hopper (sm_90a), CUDA C++ with plain C entries.
//
// The forward (bias_attention.cu, ``bias_attention_train_fwd``) computed, per
// batch row b and head h, with z = scale * q k^T + bias_scale * bias[h]
// (log2 domain; scale = sm_scale * log2(e), bias_scale = log2(e)):
//     P = exp2(z - lse),   out = P v,
// and saved the row statistic lse (B, H, T).  Here, with
// delta = rowsum(dout * out) (B, H, T),
//     dP = dout v^T,  dX = P * (dP - delta)   (the natural-domain logits' grad)
//     dq = sm_scale dX k,  dk = sm_scale dX^T q,  dv = P^T dout,
//     dbias[h] = sum over b of dX
// Three launches, in this order, on the kernels of the route
// bias_attention_bwd_route names for the call:
// * ``bias_attention_bwd_dq``: delta (written for the next kernel), dq, and
//   each batch row's dX written once into a partial dbias_part (B, H, Tp, Tp)
//   (Tp = T rounded up to 64; the sum pass reads no padding);
// * ``bias_attention_bwd_dkv``: dk and dv;
// * ``bias_attention_bwd_dbias_sum``: dbias = dbias_part[0] + ... +
//   dbias_part[B-1], added in batch order, so dbias is the same bits on
//   every run without atomics.
// dq, dk and dv land in one d(qkv) tensor (B, T, 3C), channel order
// [head][q|k|v][ch] like qkv: the first kernel fills the q slots, the second
// the k and v slots.
//
// Replaces the two Pallas kernels of ``_attn_train_bwd`` in
// detail_tts_tpu/ops/pallas/attention.py: ``_attn_bwd_dq_kernel`` (:187, dq
// and dbias summed over the batch, called at :286) and
// ``_attn_bwd_dkv_kernel`` (:218, dk and dv, called at :308), and the delta
// that ``_attn_train_bwd`` (:279) computes before them.  The Pallas kernels
// worked in the log2 domain and chained dbias back by log2(e) outside; dX is
// that chain taken inside.
//
// What bounds them on the H100, at the training step's largest call (bf16,
// B = 8, T = 496, H = 16, d = 48): bytes.  The dq kernel must read q, k, v,
// dout, out, the fp32 bias and lse (46.5 MB) and write dq, delta and dbias
// (22.1 MB): 0.020 ms at 3.35 TB/s, beside 6 B H T^2 d ~ 9.1e9 tensor FLOP
// (0.009 ms) and B H T^2 ~ 3.1e7 exp2.  Its partials add 126 MB of writes
// (0.038 ms), which the sum pass reads back while writing 15.7 MB (0.042
// ms).  The dk/dv kernel moves 52.9 MB (0.016 ms) beside 8 B H T^2 d FLOP.
// Each kernel recomputes P from (q, k, bias, lse), so the (B, H, T, T)
// probabilities never reach memory.
//
// bf16 at T % 4 != 0 (and at d = 80, 112, 128, for which the wgmma kernels
// are not built), FlashAttention-2 style on mma.sync
// (m16n8k16, fp32 accumulate), 4 warps of 16 rows per CTA, each warp
// walking its 64-wide tile in two halves of 32 columns so that S and dP
// take 32 registers, not 64 (bwd_dq_mma, bwd_dkv_mma):
// * dq: one CTA per (batch row, 64 queries, head), the batch row fastest so
//   the B CTAs of a (tile, head) share each bias tile through L2 (1024 CTAs
//   at the step's shape).  It first computes delta for its rows from the dO
//   and out tiles and keeps Q and dO as mma fragments in registers; then it
//   walks the key tiles with K, V and the fp32 bias tile double-buffered
//   through cp.async, keeps dq in registers and writes it once, and writes
//   its rows of dX once into its batch row's partial.
// * dk/dv: one CTA per (batch row, 64 keys, head) with K and V as mma
//   fragments in registers walks the query tiles, Q, dO, the bias tile
//   [query][key] (row stride 68 floats, so the transposed reads hit
//   distinct banks), lse and delta double-buffered through cp.async; dk and
//   dv stay in registers.
// Both fit three CTAs (12 warps) on an SM up to d = 64 (64-65 KB of shared
// memory at d = 48, __launch_bounds__(128, 3)); two at d = 80-128.
// The design these replaced (times at the shape above on an H100 80GB HBM3
// at 700 W): a dq kernel of 128 CTAs that each walked all 8 batch rows,
// reading, adding and writing dbias once per row (250 MB), with per-thread
// synchronous bias loads (0.505-0.513 ms, 168 registers); a dk/dv kernel of
// 181 registers (2 CTAs an SM) that copied the bias tile with a scalar loop
// outside the cp.async ring (0.267-0.268 ms); and delta in PyTorch (~0.1
// ms, ~5 launches): 0.876 ms for the backward, against SDPA's 0.436 ms.
//
// bf16 at d <= 64 or d = 96 and T % 4 == 0 (every call of the training
// step and of the raw buckets but those at T % 4 != 0: the latent
// conditioner at 706 codes, and the latent conditioner and the contextual
// embedder at the loader's 500-frame crop, T = 125) takes the two
// redesigned for Hopper, bwd_dq_wgmma and bwd_dkv_wgmma (the section
// below says how): the same grids and arithmetic, every product on wgmma,
// the tiles copied by TMA from one producer warp through an mbarrier ring,
// dX stored into its partial by TMA: at the step's trunk 17% (dq) and 44%
// (dk/dv) under the mma.sync kernels in turns on an H100 (PERF.md).  What
// the redesign found (ab_serving_kernel.py --variants): taken apart, PR 3's dq
// kernel was held by its copies and partial stores (without both 45%
// faster, without the stores alone 20%), not by its products (6%); its
// dk/dv kernel by neither alone (24%, 10%).  Summing dbias in the dq
// kernel instead, in a cluster of the B batch rows of a (query tile, head)
// through distributed shared memory (two cluster barriers a key tile, no
// partials, no sum pass), gave dbias the same bits but took longer than
// the partials and the sum pass together (0.160-0.166 against 0.144 ms at
// the step's trunk): the barriers' lockstep and the remote reads each cost
// about what the partials' bytes did.  It was removed.
// At d = 96 (the contextual embedder) the same two kernels take 6'
// a query tile in two halves of 32 (S^T and dP^T hold 16 registers each
// beside dk and dv's 96: 164 registers, two CTAs an SM), the bf16 tiles in
// 64-byte boxes (with 32-byte ones TMA's requests held 5': 0.0193 against
// 0.0170 ms at (8, 124, 16, 96)), and 5' reads delta's dO from its tile in
// shared memory, not a second time from L2 (0.0170 -> 0.0144; at d = 48 it
// gains 9% at T = 124 and ties at the trunk).  In turns against the
// mma.sync kernels at (8, 124, 16, 96) on an H100: 5' 0.0144 against 0.0157
// and 6' 0.0139 against 0.0182 device ms (PERF.md).
//
// All round P and dX to bf16 for the products, as the forward rounds P.
// float32 (a test route) takes plain scalar kernels on 32-row tiles.
// Ragged T is masked in place: rows past T are zero-filled and not written,
// keys past T get P = 0.  A fully masked row (lse = MASKED_LSE) has P = 0
// everywhere, so all its gradients are exactly 0.
#include <stdio.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace attn;

constexpr int BQ = TILE;       // query rows per tile
constexpr int BK = TILE;       // keys per tile
constexpr int HALF = TILE / 2;  // columns a warp takes at once
constexpr int LDB_DQ = BK + 8;  // staged bias row [query][key]: fragment reads hit distinct banks
constexpr int LDB_KV = BK + 4;  // staged bias row read transposed: distinct banks too

// Row stride of the dbias partials: T rounded up to a whole tile.
__host__ __device__ inline int padded(int t_len) { return (t_len + TILE - 1) / TILE * TILE; }

// CTAs an SM should hold: three up to d = 64, where 3 x 64-65 KB of shared
// memory fit; two above, where the fragments held in registers need more.
template <int D>
struct Occ {
  static constexpr int kMinBlocks = D <= 64 ? 3 : 2;
};

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * 4 * BK * (D + 8)          // two K and two V tiles
         + sizeof(float) * 2 * BQ * LDB_DQ;       // two bias tiles
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * 4 * BQ * (D + 8)          // two Q and two dO tiles
         + sizeof(float) * 2 * (BQ * LDB_KV + 2 * BQ);  // two bias tiles, lse, delta
}

// Async copy of the fp32 bias block [r0, r0 + 64) x [c0, c0 + 64) of a
// (T, T) matrix into a shared tile of row stride LDB; entries past T are 0.
// ``vec``: T % 4 == 0, so 16-byte copies stay aligned.
template <int LDB>
__device__ __forceinline__ void copy_bias_tile(float* dst, const float* src, int r0, int c0,
                                               int t_len, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < TILE * (TILE / 4); i += NTHREADS) {
      const int r = i / (TILE / 4), c = (i % (TILE / 4)) * 4;
      const bool valid = r0 + r < t_len && c0 + c < t_len;
      cp_async_16(dst + r * LDB + c, src + (valid ? (long)(r0 + r) * t_len + c0 + c : 0), valid);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * TILE; i += NTHREADS) {
      const int r = i / TILE, c = i % TILE;
      const bool valid = r0 + r < t_len && c0 + c < t_len;
      cp_async_4(dst + r * LDB + c, src + (valid ? (long)(r0 + r) * t_len + c0 + c : 0), valid);
    }
  }
}

// ------------------------------------------------------ bf16: delta, dq, dX

template <int D>
__global__ void __launch_bounds__(NTHREADS, Occ<D>::kMinBlocks)
bwd_dq_mma(const bf16* __restrict__ qkv, const float* __restrict__ bias,
           const bf16* __restrict__ dout, const bf16* __restrict__ out,
           const float* __restrict__ lse, float* __restrict__ delta,
           bf16* __restrict__ dqkv, float* __restrict__ dbias_part, int t_len, int heads,
           float scale, float bias_scale, float sm_scale) {
  constexpr int LDT = D + 8;
  constexpr int KS = D / 16;  // k-steps of Q K^T and dO V^T
  constexpr int NO = D / 8;   // 8-wide column blocks of dq
  constexpr int NH = HALF / 8;  // 8-wide key blocks of a half tile
  const int b = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int h = blockIdx.z;
  const int t_pad = gridDim.y * BQ;
  const int C = heads * D;
  const long row_stride = 3L * C;
  const bf16* base = qkv + (long)b * t_len * row_stride + (long)h * 3 * D;
  const long io_off = (long)b * t_len * C + (long)h * D;
  const float* bias_h = bias + (long)h * t_len * t_len;
  const bool vec = (t_len % 4) == 0;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);     // two buffers
  bf16* Vs = Ks + 2 * BK * LDT;                 // two buffers
  float* Bs = reinterpret_cast<float*>(Vs + 2 * BK * LDT);  // two buffers [query][key]
  // Q, dO and out are staged in the second buffers, free until tile 1 is fetched
  bf16* Qst = Ks + BK * LDT;
  bf16* dOst = Vs + BK * LDT;
  bf16* Ost = reinterpret_cast<bf16*>(Bs + BQ * LDB_DQ);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int n_tiles = gridDim.y;
  const int lr0 = warp * WROWS + g;  // this thread's rows in the tile: lr0, lr0 + 8
  const int qr0 = q0 + lr0, qr1 = qr0 + 8;
  const bool ok0 = qr0 < t_len, ok1 = qr1 < t_len;

  copy_tile<D>(Qst, base, q0, t_len, row_stride);
  copy_tile<D>(dOst, dout + io_off, q0, t_len, C);
  copy_tile<D>(Ost, out + io_off, q0, t_len, C);
  cp_async_commit();
  copy_tile<D>(Ks, base + D, 0, t_len, row_stride);
  copy_tile<D>(Vs, base + 2 * D, 0, t_len, row_stride);
  copy_bias_tile<LDB_DQ>(Bs, bias_h, q0, 0, t_len, vec);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // delta of this warp's 16 rows: lanes l and l + 16 each sum half of row l
  float dl;
  {
    const int r = warp * WROWS + lane % 16;
    const int c0 = (lane / 16) * (D / 2);
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < D / 2; c += 2) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dOst + r * LDT + c0 + c));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Ost + r * LDT + c0 + c));
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
    dl = acc + __shfl_xor_sync(0xffffffffu, acc, 16);
    if (lane < 16 && q0 + r < t_len) delta[((long)b * heads + h) * t_len + q0 + r] = dl;
  }
  const float dl0 = __shfl_sync(0xffffffffu, dl, g);
  const float dl1 = __shfl_sync(0xffffffffu, dl, g + 8);
  const float* lrow = lse + ((long)b * heads + h) * t_len;
  const float lse0 = ok0 ? lrow[qr0] : 0.f, lse1 = ok1 ? lrow[qr1] : 0.f;

  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a<LDT>(qa[kk], Qst, warp * WROWS, kk, lane);
    load_a<LDT>(da[kk], dOst, warp * WROWS, kk, lane);
  }
  __syncthreads();  // the staging buffers take tile 1 next

  float dq[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  float* prow0 = dbias_part + (((long)b * heads + h) * t_pad + qr0) * t_pad;
  float* prow1 = prow0 + 8L * t_pad;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    if (j + 1 < n_tiles) {
      const int nb = (j + 1) & 1;
      copy_tile<D>(Ks + nb * BK * LDT, base + D, k0 + BK, t_len, row_stride);
      copy_tile<D>(Vs + nb * BK * LDT, base + 2 * D, k0 + BK, t_len, row_stride);
      copy_bias_tile<LDB_DQ>(Bs + nb * BQ * LDB_DQ, bias_h, q0, k0 + BK, t_len, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + (j & 1) * BK * LDT;
    const bf16* Vt = Vs + (j & 1) * BK * LDT;
    const float* Bt = Bs + (j & 1) * BQ * LDB_DQ;

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      // S = Q K^T and dP = dO V^T for this warp's 16 rows and 32 keys
      float s[NH][4], dp[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < NH / 2; ++n2) {
          uint32_t kb[4], vb[4];
          load_b_nt<LDT>(kb, Kt, hf * (NH / 2) + n2, kk, lane);
          load_b_nt<LDT>(vb, Vt, hf * (NH / 2) + n2, kk, lane);
          mma_bf16(s[2 * n2], qa[kk], kb[0], kb[1]);
          mma_bf16(s[2 * n2 + 1], qa[kk], kb[2], kb[3]);
          mma_bf16(dp[2 * n2], da[kk], vb[0], vb[1]);
          mma_bf16(dp[2 * n2 + 1], da[kk], vb[2], vb[3]);
        }
      }

      // dX = P (dP - delta) in place of S, keys past T give 0; written once
      // into this batch row's partial (rows and keys past T write zeros)
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int lc = hf * HALF + n * 8 + 2 * t4;  // key in the tile
        const int col = k0 + lc;
        const bool v0 = col < t_len, v1 = col + 1 < t_len;
        const float2 b0 = *reinterpret_cast<const float2*>(Bt + lr0 * LDB_DQ + lc);
        const float2 b1 = *reinterpret_cast<const float2*>(Bt + (lr0 + 8) * LDB_DQ + lc);
        const float p0 = v0 ? exp2f(fmaf(s[n][0], scale, b0.x * bias_scale) - lse0) : 0.f;
        const float p1 = v1 ? exp2f(fmaf(s[n][1], scale, b0.y * bias_scale) - lse0) : 0.f;
        const float p2 = v0 ? exp2f(fmaf(s[n][2], scale, b1.x * bias_scale) - lse1) : 0.f;
        const float p3 = v1 ? exp2f(fmaf(s[n][3], scale, b1.y * bias_scale) - lse1) : 0.f;
        s[n][0] = p0 * (dp[n][0] - dl0);
        s[n][1] = p1 * (dp[n][1] - dl0);
        s[n][2] = p2 * (dp[n][2] - dl1);
        s[n][3] = p3 * (dp[n][3] - dl1);
        *reinterpret_cast<float2*>(prow0 + col) = make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(prow1 + col) = make_float2(s[n][2], s[n][3]);
      }

      // dq += dX K over these 32 keys
#pragma unroll
      for (int kk = 0; kk < NH / 2; ++kk) {
        uint32_t xa[4];
        pack_a(xa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n2 = 0; n2 < NO / 2; ++n2) {
          uint32_t kb[4];
          load_b_nn<LDT>(kb, Kt, n2, hf * (NH / 2) + kk, lane);
          mma_bf16(dq[2 * n2], xa, kb[0], kb[1]);
          mma_bf16(dq[2 * n2 + 1], xa, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();  // this tile's buffers are refilled two tiles on
  }

  bf16* drow_q = dqkv + (long)b * t_len * row_stride + (long)h * 3 * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t4;
    if (ok0) {
      *reinterpret_cast<uint32_t*>(drow_q + (long)qr0 * row_stride + col) =
          pack_bf16(dq[n][0] * sm_scale, dq[n][1] * sm_scale);
    }
    if (ok1) {
      *reinterpret_cast<uint32_t*>(drow_q + (long)qr1 * row_stride + col) =
          pack_bf16(dq[n][2] * sm_scale, dq[n][3] * sm_scale);
    }
  }
}

// ------------------------------------------------------------- bf16: dk, dv

template <int D>
__global__ void __launch_bounds__(NTHREADS, Occ<D>::kMinBlocks)
bwd_dkv_mma(const bf16* __restrict__ qkv, const float* __restrict__ bias,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dqkv, int t_len,
            int heads, float scale, float bias_scale, float sm_scale) {
  constexpr int LDT = D + 8;
  constexpr int KS = D / 16;  // k-steps of K Q^T and V dO^T
  constexpr int NO = D / 8;   // 8-wide column blocks of dk, dv
  constexpr int NH = HALF / 8;  // 8-wide query blocks of a half tile
  const int b = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int h = blockIdx.z;
  const int C = heads * D;
  const long row_stride = 3L * C;
  const bf16* base = qkv + (long)b * t_len * row_stride + (long)h * 3 * D;
  const bf16* dobase = dout + (long)b * t_len * C + (long)h * D;
  const float* bias_h = bias + (long)h * t_len * t_len;
  const float* lrow = lse + ((long)b * heads + h) * t_len;
  const float* drow = delta + ((long)b * heads + h) * t_len;
  const bool vec = (t_len % 4) == 0;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // two buffers
  bf16* dOs = Qs + 2 * BQ * LDT;              // two buffers
  float* Bs = reinterpret_cast<float*>(dOs + 2 * BQ * LDT);  // two buffers [query][key]
  float* Ls = Bs + 2 * BQ * LDB_KV;  // two buffers of lse
  float* Dl = Ls + 2 * BQ;           // two buffers of delta

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int lk0 = warp * WROWS + g;  // this thread's keys in the block: lk0, lk0 + 8
  const int lk1 = lk0 + 8;
  const int n_tiles = (t_len + BQ - 1) / BQ;

  // one query tile's Q, dO, bias block, lse and delta into buffer ``nb``
  auto fetch = [&](int q0, int nb) {
    copy_tile<D>(Qs + nb * BQ * LDT, base, q0, t_len, row_stride);
    copy_tile<D>(dOs + nb * BQ * LDT, dobase, q0, t_len, C);
    copy_bias_tile<LDB_KV>(Bs + nb * BQ * LDB_KV, bias_h, q0, k0, t_len, vec);
    const int e = threadIdx.x % BQ;
    const bool valid = q0 + e < t_len;
    if (threadIdx.x < BQ) {
      cp_async_4(Ls + nb * BQ + e, lrow + (valid ? q0 + e : 0), valid);
    } else {
      cp_async_4(Dl + nb * BQ + e, drow + (valid ? q0 + e : 0), valid);
    }
  };

  // K and V are staged in the second Q and dO buffers, free until tile 1
  copy_tile<D>(Qs + BQ * LDT, base + D, k0, t_len, row_stride);
  copy_tile<D>(dOs + BQ * LDT, base + 2 * D, k0, t_len, row_stride);
  cp_async_commit();
  fetch(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t ka[KS][4], va[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    load_a<LDT>(ka[kk], Qs + BQ * LDT, warp * WROWS, kk, lane);
    load_a<LDT>(va[kk], dOs + BQ * LDT, warp * WROWS, kk, lane);
  }
  __syncthreads();

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = i * BQ;
    if (i + 1 < n_tiles) {
      fetch(q0 + BQ, (i + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + (i & 1) * BQ * LDT;
    const bf16* dOt = dOs + (i & 1) * BQ * LDT;
    const float* Bt = Bs + (i & 1) * BQ * LDB_KV;
    const float* Lt = Ls + (i & 1) * BQ;
    const float* Dt = Dl + (i & 1) * BQ;

#pragma unroll 1  // one half at a time: unrolled, the halves spill at d = 48
    for (int hf = 0; hf < 2; ++hf) {
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys and 32 queries
      float s[NH][4], dp[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int n2 = 0; n2 < NH / 2; ++n2) {
          uint32_t qb[4], db[4];
          load_b_nt<LDT>(qb, Qt, hf * (NH / 2) + n2, kk, lane);
          load_b_nt<LDT>(db, dOt, hf * (NH / 2) + n2, kk, lane);
          mma_bf16(s[2 * n2], ka[kk], qb[0], qb[1]);
          mma_bf16(s[2 * n2 + 1], ka[kk], qb[2], qb[3]);
          mma_bf16(dp[2 * n2], va[kk], db[0], db[1]);
          mma_bf16(dp[2 * n2 + 1], va[kk], db[2], db[3]);
        }
      }

      // P^T into s, dX^T into dp; queries past T give 0
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int qc = hf * HALF + n * 8 + 2 * t4;  // this thread's queries: qc, qc + 1
        const bool v0 = q0 + qc < t_len, v1 = q0 + qc + 1 < t_len;
        const float p0 = v0 ? exp2f(fmaf(s[n][0], scale, Bt[qc * LDB_KV + lk0] * bias_scale) - Lt[qc]) : 0.f;
        const float p1 = v1 ? exp2f(fmaf(s[n][1], scale, Bt[(qc + 1) * LDB_KV + lk0] * bias_scale) - Lt[qc + 1]) : 0.f;
        const float p2 = v0 ? exp2f(fmaf(s[n][2], scale, Bt[qc * LDB_KV + lk1] * bias_scale) - Lt[qc]) : 0.f;
        const float p3 = v1 ? exp2f(fmaf(s[n][3], scale, Bt[(qc + 1) * LDB_KV + lk1] * bias_scale) - Lt[qc + 1]) : 0.f;
        s[n][0] = p0;
        s[n][1] = p1;
        s[n][2] = p2;
        s[n][3] = p3;
        dp[n][0] = p0 * (dp[n][0] - Dt[qc]);
        dp[n][1] = p1 * (dp[n][1] - Dt[qc + 1]);
        dp[n][2] = p2 * (dp[n][2] - Dt[qc]);
        dp[n][3] = p3 * (dp[n][3] - Dt[qc + 1]);
      }

      // dv += P^T dO, dk += dX^T Q over these 32 queries
#pragma unroll
      for (int kk = 0; kk < NH / 2; ++kk) {
        uint32_t pa[4], xa[4];
        pack_a(pa, s[2 * kk], s[2 * kk + 1]);
        pack_a(xa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n2 = 0; n2 < NO / 2; ++n2) {
          uint32_t ob[4], qb[4];
          load_b_nn<LDT>(ob, dOt, n2, hf * (NH / 2) + kk, lane);
          load_b_nn<LDT>(qb, Qt, n2, hf * (NH / 2) + kk, lane);
          mma_bf16(dv[2 * n2], pa, ob[0], ob[1]);
          mma_bf16(dv[2 * n2 + 1], pa, ob[2], ob[3]);
          mma_bf16(dk[2 * n2], xa, qb[0], qb[1]);
          mma_bf16(dk[2 * n2 + 1], xa, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // this tile's buffers are refilled two tiles on
  }

  bf16* drow_kv = dqkv + (long)b * t_len * row_stride + (long)h * 3 * D;
  const int kr0 = k0 + lk0, kr1 = k0 + lk1;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = n * 8 + 2 * t4;
    if (kr0 < t_len) {
      bf16* r = drow_kv + (long)kr0 * row_stride + col;
      *reinterpret_cast<uint32_t*>(r + D) = pack_bf16(dk[n][0] * sm_scale, dk[n][1] * sm_scale);
      *reinterpret_cast<uint32_t*>(r + 2 * D) = pack_bf16(dv[n][0], dv[n][1]);
    }
    if (kr1 < t_len) {
      bf16* r = drow_kv + (long)kr1 * row_stride + col;
      *reinterpret_cast<uint32_t*>(r + D) = pack_bf16(dk[n][2] * sm_scale, dk[n][3] * sm_scale);
      *reinterpret_cast<uint32_t*>(r + 2 * D) = pack_bf16(dv[n][2], dv[n][3]);
    }
  }
}

// ---------------------------------- bf16: wgmma, TMA (d <= 64 and d = 96)

// bwd_dq_wgmma and bwd_dkv_wgmma take bf16 at d <= 64 or d = 96 and T % 4
// == 0 (an fp32 bias row of T * 4 bytes is then a legal TMA stride); the
// mma.sync kernels above take the other bf16 calls.  A CTA is one consumer
// warpgroup of 64 rows (queries for dq, keys for dk/dv) and one producer
// warp that keeps TMA copies in flight through an mbarrier ring: 160
// threads.  Tiles, from a 1024-byte aligned base:
// * bf16 tiles (Q, K, V, dO) are boxes of 16 channels x 64 rows (32-byte
//   rows, 32-byte swizzle), one box a k-step of a K-major operand (S = Q K^T,
//   dP = dO V^T, S^T = K Q^T, dP^T = V dO^T, both operands in shared memory)
//   and one 16-channel atom of an MN-major one (dq += dX K, dk += dX^T Q, dv
//   += P^T dO, A from registers: LBO one box, SBO 256 bytes); at d = 96
//   boxes of 32 channels (64-byte rows, 64-byte swizzle: half the TMA
//   requests), a k-step half a box row, an atom a box, SBO 512 bytes;
// * the fp32 bias tile [64 queries x 64 keys] is two boxes of 32 keys (128-
//   byte rows, 128-byte swizzle), read in the accumulator layout: dk/dv's
//   single values down a column (its tile is S^T), which the swizzle puts
//   on 32 distinct banks, and dq's float2 pairs along a row (2-way).
// TMA reads elements past T as 0: keys past T get P = 0 in dq's last tile,
// and queries past T in dk/dv's last tile get lse = MASKED_LSE and delta 0,
// so they add nothing.
constexpr int kBwdConsumerWarps = 4;
constexpr int kBwdThreads = 32 * kBwdConsumerWarps + 32;
constexpr int kBiasBox = TILE * 32;  // floats of a [64 rows x 32 keys] bias box

template <int D>
struct BwdWg : hopper::Boxes<D> {
  // bf16 tiles in hopper::Boxes<D>: 16-channel boxes up to d = 64, 32-channel
  // ones at d = 96, where TMA's requests of 32-byte rows held 5' (PERF.md)
  using Box = hopper::Boxes<D>;
  static constexpr int KS = D / 16;                  // 16-channel k-steps of a row
  static constexpr int BIAS = 2 * kBiasBox * 4;      // the fp32 bias tile
  static constexpr int STAGE = BIAS + 2 * Box::TILE_BYTES;  // bias and two bf16 tiles
  static_assert(STAGE % 1024 == 0 && BIAS % 1024 == 0, "1024-byte aligned boxes");
  // dq: STAGES x [bias | K | V], then Q and dO, then the barriers; three
  // CTAs an SM up to d = 48 (their registers then cap a thread at 136)
  static constexpr int kDqBlocks = D <= 48 ? 3 : 2;
  static constexpr int kDqStages = 2;
  static constexpr size_t dq_bytes =
      1024 + kDqStages * STAGE + 2 * Box::TILE_BYTES + (2 * kDqStages + 1) * sizeof(uint64_t);
  // dk/dv: STAGES x [bias | Q | dO], then K and V, each stage's lse and
  // delta (64 floats each), then the barriers; two CTAs an SM.  A query
  // tile is taken in products of kDkvQueries queries: the whole tile up to
  // d = 64; at d = 96, where dk and dv hold 96 registers, two halves of 32,
  // so that S^T and dP^T hold 16 registers each, not 32
  static constexpr int kDkvBlocks = 2;
  static constexpr int kDkvStages = D <= 48 ? 3 : 2;
  static constexpr int kDkvQueries = D <= 64 ? TILE : TILE / 2;
  static constexpr size_t dkv_bytes = 1024 + kDkvStages * STAGE + 2 * Box::TILE_BYTES +
                                      kDkvStages * 2 * TILE * sizeof(float) +
                                      (2 * kDkvStages + 1) * sizeof(uint64_t);
};

// a * b summed over the 8 bf16 pairs of two 16-byte words, in channel order
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = bf16x2_to_float2(x[i]), v = bf16x2_to_float2(y[i]);
    acc = fmaf(u.x, v.x, acc);
    acc = fmaf(u.y, v.y, acc);
  }
  return acc;
}

// delta, dq and this batch row's dX for 64 queries of one (b, h), walking
// the key tiles.  A tile's dX overwrites its bias tile in shared memory in
// place (each thread writes the elements it read) and goes to the partial
// in one TMA store of two boxes, under the tile's dq += dX K; the stage is
// released once the store has read it.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, BwdWg<D>::kDqBlocks)
bwd_dq_wgmma(const __grid_constant__ CUtensorMap qkv_map,
             const __grid_constant__ CUtensorMap dout_map,
             const __grid_constant__ CUtensorMap bias_map,
             const __grid_constant__ CUtensorMap part_map, const bf16* __restrict__ out,
             const float* __restrict__ lse,
             float* __restrict__ delta, bf16* __restrict__ dqkv, int t_len, int heads,
             float scale, float bias_scale, float sm_scale) {
  using namespace hopper;
  using L = BwdWg<D>;
  constexpr int KS = L::KS;
  constexpr int STAGES = L::kDqStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_smem = smem + STAGES * L::STAGE;
  unsigned char* do_smem = q_smem + L::TILE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(do_smem + L::TILE_BYTES);  // a stage landed
  uint64_t* empty = full + STAGES;  // every consumer warp, and the store, are done with it
  uint64_t* q_full = empty + STAGES;

  const int b = blockIdx.x;  // batch fastest: the CTAs sharing a bias tile run together
  const int q0 = blockIdx.y * BQ;
  const int h = blockIdx.z;
  const int n_tiles = (t_len + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kBwdConsumerWarps);
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kBwdConsumerWarps) {
    // ---------------------------------------------------------- producer
    if (lane == 0) {
      tma_prefetch(&qkv_map);
      tma_prefetch(&dout_map);
      tma_prefetch(&bias_map);
      const int col = h * 3 * D;  // channel of this head's q in a qkv row
      mbar_expect_tx(q_full, 2 * L::TILE_BYTES);
#pragma unroll
      for (int c = 0; c < L::NBOX; ++c) {
        tma_load_3d(q_smem + c * L::BOX, &qkv_map, q_full, col + L::BOX_CH * c, q0, b);
        tma_load_3d(do_smem + c * L::BOX, &dout_map, q_full, h * D + L::BOX_CH * c, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], (j / STAGES - 1) & 1);
        unsigned char* st = smem + s * L::STAGE;
        mbar_expect_tx(&full[s], L::STAGE);
        tma_load_3d(st, &bias_map, &full[s], j * BK, q0, h);
        tma_load_3d(st + kBiasBox * 4, &bias_map, &full[s], j * BK + 32, q0, h);
#pragma unroll
        for (int c = 0; c < L::NBOX; ++c) {
          tma_load_3d(st + L::BIAS + c * L::BOX, &qkv_map, &full[s], col + D + L::BOX_CH * c,
                      j * BK, b);
          tma_load_3d(st + L::BIAS + L::TILE_BYTES + c * L::BOX, &qkv_map, &full[s],
                      col + 2 * D + L::BOX_CH * c, j * BK, b);
        }
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  const int g = lane / 4;   // this thread's rows: g and g + 8 of its warp's 16
  const int t4 = lane % 4;  // and keys 2 t4, 2 t4 + 1 of each 8-key block
  const int r0 = warp * 16 + g;
  const int qr0 = q0 + r0, qr1 = qr0 + 8;
  const int C = heads * D;

  // delta of row threadIdx.x / 2 (each of two threads sums half its
  // channels, in channel order), written once; then each thread takes its
  // two rows' from the lanes that hold them.  out comes from global memory,
  // dO from its tile in shared memory once it has landed (reading dO twice
  // from L2 cost 5' 14% at d = 96 and 9% at T = 124, d = 48: PERF.md)
  float dl;
  {
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    const bool live = q0 + r < t_len;
    float acc = 0.f;
    uint4 y[D / 16];
    if (live) {
      const long off = ((long)b * t_len + q0 + r) * C + h * D + half * (D / 2);
#pragma unroll
      for (int v = 0; v < D / 16; ++v) y[v] = reinterpret_cast<const uint4*>(out + off)[v];
    }
    mbar_wait(q_full, 0);
    if (live) {
#pragma unroll
      for (int v = 0; v < D / 16; ++v) {  // 8 channels of dO: a 16-byte chunk of a box row
        const int ch = half * (D / 2) + 8 * v, j = (ch % L::BOX_CH) / 8;
        const int chunk = j ^ ((r * L::ROW / 128) & (L::ROW / 16 - 1));  // the swizzle
        acc = dot8(*reinterpret_cast<const uint4*>(do_smem + (ch / L::BOX_CH) * L::BOX +
                                                   r * L::ROW + chunk * 16),
                   y[v], acc);
      }
    }
    dl = acc + __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0 && q0 + r < t_len) delta[((long)b * heads + h) * t_len + q0 + r] = dl;
  }
  const float dl0 = __shfl_sync(0xffffffffu, dl, 2 * g);
  const float dl1 = __shfl_sync(0xffffffffu, dl, 2 * g + 16);
  // rows past T: lse = MASKED_LSE, so P = 0 there
  const float* lrow = lse + ((long)b * heads + h) * t_len;
  const float lse0 = qr0 < t_len ? lrow[qr0] : MASKED_LSE;
  const float lse1 = qr1 < t_len ? lrow[qr1] : MASKED_LSE;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  float s[32], dp[32];   // S and dP of the 64 x 64 tile: key block n in [4n .. 4n + 3]
  uint32_t xa[BK / 16][4];  // dX as bf16 A fragments, one a 16-key k-step
  uint64_t qd[KS], dod[KS];
#pragma unroll
  for (int c = 0; c < KS; ++c) {
    qd[c] = L::k_desc(smem_addr(q_smem), c);
    dod[c] = L::k_desc(smem_addr(do_smem), c);
  }
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  };

  for (int j = 0; j < n_tiles; ++j) {
    const int sj = j % STAGES;
    unsigned char* st = smem + sj * L::STAGE;
    uint64_t kd[KS], vd[KS], kb[BK / 16];
#pragma unroll
    for (int c = 0; c < KS; ++c) {
      kd[c] = L::k_desc(smem_addr(st + L::BIAS), c);
      vd[c] = L::k_desc(smem_addr(st + L::BIAS + L::TILE_BYTES), c);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) kb[kk] = L::mn_desc(smem_addr(st + L::BIAS), kk);
    fence_regs(kd);
    fence_regs(vd);
    fence_regs(kb);
    mbar_wait(&full[sj], (j / STAGES) & 1);
    __syncwarp();
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < KS; ++c) wgmma_m64n64k16_ss(s, qd[c], kd[c], c);  // S = Q K^T
#pragma unroll
    for (int c = 0; c < KS; ++c) wgmma_m64n64k16_ss(dp, dod[c], vd[c], c);  // dP = dO V^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dX = P (dP - delta) in place of S and of the bias tile; keys past T give 0
    float* bt = reinterpret_cast<float*>(st);
    const int keys = t_len - j * BK;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const int kc = n * 8 + 2 * t4;  // key in the tile
      float* box = bt + (n / 4) * kBiasBox;
      float2* p0 = reinterpret_cast<float2*>(box + swz128(r0, kc % 32));
      float2* p1 = reinterpret_cast<float2*>(box + swz128(r0 + 8, kc % 32));
      const float2 b0 = *p0, b1 = *p1;
      const bool v0 = kc < keys, v1 = kc + 1 < keys;
      float* x = s + 4 * n;
      const float* y = dp + 4 * n;
      const float e0 = v0 ? exp2f(fmaf(x[0], scale, b0.x * bias_scale) - lse0) : 0.f;
      const float e1 = v1 ? exp2f(fmaf(x[1], scale, b0.y * bias_scale) - lse0) : 0.f;
      const float e2 = v0 ? exp2f(fmaf(x[2], scale, b1.x * bias_scale) - lse1) : 0.f;
      const float e3 = v1 ? exp2f(fmaf(x[3], scale, b1.y * bias_scale) - lse1) : 0.f;
      x[0] = e0 * (y[0] - dl0);
      x[1] = e1 * (y[1] - dl0);
      x[2] = e2 * (y[2] - dl1);
      x[3] = e3 * (y[3] - dl1);
      *p0 = make_float2(x[0], x[1]);
      *p1 = make_float2(x[2], x[3]);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // key blocks 2 kk, 2 kk + 1: k-step kk
      xa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      xa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      xa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      xa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    // the dX tile into this batch row's partial (rows and keys past T clipped)
    fence_proxy_async();
    named_barrier(1, 32 * kBwdConsumerWarps);
    if (threadIdx.x == 0) {
      tma_store_3d(&part_map, st, j * BK, q0, b * heads + h);
      tma_store_3d(&part_map, st + kBiasBox * 4, j * BK + 32, q0, b * heads + h);
      bulk_commit();
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(xa[kk]);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(dq, xa[kk], kb[kk]);  // dq += dX K
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    if (threadIdx.x == 0) bulk_wait_read<0>();
    release(sj);
  }
  if (threadIdx.x == 0) bulk_wait<0>();

  bf16* drow_q = dqkv + (long)b * t_len * 3 * C + (long)h * 3 * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (qr0 < t_len) {
      *reinterpret_cast<uint32_t*>(drow_q + (long)qr0 * 3 * C + col) =
          pack_bf16(dq[4 * n] * sm_scale, dq[4 * n + 1] * sm_scale);
    }
    if (qr1 < t_len) {
      *reinterpret_cast<uint32_t*>(drow_q + (long)qr1 * 3 * C + col) =
          pack_bf16(dq[4 * n + 2] * sm_scale, dq[4 * n + 3] * sm_scale);
    }
  }
}

// dk and dv for 64 keys of one (b, h), walking the query tiles.  The tile
// is computed transposed (rows are keys), so P^T and dX^T leave the S^T and
// dP^T accumulators as the A operands of dv += P^T dO and dk += dX^T Q.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, BwdWg<D>::kDkvBlocks)
bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qkv_map,
              const __grid_constant__ CUtensorMap dout_map,
              const __grid_constant__ CUtensorMap bias_map, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dqkv, int t_len, int heads,
              float scale, float bias_scale, float sm_scale) {
  using namespace hopper;
  using L = BwdWg<D>;
  constexpr int KS = L::KS;
  constexpr int STAGES = L::kDkvStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* k_smem = smem + STAGES * L::STAGE;
  unsigned char* v_smem = k_smem + L::TILE_BYTES;
  float* ls = reinterpret_cast<float*>(v_smem + L::TILE_BYTES);  // STAGES x 64 lse
  float* ds = ls + STAGES * TILE;                                 // STAGES x 64 delta
  uint64_t* full = reinterpret_cast<uint64_t*>(ds + STAGES * TILE);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;

  const int b = blockIdx.x;
  const int k0 = blockIdx.y * BK;
  const int h = blockIdx.z;
  const int n_tiles = (t_len + BQ - 1) / BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long row = (long)b * heads + h;  // this (b, h)'s row of lse and delta

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kBwdConsumerWarps);
    }
    mbar_init(kv_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kBwdConsumerWarps) {
    // ---------------------------------------------------------- producer
    if (lane == 0) {
      tma_prefetch(&qkv_map);
      tma_prefetch(&dout_map);
      tma_prefetch(&bias_map);
      const int col = h * 3 * D;
      mbar_expect_tx(kv_full, 2 * L::TILE_BYTES);
#pragma unroll
      for (int c = 0; c < L::NBOX; ++c) {
        tma_load_3d(k_smem + c * L::BOX, &qkv_map, kv_full, col + D + L::BOX_CH * c, k0, b);
        tma_load_3d(v_smem + c * L::BOX, &qkv_map, kv_full, col + 2 * D + L::BOX_CH * c, k0,
                    b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        const int q0 = i * BQ;
        const uint32_t row_bytes = (uint32_t)min(BQ, t_len - q0) * sizeof(float);
        unsigned char* st = smem + s * L::STAGE;
        mbar_expect_tx(&full[s], L::STAGE + 2 * row_bytes);
        tma_load_3d(st, &bias_map, &full[s], k0, q0, h);
        tma_load_3d(st + kBiasBox * 4, &bias_map, &full[s], k0 + 32, q0, h);
#pragma unroll
        for (int c = 0; c < L::NBOX; ++c) {
          tma_load_3d(st + L::BIAS + c * L::BOX, &qkv_map, &full[s], col + L::BOX_CH * c, q0,
                      b);
          tma_load_3d(st + L::BIAS + L::TILE_BYTES + c * L::BOX, &dout_map, &full[s],
                      h * D + L::BOX_CH * c, q0, b);
        }
        bulk_load(ls + s * TILE, lse + row * t_len + q0, row_bytes, &full[s]);
        bulk_load(ds + s * TILE, delta + row * t_len + q0, row_bytes, &full[s]);
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  const int g = lane / 4;   // this thread's keys: g and g + 8 of its warp's 16
  const int t4 = lane % 4;  // and queries 2 t4, 2 t4 + 1 of each 8-query block
  const int r0 = warp * 16 + g;
  // the bias box and column of this thread's keys (warps 0-1: keys 0-31)
  const int box = (warp / 2) * kBiasBox;
  const int kin0 = r0 % 32, kin1 = kin0 + 8;

  constexpr int QH = L::kDkvQueries;  // queries a product takes
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[QH / 2], dp[QH / 2];  // S^T and dP^T: query block n in [4n .. 4n + 3]
  uint32_t pa[QH / 16][4], xa[QH / 16][4];  // P^T and dX^T, one a 16-query k-step
  uint64_t kd[KS], vd[KS];
#pragma unroll
  for (int c = 0; c < KS; ++c) {
    kd[c] = L::k_desc(smem_addr(k_smem), c);
    vd[c] = L::k_desc(smem_addr(v_smem), c);
  }
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  };

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int si = i % STAGES;
    const unsigned char* st = smem + si * L::STAGE;
    const uint32_t q_addr = smem_addr(st + L::BIAS), do_addr = q_addr + L::TILE_BYTES;
    uint64_t qd[KS], dod[KS], qm[QH / 16], dom[QH / 16];
    // the descriptors of the tile's queries [hq QH, (hq + 1) QH): QH rows
    // on, the swizzle pattern starts anew
    auto describe = [&](int hq) {
      const uint32_t qa = q_addr + hq * QH * L::ROW, da = do_addr + hq * QH * L::ROW;
#pragma unroll
      for (int c = 0; c < KS; ++c) {
        qd[c] = L::k_desc(qa, c);
        dod[c] = L::k_desc(da, c);
      }
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk) {
        qm[kk] = L::mn_desc(qa, kk);
        dom[kk] = L::mn_desc(da, kk);
      }
      fence_regs(qd);
      fence_regs(dod);
      fence_regs(qm);
      fence_regs(dom);
    };
    describe(0);
    mbar_wait(&full[si], (i / STAGES) & 1);
    __syncwarp();
    const float* bt = reinterpret_cast<const float*>(st) + box;
    const float* lt = ls + si * TILE;
    const float* dt = ds + si * TILE;
    const int queries = t_len - i * BQ;
#pragma unroll
    for (int hq = 0; hq < BQ / QH; ++hq) {
      if (hq > 0) describe(hq);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < KS; ++c) wgmma_ss<QH>(s, kd[c], qd[c], c);  // S^T = K Q^T
#pragma unroll
      for (int c = 0; c < KS; ++c) wgmma_ss<QH>(dp, vd[c], dod[c], c);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T into s, dX^T into dp; queries past T (stale lse and delta in the
      // ring) take lse = MASKED_LSE and delta 0, so P = dX = 0
#pragma unroll
      for (int n = 0; n < QH / 8; ++n) {
        const int qc = hq * QH + n * 8 + 2 * t4;  // this thread's queries: qc, qc + 1
        float2 lq = *reinterpret_cast<const float2*>(lt + qc);
        float2 dq2 = *reinterpret_cast<const float2*>(dt + qc);
        if (qc >= queries) lq.x = MASKED_LSE, dq2.x = 0.f;
        if (qc + 1 >= queries) lq.y = MASKED_LSE, dq2.y = 0.f;
        float* x = s + 4 * n;
        float* y = dp + 4 * n;
        const float p0 = exp2f(fmaf(x[0], scale, bt[swz128(qc, kin0)] * bias_scale) - lq.x);
        const float p1 = exp2f(fmaf(x[1], scale, bt[swz128(qc + 1, kin0)] * bias_scale) - lq.y);
        const float p2 = exp2f(fmaf(x[2], scale, bt[swz128(qc, kin1)] * bias_scale) - lq.x);
        const float p3 = exp2f(fmaf(x[3], scale, bt[swz128(qc + 1, kin1)] * bias_scale) - lq.y);
        x[0] = p0;
        x[1] = p1;
        x[2] = p2;
        x[3] = p3;
        y[0] = p0 * (y[0] - dq2.x);
        y[1] = p1 * (y[1] - dq2.y);
        y[2] = p2 * (y[2] - dq2.x);
        y[3] = p3 * (y[3] - dq2.y);
      }
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk) {  // query blocks 2 kk, 2 kk + 1: k-step kk
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        xa[kk][0] = pack_bf16(dp[8 * kk], dp[8 * kk + 1]);
        xa[kk][1] = pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]);
        xa[kk][2] = pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]);
        xa[kk][3] = pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7]);
      }
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(xa[kk]);
      }
      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk) wgmma_rs<D>(dv, pa[kk], dom[kk]);  // dv += P^T dO
#pragma unroll
      for (int kk = 0; kk < QH / 16; ++kk) wgmma_rs<D>(dk, xa[kk], qm[kk]);  // dk += dX^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
    }
    release(si);
  }

  const int C = heads * D;
  bf16* drow = dqkv + (long)b * t_len * 3 * C + (long)h * 3 * D;
  const int kr0 = k0 + r0, kr1 = kr0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    if (kr0 < t_len) {
      bf16* r = drow + (long)kr0 * 3 * C + col;
      *reinterpret_cast<uint32_t*>(r + D) = pack_bf16(dk[4 * n] * sm_scale, dk[4 * n + 1] * sm_scale);
      *reinterpret_cast<uint32_t*>(r + 2 * D) = pack_bf16(dv[4 * n], dv[4 * n + 1]);
    }
    if (kr1 < t_len) {
      bf16* r = drow + (long)kr1 * 3 * C + col;
      *reinterpret_cast<uint32_t*>(r + D) =
          pack_bf16(dk[4 * n + 2] * sm_scale, dk[4 * n + 3] * sm_scale);
      *reinterpret_cast<uint32_t*>(r + 2 * D) = pack_bf16(dv[4 * n + 2], dv[4 * n + 3]);
    }
  }
}

// ------------------------------------------- dbias: fixed-order sum of rows

constexpr int SUM_THREADS = 256;

// dbias[h, r, c..c+3] = part[0][h, r, c..] + ... + part[B-1][h, r, c..], one
// float4 of dbias a thread, added in batch order.
__global__ void __launch_bounds__(SUM_THREADS)
dbias_sum(const float* __restrict__ part, float* __restrict__ dbias, int batch, int t_len,
          int heads) {
  const int t_pad = padded(t_len);
  const int c4n = (t_len + 3) / 4;
  const long i = (long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= (long)heads * t_len * c4n) return;
  const int c = (int)(i % c4n) * 4;
  const long hr = i / c4n;  // h * T + r
  const long slice = (long)heads * t_pad * t_pad;
  const float* p = part + ((hr / t_len) * t_pad + hr % t_len) * t_pad + c;
  float4 acc = __ldcs(reinterpret_cast<const float4*>(p));
#pragma unroll 4
  for (int bb = 1; bb < batch; ++bb) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(p + bb * slice));
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  float* o = dbias + hr * t_len + c;
  if ((t_len % 4) == 0) {
    *reinterpret_cast<float4*>(o) = acc;
  } else {
    o[0] = acc.x;
    if (c + 1 < t_len) o[1] = acc.y;
    if (c + 2 < t_len) o[2] = acc.z;
    if (c + 3 < t_len) o[3] = acc.w;
  }
}

// ------------------------------------------------------ float32: plain FMA

constexpr int RF = 32;  // rows (queries or keys) per fp32 tile

template <int D>
struct SimtBwd {
  static constexpr int LD = D + 1;       // odd row stride: column walks hit distinct banks
  static constexpr int LDX = RF + 1;
  static constexpr size_t dq_bytes = sizeof(float) * (5 * RF * LD + RF * LDX + RF);
  static constexpr size_t dkv_bytes = sizeof(float) * (6 * RF * LD + 2 * RF * LDX);
};

// Rows [r0, r0 + 32) of a row-major fp32 matrix (columns [0, D)) into a
// shared tile of row stride D + 1; rows past T are zero.
template <int D>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, int r0,
                                              int t_len, long row_stride) {
  for (int e = threadIdx.x; e < RF * D; e += NTHREADS) {
    const int r = e / D, c = e % D;
    dst[r * SimtBwd<D>::LD + c] = r0 + r < t_len ? src[(long)(r0 + r) * row_stride + c] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ float dot_rows(const float* a, const float* b) {
  float acc = 0.f;
  for (int d = 0; d < D; ++d) acc = fmaf(a[d], b[d], acc);
  return acc;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_simt(const float* __restrict__ qkv, const float* __restrict__ bias,
            const float* __restrict__ dout, const float* __restrict__ out,
            const float* __restrict__ lse, float* __restrict__ delta,
            float* __restrict__ dqkv, float* __restrict__ dbias_part, int t_len, int heads,
            float scale, float bias_scale, float sm_scale) {
  using L = SimtBwd<D>;
  const int b = blockIdx.x;
  const int q0 = blockIdx.y * RF;
  const int h = blockIdx.z;
  const int t_pad = padded(t_len);
  const int C = heads * D;
  const long row_stride = 3L * C;
  const float* bias_h = bias + (long)h * t_len * t_len;
  float* part = dbias_part + ((long)b * heads + h) * t_pad * t_pad;
  const float* base = qkv + (long)b * t_len * row_stride + (long)h * 3 * D;
  const long io_off = (long)b * t_len * C + (long)h * D;
  const float* lrow = lse + ((long)b * heads + h) * t_len;

  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + RF * L::LD;
  float* Ks = dOs + RF * L::LD;
  float* Vs = Ks + RF * L::LD;
  float* dQ = Vs + RF * L::LD;
  float* X = dQ + RF * L::LD;  // dX tile [query][key]
  float* Dl = X + RF * L::LDX;

  load_rows_f32<D>(Qs, base, q0, t_len, row_stride);
  load_rows_f32<D>(dOs, dout + io_off, q0, t_len, C);
  load_rows_f32<D>(Ks, out + io_off, q0, t_len, C);  // out, staged for delta
  for (int e = threadIdx.x; e < RF * D; e += NTHREADS) dQ[(e / D) * L::LD + e % D] = 0.f;
  __syncthreads();
  if (threadIdx.x < RF) {
    const int r = threadIdx.x;
    const float dl = dot_rows<D>(dOs + r * L::LD, Ks + r * L::LD);
    Dl[r] = dl;
    if (q0 + r < t_len) delta[((long)b * heads + h) * t_len + q0 + r] = dl;
  }
  for (int k0 = 0; k0 < t_len; k0 += RF) {
    __syncthreads();  // the previous tile's K, V and X (and out) are no longer read
    load_rows_f32<D>(Ks, base + D, k0, t_len, row_stride);
    load_rows_f32<D>(Vs, base + 2 * D, k0, t_len, row_stride);
    __syncthreads();
    for (int e = threadIdx.x; e < RF * RF; e += NTHREADS) {
      const int r = e / RF, c = e % RF;
      const int qr = q0 + r, kc = k0 + c;
      float x = 0.f;
      if (qr < t_len && kc < t_len) {
        const float z = fmaf(dot_rows<D>(Qs + r * L::LD, Ks + c * L::LD), scale,
                             bias_h[(long)qr * t_len + kc] * bias_scale);
        const float dp = dot_rows<D>(dOs + r * L::LD, Vs + c * L::LD);
        x = exp2f(z - lrow[qr]) * (dp - Dl[r]);
        part[(long)qr * t_pad + kc] = x;
      }
      X[r * L::LDX + c] = x;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < RF * D; e += NTHREADS) {
      const int r = e / D, d = e % D;
      float acc = dQ[r * L::LD + d];
      for (int c = 0; c < RF; ++c) acc = fmaf(X[r * L::LDX + c], Ks[c * L::LD + d], acc);
      dQ[r * L::LD + d] = acc;
    }
  }
  __syncthreads();
  float* dq_rows = dqkv + (long)b * t_len * row_stride + (long)h * 3 * D;
  for (int e = threadIdx.x; e < RF * D; e += NTHREADS) {
    const int r = e / D, d = e % D;
    if (q0 + r < t_len) dq_rows[(long)(q0 + r) * row_stride + d] = dQ[r * L::LD + d] * sm_scale;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dkv_simt(const float* __restrict__ qkv, const float* __restrict__ bias,
             const float* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, float* __restrict__ dqkv, int t_len,
             int heads, float scale, float bias_scale, float sm_scale) {
  using L = SimtBwd<D>;
  const int b = blockIdx.x;
  const int k0 = blockIdx.y * RF;
  const int h = blockIdx.z;
  const int C = heads * D;
  const long row_stride = 3L * C;
  const float* base = qkv + (long)b * t_len * row_stride + (long)h * 3 * D;
  const float* dobase = dout + (long)b * t_len * C + (long)h * D;
  const float* bias_h = bias + (long)h * t_len * t_len;
  const float* lrow = lse + ((long)b * heads + h) * t_len;
  const float* drow = delta + ((long)b * heads + h) * t_len;

  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + RF * L::LD;
  float* Qs = Vs + RF * L::LD;
  float* dOs = Qs + RF * L::LD;
  float* dK = dOs + RF * L::LD;
  float* dV = dK + RF * L::LD;
  float* P = dV + RF * L::LD;  // [key][query]
  float* X = P + RF * L::LDX;  // [key][query]

  load_rows_f32<D>(Ks, base + D, k0, t_len, row_stride);
  load_rows_f32<D>(Vs, base + 2 * D, k0, t_len, row_stride);
  for (int e = threadIdx.x; e < RF * D; e += NTHREADS) {
    dK[(e / D) * L::LD + e % D] = 0.f;
    dV[(e / D) * L::LD + e % D] = 0.f;
  }
  for (int q0 = 0; q0 < t_len; q0 += RF) {
    __syncthreads();  // the previous tile's Q, dO, P and X are no longer read
    load_rows_f32<D>(Qs, base, q0, t_len, row_stride);
    load_rows_f32<D>(dOs, dobase, q0, t_len, C);
    __syncthreads();
    for (int e = threadIdx.x; e < RF * RF; e += NTHREADS) {
      const int c = e / RF, r = e % RF;  // key c, query r
      const int kc = k0 + c, qr = q0 + r;
      float p = 0.f, x = 0.f;
      if (qr < t_len && kc < t_len) {
        const float z = fmaf(dot_rows<D>(Qs + r * L::LD, Ks + c * L::LD), scale,
                             bias_h[(long)qr * t_len + kc] * bias_scale);
        const float dp = dot_rows<D>(dOs + r * L::LD, Vs + c * L::LD);
        p = exp2f(z - lrow[qr]);
        x = p * (dp - drow[qr]);
      }
      P[c * L::LDX + r] = p;
      X[c * L::LDX + r] = x;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < RF * D; e += NTHREADS) {
      const int c = e / D, d = e % D;
      float av = dV[c * L::LD + d], ak = dK[c * L::LD + d];
      for (int r = 0; r < RF; ++r) {
        av = fmaf(P[c * L::LDX + r], dOs[r * L::LD + d], av);
        ak = fmaf(X[c * L::LDX + r], Qs[r * L::LD + d], ak);
      }
      dV[c * L::LD + d] = av;
      dK[c * L::LD + d] = ak;
    }
  }
  __syncthreads();
  float* dkv_rows = dqkv + (long)b * t_len * row_stride + (long)h * 3 * D;
  for (int e = threadIdx.x; e < RF * D; e += NTHREADS) {
    const int c = e / D, d = e % D;
    if (k0 + c < t_len) {
      dkv_rows[(long)(k0 + c) * row_stride + D + d] = dK[c * L::LD + d] * sm_scale;
      dkv_rows[(long)(k0 + c) * row_stride + 2 * D + d] = dV[c * L::LD + d];
    }
  }
}

// ------------------------------------------------------------------ launch

struct Args {
  const void* qkv;
  const float* bias;
  const void* dout;
  const void* out;
  const float* lse;
  float* delta;
  void* dqkv;
  float* dbias_part;
  int batch, t_len, heads;
  float scale, bias_scale, sm_scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  // prefer shared memory over L1, so that three CTAs fit on an SM
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// The kernels each backward call takes (bias_attention_bwd_route): bf16 at
// a head dim the wgmma kernels are built for and T % 4 == 0 on them, the
// other bf16 calls on mma.sync, fp32 on the scalar kernels.
enum BwdRoute { kRouteWgmma = 0, kRouteMma = 1, kRouteSimt = 2 };

using hopper::wgmma_dim;

int bwd_route(int t_len, int head_dim, int dtype) {
  if (dtype != 0) return kRouteSimt;
  return wgmma_dim(head_dim) && t_len % 4 == 0 ? kRouteWgmma : kRouteMma;
}

// Message of the last failure that has no CUDA error code of its own (a
// tensor map the driver refused, or no cuTensorMapEncodeTiled).
char g_error[256] = "";
constexpr int kOwnError = 20000;  // the error code that points at g_error

// The error code of an encode's result ``r`` (0 on success).
int map_error(CUresult r, const Args& a, const char* what) {
  if (r == CUDA_ERROR_NOT_FOUND) {
    snprintf(g_error, sizeof g_error, "cuTensorMapEncodeTiled not found in the driver");
    return kOwnError;
  }
  if (r != CUDA_SUCCESS) {
    snprintf(g_error, sizeof g_error,
             "cuTensorMapEncodeTiled refused the %s map (CUresult %d) at B=%d T=%d H=%d", what,
             (int)r, a.batch, a.t_len, a.heads);
    return kOwnError;
  }
  return 0;
}

// One bf16 or fp32 map of a launch (hopper::encode_map_3d).
int encode(CUtensorMap* map, CUtensorMapDataType type, void* base, const cuuint64_t (&dims)[3],
           const cuuint64_t (&strides)[2], const cuuint32_t (&box)[3],
           CUtensorMapSwizzle swizzle, const Args& a, const char* what) {
  return map_error(hopper::encode_map_3d(map, type, base, dims, strides, box, swizzle), a, what);
}

// The maps of the wgmma kernels: qkv (3 H D channels, T, B) and dout (H D
// channels, T, B) in bf16 boxes of BwdWg<D>::BOX_CH channels x 64 rows with
// the swizzle of their row's bytes; the bias (T keys, T queries, H) in fp32
// boxes of 32 keys x 64 queries with the 128-byte swizzle; and, for dq, the
// partials (T keys, T queries, B H) of row stride Tp in the same boxes.
template <int D>
int encode_maps(const Args& a, CUtensorMap* qkv_map, CUtensorMap* dout_map,
                CUtensorMap* bias_map, CUtensorMap* part_map) {
  using L = BwdWg<D>;
  const cuuint64_t t = a.t_len, c = (cuuint64_t)a.heads * D, tp = padded(a.t_len);
  const cuuint32_t tile_box[3] = {L::BOX_CH, TILE, 1}, bias_box[3] = {32, TILE, 1};
  const CUtensorMapSwizzle swizzle = L::SWIZZLE;
  int err = encode(qkv_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, const_cast<void*>(a.qkv),
                   {3 * c, t, (cuuint64_t)a.batch}, {3 * c * 2, 3 * c * 2 * t}, tile_box,
                   swizzle, a, "qkv");
  if (err == 0) {
    err = encode(dout_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, const_cast<void*>(a.dout),
                 {c, t, (cuuint64_t)a.batch}, {c * 2, c * 2 * t}, tile_box, swizzle, a,
                 "dout");
  }
  if (err == 0) {
    err = map_error(hopper::encode_bias_f32_map(bias_map, a.bias, a.t_len, a.heads, TILE), a,
                    "bias");
  }
  if (err == 0 && part_map != nullptr) {
    err = encode(part_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.dbias_part,
                 {t, t, (cuuint64_t)a.batch * a.heads}, {tp * 4, tp * tp * 4}, bias_box,
                 CU_TENSOR_MAP_SWIZZLE_128B, a, "dbias partials");
  }
  return err;
}

template <int D>
int launch_dq_wgmma(const Args& a) {
  using L = BwdWg<D>;
  int err = (int)prepare(bwd_dq_wgmma<D>, L::dq_bytes);
  if (err != 0) return err;
  CUtensorMap qkv_map, dout_map, bias_map, part_map;
  if ((err = encode_maps<D>(a, &qkv_map, &dout_map, &bias_map, &part_map)) != 0) return err;
  const dim3 grid(a.batch, (a.t_len + BQ - 1) / BQ, a.heads);
  bwd_dq_wgmma<D><<<grid, kBwdThreads, L::dq_bytes, a.stream>>>(
      qkv_map, dout_map, bias_map, part_map, static_cast<const bf16*>(a.out), a.lse, a.delta,
      static_cast<bf16*>(a.dqkv), a.t_len, a.heads, a.scale, a.bias_scale, a.sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const Args& a) {
  using L = BwdWg<D>;
  int err = (int)prepare(bwd_dkv_wgmma<D>, L::dkv_bytes);
  if (err != 0) return err;
  CUtensorMap qkv_map, dout_map, bias_map;
  if ((err = encode_maps<D>(a, &qkv_map, &dout_map, &bias_map, nullptr)) != 0) return err;
  const dim3 grid(a.batch, (a.t_len + BK - 1) / BK, a.heads);
  bwd_dkv_wgmma<D><<<grid, kBwdThreads, L::dkv_bytes, a.stream>>>(
      qkv_map, dout_map, bias_map, a.lse, a.delta, static_cast<bf16*>(a.dqkv), a.t_len,
      a.heads, a.scale, a.bias_scale, a.sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(int dtype, const Args& a) {
  const int route = bwd_route(a.t_len, D, dtype);
  if constexpr (wgmma_dim(D)) {
    if (route == kRouteWgmma) return launch_dq_wgmma<D>(a);
  }
  cudaError_t err;
  if (route == kRouteMma) {
    const dim3 grid(a.batch, (a.t_len + BQ - 1) / BQ, a.heads);
    const size_t smem = dq_smem_bytes<D>();
    if ((err = prepare(bwd_dq_mma<D>, smem)) != cudaSuccess) return (int)err;
    bwd_dq_mma<D><<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const bf16*>(a.qkv), a.bias, static_cast<const bf16*>(a.dout),
        static_cast<const bf16*>(a.out), a.lse, a.delta, static_cast<bf16*>(a.dqkv),
        a.dbias_part, a.t_len, a.heads, a.scale, a.bias_scale, a.sm_scale);
  } else {
    const dim3 grid(a.batch, (a.t_len + RF - 1) / RF, a.heads);
    const size_t smem = SimtBwd<D>::dq_bytes;
    if ((err = prepare(bwd_dq_simt<D>, smem)) != cudaSuccess) return (int)err;
    bwd_dq_simt<D><<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const float*>(a.qkv), a.bias, static_cast<const float*>(a.dout),
        static_cast<const float*>(a.out), a.lse, a.delta, static_cast<float*>(a.dqkv),
        a.dbias_part, a.t_len, a.heads, a.scale, a.bias_scale, a.sm_scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(int dtype, const Args& a) {
  const int route = bwd_route(a.t_len, D, dtype);
  if constexpr (wgmma_dim(D)) {
    if (route == kRouteWgmma) return launch_dkv_wgmma<D>(a);
  }
  cudaError_t err;
  if (route == kRouteMma) {
    const dim3 grid(a.batch, (a.t_len + BK - 1) / BK, a.heads);
    const size_t smem = dkv_smem_bytes<D>();
    if ((err = prepare(bwd_dkv_mma<D>, smem)) != cudaSuccess) return (int)err;
    bwd_dkv_mma<D><<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const bf16*>(a.qkv), a.bias, static_cast<const bf16*>(a.dout), a.lse,
        a.delta, static_cast<bf16*>(a.dqkv), a.t_len, a.heads, a.scale, a.bias_scale,
        a.sm_scale);
  } else {
    const dim3 grid(a.batch, (a.t_len + RF - 1) / RF, a.heads);
    const size_t smem = SimtBwd<D>::dkv_bytes;
    if ((err = prepare(bwd_dkv_simt<D>, smem)) != cudaSuccess) return (int)err;
    bwd_dkv_simt<D><<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const float*>(a.qkv), a.bias, static_cast<const float*>(a.dout), a.lse,
        a.delta, static_cast<float*>(a.dqkv), a.t_len, a.heads, a.scale, a.bias_scale,
        a.sm_scale);
  }
  return (int)cudaGetLastError();
}

// CTAs of a bf16 kernel that fit on an SM: ``which`` 0 dq, 1 dk/dv of the
// mma.sync route, 2 dq, 3 dk/dv of the wgmma route (its head dims only).
template <int D>
cudaError_t blocks_per_sm(int which, int* blocks) {
  cudaError_t err;
  if (which >= 2) {
    if constexpr (wgmma_dim(D)) {
      using L = BwdWg<D>;
      if (which == 2) {
        if ((err = prepare(bwd_dq_wgmma<D>, L::dq_bytes)) != cudaSuccess) return err;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, bwd_dq_wgmma<D>,
                                                             kBwdThreads, L::dq_bytes);
      }
      if ((err = prepare(bwd_dkv_wgmma<D>, L::dkv_bytes)) != cudaSuccess) return err;
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, bwd_dkv_wgmma<D>,
                                                           kBwdThreads, L::dkv_bytes);
    }
    return cudaErrorInvalidValue;
  }
  if (which == 0) {
    if ((err = prepare(bwd_dq_mma<D>, dq_smem_bytes<D>())) != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, bwd_dq_mma<D>, NTHREADS,
                                                         dq_smem_bytes<D>());
  }
  if ((err = prepare(bwd_dkv_mma<D>, dkv_smem_bytes<D>())) != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, bwd_dkv_mma<D>, NTHREADS,
                                                       dkv_smem_bytes<D>());
}

enum class Op { kDq, kDkv, kOccupancy };

template <Op kOp>
int dispatch(int head_dim, int dtype, const Args& a, int* blocks = nullptr) {
  if (kOp != Op::kOccupancy &&
      (a.batch <= 0 || a.t_len <= 0 || a.heads <= 0 || (dtype != 0 && dtype != 1))) {
    return (int)cudaErrorInvalidValue;
  }
#define DTTS_CASE(DIM)                                                          \
  case DIM:                                                                     \
    return (int)(kOp == Op::kDq    ? launch_dq<DIM>(dtype, a)                   \
                 : kOp == Op::kDkv ? launch_dkv<DIM>(dtype, a)                  \
                                   : (int)blocks_per_sm<DIM>(dtype, blocks));
  switch (head_dim) {
    DTTS_CASE(16) DTTS_CASE(32) DTTS_CASE(48) DTTS_CASE(64)
    DTTS_CASE(80) DTTS_CASE(96) DTTS_CASE(112) DTTS_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DTTS_CASE
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 for qkv (B, T, 3 * H * D), dout and out
// (B, T, H * D) and dqkv (B, T, 3 * H * D); bias (H, T, T, natural domain),
// lse and delta (B, H, T), dbias_part (B, H, Tp, Tp) with Tp = T rounded up
// to a multiple of 64, and dbias (H, T, T) are float32.  All contiguous and
// 16-byte aligned.  scale = sm_scale * log2(e), bias_scale = log2(e).
// Each returns the CUDA error code of its launch (0 on success).  Both
// entries take the route bias_attention_bwd_route names.

// delta and dq, and each batch row's dX into dbias_part.
extern "C" int bias_attention_bwd_dq(const void* qkv, const void* bias, const void* dout,
                                     const void* out, const void* lse, void* delta,
                                     void* dqkv, void* dbias_part, int batch, int t_len,
                                     int heads, int head_dim, float scale, float bias_scale,
                                     float sm_scale, int dtype, void* stream) {
  const Args a{qkv, static_cast<const float*>(bias), dout, out,
               static_cast<const float*>(lse), static_cast<float*>(delta), dqkv,
               static_cast<float*>(dbias_part), batch, t_len, heads, scale, bias_scale,
               sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<Op::kDq>(head_dim, dtype, a);
}

// dk and dv, from the delta that bias_attention_bwd_dq wrote.
extern "C" int bias_attention_bwd_dkv(const void* qkv, const void* bias, const void* dout,
                                      const void* lse, const void* delta, void* dqkv,
                                      int batch, int t_len, int heads, int head_dim,
                                      float scale, float bias_scale, float sm_scale,
                                      int dtype, void* stream) {
  const Args a{qkv, static_cast<const float*>(bias), dout, nullptr,
               static_cast<const float*>(lse), static_cast<float*>(const_cast<void*>(delta)),
               dqkv, nullptr, batch, t_len, heads, scale, bias_scale, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Op::kDkv>(head_dim, dtype, a);
}

// dbias = the sum of the B partials in batch order.
extern "C" int bias_attention_bwd_dbias_sum(const void* dbias_part, void* dbias, int batch,
                                            int t_len, int heads, void* stream) {
  if (batch <= 0 || t_len <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  const long n = (long)heads * t_len * ((t_len + 3) / 4);
  dbias_sum<<<(unsigned)((n + SUM_THREADS - 1) / SUM_THREADS), SUM_THREADS, 0,
              static_cast<cudaStream_t>(stream)>>>(static_cast<const float*>(dbias_part),
                                                   static_cast<float*>(dbias), batch, t_len,
                                                   heads);
  return (int)cudaGetLastError();
}

// The kernels a backward call of this B, T, head_dim and dtype (0 bf16, 1
// fp32) takes: 0 bwd_dq_wgmma and bwd_dkv_wgmma (bf16, d <= 64 or d = 96,
// T % 4 == 0), 1 bwd_dq_mma and bwd_dkv_mma (the other bf16 calls), 2 the scalar
// kernels, each route with the sum pass; -1 for a shape or dtype the
// entries refuse.
extern "C" int bias_attention_bwd_route(int batch, int t_len, int head_dim, int dtype) {
  if (batch <= 0 || t_len <= 0 || head_dim % 16 != 0 || head_dim < 16 || head_dim > 128 ||
      (dtype != 0 && dtype != 1)) {
    return -1;
  }
  return bwd_route(t_len, head_dim, dtype);
}

// CTAs of the bf16 kernel ``which`` (0 bwd_dq_mma, 1 bwd_dkv_mma, 2
// bwd_dq_wgmma, 3 bwd_dkv_wgmma; 2-3 at d <= 64 and d = 96) at
// ``head_dim`` that fit on one SM of the current device, or minus the CUDA
// error code.
extern "C" int bias_attention_bwd_blocks_per_sm(int which, int head_dim) {
  int blocks = 0;
  const Args a{};
  const int err = dispatch<Op::kOccupancy>(head_dim, which, a, &blocks);
  return err != 0 ? -err : blocks;
}

extern "C" const char* bias_attention_bwd_error_string(int code) {
  if (code == kOwnError) return g_error;
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
