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
// Three launches, in this order:
// * ``bias_attention_bwd_dq``: delta (written for the next kernel), dq, and
//   each batch row's dX written once into a partial dbias_part (B, H, Tp, Tp)
//   (Tp = T rounded up to 64; the padding holds zeros);
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
// bf16, FlashAttention-2 style on mma.sync (m16n8k16, fp32 accumulate), 4
// warps of 16 rows per CTA, each warp walking its 64-wide tile in two
// halves of 32 columns so that S and dP take 32 registers, not 64:
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
// Both round P and dX to bf16 for the products, as the forward rounds P.
// float32 (a test route) takes plain scalar kernels on 32-row tiles.
// Ragged T is masked in place: rows past T are zero-filled and not written,
// keys past T get P = 0.  A fully masked row (lse = MASKED_LSE) has P = 0
// everywhere, so all its gradients are exactly 0.
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

template <int D>
cudaError_t launch_dq(int dtype, const Args& a) {
  cudaError_t err;
  if (dtype == 0) {
    const dim3 grid(a.batch, (a.t_len + BQ - 1) / BQ, a.heads);
    const size_t smem = dq_smem_bytes<D>();
    if ((err = prepare(bwd_dq_mma<D>, smem)) != cudaSuccess) return err;
    bwd_dq_mma<D><<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const bf16*>(a.qkv), a.bias, static_cast<const bf16*>(a.dout),
        static_cast<const bf16*>(a.out), a.lse, a.delta, static_cast<bf16*>(a.dqkv),
        a.dbias_part, a.t_len, a.heads, a.scale, a.bias_scale, a.sm_scale);
  } else {
    const dim3 grid(a.batch, (a.t_len + RF - 1) / RF, a.heads);
    const size_t smem = SimtBwd<D>::dq_bytes;
    if ((err = prepare(bwd_dq_simt<D>, smem)) != cudaSuccess) return err;
    bwd_dq_simt<D><<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const float*>(a.qkv), a.bias, static_cast<const float*>(a.dout),
        static_cast<const float*>(a.out), a.lse, a.delta, static_cast<float*>(a.dqkv),
        a.dbias_part, a.t_len, a.heads, a.scale, a.bias_scale, a.sm_scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(int dtype, const Args& a) {
  cudaError_t err;
  if (dtype == 0) {
    const dim3 grid(a.batch, (a.t_len + BK - 1) / BK, a.heads);
    const size_t smem = dkv_smem_bytes<D>();
    if ((err = prepare(bwd_dkv_mma<D>, smem)) != cudaSuccess) return err;
    bwd_dkv_mma<D><<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const bf16*>(a.qkv), a.bias, static_cast<const bf16*>(a.dout), a.lse,
        a.delta, static_cast<bf16*>(a.dqkv), a.t_len, a.heads, a.scale, a.bias_scale,
        a.sm_scale);
  } else {
    const dim3 grid(a.batch, (a.t_len + RF - 1) / RF, a.heads);
    const size_t smem = SimtBwd<D>::dkv_bytes;
    if ((err = prepare(bwd_dkv_simt<D>, smem)) != cudaSuccess) return err;
    bwd_dkv_simt<D><<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const float*>(a.qkv), a.bias, static_cast<const float*>(a.dout), a.lse,
        a.delta, static_cast<float*>(a.dqkv), a.t_len, a.heads, a.scale, a.bias_scale,
        a.sm_scale);
  }
  return cudaGetLastError();
}

// CTAs of the bf16 dq (which 0) or dk/dv (which 1) kernel that fit on an SM.
template <int D>
cudaError_t blocks_per_sm(int which, int* blocks) {
  cudaError_t err;
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
                                   : blocks_per_sm<DIM>(dtype, blocks));
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
// Each returns the CUDA error code of its launch (0 on success).

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

// CTAs of the bf16 kernel ``which`` (0 dq, 1 dk/dv) at ``head_dim`` that fit
// on one SM of the current device, or minus the CUDA error code.
extern "C" int bias_attention_bwd_blocks_per_sm(int which, int head_dim) {
  int blocks = 0;
  const Args a{};
  const int err = dispatch<Op::kOccupancy>(head_dim, which, a, &blocks);
  return err != 0 ? -err : blocks;
}

extern "C" const char* bias_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
