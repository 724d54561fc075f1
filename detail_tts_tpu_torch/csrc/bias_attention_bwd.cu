// Bias-attention backward for Hopper (sm_90a), CUDA C++ with plain C entries.
//
// The forward (bias_attention.cu, ``bias_attention_train_fwd``) computed, per
// batch row b and head h, with z = scale * q k^T + bias_scale * bias[h]
// (log2 domain; scale = sm_scale * log2(e), bias_scale = log2(e)):
//     P = exp2(z - lse),   out = P v,
// and saved the row statistic lse (B, H, T).  Here, with delta =
// rowsum(dout * out) (B, H, T) computed before the launch,
//     dP = dout v^T,  dX = P * (dP - delta)   (the natural-domain logits' grad)
//     dq = sm_scale dX k,  dk = sm_scale dX^T q,  dv = P^T dout,
//     dbias[h] = sum over b of dX
// dq, dk and dv land in one d(qkv) tensor (B, T, 3C), channel order
// [head][q|k|v][ch] like qkv: ``bias_attention_bwd_dq`` fills the q slots,
// ``bias_attention_bwd_dkv`` the k and v slots.  They are disjoint, so
// there are no atomics.
//
// Replaces the two Pallas kernels of ``_attn_train_bwd`` in
// detail_tts_tpu/ops/pallas/attention.py: ``_attn_bwd_dq_kernel`` (dq and
// dbias summed over the batch) and ``_attn_bwd_dkv_kernel`` (dk, dv).  The
// Pallas kernels worked in the log2 domain and chained dbias back by
// log2(e) outside; dX is that chain taken inside.
//
// What bounds it on the H100: at the training step's largest call (B = 8,
// T = 496, H = 16, d = 48) the dq/dbias kernel does 6 B H T^2 d ~ 9.1e9
// tensor-core FLOP (three products) and the dk/dv kernel 8 B H T^2 d
// ~ 1.2e10 (four), each beside B H T^2 ~ 3.1e7 exp2 and ~40 MB of
// compulsory traffic (q, k, v, dout, the fp32 bias and dbias); bytes bound
// both.  Each kernel recomputes P from (q, k, bias, lse) so the
// (B, H, T, T) probabilities never reach memory.
//
// bf16, FlashAttention-2 style on mma.sync (m16n8k16, fp32 accumulate):
// * dq/dbias: one CTA of 4 warps owns 64 query rows of one head and walks
//   the batch, and inside it the 64-key tiles (K and V double-buffered with
//   cp.async).  dq stays in registers for one batch row.  The CTA alone owns
//   those rows of dbias[h]: each thread reads, adds and writes its own
//   elements once per batch row, in batch order, so dbias is the same bits
//   on every run (no atomics, and no other CTA touches the rows).
// * dk/dv: one CTA per (batch, head, 64-key block) walks the 64-query
//   tiles (Q and dout double-buffered); dk and dv stay in registers.  The
//   bias tile is staged through shared memory, because this kernel reads it
//   transposed.
// Both round P and dX to bf16 for the products, as the forward rounds P.
// float32 (a test route) takes plain scalar kernels on 32-row tiles.
// Ragged T is masked in place: rows past T are zero-filled and not written,
// keys past T get P = 0.  A fully masked row (lse = MASKED_LSE) has P = 0
// everywhere, so all its gradients are exactly 0.
#include "mma.cuh"

namespace {

using namespace attn;

constexpr int BQ = TILE;   // query rows per tile
constexpr int BK = TILE;   // keys per tile
constexpr int LDB = BK + 4;  // staged fp32 bias row: transposed reads hit distinct banks

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * (2 * BQ + 4 * BK) * (D + 8);  // Q, dO + two K and two V tiles
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * (2 * BK + 4 * BQ) * (D + 8)  // K, V + two Q and two dO tiles
         + sizeof(float) * (BQ * LDB + 2 * BQ);       // bias tile, lse, delta
}

// ------------------------------------------------------------ bf16: dq, dbias

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dq_mma(const bf16* __restrict__ qkv, const float* __restrict__ bias,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, bf16* __restrict__ dqkv,
           float* __restrict__ dbias, int batch, int t_len, int heads, float scale,
           float bias_scale, float sm_scale) {
  constexpr int LDT = D + 8;
  constexpr int KS = D / 16;  // k-steps of Q K^T and dO V^T
  constexpr int NO = D / 8;   // 8-wide column blocks of dq
  constexpr int NS = BK / 8;  // 8-wide key blocks of a tile
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int C = heads * D;
  const long row_stride = 3L * C;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * LDT;
  bf16* Ks = dOs + BQ * LDT;     // two buffers
  bf16* Vs = Ks + 2 * BK * LDT;  // two buffers

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int n_tiles = (t_len + BK - 1) / BK;
  const int qr0 = q0 + warp * WROWS + g;
  const int qr1 = qr0 + 8;
  const bool ok0 = qr0 < t_len, ok1 = qr1 < t_len;
  const float* bias_h = bias + (long)h * t_len * t_len;
  const float* brow0 = bias_h + (long)(ok0 ? qr0 : 0) * t_len;
  const float* brow1 = bias_h + (long)(ok1 ? qr1 : 0) * t_len;
  float* dbrow0 = dbias + (long)h * t_len * t_len + (long)(ok0 ? qr0 : 0) * t_len;
  float* dbrow1 = dbias + (long)h * t_len * t_len + (long)(ok1 ? qr1 : 0) * t_len;
  const bool even = (t_len % 2) == 0;

  for (int b = 0; b < batch; ++b) {
    const bf16* base = qkv + (long)b * t_len * row_stride + (long)h * 3 * D;
    copy_tile<D>(Qs, base, q0, t_len, row_stride);
    copy_tile<D>(dOs, dout + (long)b * t_len * C + (long)h * D, q0, t_len, C);
    copy_tile<D>(Ks, base + D, 0, t_len, row_stride);
    copy_tile<D>(Vs, base + 2 * D, 0, t_len, row_stride);
    cp_async_commit();
    const float* lrow = lse + ((long)b * heads + h) * t_len;
    const float* drow = delta + ((long)b * heads + h) * t_len;
    const float lse0 = ok0 ? lrow[qr0] : 0.f, lse1 = ok1 ? lrow[qr1] : 0.f;
    const float dl0 = ok0 ? drow[qr0] : 0.f, dl1 = ok1 ? drow[qr1] : 0.f;

    float dq[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

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
      const bf16* Kt = Ks + (j & 1) * BK * LDT;
      const bf16* Vt = Vs + (j & 1) * BK * LDT;

      // S = Q K^T and dP = dO V^T for this warp's 16 rows and 64 keys
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t qa[4], da[4];
        load_a<LDT>(qa, Qs, warp * WROWS, kk, lane);
        load_a<LDT>(da, dOs, warp * WROWS, kk, lane);
#pragma unroll
        for (int n2 = 0; n2 < NS / 2; ++n2) {
          uint32_t kb[4], vb[4];
          load_b_nt<LDT>(kb, Kt, n2, kk, lane);
          load_b_nt<LDT>(vb, Vt, n2, kk, lane);
          mma_bf16(s[2 * n2], qa, kb[0], kb[1]);
          mma_bf16(s[2 * n2 + 1], qa, kb[2], kb[3]);
          mma_bf16(dp[2 * n2], da, vb[0], vb[1]);
          mma_bf16(dp[2 * n2 + 1], da, vb[2], vb[3]);
        }
      }

      // dX = P (dP - delta) in place of S; keys past T give 0
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int col = k0 + n * 8 + 2 * t4;
        const bool v0 = col < t_len, v1 = col + 1 < t_len;
        const float p0 = v0 ? exp2f(fmaf(s[n][0], scale, b0[n].x * bias_scale) - lse0) : 0.f;
        const float p1 = v1 ? exp2f(fmaf(s[n][1], scale, b0[n].y * bias_scale) - lse0) : 0.f;
        const float p2 = v0 ? exp2f(fmaf(s[n][2], scale, b1[n].x * bias_scale) - lse1) : 0.f;
        const float p3 = v1 ? exp2f(fmaf(s[n][3], scale, b1[n].y * bias_scale) - lse1) : 0.f;
        s[n][0] = p0 * (dp[n][0] - dl0);
        s[n][1] = p1 * (dp[n][1] - dl0);
        s[n][2] = p2 * (dp[n][2] - dl1);
        s[n][3] = p3 * (dp[n][3] - dl1);
      }

      // dbias rows of this CTA: this thread's elements, added in batch order
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int col = k0 + n * 8 + 2 * t4;
        const bool v0 = col < t_len, v1 = col + 1 < t_len;
        if (even && v0) {
          if (ok0) {
            float2* p = reinterpret_cast<float2*>(dbrow0 + col);
            float2 a = b > 0 ? *p : make_float2(0.f, 0.f);
            *p = make_float2(a.x + s[n][0], a.y + s[n][1]);
          }
          if (ok1) {
            float2* p = reinterpret_cast<float2*>(dbrow1 + col);
            float2 a = b > 0 ? *p : make_float2(0.f, 0.f);
            *p = make_float2(a.x + s[n][2], a.y + s[n][3]);
          }
        } else {
          if (ok0 && v0) dbrow0[col] = (b > 0 ? dbrow0[col] : 0.f) + s[n][0];
          if (ok0 && v1) dbrow0[col + 1] = (b > 0 ? dbrow0[col + 1] : 0.f) + s[n][1];
          if (ok1 && v0) dbrow1[col] = (b > 0 ? dbrow1[col] : 0.f) + s[n][2];
          if (ok1 && v1) dbrow1[col + 1] = (b > 0 ? dbrow1[col + 1] : 0.f) + s[n][3];
        }
      }

      // dq += dX K
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t xa[4];
        pack_a(xa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n2 = 0; n2 < NO / 2; ++n2) {
          uint32_t kb[4];
          load_b_nn<LDT>(kb, Kt, n2, kk, lane);
          mma_bf16(dq[2 * n2], xa, kb[0], kb[1]);
          mma_bf16(dq[2 * n2 + 1], xa, kb[2], kb[3]);
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
}

// ------------------------------------------------------------- bf16: dk, dv

template <int D>
__global__ void __launch_bounds__(NTHREADS)
bwd_dkv_mma(const bf16* __restrict__ qkv, const float* __restrict__ bias,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dqkv, int t_len,
            int heads, float scale, float bias_scale, float sm_scale) {
  constexpr int LDT = D + 8;
  constexpr int KS = D / 16;  // k-steps of K Q^T and V dO^T
  constexpr int NO = D / 8;   // 8-wide column blocks of dk, dv
  constexpr int NS = BQ / 8;  // 8-wide query blocks of a tile
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

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BK * LDT;
  bf16* Qs = Vs + BK * LDT;       // two buffers
  bf16* dOs = Qs + 2 * BQ * LDT;  // two buffers
  float* Bs = reinterpret_cast<float*>(dOs + 2 * BQ * LDT);  // [query][key]
  float* Ls = Bs + BQ * LDB;
  float* Dl = Ls + BQ;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int lk0 = warp * WROWS + g;  // this thread's keys in the block: lk0, lk0 + 8
  const int lk1 = lk0 + 8;
  const int n_tiles = (t_len + BQ - 1) / BQ;

  copy_tile<D>(Ks, base + D, k0, t_len, row_stride);
  copy_tile<D>(Vs, base + 2 * D, k0, t_len, row_stride);
  copy_tile<D>(Qs, base, 0, t_len, row_stride);
  copy_tile<D>(dOs, dobase, 0, t_len, C);
  cp_async_commit();

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = i * BQ;
    // the bias tile [q0, q0 + 64) x [k0, k0 + 64), the rows' lse and delta
    for (int e = threadIdx.x; e < BQ * BK; e += NTHREADS) {
      const int r = e / BK, c = e % BK;
      const bool valid = q0 + r < t_len && k0 + c < t_len;
      Bs[r * LDB + c] = valid ? bias_h[(long)(q0 + r) * t_len + k0 + c] : 0.f;
    }
    for (int e = threadIdx.x; e < BQ; e += NTHREADS) {
      const bool valid = q0 + e < t_len;
      Ls[e] = valid ? lrow[q0 + e] : 0.f;
      Dl[e] = valid ? drow[q0 + e] : 0.f;
    }
    if (i + 1 < n_tiles) {
      const int nb = (i + 1) & 1;
      copy_tile<D>(Qs + nb * BQ * LDT, base, q0 + BQ, t_len, row_stride);
      copy_tile<D>(dOs + nb * BQ * LDT, dobase, q0 + BQ, t_len, C);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qt = Qs + (i & 1) * BQ * LDT;
    const bf16* dOt = dOs + (i & 1) * BQ * LDT;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys and 64 queries
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      load_a<LDT>(ka, Ks, warp * WROWS, kk, lane);
      load_a<LDT>(va, Vs, warp * WROWS, kk, lane);
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t qb[4], db[4];
        load_b_nt<LDT>(qb, Qt, n2, kk, lane);
        load_b_nt<LDT>(db, dOt, n2, kk, lane);
        mma_bf16(s[2 * n2], ka, qb[0], qb[1]);
        mma_bf16(s[2 * n2 + 1], ka, qb[2], qb[3]);
        mma_bf16(dp[2 * n2], va, db[0], db[1]);
        mma_bf16(dp[2 * n2 + 1], va, db[2], db[3]);
      }
    }

    // P^T into s, dX^T into dp; queries past T give 0
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int qc = n * 8 + 2 * t4;  // this thread's queries in the tile: qc, qc + 1
      const bool v0 = q0 + qc < t_len, v1 = q0 + qc + 1 < t_len;
      const float p0 = v0 ? exp2f(fmaf(s[n][0], scale, Bs[qc * LDB + lk0] * bias_scale) - Ls[qc]) : 0.f;
      const float p1 = v1 ? exp2f(fmaf(s[n][1], scale, Bs[(qc + 1) * LDB + lk0] * bias_scale) - Ls[qc + 1]) : 0.f;
      const float p2 = v0 ? exp2f(fmaf(s[n][2], scale, Bs[qc * LDB + lk1] * bias_scale) - Ls[qc]) : 0.f;
      const float p3 = v1 ? exp2f(fmaf(s[n][3], scale, Bs[(qc + 1) * LDB + lk1] * bias_scale) - Ls[qc + 1]) : 0.f;
      s[n][0] = p0;
      s[n][1] = p1;
      s[n][2] = p2;
      s[n][3] = p3;
      dp[n][0] = p0 * (dp[n][0] - Dl[qc]);
      dp[n][1] = p1 * (dp[n][1] - Dl[qc + 1]);
      dp[n][2] = p2 * (dp[n][2] - Dl[qc]);
      dp[n][3] = p3 * (dp[n][3] - Dl[qc + 1]);
    }

    // dv += P^T dO, dk += dX^T Q
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t pa[4], xa[4];
      pack_a(pa, s[2 * kk], s[2 * kk + 1]);
      pack_a(xa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t ob[4], qb[4];
        load_b_nn<LDT>(ob, dOt, n2, kk, lane);
        load_b_nn<LDT>(qb, Qt, n2, kk, lane);
        mma_bf16(dv[2 * n2], pa, ob[0], ob[1]);
        mma_bf16(dv[2 * n2 + 1], pa, ob[2], ob[3]);
        mma_bf16(dk[2 * n2], xa, qb[0], qb[1]);
        mma_bf16(dk[2 * n2 + 1], xa, qb[2], qb[3]);
      }
    }
    __syncthreads();  // Bs, Ls, Dl and this tile's buffers are refilled
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

// ------------------------------------------------------ float32: plain FMA

constexpr int RF = 32;  // rows (queries or keys) per fp32 tile

template <int D>
struct SimtBwd {
  static constexpr int LD = D + 1;       // odd row stride: column walks hit distinct banks
  static constexpr int LDX = RF + 1;
  static constexpr size_t dq_bytes = sizeof(float) * (5 * RF * LD + RF * LDX);
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
            const float* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dqkv,
            float* __restrict__ dbias, int batch, int t_len, int heads, float scale,
            float bias_scale, float sm_scale) {
  using L = SimtBwd<D>;
  const int q0 = blockIdx.x * RF;
  const int h = blockIdx.y;
  const int C = heads * D;
  const long row_stride = 3L * C;
  const float* bias_h = bias + (long)h * t_len * t_len;
  float* dbias_h = dbias + (long)h * t_len * t_len;

  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + RF * L::LD;
  float* Ks = dOs + RF * L::LD;
  float* Vs = Ks + RF * L::LD;
  float* dQ = Vs + RF * L::LD;
  float* X = dQ + RF * L::LD;  // dX tile [query][key]

  for (int b = 0; b < batch; ++b) {
    const float* base = qkv + (long)b * t_len * row_stride + (long)h * 3 * D;
    const float* lrow = lse + ((long)b * heads + h) * t_len;
    const float* drow = delta + ((long)b * heads + h) * t_len;
    load_rows_f32<D>(Qs, base, q0, t_len, row_stride);
    load_rows_f32<D>(dOs, dout + (long)b * t_len * C + (long)h * D, q0, t_len, C);
    for (int e = threadIdx.x; e < RF * D; e += NTHREADS) dQ[(e / D) * L::LD + e % D] = 0.f;
    for (int k0 = 0; k0 < t_len; k0 += RF) {
      __syncthreads();  // the previous tile's K, V and X are no longer read
      load_rows_f32<D>(Ks, base + D, k0, t_len, row_stride);
      load_rows_f32<D>(Vs, base + 2 * D, k0, t_len, row_stride);
      __syncthreads();
      // one element (query r, key c) at a time; each thread always owns the
      // same elements, so its dbias adds run in batch order
      for (int e = threadIdx.x; e < RF * RF; e += NTHREADS) {
        const int r = e / RF, c = e % RF;
        const int qr = q0 + r, kc = k0 + c;
        float x = 0.f;
        if (qr < t_len && kc < t_len) {
          const float z = fmaf(dot_rows<D>(Qs + r * L::LD, Ks + c * L::LD), scale,
                               bias_h[(long)qr * t_len + kc] * bias_scale);
          const float dp = dot_rows<D>(dOs + r * L::LD, Vs + c * L::LD);
          x = exp2f(z - lrow[qr]) * (dp - drow[qr]);
          float* db = dbias_h + (long)qr * t_len + kc;
          *db = (b > 0 ? *db : 0.f) + x;
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
    __syncthreads();  // Qs, dOs and dQ are refilled for the next batch row
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
  const float* lse;
  const float* delta;
  void* dqkv;
  float* dbias;
  int batch, t_len, heads;
  float scale, bias_scale, sm_scale;
  cudaStream_t stream;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int D>
cudaError_t launch_dq(int dtype, const Args& a) {
  cudaError_t err;
  if (dtype == 0) {
    const dim3 grid((a.t_len + BQ - 1) / BQ, a.heads);
    const size_t smem = dq_smem_bytes<D>();
    if ((err = prepare(bwd_dq_mma<D>, smem)) != cudaSuccess) return err;
    bwd_dq_mma<D><<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const bf16*>(a.qkv), a.bias, static_cast<const bf16*>(a.dout), a.lse,
        a.delta, static_cast<bf16*>(a.dqkv), a.dbias, a.batch, a.t_len, a.heads, a.scale,
        a.bias_scale, a.sm_scale);
  } else {
    const dim3 grid((a.t_len + RF - 1) / RF, a.heads);
    const size_t smem = SimtBwd<D>::dq_bytes;
    if ((err = prepare(bwd_dq_simt<D>, smem)) != cudaSuccess) return err;
    bwd_dq_simt<D><<<grid, NTHREADS, smem, a.stream>>>(
        static_cast<const float*>(a.qkv), a.bias, static_cast<const float*>(a.dout), a.lse,
        a.delta, static_cast<float*>(a.dqkv), a.dbias, a.batch, a.t_len, a.heads, a.scale,
        a.bias_scale, a.sm_scale);
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

template <bool kDq>
int dispatch(int head_dim, int dtype, const Args& a) {
  if (a.batch <= 0 || a.t_len <= 0 || a.heads <= 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
#define DTTS_CASE(DIM) \
  case DIM:            \
    return (int)(kDq ? launch_dq<DIM>(dtype, a) : launch_dkv<DIM>(dtype, a));
  switch (head_dim) {
    DTTS_CASE(16) DTTS_CASE(32) DTTS_CASE(48) DTTS_CASE(64)
    DTTS_CASE(80) DTTS_CASE(96) DTTS_CASE(112) DTTS_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DTTS_CASE
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32 for qkv (B, T, 3 * H * D), dout
// (B, T, H * D) and dqkv (B, T, 3 * H * D); bias (H, T, T, natural domain),
// lse and delta (B, H, T) and dbias (H, T, T) are float32.  All contiguous
// and 16-byte aligned.  scale = sm_scale * log2(e), bias_scale = log2(e).
// Each returns the CUDA error code of its launch (0 on success).
extern "C" int bias_attention_bwd_dq(const void* qkv, const void* bias, const void* dout,
                                     const void* lse, const void* delta, void* dqkv,
                                     void* dbias, int batch, int t_len, int heads,
                                     int head_dim, float scale, float bias_scale,
                                     float sm_scale, int dtype, void* stream) {
  const Args a{qkv, static_cast<const float*>(bias), dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dqkv, static_cast<float*>(dbias),
               batch, t_len, heads, scale, bias_scale, sm_scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(head_dim, dtype, a);
}

extern "C" int bias_attention_bwd_dkv(const void* qkv, const void* bias, const void* dout,
                                      const void* lse, const void* delta, void* dqkv,
                                      int batch, int t_len, int heads, int head_dim,
                                      float scale, float bias_scale, float sm_scale,
                                      int dtype, void* stream) {
  const Args a{qkv, static_cast<const float*>(bias), dout, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dqkv, nullptr, batch, t_len, heads, scale,
               bias_scale, sm_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(head_dim, dtype, a);
}

extern "C" const char* bias_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
