// Bias-attention forward for Hopper (sm_90a), CUDA C++ with plain C entries.
//
// Computes, per batch row b and head h,
//     out[b, :, h] = softmax2(q k^T * scale + bias[h]) v
// where softmax2 is a base-2 softmax (exp2), ``scale`` already carries
// log2(e) and ``bias`` is (H, T, T) in the log2 domain, shared over the batch.
//
// ``bias_attention_fwd`` (serving, bf16 log2 bias) replaces the three Pallas
// serving kernels of detail_tts_tpu/ops/pallas/attention.py:
// ``attention_packed_pairs`` (_attn_paired_kernel), ``attention_packed``
// (_attn_packed_kernel) and ``row_block_attention`` (_attn_kernel).
// ``bias_attention_train_fwd`` computes the same with an fp32
// natural-domain bias (scaled to log2 at use) and also writes the row
// statistic lse = m + log2(l) (B, H, T); it replaces ``_attn_train_fwd``
// (_attn_fwd_train_kernel), whose no-max softmax saved the row sum l.
// The Pallas kernels are one function in three
// lane layouts made for the TPU's 128-lane tiles; here q, k and v are read
// straight from the (B, T, 3C) qkv projection, channel order
// [head][q|k|v][ch], with no padding or transpose outside the kernel.
//
// What bounds the serving kernel on the H100, at the diffusion trunk's
// shape (2B = 16, T = 1600, H = 16, d = 48): ~1.26e11 tensor-core FLOP
// (0.13 ms at 989 TFLOP/s), ~6.6e8 exp2 (0.157 ms at 16 a clock on each of
// 132 SMs at 1.98 GHz: the largest) and ~0.24 GB of compulsory traffic
// (qkv + bias + out, 0.07 ms at 3.35 TB/s).  So every logit stays on chip
// and is exponentiated once: the (B, H, T, T) logits never reach memory.
// In practice the bytes the SMs pull from L2 bound it, since each CTA reads
// its (b, h)'s whole K and V and its query rows of the bias for every key:
// * 64 query rows a CTA in 16-row warps (the design this replaced, with a
//   bf16 bias): 6400 CTAs pulled 1.97 GB of
//   K/V and 1.31 GB of bias (B times the 82 MB tensor) from L2; each warp
//   read the whole K/V tile from shared memory for 16 rows (48 KB of
//   ldmatrix a 64-key tile for 64 rows); the bias came from global memory
//   in synchronous 4-byte loads in the accumulator layout, outside the
//   cp.async ring.  0.96-1.02 ms, and
//   0.75-0.76 ms with those bias loads dropped (PERF.md, H100 80GB HBM3 at
//   700 W), against SDPA's 0.89-0.94 ms.
// * ``serve_fwd_mma`` below: 128 query rows a CTA in 32-row warps (d <= 64),
//   3200 CTAs.  K/V from L2 halves to 0.98 GB; the bias stays 1.31 GB.  Each
//   K or V fragment that ldmatrix loads feeds the warp's two m16 row tiles,
//   so a 64-key tile costs the same 48 KB of ldmatrix reads for 128 rows.
//   The bias tile [128 queries x 64 keys] rides in the same cp.async commit
//   group as its K and V tiles, in 16-byte copies (8-byte when T % 4 == 0,
//   single values for other T), with keys past T set to -inf so the softmax
//   needs no mask; an x4 ldmatrix hands each thread its accumulator-layout
//   pairs of two 8-key blocks (the row stride of 72 bf16, 144 B, keeps the
//   8 rows of each 8 x 8 block on distinct banks).  Three key tiles are in
//   flight (two above d = 64), behind one barrier a tile.  With its copies
//   alone the kernel takes ~0.52 ms (~4.6 TB/s from L2), with its arithmetic
//   alone ~0.50 ms; together ~0.7 ms, 255 registers a thread and no spills,
//   two CTAs (8 warps) an SM.  Q stays in its own shared tile after the
//   ring and its fragments are read for each key tile.  Above d = 64 the
//   registers of a 32-row warp do not fit (at d = 128 the output accumulator
//   alone takes 128), so a warp takes 16 rows and a CTA 64.  It takes the
//   bf16 calls that serve_fwd_wgmma does not: T % 8 != 0 (the latent
//   conditioner at code buckets 100, 300 and 500) and d = 80, 112, 128.
// * ``serve_fwd_wgmma`` below (bf16, d <= 64 or d = 96, T % 8 == 0: the
//   trunk, the integrator, the latent conditioner at code buckets that are
//   multiples of 8, and the contextual embedder at every prompt bucket,
//   d = 96): the same 128 query rows a CTA, K, V, Q and the bias tile copied
//   by TMA from one producer warp through an mbarrier ring, both products on
//   wgmma from two consumer warpgroups (one, 64 rows a CTA, at d = 96), no
//   spills, two CTAs an SM; 31% faster than serve_fwd_mma at the trunk's
//   shape in turns
//   (ab_serving_kernel.py, PERF.md).  Clusters of 2 or 4 batch rows that
//   multicast each bias tile (1/2 and 1/4 of the bias bytes from L2) ran
//   slower and were removed: the kernel is bound by latency (each
//   warpgroup's Q K^T, softmax and P V in turn) and the exp2 work, not by L2.
//
// What bounds the training forward (kernel 4), at the training step's
// largest call (B = 8, T = 496, H = 16, d = 48): bytes.  It must read q, k,
// v and the 15.7 MB fp32 bias and write out and lse, 40.4 MB (0.012 ms at
// 3.35 TB/s), beside 6.0e9 tensor FLOP (0.006 ms) and 3.1e7 exp2 (0.008
// ms).  In practice, as in the serving kernel, the bytes that the SMs pull
// from L2 and the arithmetic at 8 warps an SM bound it: each CTA reads its
// query rows of the bias for every key, so the tensor crosses L2 -> SM B
// times (126 MB at that shape), and its (b, h)'s whole K and V.
// ``train_fwd_mma`` below is the serving kernel's skeleton with an fp32
// bias: up to d = 64, 128 query rows a CTA in four 32-row warps (512 CTAs at
// that shape, 49 MB of K/V from L2) wherever that grid fills every SM, two
// key tiles in flight, 108,544 B of shared memory at d = 48, two CTAs an
// SM; elsewhere (the step's T = 124 calls, whose 128-row grid would leave
// SMs idle, and d > 64, where two m16 tiles' registers do not fit) 64 rows
// in 16-row warps.
// The fp32 bias tile [BQ x 64] rides in its K and V tiles' cp.async commit
// group (16-byte copies when T % 4 == 0, 8-byte when T % 2 == 0, else
// 4-byte), keys past T stored as -inf.  It is unpadded (the backward's
// 72-float rows would make two stages and Q 117 KB, past two CTAs an SM),
// its 16-byte chunks XOR-swizzled by row so that the float2 pairs each
// thread reads at the point of use hit distinct banks.  One barrier a key
// tile.  It takes the bf16 calls that train_fwd_wgmma does not: T % 4 != 0
// (the 500-frame crop's 125, 706 codes), d = 80, 112, 128, and at d <= 64
// grids of 128-row CTAs under half the SMs (a data-parallel rank's small
// micro-batch).
// ``train_fwd_wgmma`` below (bf16, d <= 64 or d = 96, T % 4 == 0: at a
// step's micro-batch of 8 the trunk, the integrator, the latent conditioner
// at code lengths that are multiples of 4, the contextual embedder at a
// 496-frame prompt) is serve_fwd_wgmma's design with the fp32 bias: one
// producer warp copies Q once and each key tile's K, V and fp32 bias tile
// by TMA through an mbarrier ring (no thread spends an instruction on a
// copy, and no __syncthreads a tile), both products on wgmma from
// consumer warpgroups of 64 rows.
//
// Both bf16 kernels follow FlashAttention-2 on mma.sync (m16n8k16, fp32
// accumulate): S, P and the output accumulator stay in registers, P goes
// from the S accumulator straight into the A operand of P.V, and the grid
// puts the batch index fastest, so the CTAs that read one head's bias tile
// run together and share it through L2 (the bias is the largest input and
// is the same for every batch row).  float32 (a test route of both entries)
// takes a plain scalar kernel through shared memory.
//
// All: online-max softmax in fp32 with exp2 (ex2.approx; the bf16 kernels
// flush results below 2^-126 to 0, the scalar kernel's exp2f does not);
// P is rounded to the input type before P.V, as the Pallas kernel does.  The
// running max is floored at FLOOR (log2 domain), so a row whose every bias
// is <= -1e9 sums to 0 and is written as 0, as the Pallas kernels' no-max
// softmax gives; ordinary rows are unchanged.  Such a row's lse is
// MASKED_LSE, so the backward's exp2(z - lse) gives it exactly zero
// gradients.  Ragged T is masked in the kernel: keys past T get -inf and
// zero K/V rows, query rows past T are computed on zeros and not written.
#include <stdio.h>

#include "hopper.cuh"
#include "mma.cuh"

namespace {

using namespace attn;

constexpr int BQ = TILE;  // query rows per CTA of the scalar kernel
constexpr int BK = TILE;  // keys per tile

// ------------------------------------------------- bf16 serving: mma.sync

// Tiling of the serving kernel, a compile-time function of D.  Up to d = 64
// a warp owns two m16 row tiles (32 rows), so every K and V fragment feeds
// two products; above, two tiles' registers do not fit and it owns one.
template <int D>
struct Serve {
  static constexpr int MT = D <= 64 ? 2 : 1;  // m16 row tiles a warp
  static constexpr int RW = 16 * MT;          // query rows a warp
  static constexpr int BQ = 4 * RW;           // query rows a CTA
  static constexpr int LDT = D + 8;           // Q, K, V row: ldmatrix rows hit distinct banks
  static constexpr int LDB = BK + 8;          // bias row (144 B): ldmatrix rows hit distinct banks
  static constexpr int KV = BK * LDT;         // one K or V tile
  static constexpr int STAGE = 2 * KV + BQ * LDB;  // K, V and bias of one key tile
  static constexpr int STAGES = D <= 64 ? 3 : 2;  // key tiles in flight, as two CTAs an SM allow
  static constexpr size_t bytes = sizeof(bf16) * (STAGES * STAGE + BQ * LDT);  // ring, Q
  static constexpr int kMinBlocks = 2;        // CTAs an SM the registers must allow
};

constexpr uint32_t NEG_INF_BF16X2 = 0xff80ff80u;  // two bf16 -inf

// The bias block [r0, r0 + ROWS) x [c0, c0 + 64) of a bf16 (T, T) matrix
// into a shared tile of row stride LDB, W values a cp.async (8 when
// T % 8 == 0, 4 when T % 4 == 0).  Keys past T read -inf, so the softmax
// needs no mask of its own (their K and V rows are 0); rows past T read 0.
template <int ROWS, int LDB, int W>
__device__ __forceinline__ void copy_bias_vec(bf16* dst, const bf16* src, int r0, int c0,
                                              int t_len) {
  constexpr int CPR = BK / W;            // copies a row
  constexpr int STEP = NTHREADS / CPR;   // rows between one thread's copies
  static_assert(ROWS % STEP == 0, "every thread makes the same number of copies");
  const int c = (threadIdx.x % CPR) * W;  // the same columns in every row
  const int rt = threadIdx.x / CPR;
  const bool key_ok = c0 + c < t_len;
#pragma unroll
  for (int k = 0; k < ROWS / STEP; ++k) {
    const int r = rt + k * STEP;
    bf16* d = dst + r * LDB + c;
    if (!key_ok) {
      if (W == 8) {
        *reinterpret_cast<uint4*>(d) =
            make_uint4(NEG_INF_BF16X2, NEG_INF_BF16X2, NEG_INF_BF16X2, NEG_INF_BF16X2);
      } else {
        *reinterpret_cast<uint2*>(d) = make_uint2(NEG_INF_BF16X2, NEG_INF_BF16X2);
      }
      continue;
    }
    const bool valid = r0 + r < t_len;
    const bf16* s = src + (valid ? (long)(r0 + r) * t_len + c0 + c : 0);
    if (W == 8) {
      cp_async_16(d, s, valid);
    } else {
      cp_async_8(d, s, valid);
    }
  }
}

// As copy_bias_vec for any T, with plain loads and stores of single values
// (only test lengths, T % 4 != 0, take it).
template <int ROWS, int LDB>
__device__ __forceinline__ void copy_bias_plain(bf16* dst, const bf16* src, int r0, int c0,
                                                int t_len) {
  for (int i = threadIdx.x; i < ROWS * BK; i += NTHREADS) {
    const int r = i / BK, c = i % BK;
    bf16 v = __float2bfloat16(-INFINITY);
    if (c0 + c < t_len) {
      v = r0 + r < t_len ? src[(long)(r0 + r) * t_len + c0 + c] : __float2bfloat16(0.f);
    }
    dst[r * LDB + c] = v;
  }
}

// ``width``: bf16 values a bias copy moves, 8, 4 or 1, fixed for a launch
// by T's alignment.
template <int D>
__global__ void __launch_bounds__(NTHREADS, Serve<D>::kMinBlocks)
serve_fwd_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
              bf16* __restrict__ out, int t_len, int heads, float scale, int width) {
  using L = Serve<D>;
  constexpr int MT = L::MT, LDT = L::LDT, LDB = L::LDB;
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int NO = D / 8;   // 8-wide column blocks of the output
  constexpr int NS = BK / 8;  // 8-wide key blocks of a tile
  const int b = blockIdx.x;   // batch fastest: the CTAs sharing a bias tile run together
  const int q0 = blockIdx.y * L::BQ;
  const int h = blockIdx.z;
  const int C = heads * D;
  const long row_stride = 3L * C;
  const bf16* base = qkv + (long)b * t_len * row_stride + (long)h * 3 * D;
  const bf16* bias_h = bias + (long)h * t_len * t_len;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);  // STAGES stages of [K | V | bias], then Q

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // this thread's rows: g and g + 8 of each m16 tile
  const int t4 = lane % 4;  // and columns 2 * t4, 2 * t4 + 1 of each 8-block
  const int row0 = warp * L::RW;  // the warp's first row in the CTA's block
  const int n_tiles = (t_len + BK - 1) / BK;

  // Each thread copies the same KVN 16-byte chunks of every K and V tile:
  // their rows and offsets in the global and the shared tile are worked out
  // once (worked out anew for each tile, they made the kernel spill).
  constexpr int VPR = D / 8;                   // 16-byte chunks of a K or V row
  constexpr int KVN = BK * VPR / NTHREADS;
  int kv_row[KVN], kv_src[KVN], kv_dst[KVN];
#pragma unroll
  for (int k = 0; k < KVN; ++k) {
    const int i = threadIdx.x + k * NTHREADS;
    kv_row[k] = i / VPR;
    kv_src[k] = kv_row[k] * 3 * C + (i % VPR) * 8;
    kv_dst[k] = kv_row[k] * LDT + (i % VPR) * 8;
  }

  // K, V and the bias block of key tile j into stage s; K and V rows past T
  // are 0
  auto fetch = [&](int j, int s) {
    bf16* st = ring + s * L::STAGE;
    const bf16* kt = base + D + (long)j * BK * row_stride;
#pragma unroll
    for (int k = 0; k < KVN; ++k) {
      const bool valid = j * BK + kv_row[k] < t_len;
      cp_async_16(st + kv_dst[k], valid ? kt + kv_src[k] : base, valid);
      cp_async_16(st + L::KV + kv_dst[k], valid ? kt + D + kv_src[k] : base, valid);
    }
    bf16* bt = st + 2 * L::KV;
    if (width == 8) {
      copy_bias_vec<L::BQ, LDB, 8>(bt, bias_h, q0, j * BK, t_len);
    } else if (width == 4) {
      copy_bias_vec<L::BQ, LDB, 4>(bt, bias_h, q0, j * BK, t_len);
    } else {
      copy_bias_plain<L::BQ, LDB>(bt, bias_h, q0, j * BK, t_len);
    }
  };

  // Q stays in shared memory after the ring and joins tile 0's commit
  // group; its fragments are read anew for every key tile, since holding
  // them (24 registers a thread at d = 48) made the kernel spill
  bf16* q_tile = ring + L::STAGES * L::STAGE;
  copy_tile<D, L::BQ>(q_tile, base, q0, t_len, row_stride);
#pragma unroll
  for (int j = 0; j < L::STAGES - 1; ++j) {
    if (j < n_tiles) fetch(j, j);
    cp_async_commit();
  }
  cp_async_wait<L::STAGES - 2>();
  __syncthreads();

  float o[MT][NO][4];
  float m[MT][2], l[MT][2];  // running max and this thread's share of the sum, rows g, g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = FLOOR;
    l[mt][0] = l[mt][1] = 0.f;
  }
  // this lane's row of an x4 ldmatrix of the bias: its four 8 x 8 blocks are
  // rows 0-7 and 8-15 of an m16 tile at keys 0-7, then at keys 8-15, so a
  // thread receives its accumulator-layout pairs of two 8-key blocks
  const int bias_lane = 2 * L::KV + (row0 + (lane / 8) % 2 * 8 + lane % 8) * LDB + lane / 16 * 8;

  for (int j = 0; j < n_tiles; ++j) {
    if (j > 0) cp_async_wait<L::STAGES - 2>();  // this thread's copies of tile j
    // every thread's copies of tile j are visible, and every warp is done
    // with tile j - 1, whose stage takes tile j + STAGES - 1
    __syncthreads();
    if (j + L::STAGES - 1 < n_tiles) fetch(j + L::STAGES - 1, (j + L::STAGES - 1) % L::STAGES);
    cp_async_commit();  // one group an iteration, empty or not, keeps the wait's count
    const bf16* Kt = ring + (j % L::STAGES) * L::STAGE;
    const bf16* Vt = Kt + L::KV;
    const bf16* Bl = Kt + bias_lane;

    uint32_t qa[MT][KS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        load_a<LDT>(qa[mt][kk], q_tile, row0 + mt * 16, kk, lane);
      }
    }
    // S = Q K^T for the warp's rows and the tile's 64 keys
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int n = 0; n < NS; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t kb[4];
        load_b_nt<LDT>(kb, Kt, n2, kk, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * n2], qa[mt][kk], kb[0], kb[1]);
          mma_bf16(s[mt][2 * n2 + 1], qa[mt][kk], kb[2], kb[3]);
        }
      }
    }

    // log2-domain logits (keys past T have a -inf bias); online softmax in fp32
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t bb[4];  // rows g, g + 8 of key block 2 n2, then of block 2 n2 + 1
        ldmatrix_x4(bb, Bl + mt * 16 * LDB + n2 * 16);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* x = s[mt][2 * n2 + e];
          const float2 b0 = bf16x2_to_float2(bb[2 * e]);
          const float2 b1 = bf16x2_to_float2(bb[2 * e + 1]);
          x[0] = fmaf(x[0], scale, b0.x);
          x[1] = fmaf(x[1], scale, b0.y);
          x[2] = fmaf(x[2], scale, b1.x);
          x[3] = fmaf(x[3], scale, b1.y);
          mx0 = fmaxf(mx0, fmaxf(x[0], x[1]));
          mx1 = fmaxf(mx1, fmaxf(x[2], x[3]));
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m[mt][0], mx0), mn1 = fmaxf(m[mt][1], mx1);
      const float a0 = exp2_ftz(m[mt][0] - mn0), a1 = exp2_ftz(m[mt][1] - mn1);
      m[mt][0] = mn0;
      m[mt][1] = mn1;
      l[mt][0] *= a0;
      l[mt][1] *= a1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[mt][n][0] *= a0;
        o[mt][n][1] *= a0;
        o[mt][n][2] *= a1;
        o[mt][n][3] *= a1;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[mt][n][0] = exp2_ftz(s[mt][n][0] - mn0);
        s[mt][n][1] = exp2_ftz(s[mt][n][1] - mn0);
        s[mt][n][2] = exp2_ftz(s[mt][n][2] - mn1);
        s[mt][n][3] = exp2_ftz(s[mt][n][3] - mn1);
        l[mt][0] += s[mt][n][0] + s[mt][n][1];
        l[mt][1] += s[mt][n][2] + s[mt][n][3];
      }
    }

    // O += P V, P rounded to bf16 (key blocks 2k and 2k + 1 of S are k-step
    // k of the product); each V fragment feeds the warp's row tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) pack_a(pa[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t vb[4];
        load_b_nn<LDT>(vb, Vt, n2, kk, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * n2], pa[mt], vb[0], vb[1]);
          mma_bf16(o[mt][2 * n2 + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }

  // out = O / l, or 0 where the row sum is 0 (a fully masked row)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const int qr0 = q0 + row0 + mt * 16 + g, qr1 = qr0 + 8;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = h * D + n * 8 + 2 * t4;
      if (qr0 < t_len) {
        *reinterpret_cast<uint32_t*>(out + ((long)b * t_len + qr0) * C + col) =
            pack_bf16(o[mt][n][0] * inv0, o[mt][n][1] * inv0);
      }
      if (qr1 < t_len) {
        *reinterpret_cast<uint32_t*>(out + ((long)b * t_len + qr1) * C + col) =
            pack_bf16(o[mt][n][2] * inv1, o[mt][n][3] * inv1);
      }
    }
  }
}

// ------------------------------------------------- bf16 serving: wgmma

// serve_fwd_wgmma takes bf16 at d <= 64 or d = 96 and T % 8 == 0 (a bias
// row of T * 2 bytes is then a legal TMA stride); serve_fwd_mma takes the
// other bf16 calls.  Up to d = 64 a CTA holds 128 query rows of one (b, h)
// in two consumer warpgroups of 64 rows and one producer warp: 288
// threads, two CTAs an SM, which caps a thread at 96 registers (95 used, no
// spills at d = 48).  At d = 96 (the contextual embedder) a CTA is one
// consumer warpgroup of 64 rows and the producer warp, two CTAs an SM: its
// grids are small (64 CTAs at (2, 128, 16, 96)), and with two warpgroups a
// CTA (one CTA an SM, as O's 48 registers, S's 32 and P's 16 leave too
// little of two CTAs' 112) half as many CTAs shared SMs while others idled:
// in turns on the H100 that tiling ran 1-43% slower at every shape
// measured, most at 1 and 2 rows of T = 128 (PERF.md §6).
// Shared memory, from a 1024-byte aligned base: STAGES stages of [bias tile
// | K | V], then Q, then the barriers.  K, V and Q are tiles of 64-row TMA
// boxes (hopper::Boxes<D>: 16 channels in 32-byte rows with the 32-byte
// swizzle up to d = 64, 32 channels in 64-byte rows with the 64-byte swizzle
// at d = 96, half the TMA requests): a K-major k-step of Q K^T is a box, or
// half a 64-byte box row; a 16-row k-step of V in P V spans the boxes, one
// atom each.  Q is one such tile a warpgroup.  The bias tile is [128
// queries x 64 keys] in 128-byte rows with the 128-byte swizzle, so the x4
// ldmatrix that hands a thread its accumulator-layout pairs hits distinct
// banks.  Keys past T read 0 from TMA and are set to -inf in the logits;
// query rows past T read 0 and are not written.
//
// A consumer warpgroup runs tile j's Q K^T, softmax and P V in turn, each
// product waited for before the next step, so no product is in flight while
// another's registers are live (with tile j - 1's P V still running under
// tile j's Q K^T, ptxas serialised every wgmma for want of registers, and
// the kernel was slower); the softmax of one warpgroup overlaps the
// products of the others on its SM.  Designs tried on the H100 at d = 48
// and dropped, each slower than this one in turns: the softmax of tile j
// overlapping P V within a warpgroup (a second S or P in registers, which
// at 96 spills or serialises the wgmmas); a
// whole producer warpgroup, so that setmaxnreg can move registers to the
// consumers (the launch cap falls to 80 a thread and the consumers spill;
// setmaxnreg on a lone producer warp never returns, as it is a warpgroup's
// instruction); one CTA an SM with 240-register consumers (half the warps
// to hide each other's latency); clusters of 2 or 4 consecutive batch rows,
// each CTA multicasting its share of the common bias tile (the pairs'
// lockstep cost more than the L2 bytes saved).
// Dynamic shared memory of a CTA with ``stages`` stages of ``stage`` bytes
// and ``q`` bytes of Q: the tiles from a 1024-byte aligned base, then the
// barriers.
constexpr size_t ring_bytes(int stage, int q, int stages) {
  return 1024 + (size_t)stages * stage + q + (2 * stages + 1) * sizeof(uint64_t);
}
// Whether ``blocks`` CTAs of ``bytes`` fit on an SM (228 KB, 1 KB reserved
// a CTA, at most 227 KB a CTA).
constexpr bool fits_sm(size_t bytes, int blocks) {
  return bytes <= 227 * 1024 && blocks * (bytes + 1024) <= 228 * 1024;
}

template <int D>
struct Wg {
  using Box = hopper::Boxes<D>;
  // consumer warpgroups of 64 query rows: one at d = 96 (see above)
  static constexpr int WG = D == 96 ? 1 : 2;
  static constexpr int kConsumerWarps = 4 * WG;
  static constexpr int kThreads = 32 * kConsumerWarps + 32;  // and the producer warp
  static constexpr int BQ = 64 * WG;                  // query rows a CTA
  static constexpr int KS = D / 16;                   // 16-channel k-steps of a row
  static constexpr int KV = Box::TILE_BYTES;          // a K or V tile
  static constexpr int BIAS = BQ * BK * 2;            // the bias tile
  static constexpr int STAGE = BIAS + 2 * KV;         // bytes that fill a stage
  static constexpr int QB = WG * KV;                  // Q: a tile a warpgroup
  static constexpr int kBlocks = 2;                   // CTAs an SM
  // stages: three where two CTAs of them fit on an SM, else two
  static constexpr int STAGES = fits_sm(ring_bytes(STAGE, QB, 3), kBlocks) ? 3 : 2;
  static constexpr size_t bytes = ring_bytes(STAGE, QB, STAGES);
  static_assert(STAGE % 1024 == 0 && QB % 1024 == 0, "1024-byte aligned tiles");
  static_assert(fits_sm(bytes, kBlocks), "the CTAs an SM fit its shared memory");
};

template <int D>
__global__ void __launch_bounds__(Wg<D>::kThreads, Wg<D>::kBlocks)
serve_fwd_wgmma(const __grid_constant__ CUtensorMap qkv_map,
                const __grid_constant__ CUtensorMap bias_map, bf16* __restrict__ out,
                int t_len, int heads, float scale) {
  using namespace hopper;
  using L = Wg<D>;
  using Box = typename L::Box;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_smem = smem + L::STAGES * L::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(q_smem + L::QB);  // a stage's bytes landed
  uint64_t* empty = full + L::STAGES;                             // every consumer is done with it
  uint64_t* q_full = empty + L::STAGES;

  const int b = blockIdx.x;  // batch fastest: the CTAs sharing a bias tile run together
  const int q0 = blockIdx.y * L::BQ;
  const int h = blockIdx.z;
  const int n_tiles = (t_len + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::kConsumerWarps);
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == L::kConsumerWarps) {
    // ---------------------------------------------------------- producer
    if (lane == 0) {
      tma_prefetch(&qkv_map);
      tma_prefetch(&bias_map);
      const int col = h * 3 * D;  // channel of this head's q in a qkv row
      mbar_expect_tx(q_full, L::QB);
#pragma unroll
      for (int w = 0; w < L::WG; ++w) {
#pragma unroll
        for (int c = 0; c < Box::NBOX; ++c) {
          tma_load_3d(q_smem + w * L::KV + c * Box::BOX, &qkv_map, q_full,
                      col + Box::BOX_CH * c, q0 + 64 * w, b);
        }
      }
      const int bias_row = h * t_len + q0;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % L::STAGES;
        if (j >= L::STAGES) mbar_wait(&empty[s], (j / L::STAGES - 1) & 1);
        unsigned char* st = smem + s * L::STAGE;
        mbar_expect_tx(&full[s], L::STAGE);
#pragma unroll
        for (int c = 0; c < Box::NBOX; ++c) {
          tma_load_3d(st + L::BIAS + c * Box::BOX, &qkv_map, &full[s],
                      col + D + Box::BOX_CH * c, j * BK, b);
          tma_load_3d(st + L::BIAS + L::KV + c * Box::BOX, &qkv_map, &full[s],
                      col + 2 * D + Box::BOX_CH * c, j * BK, b);
        }
        tma_load_2d(st, &bias_map, &full[s], j * BK, bias_row);
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  const int wg = warp / 4;  // rows 64 wg .. 64 wg + 63 of the CTA's block
  const int g = lane / 4;   // this thread's rows: g and g + 8 of its warp's 16
  const int t4 = lane % 4;  // and columns 2 t4, 2 t4 + 1 of each 8-block
  const int row0 = wg * 64 + (warp % 4) * 16;
  // this lane's row of an x4 ldmatrix of the bias (rows 0-7, 8-15 of the
  // warp at a 16-key block's first 8 keys, then at its second 8) and the
  // 128-byte swizzle of that row
  const uint32_t bias_lane = (row0 + (lane / 8) % 2 * 8 + lane % 8) * (BK * 2);
  const int bias_half = lane / 16;
  const int bias_swz = lane % 8;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = FLOOR, m1 = FLOOR;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;      // and this thread's share of their sums
  float s[32];                   // S of a 64 x 64 tile: key block n in s[4n .. 4n + 3]
  uint32_t p[BK / 16][4];        // P as bf16 A fragments, one a 16-key k-step
  uint64_t qd[L::KS];            // Q's descriptors: this warpgroup's rows, k-step c
#pragma unroll
  for (int c = 0; c < L::KS; ++c) qd[c] = Box::k_desc(smem_addr(q_smem + wg * L::KV), c);

  // log2-domain logits of key tile j, the online softmax in fp32 (O
  // rescaled), and P rounded to bf16
  auto softmax = [&](const unsigned char* st, int j) {
    const uint32_t bt = smem_addr(st) + bias_lane;
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t bb[4];  // rows g, g + 8 of key block 2 jp, then of block 2 jp + 1
      ldmatrix_x4_at(bb, bt + (((2 * jp + bias_half) ^ bias_swz) << 4));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* x = s + 4 * (2 * jp + e);
        const float2 b0 = bf16x2_to_float2(bb[2 * e]);
        const float2 b1 = bf16x2_to_float2(bb[2 * e + 1]);
        x[0] = fmaf(x[0], scale, b0.x);
        x[1] = fmaf(x[1], scale, b0.y);
        x[2] = fmaf(x[2], scale, b1.x);
        x[3] = fmaf(x[3], scale, b1.y);
      }
    }
    if (j == n_tiles - 1 && t_len % BK != 0) {  // keys past T: TMA read 0, make them -inf
      const int keys = t_len - j * BK;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n * 8 + 2 * t4 + e >= keys) s[4 * n + e] = s[4 * n + 2 + e] = -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2_ftz(m0 - mn0), a1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[4 * n] = exp2_ftz(s[4 * n] - mn0);
      s[4 * n + 1] = exp2_ftz(s[4 * n + 1] - mn0);
      s[4 * n + 2] = exp2_ftz(s[4 * n + 2] - mn1);
      s[4 * n + 3] = exp2_ftz(s[4 * n + 3] - mn1);
      r0 += s[4 * n] + s[4 * n + 1];
      r1 += s[4 * n + 2] + s[4 * n + 3];
    }
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i % 4 < 2 ? a0 : a1);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // key blocks 2 kk, 2 kk + 1: k-step kk
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto release = [&](int stage) {  // every read of the stage is done
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  };

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int sj = j % L::STAGES;
    const unsigned char* st = smem + sj * L::STAGE;
    // K's and V's descriptors in this stage, made before the products so
    // that no other instruction writes a wgmma's input between them
    uint64_t kd[L::KS], vd[BK / 16];
#pragma unroll
    for (int c = 0; c < L::KS; ++c) kd[c] = Box::k_desc(smem_addr(st + L::BIAS), c);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) vd[kk] = Box::mn_desc(smem_addr(st + L::BIAS + L::KV), kk);
    fence_regs(kd);
    fence_regs(vd);
    mbar_wait(&full[sj], (j / L::STAGES) & 1);
    __syncwarp();
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < L::KS; ++c) wgmma_m64n64k16_ss(s, qd[c], kd[c], c);  // S = Q K^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(o);
    softmax(st, j);
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(p[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(o, p[kk], vd[kk]);  // O += P V
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    release(sj);
  }

  // out = O / l, or 0 where the row sum is 0 (a fully masked row)
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int qr0 = q0 + row0 + g, qr1 = qr0 + 8;
  const int C = heads * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = h * D + n * 8 + 2 * t4;
    if (qr0 < t_len) {
      *reinterpret_cast<uint32_t*>(out + ((long)b * t_len + qr0) * C + col) =
          pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    }
    if (qr1 < t_len) {
      *reinterpret_cast<uint32_t*>(out + ((long)b * t_len + qr1) * C + col) =
          pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
}

// ------------------------------------------------ bf16 training: mma.sync

// Tiling of the training forward (kernel 4), a compile-time function of D
// and of the m16 row tiles a warp takes (MT): 2 (128 query rows a CTA, each
// K or V fragment feeding two products) where the grid still fills the
// card, else 1 (64 rows).  A stage holds the K and V tiles (bf16, row
// stride D + 8) and the fp32 bias tile [BQ x 64], unpadded, its 16-byte
// chunks swizzled by row (bias_at).  Q stays in its own tile after the ring.
template <int D, int MT>
struct TrainFwd {
  static constexpr int RW = 16 * MT;                  // query rows a warp
  static constexpr int BQ = 4 * RW;                   // query rows a CTA
  static constexpr int LDT = D + 8;                   // Q, K, V row: ldmatrix rows hit distinct banks
  static constexpr int KV = BK * LDT;                 // bf16 of one K or V tile
  static constexpr int KV_BYTES = 2 * KV * (int)sizeof(bf16);
  static constexpr int STAGE = KV_BYTES + BQ * BK * (int)sizeof(float);  // K, V, bias
  static constexpr int Q_BYTES = BQ * LDT * (int)sizeof(bf16);
  static constexpr int kMinBlocks = 2;                // CTAs an SM the registers must allow
  // key tiles in flight: three where they fit beside a second CTA on the SM
  // (228 KB of shared memory, 1 KB of it reserved a CTA), else two
  static constexpr int STAGES = 3 * STAGE + Q_BYTES <= 228 * 1024 / kMinBlocks - 1024 ? 3 : 2;
  static constexpr size_t bytes = (size_t)STAGES * STAGE + Q_BYTES;  // ring, Q
};

// Float offset of (row, col) in an unpadded fp32 [rows x 64] tile whose
// 16-byte chunks are XOR-swizzled by row: chunk c of row r lives at
// c ^ 2 (r & 3), so the float2 reads of a half-warp in the accumulator
// layout (rows g = 0-3 at the same 8 columns) hit 16 distinct bank pairs.
__device__ __forceinline__ int bias_at(int row, int col) {
  return row * BK + (((col >> 2) ^ ((row & 3) << 1)) << 2) + (col & 3);
}

// The fp32 bias block [r0, r0 + ROWS) x [c0, c0 + 64) of a (T, T) matrix
// into a swizzled shared tile, W floats a cp.async (4 when T % 4 == 0, 2
// when T % 2 == 0, else 1), so a copy never crosses the key edge.  Keys
// past T read -inf, so the softmax needs no mask of its own (their K and V
// rows are 0); rows past T read 0.
template <int ROWS, int W>
__device__ __forceinline__ void copy_bias_f32(float* dst, const float* src, int r0, int c0,
                                              int t_len) {
  constexpr int CPR = BK / W;            // copies a row
  constexpr int STEP = NTHREADS / CPR;   // rows between one thread's copies
  static_assert(ROWS % STEP == 0, "every thread makes the same number of copies");
  const int c = (threadIdx.x % CPR) * W;  // the same columns in every row
  const int rt = threadIdx.x / CPR;
  const bool key_ok = c0 + c < t_len;
  const int s = (r0 + rt) * t_len + c0 + c;  // within one head's (T, T) matrix
  // not unrolled, 32-bit offsets: hoisted out of the key loop, the copies'
  // 64-bit addresses made the 128-row tiling spill
#pragma unroll 1
  for (int k = 0; k < ROWS / STEP; ++k) {
    const int r = rt + k * STEP;
    float* d = dst + bias_at(r, c);
    if (!key_ok) {
      if (W == 4) {
        *reinterpret_cast<float4*>(d) = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      } else if (W == 2) {
        *reinterpret_cast<float2*>(d) = make_float2(-INFINITY, -INFINITY);
      } else {
        *d = -INFINITY;
      }
      continue;
    }
    const bool valid = r0 + r < t_len;
    const float* p = src + (valid ? s + k * STEP * t_len : 0);
    if (W == 4) {
      cp_async_16(d, p, valid);
    } else if (W == 2) {
      cp_async_8(d, p, valid);
    } else {
      cp_async_4(d, p, valid);
    }
  }
}

// out = softmax2(q k^T scale + bias bias_scale) v with an fp32
// natural-domain bias (bias_scale = log2(e)), and the row statistic
// lse = m + log2(l) (B, H, T) that the backward recomputes P from.
// ``width``: floats a bias copy moves, 4, 2 or 1, fixed for a launch by T's
// alignment.
template <int D, int MT>
__global__ void __launch_bounds__(NTHREADS, TrainFwd<D, MT>::kMinBlocks)
train_fwd_mma(const bf16* __restrict__ qkv, const float* __restrict__ bias,
              bf16* __restrict__ out, float* __restrict__ lse, int t_len, int heads,
              float scale, float bias_scale, int width) {
  using L = TrainFwd<D, MT>;
  constexpr int LDT = L::LDT;
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int NO = D / 8;   // 8-wide column blocks of the output
  constexpr int NS = BK / 8;  // 8-wide key blocks of a tile
  const int b = blockIdx.x;   // batch fastest: the CTAs sharing a bias tile run together
  const int q0 = blockIdx.y * L::BQ;
  const int h = blockIdx.z;
  const int C = heads * D;
  const long row_stride = 3L * C;
  const bf16* base = qkv + (long)b * t_len * row_stride + (long)h * 3 * D;
  const float* bias_h = bias + (long)h * t_len * t_len;

  extern __shared__ __align__(128) unsigned char smem[];  // STAGES x [K | V | bias], then Q

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // this thread's rows: g and g + 8 of each m16 tile
  const int t4 = lane % 4;  // and columns 2 * t4, 2 * t4 + 1 of each 8-block
  const int row0 = warp * L::RW;  // the warp's first row in the CTA's block
  const int n_tiles = (t_len + BK - 1) / BK;

  // Each thread copies the same KVN 16-byte chunks of every K and V tile,
  // their offsets worked out once
  constexpr int VPR = D / 8;  // 16-byte chunks of a K or V row
  constexpr int KVN = BK * VPR / NTHREADS;
  int kv_row[KVN], kv_src[KVN], kv_dst[KVN];
#pragma unroll
  for (int k = 0; k < KVN; ++k) {
    const int i = threadIdx.x + k * NTHREADS;
    kv_row[k] = i / VPR;
    kv_src[k] = kv_row[k] * 3 * C + (i % VPR) * 8;
    kv_dst[k] = kv_row[k] * LDT + (i % VPR) * 8;
  }

  // K, V and the bias block of key tile j into stage s, in one commit group;
  // K and V rows past T are 0
  auto fetch = [&](int j, int s) {
    bf16* st = reinterpret_cast<bf16*>(smem + s * L::STAGE);
    const bf16* kt = base + D + (long)j * BK * row_stride;
#pragma unroll
    for (int k = 0; k < KVN; ++k) {
      const bool valid = j * BK + kv_row[k] < t_len;
      cp_async_16(st + kv_dst[k], valid ? kt + kv_src[k] : base, valid);
      cp_async_16(st + L::KV + kv_dst[k], valid ? kt + D + kv_src[k] : base, valid);
    }
    float* bt = reinterpret_cast<float*>(smem + s * L::STAGE + L::KV_BYTES);
    if (width == 4) {
      copy_bias_f32<L::BQ, 4>(bt, bias_h, q0, j * BK, t_len);
    } else if (width == 2) {
      copy_bias_f32<L::BQ, 2>(bt, bias_h, q0, j * BK, t_len);
    } else {
      copy_bias_f32<L::BQ, 1>(bt, bias_h, q0, j * BK, t_len);
    }
  };

  // Q joins tile 0's commit group; its fragments are read anew for every
  // key tile (held in registers, they made the serving kernel spill)
  bf16* q_tile = reinterpret_cast<bf16*>(smem + L::STAGES * L::STAGE);
  copy_tile<D, L::BQ>(q_tile, base, q0, t_len, row_stride);
#pragma unroll
  for (int j = 0; j < L::STAGES - 1; ++j) {
    if (j < n_tiles) fetch(j, j);
    cp_async_commit();
  }

  float o[MT][NO][4];
  float m[MT][2], l[MT][2];  // running max and this thread's share of the sum, rows g, g + 8
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = FLOOR;
    l[mt][0] = l[mt][1] = 0.f;
  }
  // this thread's bias pairs: rows row0 + 16 mt + g (+ 8), key block n at
  // bias_at(row, 8 n + 2 t4) = row * 64 + 8 (n ^ (g & 3)) + 2 t4
  const int bias_lane = (row0 + g) * BK + 2 * t4;
  const int swz = g & 3;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<L::STAGES - 2>();  // this thread's copies of tile j
    // every thread's copies of tile j are visible, and every warp is done
    // with tile j - 1, whose stage takes tile j + STAGES - 1
    __syncthreads();
    if (j + L::STAGES - 1 < n_tiles) fetch(j + L::STAGES - 1, (j + L::STAGES - 1) % L::STAGES);
    cp_async_commit();  // one group an iteration, empty or not, keeps the wait's count
    const unsigned char* st = smem + (j % L::STAGES) * L::STAGE;
    const bf16* Kt = reinterpret_cast<const bf16*>(st);
    const bf16* Vt = Kt + L::KV;
    const float* Bl = reinterpret_cast<const float*>(st + L::KV_BYTES) + bias_lane;

    // S = Q K^T for the warp's rows and the tile's 64 keys, Q's fragments
    // read one k-step at a time
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int n = 0; n < NS; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) load_a<LDT>(qa[mt], q_tile, row0 + mt * 16, kk, lane);
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t kb[4];
        load_b_nt<LDT>(kb, Kt, n2, kk, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * n2], qa[mt], kb[0], kb[1]);
          mma_bf16(s[mt][2 * n2 + 1], qa[mt], kb[2], kb[3]);
        }
      }
    }

    // log2-domain logits, the bias scaled at use (keys past T have a -inf
    // bias); online softmax in fp32
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float* bp = Bl + mt * 16 * BK + 8 * (n ^ swz);
        const float2 b0 = *reinterpret_cast<const float2*>(bp);
        const float2 b1 = *reinterpret_cast<const float2*>(bp + 8 * BK);
        float* x = s[mt][n];
        x[0] = fmaf(x[0], scale, b0.x * bias_scale);
        x[1] = fmaf(x[1], scale, b0.y * bias_scale);
        x[2] = fmaf(x[2], scale, b1.x * bias_scale);
        x[3] = fmaf(x[3], scale, b1.y * bias_scale);
        mx0 = fmaxf(mx0, fmaxf(x[0], x[1]));
        mx1 = fmaxf(mx1, fmaxf(x[2], x[3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m[mt][0], mx0), mn1 = fmaxf(m[mt][1], mx1);
      const float a0 = exp2_ftz(m[mt][0] - mn0), a1 = exp2_ftz(m[mt][1] - mn1);
      m[mt][0] = mn0;
      m[mt][1] = mn1;
      l[mt][0] *= a0;
      l[mt][1] *= a1;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[mt][n][0] *= a0;
        o[mt][n][1] *= a0;
        o[mt][n][2] *= a1;
        o[mt][n][3] *= a1;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[mt][n][0] = exp2_ftz(s[mt][n][0] - mn0);
        s[mt][n][1] = exp2_ftz(s[mt][n][1] - mn0);
        s[mt][n][2] = exp2_ftz(s[mt][n][2] - mn1);
        s[mt][n][3] = exp2_ftz(s[mt][n][3] - mn1);
        l[mt][0] += s[mt][n][0] + s[mt][n][1];
        l[mt][1] += s[mt][n][2] + s[mt][n][3];
      }
    }

    // O += P V, P rounded to bf16 (key blocks 2k and 2k + 1 of S are k-step
    // k of the product); each V fragment feeds the warp's row tiles
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) pack_a(pa[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int n2 = 0; n2 < NO / 2; ++n2) {
        uint32_t vb[4];
        load_b_nn<LDT>(vb, Vt, n2, kk, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][2 * n2], pa[mt], vb[0], vb[1]);
          mma_bf16(o[mt][2 * n2 + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }

  // out = O / l, or 0 where the row sum is 0 (a fully masked row), and lse
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const int qr0 = q0 + row0 + mt * 16 + g, qr1 = qr0 + 8;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = h * D + n * 8 + 2 * t4;
      if (qr0 < t_len) {
        *reinterpret_cast<uint32_t*>(out + ((long)b * t_len + qr0) * C + col) =
            pack_bf16(o[mt][n][0] * inv0, o[mt][n][1] * inv0);
      }
      if (qr1 < t_len) {
        *reinterpret_cast<uint32_t*>(out + ((long)b * t_len + qr1) * C + col) =
            pack_bf16(o[mt][n][2] * inv1, o[mt][n][3] * inv1);
      }
    }
    if (t4 == 0) {
      float* lrow = lse + ((long)b * heads + h) * t_len;
      if (qr0 < t_len) lrow[qr0] = l0 > 0.f ? m[mt][0] + log2f(l0) : MASKED_LSE;
      if (qr1 < t_len) lrow[qr1] = l1 > 0.f ? m[mt][1] + log2f(l1) : MASKED_LSE;
    }
  }
}

// ------------------------------------------------- bf16 training: wgmma

// train_fwd_wgmma takes bf16 at d <= 64 or d = 96 and T % 4 == 0 (an fp32
// bias row of T * 4 bytes is then a legal TMA stride), at d <= 64 where its
// grid fills at least half the SMs (train_route); train_fwd_mma takes the
// other bf16 calls.  A CTA holds WG x 64 query rows of one (b, h) in WG
// consumer warpgroups and one producer warp that keeps TMA copies in flight
// through an mbarrier ring: up to d = 64 serve_fwd_wgmma's 288 threads (two
// warpgroups), two CTAs an SM up to d = 48.  Shared memory, from a 1024-byte
// aligned base: STAGES stages of [bias tile | K | V], then Q, then the
// barriers.  K, V and Q are serve_fwd_wgmma's tiles of 64-row boxes
// (hopper::Boxes<D>; at d = 96 32 channels in 64-byte rows).  The fp32 bias
// tile [BQ queries x 64 keys] is two boxes of 32 keys (128-byte rows,
// 128-byte swizzle) from the backward's (T keys, T queries, H) map, read as
// float2 pairs in the accumulator layout (hopper::swz128): 256 bytes a warp
// in two wavefronts.
// The producer initialises the barriers and issues Q and the first stages
// before the CTA's one __syncthreads, so that a short key loop (two tiles
// at T = 124) starts on copies already in flight.  Keys past T read 0 and
// are set to -inf in the logits; query rows past T read 0 (their logits are
// their zero bias) and are written neither in out nor in lse.
// In turns with train_fwd_mma it is 19% faster at (8, 496, 16, 48) and 28%
// at T = 1024, and ties at T = 124 (PERF.md §6).  Measured
// on the H100 at d = 48 and dropped, each slower in turns: CTAs of one
// warpgroup (64 rows, three an SM; 8-32% slower at every step shape, even
// at T = 124, where 128-row CTAs leave 4 of 132 SMs idle), and clusters of
// two batch rows that multicast each bias box to both CTAs (half the bias
// bytes from L2, 45-56% slower: a stage is refilled only when both CTAs are
// done with it).  At d = 96 (the contextual embedder) two warpgroups' 197
// KB of shared memory fit one CTA an SM, and CTAs of one warpgroup (two an
// SM, two stages) won in turns: a tie at (8, 124, 16, 96), 5% faster at
// (8, 256) and 26-35% at a data-parallel rank's (4, 124) and (2, 124), where
// they also beat train_fwd_mma's 64-row CTAs, so d = 96 takes this kernel
// at every grid (PERF.md §6).
template <int D>
struct TrainWg {
  using Box = hopper::Boxes<D>;
  static constexpr int WG = D == 96 ? 1 : 2;          // consumer warpgroups (see above)
  static constexpr int kConsumerWarps = 4 * WG;
  static constexpr int kThreads = 32 * kConsumerWarps + 32;  // and the producer warp
  static constexpr int BQ = 64 * WG;                  // query rows a CTA
  static constexpr int KS = D / 16;                   // 16-channel k-steps of a row
  static constexpr int KV = Box::TILE_BYTES;          // a K or V tile
  static constexpr int BIAS_BOX = BQ * 128;           // an fp32 box: BQ rows of 32 keys
  static constexpr int STAGE = 2 * BIAS_BOX + 2 * KV;  // bias, K, V of a key tile
  static constexpr int QB = WG * KV;                  // Q: a tile a warpgroup
  // two CTAs an SM where two stages fit, else one
  static constexpr int kBlocks = fits_sm(ring_bytes(STAGE, QB, 2), 2) ? 2 : 1;
  // then as many stages as those CTAs leave room for, up to four
  static constexpr int STAGES = fits_sm(ring_bytes(STAGE, QB, 4), kBlocks)   ? 4
                                : fits_sm(ring_bytes(STAGE, QB, 3), kBlocks) ? 3
                                                                             : 2;
  static constexpr size_t bytes = ring_bytes(STAGE, QB, STAGES);
  static_assert(STAGE % 1024 == 0 && QB % 1024 == 0, "1024-byte aligned tiles");
};

// out = softmax2(q k^T scale + bias bias_scale) v and lse = m + log2(l), as
// train_fwd_mma, for 128 query rows of one (b, h).
template <int D>
__global__ void __launch_bounds__(TrainWg<D>::kThreads, TrainWg<D>::kBlocks)
train_fwd_wgmma(const __grid_constant__ CUtensorMap qkv_map,
                const __grid_constant__ CUtensorMap bias_map, bf16* __restrict__ out,
                float* __restrict__ lse, int t_len, int heads, float scale, float bias_scale) {
  using namespace hopper;
  using L = TrainWg<D>;
  using Box = typename L::Box;
  constexpr int STAGES = L::STAGES;
  constexpr int kConsumerWarps = L::kConsumerWarps;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* q_smem = smem + STAGES * L::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(q_smem + L::QB);  // a stage's bytes landed
  uint64_t* empty = full + STAGES;                                // every consumer is done with it
  uint64_t* q_full = empty + STAGES;

  const int b = blockIdx.x;  // batch fastest: the CTAs sharing a bias tile run together
  const int q0 = blockIdx.y * L::BQ;
  const int h = blockIdx.z;
  const int n_tiles = (t_len + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = h * 3 * D;  // channel of this head's q in a qkv row

  const CUtensorMap* qmap = &qkv_map;
  const CUtensorMap* bmap = &bias_map;
  // the bias boxes, K and V of key tile j into its stage
  auto load_stage = [&](int j) {
    const int s = j % STAGES;
    unsigned char* st = smem + s * L::STAGE;
    mbar_expect_tx(&full[s], L::STAGE);
    tma_load_3d(st, bmap, &full[s], j * BK, q0, h);
    tma_load_3d(st + L::BIAS_BOX, bmap, &full[s], j * BK + 32, q0, h);
#pragma unroll
    for (int c = 0; c < Box::NBOX; ++c) {
      tma_load_3d(st + 2 * L::BIAS_BOX + c * Box::BOX, qmap, &full[s],
                  col + D + Box::BOX_CH * c, j * BK, b);
      tma_load_3d(st + 2 * L::BIAS_BOX + L::KV + c * Box::BOX, qmap, &full[s],
                  col + 2 * D + Box::BOX_CH * c, j * BK, b);
    }
  };

  const bool producer = warp == kConsumerWarps;
  if (producer && lane == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
    tma_prefetch(qmap);
    tma_prefetch(bmap);
    mbar_expect_tx(q_full, L::QB);
#pragma unroll
    for (int w = 0; w < L::WG; ++w) {
#pragma unroll
      for (int c = 0; c < Box::NBOX; ++c) {
        tma_load_3d(q_smem + w * L::KV + c * Box::BOX, qmap, q_full, col + Box::BOX_CH * c,
                    q0 + 64 * w, b);
      }
    }
    for (int j = 0; j < STAGES && j < n_tiles; ++j) load_stage(j);
  }
  __syncthreads();  // the barriers are initialised

  if (producer) {
    if (lane == 0) {
      for (int j = STAGES; j < n_tiles; ++j) {
        mbar_wait(&empty[j % STAGES], (j / STAGES - 1) & 1);
        load_stage(j);
      }
    }
    return;
  }

  // ----------------------------------------------------------- consumers
  const int wg = warp / 4;  // rows 64 wg .. 64 wg + 63 of the CTA's block
  const int g = lane / 4;   // this thread's rows: g and g + 8 of its warp's 16
  const int t4 = lane % 4;  // and keys 2 t4, 2 t4 + 1 of each 8-key block
  const int row0 = wg * 64 + (warp % 4) * 16;
  // this thread's bias pair of key block n, row row0 + g, is at
  // swz128(row0 + g, 8 (n % 4) + 2 t4) in box n / 4; row0 is a multiple of
  // 8, so the swizzle is g and the pair of row g + 8 lies 8 rows further
  const int bias_row = (row0 + g) * 32 + 2 * (t4 & 1);
  const int bias_chunk = t4 >> 1;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = FLOOR, m1 = FLOOR;  // running max of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;      // and this thread's share of their sums
  float s[32];                   // S of a 64 x 64 tile: key block n in s[4n .. 4n + 3]
  uint32_t p[BK / 16][4];        // P as bf16 A fragments, one a 16-key k-step
  uint64_t qd[L::KS];            // Q's descriptors: this warpgroup's rows, k-step c
#pragma unroll
  for (int c = 0; c < L::KS; ++c) qd[c] = Box::k_desc(smem_addr(q_smem + wg * L::KV), c);

  // log2-domain logits of key tile j, the bias scaled at use; the online
  // softmax in fp32 (O rescaled), and P rounded to bf16
  auto softmax = [&](const unsigned char* st, int j) {
    const float* bt = reinterpret_cast<const float*>(st) + bias_row;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float* bp =
          bt + (n / 4) * (L::BIAS_BOX / 4) + ((((n % 4) * 2 + bias_chunk) ^ g) << 2);
      const float2 b0 = *reinterpret_cast<const float2*>(bp);
      const float2 b1 = *reinterpret_cast<const float2*>(bp + 8 * 32);
      float* x = s + 4 * n;
      x[0] = fmaf(x[0], scale, b0.x * bias_scale);
      x[1] = fmaf(x[1], scale, b0.y * bias_scale);
      x[2] = fmaf(x[2], scale, b1.x * bias_scale);
      x[3] = fmaf(x[3], scale, b1.y * bias_scale);
    }
    if (j == n_tiles - 1 && t_len % BK != 0) {  // keys past T: TMA read 0, make them -inf
      const int keys = t_len - j * BK;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n * 8 + 2 * t4 + e >= keys) s[4 * n + e] = s[4 * n + 2 + e] = -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2_ftz(m0 - mn0), a1 = exp2_ftz(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      s[4 * n] = exp2_ftz(s[4 * n] - mn0);
      s[4 * n + 1] = exp2_ftz(s[4 * n + 1] - mn0);
      s[4 * n + 2] = exp2_ftz(s[4 * n + 2] - mn1);
      s[4 * n + 3] = exp2_ftz(s[4 * n + 3] - mn1);
      r0 += s[4 * n] + s[4 * n + 1];
      r1 += s[4 * n + 2] + s[4 * n + 3];
    }
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= (i % 4 < 2 ? a0 : a1);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // key blocks 2 kk, 2 kk + 1: k-step kk
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int sj = j % STAGES;
    const unsigned char* st = smem + sj * L::STAGE;
    const unsigned char* kt = st + 2 * L::BIAS_BOX;
    // K's and V's descriptors in this stage, made before the products so
    // that no other instruction writes a wgmma's input between them
    uint64_t kd[L::KS], vd[BK / 16];
#pragma unroll
    for (int c = 0; c < L::KS; ++c) kd[c] = Box::k_desc(smem_addr(kt), c);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) vd[kk] = Box::mn_desc(smem_addr(kt + L::KV), kk);
    fence_regs(kd);
    fence_regs(vd);
    mbar_wait(&full[sj], (j / STAGES) & 1);
    __syncwarp();
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < L::KS; ++c) wgmma_m64n64k16_ss(s, qd[c], kd[c], c);  // S = Q K^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(o);
    softmax(st, j);
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(p[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<D>(o, p[kk], vd[kk]);  // O += P V
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();  // every read of the stage is done
    if (lane == 0) mbar_arrive(&empty[sj]);
  }

  // out = O / l, or 0 where the row sum is 0 (a fully masked row), and lse
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int qr0 = q0 + row0 + g, qr1 = qr0 + 8;
  const int C = heads * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int oc = h * D + n * 8 + 2 * t4;
    if (qr0 < t_len) {
      *reinterpret_cast<uint32_t*>(out + ((long)b * t_len + qr0) * C + oc) =
          pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    }
    if (qr1 < t_len) {
      *reinterpret_cast<uint32_t*>(out + ((long)b * t_len + qr1) * C + oc) =
          pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
  }
  if (t4 == 0) {
    float* lrow = lse + ((long)b * heads + h) * t_len;
    if (qr0 < t_len) lrow[qr0] = l0 > 0.f ? m0 + log2f(l0) : MASKED_LSE;
    if (qr1 < t_len) lrow[qr1] = l1 > 0.f ? m1 + log2f(l1) : MASKED_LSE;
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

template <int D, bool kLse>
__global__ void __launch_bounds__(NTHREADS)
bias_attention_simt(const float* __restrict__ qkv, const float* __restrict__ bias,
                    float* __restrict__ out, float* __restrict__ lse, int t_len,
                    int heads, float scale, float bias_scale) {
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
          v = fmaf(acc, scale, qrow < t_len ? bias_h[(long)qrow * t_len + col] * bias_scale : 0.f);
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
    const int qrow = q0 + r0 + r;
    if (kLse && lane == 0 && qrow < t_len) {
      lse[((long)b * heads + h) * t_len + qrow] = l > 0.f ? m_run[r] + log2f(l) : MASKED_LSE;
    }
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

struct Args {
  const void* qkv;
  const void* bias;
  void* out;
  float* lse;
  int batch, t_len, heads;
  float scale, bias_scale;
  cudaStream_t stream;
};

// fp32 qkv/out/bias on the scalar kernel (the test route of both entries).
template <int D, bool kLse>
cudaError_t launch_simt(const Args& a) {
  const dim3 grid(a.batch, (a.t_len + BQ - 1) / BQ, a.heads);
  const int smem = (int)SimtLayout<D>::bytes;
  auto kernel = bias_attention_simt<D, kLse>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const float*>(a.qkv), static_cast<const float*>(a.bias),
      static_cast<float*>(a.out), a.lse, a.t_len, a.heads, a.scale, a.bias_scale);
  return cudaGetLastError();
}

// Opt a kernel in to ``bytes`` of dynamic shared memory, preferring shared
// memory over L1 so that two or three CTAs fit on an SM.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Message of the last failure that has no CUDA error code of its own (a
// tensor map the driver refused, or no cuTensorMapEncodeTiled).
char g_error[256] = "";
constexpr int kOwnError = 20000;  // the error code that points at g_error

// The error code of an encode's result ``r`` (0 on success).
int map_error(CUresult r, const Args& a, int head_dim, const char* what) {
  if (r == CUDA_ERROR_NOT_FOUND) {
    snprintf(g_error, sizeof g_error, "cuTensorMapEncodeTiled not found in the driver");
    return kOwnError;
  }
  if (r != CUDA_SUCCESS) {
    snprintf(g_error, sizeof g_error,
             "cuTensorMapEncodeTiled refused the %s map (CUresult %d) at B=%d T=%d H=%d d=%d",
             what, (int)r, a.batch, a.t_len, a.heads, head_dim);
    return kOwnError;
  }
  return 0;
}

// qkv as (3 H D channels, T, B) in boxes of hopper::Boxes<D>'s channels x 64
// rows x 1 with its swizzle (rows past T read 0, never the next batch row's).
template <int D>
int encode_qkv_map(const Args& a, CUtensorMap* qkv_map) {
  using Box = hopper::Boxes<D>;
  const cuuint64_t c3 = 3ull * a.heads * D;
  return map_error(hopper::encode_map_3d(qkv_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                         const_cast<void*>(a.qkv),
                                         {c3, (cuuint64_t)a.t_len, (cuuint64_t)a.batch},
                                         {c3 * sizeof(bf16), c3 * sizeof(bf16) * a.t_len},
                                         {Box::BOX_CH, BK, 1}, Box::SWIZZLE),
                   a, D, "qkv");
}

// The two tensor maps of a serving launch: qkv (encode_qkv_map), the bf16
// bias as (T keys, H T rows) in boxes of 64 keys x ``bias_rows`` rows with
// the 128-byte swizzle (keys past T read 0).
template <int D>
int encode_maps(const Args& a, int bias_rows, CUtensorMap* qkv_map, CUtensorMap* bias_map) {
  int err = encode_qkv_map<D>(a, qkv_map);
  if (err != 0) return err;
  const hopper::EncodeTiled encode = hopper::tensor_map_encoder();
  if (encode == nullptr) return map_error(CUDA_ERROR_NOT_FOUND, a, D, "bias");
  const cuuint64_t bias_dims[2] = {(cuuint64_t)a.t_len, (cuuint64_t)a.heads * a.t_len};
  const cuuint64_t bias_strides[1] = {(cuuint64_t)a.t_len * sizeof(bf16)};
  const cuuint32_t bias_box[2] = {BK, (cuuint32_t)bias_rows};
  const cuuint32_t ones[2] = {1, 1};
  return map_error(encode(bias_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(a.bias),
                          bias_dims, bias_strides, bias_box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE),
                   a, D, "bias");
}

// bf16 serving on serve_fwd_wgmma<D>: grid (B, T / 128, H).  The shared
// memory is opted in at every launch, as the attribute belongs to the
// current device's context.
template <int D>
int launch_wgmma(const Args& a) {
  using L = Wg<D>;
  int err = (int)prepare(serve_fwd_wgmma<D>, L::bytes);
  if (err != 0) return err;
  CUtensorMap qkv_map, bias_map;
  err = encode_maps<D>(a, L::BQ, &qkv_map, &bias_map);
  if (err != 0) return err;
  const dim3 grid(a.batch, (a.t_len + L::BQ - 1) / L::BQ, a.heads);
  serve_fwd_wgmma<D><<<grid, L::kThreads, L::bytes, a.stream>>>(
      qkv_map, bias_map, static_cast<bf16*>(a.out), a.t_len, a.heads, a.scale);
  return (int)cudaGetLastError();
}

// The kernel each serving shape takes (bias_attention_fwd_route).
enum ServeRoute { kRouteWgmma = 0, kRouteMma = 1, kRouteSimt = 2 };

int serve_route(int t_len, int head_dim, int dtype) {
  if (dtype != 0) return kRouteSimt;
  return hopper::wgmma_dim(head_dim) && t_len % 8 == 0 ? kRouteWgmma : kRouteMma;
}

// Serving: dtype 0 bf16 on serve_fwd_wgmma (d <= 64 or d = 96, T % 8 == 0)
// or serve_fwd_mma, dtype 1 fp32 on the scalar kernel.
template <int D>
int launch_serve(int dtype, const Args& a) {
  const int route = serve_route(a.t_len, D, dtype);
  if (route == kRouteSimt) return (int)launch_simt<D, false>(a);
  if constexpr (hopper::wgmma_dim(D)) {
    if (route == kRouteWgmma) return launch_wgmma<D>(a);
  }
  using L = Serve<D>;
  const int width = a.t_len % 8 == 0 ? 8 : a.t_len % 4 == 0 ? 4 : 1;
  cudaError_t err = prepare(serve_fwd_mma<D>, L::bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.batch, (a.t_len + L::BQ - 1) / L::BQ, a.heads);
  serve_fwd_mma<D><<<grid, NTHREADS, L::bytes, a.stream>>>(
      static_cast<const bf16*>(a.qkv), static_cast<const bf16*>(a.bias),
      static_cast<bf16*>(a.out), a.t_len, a.heads, a.scale, width);
  return (int)cudaGetLastError();
}

template <int D, int MT>
cudaError_t launch_train_tile(const Args& a) {
  using L = TrainFwd<D, MT>;
  if (a.t_len > 46340) return cudaErrorInvalidValue;  // T * T past int: the bias copy's offsets
  const int width = a.t_len % 4 == 0 ? 4 : a.t_len % 2 == 0 ? 2 : 1;
  cudaError_t err = prepare(train_fwd_mma<D, MT>, L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch, (a.t_len + L::BQ - 1) / L::BQ, a.heads);
  train_fwd_mma<D, MT><<<grid, NTHREADS, L::bytes, a.stream>>>(
      static_cast<const bf16*>(a.qkv), static_cast<const float*>(a.bias),
      static_cast<bf16*>(a.out), a.lse, a.t_len, a.heads, a.scale, a.bias_scale, width);
  return cudaGetLastError();
}

// SMs of the current device (asked once).
int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 1;
    }
  }
  return sms;
}

// bf16 training on train_fwd_wgmma<D>: grid (B, T / BQ, H).
template <int D>
int launch_train_wgmma(const Args& a) {
  using L = TrainWg<D>;
  int err = (int)prepare(train_fwd_wgmma<D>, L::bytes);
  if (err != 0) return err;
  CUtensorMap qkv_map, bias_map;
  if ((err = encode_qkv_map<D>(a, &qkv_map)) != 0) return err;
  err = map_error(hopper::encode_bias_f32_map(&bias_map, static_cast<const float*>(a.bias),
                                              a.t_len, a.heads, L::BQ),
                  a, D, "bias");
  if (err != 0) return err;
  const dim3 grid(a.batch, (a.t_len + L::BQ - 1) / L::BQ, a.heads);
  train_fwd_wgmma<D><<<grid, L::kThreads, L::bytes, a.stream>>>(
      qkv_map, bias_map, static_cast<bf16*>(a.out), a.lse, a.t_len, a.heads, a.scale,
      a.bias_scale);
  return (int)cudaGetLastError();
}

// The kernel each training forward call takes
// (bias_attention_train_fwd_route): bf16 at T % 4 == 0 on train_fwd_wgmma
// at d = 96, and at d <= 64 where its 128-row grid fills at least half the
// SMs; the other bf16 calls on train_fwd_mma, fp32 on the scalar kernel.
// At d <= 64 on a smaller grid train_fwd_mma's 64-row CTAs, twice as many,
// won in turns: 10-52% faster at (1, 496), (2, 256), (2, 124) and (4, 124)
// x 16 heads of 48 (64 CTAs or fewer); at 128 CTAs the two tie at (8, 124)
// and (8, 128) and train_fwd_wgmma wins at (2, 496) and (4, 256) (13-21%
// warm, 0-6% cold; PERF.md §6).
enum TrainRoute { kTrainWgmma = 0, kTrainMma = 1, kTrainSimt = 2 };

int train_route(int batch, int t_len, int heads, int head_dim, int dtype) {
  if (dtype != 0) return kTrainSimt;
  if (!hopper::wgmma_dim(head_dim) || t_len % 4 != 0) return kTrainMma;
  if (head_dim == 96) return kTrainWgmma;
  const long ctas = (long)batch * ((t_len + 127) / 128) * heads;
  return 2 * ctas >= sm_count() ? kTrainWgmma : kTrainMma;
}

// Query rows a CTA of the route's kernel takes at this call: TrainWg<D>::BQ
// on train_fwd_wgmma; on train_fwd_mma 128 up to d = 64 wherever that grid
// fills every SM, else 64 (above d = 64 two m16 tiles' registers do not fit
// its warps).
template <int D>
int train_rows(const Args& a, int route) {
  if (route == kTrainSimt) return BQ;
  if (route == kTrainWgmma) return TrainWg<D>::BQ;
  const long ctas = (long)a.batch * ((a.t_len + 127) / 128) * a.heads;
  return D <= 64 && ctas >= sm_count() ? 128 : 64;
}

// Training: write out and lse on the route train_route names.
template <int D>
int launch_train(int dtype, const Args& a) {
  const int route = train_route(a.batch, a.t_len, a.heads, D, dtype);
  if (route == kTrainSimt) return (int)launch_simt<D, true>(a);
  if constexpr (hopper::wgmma_dim(D)) {
    if (route == kTrainWgmma) return launch_train_wgmma<D>(a);
  }
  if constexpr (D <= 64) {
    if (train_rows<D>(a, route) == 128) return (int)launch_train_tile<D, 2>(a);
  }
  return (int)launch_train_tile<D, 1>(a);
}

// CTAs of a kernel with ``bytes`` of dynamic shared memory that fit on one SM.
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, size_t bytes, int* blocks) {
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, NTHREADS, bytes);
}

// The serving kernel a T % 8 == 0 call takes at d = D.
template <int D>
cudaError_t serve_blocks_per_sm(int* blocks) {
  if constexpr (hopper::wgmma_dim(D)) {
    using L = Wg<D>;
    const auto kernel = serve_fwd_wgmma<D>;
    const cudaError_t err = prepare(kernel, L::bytes);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, L::kThreads, L::bytes);
  } else {
    return blocks_per_sm(serve_fwd_mma<D>, Serve<D>::bytes, blocks);
  }
}

// Registers a thread and dynamic shared memory of a route's kernel at d = D
// (bf16).
template <int D>
cudaError_t route_info(int route, int* regs, int* smem) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaErrorInvalidValue;
  if (route == kRouteWgmma) {
    if constexpr (hopper::wgmma_dim(D)) {
      err = cudaFuncGetAttributes(&fa, serve_fwd_wgmma<D>);
      *smem = (int)Wg<D>::bytes;
    }
  } else if (route == kRouteMma) {
    err = cudaFuncGetAttributes(&fa, serve_fwd_mma<D>);
    *smem = (int)Serve<D>::bytes;
  } else if (route == kRouteSimt) {
    err = cudaFuncGetAttributes(&fa, bias_attention_simt<D, false>);
    *smem = (int)SimtLayout<D>::bytes;
  }
  if (err == cudaSuccess) *regs = fa.numRegs;
  return err;
}

// A training forward call's kernel and launch: info[0] the route, [1] query
// rows a CTA, [2] CTAs that fit on one SM, [3] dynamic shared memory a CTA,
// [4] registers a thread.
template <int D>
cudaError_t train_info(int dtype, const Args& a, int* info) {
  const int route = train_route(a.batch, a.t_len, a.heads, D, dtype);
  info[0] = route;
  info[1] = train_rows<D>(a, route);
  auto query = [&](auto kernel, size_t bytes, int threads) {
    info[3] = (int)bytes;
    cudaFuncAttributes fa;
    cudaError_t err = prepare(kernel, bytes);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], kernel, threads, bytes);
    }
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess) info[4] = fa.numRegs;
    return err;
  };
  if (route == kTrainSimt) return query(bias_attention_simt<D, true>, SimtLayout<D>::bytes, NTHREADS);
  if constexpr (hopper::wgmma_dim(D)) {
    if (route == kTrainWgmma) {
      return query(train_fwd_wgmma<D>, TrainWg<D>::bytes, TrainWg<D>::kThreads);
    }
  }
  if constexpr (D <= 64) {
    if (info[1] == 128) return query(train_fwd_mma<D, 2>, TrainFwd<D, 2>::bytes, NTHREADS);
  }
  return query(train_fwd_mma<D, 1>, TrainFwd<D, 1>::bytes, NTHREADS);
}

enum class Op { kServe, kTrain, kServeOccupancy, kTrainInfo };

template <Op kOp>
int dispatch(int head_dim, int dtype, const Args& a, int* blocks = nullptr) {
  constexpr bool kLaunch = kOp == Op::kServe || kOp == Op::kTrain || kOp == Op::kTrainInfo;
  if (kLaunch && (a.batch <= 0 || a.t_len <= 0 || a.heads <= 0 || (dtype != 0 && dtype != 1))) {
    return (int)cudaErrorInvalidValue;
  }
#define DTTS_CASE(DIM)                                                          \
  case DIM:                                                                     \
    return (int)(kOp == Op::kServe            ? launch_serve<DIM>(dtype, a)     \
                 : kOp == Op::kTrain          ? launch_train<DIM>(dtype, a)     \
                 : kOp == Op::kServeOccupancy ? serve_blocks_per_sm<DIM>(blocks) \
                                              : train_info<DIM>(dtype, a, blocks));
  switch (head_dim) {
    DTTS_CASE(16) DTTS_CASE(32) DTTS_CASE(48) DTTS_CASE(64)
    DTTS_CASE(80) DTTS_CASE(96) DTTS_CASE(112) DTTS_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef DTTS_CASE
}

}  // namespace

// Serving forward.  dtype: 0 = bfloat16, 1 = float32.  qkv (B, T, 3 * H * D),
// bias (H, T, T) and out (B, T, H * D) are contiguous, 16-byte aligned and of
// that type; scale = sm_scale * log2(e); bias is in the log2 domain.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int bias_attention_fwd(const void* qkv, const void* bias, void* out,
                                  int batch, int t_len, int heads, int head_dim,
                                  float scale, int dtype, void* stream) {
  const Args a{qkv, bias, out, nullptr, batch, t_len, heads, scale, 1.f,
               static_cast<cudaStream_t>(stream)};
  return dispatch<Op::kServe>(head_dim, dtype, a);
}

// Training forward: as above, but the bias is float32 in the natural domain
// (scaled by bias_scale = log2(e) inside) and the row statistic
// lse = m + log2(l), float32 (B, H, T), is written beside the output.
extern "C" int bias_attention_train_fwd(const void* qkv, const void* bias, void* out,
                                        void* lse, int batch, int t_len, int heads,
                                        int head_dim, float scale, float bias_scale,
                                        int dtype, void* stream) {
  const Args a{qkv, bias, out, static_cast<float*>(lse), batch, t_len, heads, scale,
               bias_scale, static_cast<cudaStream_t>(stream)};
  return dispatch<Op::kTrain>(head_dim, dtype, a);
}

// CTAs of the bf16 serving kernel that a call at ``head_dim`` with T % 8 ==
// 0 takes (serve_fwd_wgmma at d <= 64 and d = 96) that fit on one SM of the
// current device, or minus the CUDA error code.
extern "C" int bias_attention_fwd_blocks_per_sm(int head_dim) {
  int blocks = 0;
  const Args a{};
  const int err = dispatch<Op::kServeOccupancy>(head_dim, 0, a, &blocks);
  return err != 0 ? -err : blocks;
}

// The kernel a training forward call of this B, T, H, head_dim and dtype (0
// bf16, 1 fp32) takes on the current device: 0 train_fwd_wgmma (bf16,
// T % 4 == 0, at d = 96 or at d <= 64 where B ceil(T / 128) H >= SMs / 2),
// 1 train_fwd_mma (the other bf16 calls), 2 the scalar kernel; -1 for a
// shape or dtype the entry refuses.
extern "C" int bias_attention_train_fwd_route(int batch, int t_len, int heads, int head_dim,
                                              int dtype) {
  if (batch <= 0 || t_len <= 0 || heads <= 0 || head_dim % 16 != 0 || head_dim < 16 ||
      head_dim > 128 || (dtype != 0 && dtype != 1)) {
    return -1;
  }
  return train_route(batch, t_len, heads, head_dim, dtype);
}

// The kernel and launch of a training forward call at (batch, t_len, heads,
// head_dim, dtype) on the current device, into info[5]: the route (as
// bias_attention_train_fwd_route), query rows a CTA, CTAs that fit on one
// SM, dynamic shared memory a CTA and registers a thread.  Returns the CUDA
// error code (0 on success).
extern "C" int bias_attention_train_fwd_info(int batch, int t_len, int heads, int head_dim,
                                             int dtype, int* info) {
  const Args a{nullptr, nullptr, nullptr, nullptr, batch, t_len, heads, 1.f, 1.f, nullptr};
  return dispatch<Op::kTrainInfo>(head_dim, dtype, a, info);
}

// The kernel a serving call of this T, head_dim and dtype (0 bf16, 1 fp32)
// takes: 0 serve_fwd_wgmma, 1 serve_fwd_mma, 2 the scalar kernel; -1 for a
// head_dim or dtype the entry refuses.
extern "C" int bias_attention_fwd_route(int t_len, int head_dim, int dtype) {
  if (head_dim % 16 != 0 || head_dim < 16 || head_dim > 128 || (dtype != 0 && dtype != 1)) {
    return -1;
  }
  return serve_route(t_len, head_dim, dtype);
}

// Registers a thread and dynamic shared memory of ``route``'s kernel at
// ``head_dim``; returns the CUDA error code (0 on success).
extern "C" int bias_attention_fwd_route_info(int route, int head_dim, int* regs,
                                             int* smem_bytes) {
  switch (head_dim) {
    case 16: return (int)route_info<16>(route, regs, smem_bytes);
    case 32: return (int)route_info<32>(route, regs, smem_bytes);
    case 48: return (int)route_info<48>(route, regs, smem_bytes);
    case 64: return (int)route_info<64>(route, regs, smem_bytes);
    case 80: return (int)route_info<80>(route, regs, smem_bytes);
    case 96: return (int)route_info<96>(route, regs, smem_bytes);
    case 112: return (int)route_info<112>(route, regs, smem_bytes);
    case 128: return (int)route_info<128>(route, regs, smem_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* bias_attention_error_string(int code) {
  if (code == kOwnError) return g_error;
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
