// The decode step's sampler for Hopper (sm_90a), CUDA C++ with plain C
// entries: one launch a step does what the JAX package's ``body_fn``
// (detail_tts_tpu/models/gpt.py:356-377) does around the GPT's logits, which
// XLA lowers with no ``pallas_call``: ``sample_token``
// (detail_tts_tpu/ops/sampling.py:86: repetition penalty, temperature,
// typical filtering, top-p, ``jax.random.categorical``) and the step's
// bookkeeping (the stop token for finished rows, ``codes[:, step]``,
// ``seen[r, tok]``, ``lengths``, ``finished``).
//
// A row is spread over a thread-block cluster of kCluster = 8 CTAs of
// kThreads threads: CTA c owns the row's tokens [c chunk, (c + 1) chunk),
// chunk = ceil(V / 8).  B rows are 8 B CTAs, one wave of an H100's 132 SMs
// up to B = 16; past that the grid wraps.  Two kernels, one a launch:
//
// * ``sample_step_kernel`` (V <= 8 x kCtaVocab = 65,536, the decode's
//   8194 among them): a CTA holds its chunk in shared memory, 16 B a token
//   (the logit, its key's value bits, its fixed-point mass);
// * ``sample_step_kernel_wide`` (every larger V, up to the C entry's int
//   2^31 - 1): a CTA keeps the first ``Params.cache`` tokens of its chunk
//   (~32,000, what its shared memory holds beside the histograms) as
//   penalized, tempered logits, 4 B a token, and re-reads the rest from
//   global memory in each pass.  Every pass recomputes a token's value,
//   key and mass from that logit with the same code for a cached and a
//   re-read token, so it needs no workspace: a token the typical filter
//   removed is recognised again by its key against the boundary.
//
// The CTAs meet through distributed shared memory: each pushes its partials
// into every CTA's slots and a ``cluster.sync()`` publishes them.  Each CTA arrives at a cluster
// barrier on entry and waits on it after loading its tokens, before its
// first push, so no CTA writes into one that has not started.  Thread t of a
// CTA owns its tokens t, t + kThreads, ... in every pass but the sums.
//
// * penalty and temperature, each skipped at 1.0 as the plain version skips
//   it (IEEE division, as the plain version divides);
// * typical filtering, when ``mass < 1``: fp32 log-softmax and entropy;
//   the boundary of the plain version's stable sort of |-logp - H|, scan of
//   p in that order and count(cum < mass); what lies above it removed;
// * top-p, when ``top_p < 1``: fp32 softmax; the boundary of the plain
//   version's stable ascending sort of the values, its scan and k =
//   min(count(cum <= 1 - top_p), V - 1); HF's tie rule: kept where the
//   (value, index) key is at or above the boundary's;
// * a Gumbel for each kept token only, drawn in registers at flat index
//   offset + r V + j under the step's device key (threefry.cuh: the bits and
//   transform of ``threefry_draw``), and the argmax of gumbel + x over the
//   kept tokens, the first index on ties; a removed token is -inf in the
//   plain version and cannot win, so its draw changes nothing.
//
// Neither filter needs the sorted order, only the element at which the
// ascending scan passes its threshold.  A token's key is its value's bits
// made order-preserving (-0.0 made +0.0 first: the two compare equal, and a
// stable sort orders them by index), above its index bits for top-p; every
// key is distinct and key order is the stable sort's order.  The boundary
// is the least key whose mass at or below it passes the threshold, found by
// radix select from the top of the key, kRadixBits a pass: a histogram of
// the mass of the candidates that share the prefix chosen so far (each
// warp's in shared memory, the warps' and then the CTAs' added in order),
// a scan of its bins, and the first non-empty bin where the carried mass
// below it plus the bins up to it passes; where none passes (rounding), the
// last non-empty bin, which ends at the largest key (the clamp to V - 1).
// A pass whose bin holds one candidate ends the select; the 32 value bits
// take at most 4 passes, and top-p's index bits (up to 31) passes more only
// on a tie at the boundary value.  Masses are summed in fixed point, so
// every sum is exact and the same in any order: the kept set is the same
// from run to run.  A token's mass rounds to the nearest unit, so a row's
// sum is within V / 2 units of the float masses' exact sum: the shared
// path packs a count of candidates above 41 bits of mass at 2^-40 a unit
// (the count fits in 23 bits, V <= 2^16: within 2^-25 = 3.0e-8); the wide
// path keeps the count in a word of its own and the mass at 2^-60 a unit
// (within 2^31 x 2^-61 = 9.3e-10 at the largest V), both far inside the
// 1e-5 that chip_smoke.py's phase 3c excuses.  The max, softmax and entropy
// sums run in one fixed order (each CTA's tokens, then the CTAs in order),
// so a row's token does not depend on its batch.  They differ in
// order from PyTorch's sort-then-cumsum, so the kept set can differ from
// the plain version's only where its cumulative mass at the boundary lies
// within a few ulp of the threshold; penalty, temperature and the Gumbels
// are bit-identical (one rounding an operation, no contraction).
//
// What bounds it on the H100: neither bytes nor operations.  A (8, 8194)
// fp32 step reads 328 KB and writes 8 tokens, ~0.1 us at 3.35 TB/s.  It is
// latency-bound: a filter is a few exchanges (max, sum, each select pass),
// each a chain of CTA barriers, shared-memory round trips and one cluster
// barrier.  Radix select cuts a filter's dependent rounds from 46 bisection
// steps to at most 6 passes, and the cluster puts 8 SMs on a row, so each
// thread holds a few tokens.  The wide path at V in the millions is bound
// by the 8 SMs' reads of the row, once a pass: its bytes bound counts the
// row once, and it is the repair of a refusal, not a path the decode runs.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRadixBits = 8;
constexpr int kBins = 1 << kRadixBits;
static_assert(kBins % 32 == 0 && kBins <= kThreads, "thread b owns bin b, in whole warps");
constexpr int kCluster = 8;      // CTAs a row
constexpr int kCtaVocab = 8192;  // tokens a CTA holds on the shared path
// a token's packed histogram entry: a count of one above its mass in fixed
// point, 2^-40 a unit in the low kMassBits bits (a row's masses sum to < 2)
constexpr int kMassBits = 41;
constexpr unsigned long long kMassMask = (1ULL << kMassBits) - 1;
constexpr unsigned long long kCountOne = 1ULL << kMassBits;
constexpr float kMassScale = 1099511627776.0f;  // 2^40
// the wide path's mass word: 2^-60 a unit (a row's masses sum to < 16)
constexpr float kWideMassScale = 1152921504606846976.0f;  // 2^60
// float exchanges through the cluster: typical's max, sum and entropy,
// top-p's max and sum
constexpr int kExchanges = 5;

struct Params {
  int vocab, code_stride, step, stop, chunk, index_bits;
  int cache;  // the wide path: tokens a CTA keeps in shared memory
  bool penalty_on, temperature_on, typical_on, top_p_on, force_full;
  float penalty, temperature;
  // fixed-point thresholds: typical passes at cum >= typical_thr, top-p at
  // cum > top_p_thr
  unsigned long long typical_thr, top_p_thr;
  unsigned long long offset;
};

// Dynamic shared memory: the CTA's tokens, then the select's histograms.
struct Tokens {
  float* xs;                   // logits, then -inf where removed [chunk]
  uint32_t* vkey;              // the filter's key value bits [chunk]
  unsigned long long* q;       // the filter's packed mass entries [chunk]
  unsigned long long* recv;    // [2][kCluster][kBins]: the CTAs' histograms, pushed
  unsigned long long* whist;   // [kWarps][kBins]: each warp's histogram
};

__host__ __device__ inline int round_up4(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ inline size_t smem_bytes(int chunk, bool filters) {
  const size_t tokens = 4 * static_cast<size_t>(round_up4(chunk));
  if (!filters) return tokens;
  return tokens * 4 + 8 * static_cast<size_t>(2 * kCluster * kBins + kWarps * kBins);
}

// The wide path's dynamic shared memory: each warp's histogram and the CTAs'
// pushed ones, a mass word and a count word a bin, then the cached tokens.
struct WideHist {
  unsigned long long* mass;       // [kWarps][kBins]
  unsigned long long* recv_mass;  // [2][kCluster][kBins]
  unsigned* count;                // [kWarps][kBins]
  unsigned* recv_count;           // [2][kCluster][kBins]
};
constexpr size_t kWideHistBytes =
    (8 + 4) * static_cast<size_t>(kWarps * kBins + 2 * kCluster * kBins);

// The CTA's small exchange slots (static shared memory).
struct Slots {
  float red[kWarps];                        // block reductions
  float xf[kExchanges][kCluster];           // the cluster's partials, pushed
  unsigned long long wscan[kWarps];         // the warps' bin totals
  unsigned long long bexcl[kBins], bh[kBins];  // each bin's exclusive prefix and sum
  unsigned wfirst[kWarps], wlast[kWarps];   // each warp's first passing, last non-empty
  float warp_val[kWarps], cta_val[kCluster];  // each warp's and each CTA's best
  int warp_idx[kWarps], cta_idx[kCluster];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Float bits made order-preserving as unsigned; -0.0 becomes +0.0 first.
__device__ __forceinline__ uint32_t order_bits(float v) {
  const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A token's histogram entry: a count of one and its mass in fixed point
// (0 for a mass that is not positive, or NaN).
__device__ __forceinline__ unsigned long long mass_entry(float p) {
  return kCountOne | (p > 0.0f ? __float2ull_rn(fminf(p, 1.0f) * kMassScale) : 0ULL);
}

// The wide path's mass word of a token, 2^-60 a unit (0 as above).
__device__ __forceinline__ unsigned long long wide_mass(float p) {
  return p > 0.0f ? __float2ull_rn(fminf(p, 1.0f) * kWideMassScale) : 0ULL;
}

// Token j of a row after the repetition penalty and the temperature, each
// skipped at 1.0 as the plain version skips it (IEEE division, as the plain
// version divides).
template <typename T>
__device__ __forceinline__ float scaled_logit(const T* row, const uint8_t* seen_row, int j,
                                              const Params& p) {
  float x = to_float(row[j]);
  if (p.penalty_on && seen_row[j]) {
    x = x > 0.0f ? __fdiv_rn(x, p.penalty) : __fmul_rn(x, p.penalty);
  }
  if (p.temperature_on) x = __fdiv_rn(x, p.temperature);
  return x;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// The row's max of ``v`` over every thread of the cluster.
__device__ float row_max(float v, Slots& s, int slot, cg::cluster_group& cluster, int rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();  // red is free
  if (lane == 0) s.red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float m = warp_max(lane < kWarps ? s.red[lane] : -INFINITY);
    if (lane < kCluster) *cluster.map_shared_rank(&s.xf[slot][rank], lane) = m;
  }
  cluster.sync();
  float m = s.xf[slot][0];
  for (int c = 1; c < kCluster; ++c) m = fmaxf(m, s.xf[slot][c]);
  return m;
}

// The row's sum of term(t) over the tokens t of every CTA, in one fixed
// order: each CTA's (thread i its tokens i, i + kThreads, ..., the warp's
// butterfly, the butterfly over the warps), then the CTAs in order.
template <typename F>
__device__ float row_sum(F term, int n, Slots& s, int slot, cg::cluster_group& cluster,
                         int rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float v = 0.0f;
  for (int t = threadIdx.x; t < n; t += kThreads) v = __fadd_rn(v, term(t));
  v = warp_sum(v);
  __syncthreads();  // red is free
  if (lane == 0) s.red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < kWarps ? s.red[lane] : 0.0f);
    if (lane < kCluster) *cluster.map_shared_rank(&s.xf[slot][rank], lane) = v;
  }
  cluster.sync();
  v = s.xf[slot][0];
  for (int c = 1; c < kCluster; ++c) v = __fadd_rn(v, s.xf[slot][c]);
  return v;
}

// The boundary key of one filter by radix select: on return, the boundary
// is the one key whose bits above ``shift`` equal ``prefix``.  Top-p's keys
// are the value bits above ``index_bits`` of the token's index, and pass at
// cum > thr; typical's are the value bits alone, and pass at cum >= thr.
// Top-p's candidates are the tokens of positive mass: cum > thr first at
// one of them, and the largest key (the clamp) is the row's max, of mass
// 1 / sum.  A row with none (every logit -inf, masses NaN) keeps every
// token, as the plain version's NaN scan does (prefix 0 above every key).
template <bool kTopP>
__device__ void radix_select(const Tokens& tk, int n, int j0, int index_bits,
                             unsigned long long thr, Slots& s, cg::cluster_group& cluster,
                             int rank, unsigned long long& prefix_out, int& shift_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long prefix = 0, carried = 0;  // carried: the mass below the prefix
  int shift = kTopP ? 32 + index_bits : 32, buf = 0;
  while (shift > 0) {
    const int bits = min(kRadixBits, shift);
    shift -= bits;
    const unsigned long long digit = (1ULL << bits) - 1;
    // this warp's histogram of the candidates' masses (integer atomics:
    // exact in any order)
    unsigned long long* wh = tk.whist + warp * kBins;
    for (int t = threadIdx.x; t < n; t += kThreads) {
      unsigned long long key = tk.vkey[t];
      if (kTopP) key = (key << index_bits) | static_cast<unsigned>(j0 + t);
      const unsigned long long q = tk.q[t];
      if ((key >> (shift + bits)) == prefix && (!kTopP || (q & kMassMask) != 0)) {
        atomicAdd(wh + ((key >> shift) & digit), q);
      }
    }
    __syncthreads();
    // the CTA's histogram, the warps in order, pushed into every CTA's slot
    // (thread b owns bin b)
    unsigned long long* slot = tk.recv + buf * kCluster * kBins;
    const int bin = threadIdx.x;
    unsigned long long h = 0;
    if (bin < kBins) {
      unsigned long long part[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) part[w] = tk.whist[w * kBins + bin];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) tk.whist[w * kBins + bin] = 0;
      for (int w = 0; w < kWarps; ++w) h += part[w];
      for (int c = 0; c < kCluster; ++c) *cluster.map_shared_rank(slot + rank * kBins + bin, c) = h;
    }
    cluster.sync();
    // the cluster's histogram, the CTAs in order, and its inclusive scan
    unsigned long long excl = 0;
    if (bin < kBins) {
      unsigned long long part[kCluster];
#pragma unroll
      for (int c = 0; c < kCluster; ++c) part[c] = slot[c * kBins + bin];
      h = 0;
      for (int c = 0; c < kCluster; ++c) h += part[c];
      unsigned long long incl = h;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) s.wscan[warp] = incl;
      excl = incl - h;
    }
    __syncthreads();
    if (bin < kBins) {
      for (int w = 0; w < warp; ++w) excl += s.wscan[w];
      s.bexcl[bin] = excl;
      s.bh[bin] = h;
      const unsigned long long cum = carried + ((excl + h) & kMassMask);
      const bool nonempty = (h >> kMassBits) != 0;
      const unsigned first = nonempty && (kTopP ? cum > thr : cum >= thr) ? bin : kBins;
      const unsigned last = nonempty ? bin + 1 : 0;  // one past the last non-empty bin
      const unsigned wf = __reduce_min_sync(0xFFFFFFFFu, first);
      const unsigned wl = __reduce_max_sync(0xFFFFFFFFu, last);
      if (lane == 0) {
        s.wfirst[warp] = wf;
        s.wlast[warp] = wl;
      }
    }
    __syncthreads();
    unsigned first = kBins, last = 0;
    for (int w = 0; w < kBins / 32; ++w) {
      first = min(first, s.wfirst[w]);
      last = max(last, s.wlast[w]);
    }
    if (last == 0) {  // no candidate: every token kept
      prefix = 0;
      shift += bits;
      break;
    }
    const unsigned b = first < kBins ? first : last - 1;
    carried += s.bexcl[b] & kMassMask;
    prefix = (prefix << bits) | b;
    buf ^= 1;
    if ((s.bh[b] >> kMassBits) == 1) break;  // one candidate left: the boundary
  }
  prefix_out = prefix;
  shift_out = shift;
}

// radix_select on the wide path: the same passes, with a token's key and
// mass from ``key_of(t)`` and ``mass_of(t)`` (computed again in each pass,
// the mass only for a candidate), and a bin's mass and count in words of
// their own.  ``total_bits``: the key's width (32, or 32 + index bits).
template <bool kTopP, typename KeyFn, typename MassFn>
__device__ void radix_select_wide(KeyFn key_of, MassFn mass_of, int n, int total_bits,
                                  unsigned long long thr, const WideHist& w, Slots& s,
                                  unsigned* bcount, cg::cluster_group& cluster, int rank,
                                  unsigned long long& prefix_out, int& shift_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long prefix = 0, carried = 0;  // carried: the mass below the prefix
  int shift = total_bits, buf = 0;
  while (shift > 0) {
    const int bits = min(kRadixBits, shift);
    shift -= bits;
    const unsigned long long digit = (1ULL << bits) - 1;
    unsigned long long* wm = w.mass + warp * kBins;
    unsigned* wc = w.count + warp * kBins;
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const unsigned long long key = key_of(t);
      if ((key >> (shift + bits)) != prefix) continue;
      const unsigned long long q = mass_of(t);
      if (kTopP && q == 0) continue;
      const int b = static_cast<int>((key >> shift) & digit);
      atomicAdd(wm + b, q);
      atomicAdd(wc + b, 1u);
    }
    __syncthreads();
    // the CTA's histogram, the warps in order, pushed into every CTA's slot
    unsigned long long* slot_m = w.recv_mass + buf * kCluster * kBins;
    unsigned* slot_c = w.recv_count + buf * kCluster * kBins;
    const int bin = threadIdx.x;
    unsigned long long h = 0;
    unsigned c = 0;
    if (bin < kBins) {
      for (int v = 0; v < kWarps; ++v) {
        h += w.mass[v * kBins + bin];
        c += w.count[v * kBins + bin];
        w.mass[v * kBins + bin] = 0;
        w.count[v * kBins + bin] = 0;
      }
      for (int k = 0; k < kCluster; ++k) {
        *cluster.map_shared_rank(slot_m + rank * kBins + bin, k) = h;
        *cluster.map_shared_rank(slot_c + rank * kBins + bin, k) = c;
      }
    }
    cluster.sync();
    // the cluster's histogram, the CTAs in order, and its inclusive scan
    unsigned long long excl = 0;
    if (bin < kBins) {
      h = 0;
      c = 0;
      for (int k = 0; k < kCluster; ++k) {
        h += slot_m[k * kBins + bin];
        c += slot_c[k * kBins + bin];
      }
      unsigned long long incl = h;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) s.wscan[warp] = incl;
      excl = incl - h;
    }
    __syncthreads();
    if (bin < kBins) {
      for (int v = 0; v < warp; ++v) excl += s.wscan[v];
      s.bexcl[bin] = excl;
      bcount[bin] = c;
      const unsigned long long cum = carried + excl + h;
      const unsigned first = c != 0 && (kTopP ? cum > thr : cum >= thr) ? bin : kBins;
      const unsigned last = c != 0 ? bin + 1 : 0;  // one past the last non-empty bin
      const unsigned wf = __reduce_min_sync(0xFFFFFFFFu, first);
      const unsigned wl = __reduce_max_sync(0xFFFFFFFFu, last);
      if (lane == 0) {
        s.wfirst[warp] = wf;
        s.wlast[warp] = wl;
      }
    }
    __syncthreads();
    unsigned first = kBins, last = 0;
    for (int v = 0; v < kBins / 32; ++v) {
      first = min(first, s.wfirst[v]);
      last = max(last, s.wlast[v]);
    }
    if (last == 0) {  // no candidate: every token kept
      prefix = 0;
      shift += bits;
      break;
    }
    const unsigned b = first < kBins ? first : last - 1;
    carried += s.bexcl[b];
    prefix = (prefix << bits) | b;
    buf ^= 1;
    if (bcount[b] == 1) break;  // one candidate left: the boundary
  }
  prefix_out = prefix;
  shift_out = shift;
}

// log p of a logit x under the row's max m and log-sum log_s, as
// ``torch.log_softmax``'s epilogue: (x - m) - log_s.
__device__ __forceinline__ float log_prob(float x, float m, float log_s) {
  return __fsub_rn(__fsub_rn(x, m), log_s);
}

// |-log p - H|, typical filtering's distance from the entropy H.
__device__ __forceinline__ float typical_distance(float x, float m, float log_s, float h) {
  return fabsf(__fsub_rn(-log_prob(x, m, log_s), h));
}

// The Gumbels of the kept tokens and the argmax over the row, the first
// index on ties (``x_final(t)``: token t's value after both filters, -inf
// where removed), then the step's bookkeeping on CTA 0.
template <typename F>
__device__ __forceinline__ void sample_row(F x_final, int n, int j0, int r, const Params& p,
                                           Slots& s, cg::cluster_group& cluster, int rank,
                                           uint8_t* seen_row, long long* codes,
                                           long long* lengths, uint8_t* finished,
                                           long long* tok_out, const uint32_t* key) {
  const int V = p.vocab;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t k0 = key[0], k1 = key[1];
  const unsigned long long base = p.offset + static_cast<unsigned long long>(r) * V;
  float best = -INFINITY;
  int arg = V;  // none yet
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const float x = x_final(t);
    if (x == -INFINITY) continue;  // removed, or -inf: wins only if all are
    const int j = j0 + t;
    const float v = __fadd_rn(threefry::gumbel(threefry::random_bits(k0, k1, base + j)), x);
    if (v > best || (v == best && j < arg)) {
      best = v;
      arg = j;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, best, o);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, arg, o);
    if (ov > best || (ov == best && oi < arg)) {
      best = ov;
      arg = oi;
    }
  }
  if (lane == 0) {
    s.warp_val[warp] = best;
    s.warp_idx[warp] = arg;
  }
  __syncthreads();
  if (warp == 0) {  // the warps' bests, pushed into CTA 0
    best = lane < kWarps ? s.warp_val[lane] : -INFINITY;
    arg = lane < kWarps ? s.warp_idx[lane] : V;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xFFFFFFFFu, best, o);
      const int oi = __shfl_xor_sync(0xFFFFFFFFu, arg, o);
      if (ov > best || (ov == best && oi < arg)) {
        best = ov;
        arg = oi;
      }
    }
    if (lane == 0) {
      *cluster.map_shared_rank(&s.cta_val[rank], 0) = best;
      *cluster.map_shared_rank(&s.cta_idx[rank], 0) = arg;
    }
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {  // the CTAs in order
    best = s.cta_val[0];
    arg = s.cta_idx[0];
    for (int c = 1; c < kCluster; ++c) {
      if (s.cta_val[c] > best || (s.cta_val[c] == best && s.cta_idx[c] < arg)) {
        best = s.cta_val[c];
        arg = s.cta_idx[c];
      }
    }
    if (arg == V) arg = 0;  // every value -inf: torch.argmax's first index
    // the step's bookkeeping (body_fn): finished rows emit the stop token
    const bool done = finished[r] != 0;
    const long long tok = done ? p.stop : arg;
    codes[static_cast<long long>(r) * p.code_stride + p.step] = tok;
    seen_row[tok] = 1;
    if (!done) lengths[r] += 1;
    if (!p.force_full && tok == p.stop) finished[r] = 1;
    tok_out[r] = tok;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    sample_step_kernel(const T* __restrict__ logits, uint8_t* __restrict__ seen,
                       long long* __restrict__ codes, long long* __restrict__ lengths,
                       uint8_t* __restrict__ finished, long long* __restrict__ tok_out,
                       const uint32_t* __restrict__ key, const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Slots s;
  // no CTA may write into another's shared memory before both have started:
  // arrive here, wait once this CTA's tokens are loaded
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int V = p.vocab;
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = blockIdx.x / kCluster;
  const int j0 = rank * p.chunk;            // this CTA's first token
  const int n = max(0, min(p.chunk, V - j0));  // and its count
  Tokens tk;
  tk.xs = reinterpret_cast<float*>(smem);
  tk.vkey = reinterpret_cast<uint32_t*>(tk.xs + round_up4(p.chunk));
  tk.q = reinterpret_cast<unsigned long long*>(tk.vkey + round_up4(p.chunk));
  tk.recv = tk.q + round_up4(p.chunk);
  tk.whist = tk.recv + 2 * kCluster * kBins;
  const T* row = logits + static_cast<long long>(r) * V;
  uint8_t* seen_row = seen + static_cast<long long>(r) * V;

  // penalty and temperature
  for (int t = threadIdx.x; t < n; t += kThreads) {
    tk.xs[t] = scaled_logit(row, seen_row, j0 + t, p);
  }
  if (p.typical_on || p.top_p_on) {
    for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) tk.whist[i] = 0;
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // every CTA has started

  int slot = 0;
  unsigned long long prefix;
  int shift;
  if (p.typical_on) {
    float m = -INFINITY;
    for (int t = threadIdx.x; t < n; t += kThreads) m = fmaxf(m, tk.xs[t]);
    m = row_max(m, s, slot++, cluster, rank);
    const float* xs = tk.xs;
    const float log_s = logf(row_sum(
        [&](int t) { return expf(__fsub_rn(xs[t], m)); }, n, s, slot++, cluster, rank));
    const float h = -row_sum(  // the entropy
        [&](int t) {
          const float lp = log_prob(xs[t], m, log_s), pj = expf(lp);
          return pj > 0.0f ? __fmul_rn(pj, lp) : 0.0f;
        },
        n, s, slot++, cluster, rank);
    for (int t = threadIdx.x; t < n; t += kThreads) {
      tk.q[t] = mass_entry(expf(log_prob(tk.xs[t], m, log_s)));
      tk.vkey[t] = order_bits(typical_distance(tk.xs[t], m, log_s, h));
    }
    radix_select<false>(tk, n, j0, 0, p.typical_thr, s, cluster, rank, prefix, shift);
    for (int t = threadIdx.x; t < n; t += kThreads) {
      if ((tk.vkey[t] >> shift) > prefix) tk.xs[t] = -INFINITY;
    }
  }

  if (p.top_p_on) {
    float m = -INFINITY;
    for (int t = threadIdx.x; t < n; t += kThreads) m = fmaxf(m, tk.xs[t]);
    m = row_max(m, s, slot++, cluster, rank);
    const float* xs = tk.xs;
    const float sum = row_sum([&](int t) { return expf(__fsub_rn(xs[t], m)); }, n, s, slot++,
                              cluster, rank);
    for (int t = threadIdx.x; t < n; t += kThreads) {
      tk.q[t] = mass_entry(__fdiv_rn(expf(__fsub_rn(tk.xs[t], m)), sum));
      tk.vkey[t] = order_bits(tk.xs[t]);
    }
    radix_select<true>(tk, n, j0, p.index_bits, p.top_p_thr, s, cluster, rank, prefix, shift);
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const unsigned long long k =
          (static_cast<unsigned long long>(tk.vkey[t]) << p.index_bits) |
          static_cast<unsigned>(j0 + t);
      if ((k >> shift) < prefix) tk.xs[t] = -INFINITY;
    }
  }

  sample_row([&](int t) { return tk.xs[t]; }, n, j0, r, p, s, cluster, rank, seen_row, codes,
             lengths, finished, tok_out, key);
}

// The wide path (V > 8 x kCtaVocab): the same filters and draw as
// sample_step_kernel, each pass over a CTA's chunk computing a token's value
// from the first ``p.cache`` tokens kept in shared memory, or else from the
// logit and seen bit in global memory, by one function of the two.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sample_step_kernel_wide(const T* __restrict__ logits, uint8_t* __restrict__ seen,
                            long long* __restrict__ codes, long long* __restrict__ lengths,
                            uint8_t* __restrict__ finished, long long* __restrict__ tok_out,
                            const uint32_t* __restrict__ key, const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Slots s;
  __shared__ unsigned bcount[kBins];
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int V = p.vocab;
  const int rank = static_cast<int>(cluster.block_rank());
  const int r = blockIdx.x / kCluster;
  const int j0 = rank * p.chunk;
  const int n = max(0, min(p.chunk, V - j0));
  const int nc = min(n, p.cache);  // the tokens kept in shared memory
  WideHist w;
  w.mass = reinterpret_cast<unsigned long long*>(smem);
  w.recv_mass = w.mass + kWarps * kBins;
  w.count = reinterpret_cast<unsigned*>(w.recv_mass + 2 * kCluster * kBins);
  w.recv_count = w.count + kWarps * kBins;
  float* xs = reinterpret_cast<float*>(w.recv_count + 2 * kCluster * kBins);
  const T* row = logits + static_cast<long long>(r) * V;
  uint8_t* seen_row = seen + static_cast<long long>(r) * V;

  for (int t = threadIdx.x; t < nc; t += kThreads) xs[t] = scaled_logit(row, seen_row, j0 + t, p);
  if (p.typical_on || p.top_p_on) {
    for (int i = threadIdx.x; i < kWarps * kBins; i += kThreads) {
      w.mass[i] = 0;
      w.count[i] = 0;
    }
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // every CTA has started
  const auto x_of = [&](int t) {
    return t < nc ? xs[t] : scaled_logit(row, seen_row, j0 + t, p);
  };

  int slot = 0;
  // typical: removed where the key of |-log p - H| lies above the boundary
  float tm = 0.0f, tls = 0.0f, th = 0.0f;
  unsigned long long tprefix = 0;
  int tshift = 0;
  if (p.typical_on) {
    float m = -INFINITY;
    for (int t = threadIdx.x; t < n; t += kThreads) m = fmaxf(m, x_of(t));
    tm = row_max(m, s, slot++, cluster, rank);
    tls = logf(row_sum([&](int t) { return expf(__fsub_rn(x_of(t), tm)); }, n, s, slot++,
                       cluster, rank));
    th = -row_sum(
        [&](int t) {
          const float lp = log_prob(x_of(t), tm, tls), pj = expf(lp);
          return pj > 0.0f ? __fmul_rn(pj, lp) : 0.0f;
        },
        n, s, slot++, cluster, rank);
    radix_select_wide<false>(
        [&](int t) {
          return static_cast<unsigned long long>(
              order_bits(typical_distance(x_of(t), tm, tls, th)));
        },
        [&](int t) { return wide_mass(expf(log_prob(x_of(t), tm, tls))); }, n, 32,
        p.typical_thr, w, s, bcount, cluster, rank, tprefix, tshift);
  }
  const auto x_typical = [&](int t) {
    const float x = x_of(t);
    if (!p.typical_on) return x;
    const unsigned long long k = order_bits(typical_distance(x, tm, tls, th));
    return (k >> tshift) > tprefix ? -INFINITY : x;
  };

  // top-p: removed where the (value, index) key lies below the boundary
  const auto top_p_key = [&](float x, int t) {
    return (static_cast<unsigned long long>(order_bits(x)) << p.index_bits) |
           static_cast<unsigned>(j0 + t);
  };
  unsigned long long pprefix = 0;  // nothing removed unless top-p is on
  int pshift = 0;
  if (p.top_p_on) {
    float m = -INFINITY;
    for (int t = threadIdx.x; t < n; t += kThreads) m = fmaxf(m, x_typical(t));
    m = row_max(m, s, slot++, cluster, rank);
    const float sum = row_sum([&](int t) { return expf(__fsub_rn(x_typical(t), m)); }, n, s,
                              slot++, cluster, rank);
    radix_select_wide<true>(
        [&](int t) { return top_p_key(x_typical(t), t); },
        [&](int t) { return wide_mass(__fdiv_rn(expf(__fsub_rn(x_typical(t), m)), sum)); },
        n, 32 + p.index_bits, p.top_p_thr, w, s, bcount, cluster, rank, pprefix, pshift);
  }

  sample_row(
      [&](int t) {
        const float x = x_typical(t);
        return (top_p_key(x, t) >> pshift) < pprefix ? -INFINITY : x;
      },
      n, j0, r, p, s, cluster, rank, seen_row, codes, lengths, finished, tok_out, key);
}

__global__ void empty_kernel() {}

// A fixed-point threshold: cum >= thr (at_least) or cum > thr on sums of
// masses at ``scale`` units to 1 (mass_entry's, or wide_mass's), as the
// float comparison with ``thr`` decides them.  No row's masses sum to 8.
unsigned long long fixed_threshold(float thr, bool at_least, double scale) {
  if (!(thr > 0.0f)) return 0;  // at_least: every cum passes
  const double x = std::fmin(static_cast<double>(thr) * scale, 8.0 * scale);
  return static_cast<unsigned long long>(at_least ? std::ceil(x) : std::floor(x));
}

cudaLaunchConfig_t cluster_config(int batch, size_t bytes, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The wide path's tokens kept in shared memory a CTA, found once: what the
// block's opt-in shared memory holds beside its static slots and the
// histograms; and a check that a cluster of CTAs that size can be scheduled.
template <typename T>
int wide_cache_tokens(cudaStream_t stream, int* tokens) {
  static int cache = -1;
  if (cache < 0) {
    const auto kernel = sample_step_kernel_wide<T>;
    int dev = 0, optin = 0;
    cudaFuncAttributes fa;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    const long long room =
        optin - static_cast<long long>(fa.sharedSizeBytes) - static_cast<long long>(kWideHistBytes);
    if (room < 16) return static_cast<int>(cudaErrorLaunchOutOfResources);
    const int n = static_cast<int>(room / 16 * 4);
    const size_t most = kWideHistBytes + 4 * static_cast<size_t>(n);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(1, most, stream, &attr);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    cache = n;
  }
  *tokens = cache;
  return 0;
}

template <typename T>
int launch(const void* logits, const Params& p, int batch, void* seen, void* codes,
           void* lengths, void* finished, void* tok, const void* key, cudaStream_t stream) {
  const bool filters = p.typical_on || p.top_p_on;
  cudaLaunchAttribute attr;
  cudaError_t e;
  if (p.chunk > kCtaVocab) {  // the wide path
    int cache = 0;
    const int rc = wide_cache_tokens<T>(stream, &cache);
    if (rc != 0) return rc;
    Params q = p;
    q.cache = filters ? (p.chunk < cache ? p.chunk : cache) : 0;
    const size_t bytes = filters ? kWideHistBytes + 4 * static_cast<size_t>(q.cache) : 0;
    cudaLaunchConfig_t cfg = cluster_config(batch, bytes, stream, &attr);
    e = cudaLaunchKernelEx(&cfg, sample_step_kernel_wide<T>, static_cast<const T*>(logits),
                           static_cast<uint8_t*>(seen), static_cast<long long*>(codes),
                           static_cast<long long*>(lengths), static_cast<uint8_t*>(finished),
                           static_cast<long long*>(tok), static_cast<const uint32_t*>(key), q);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  // once: the shared memory of the largest row, and a check that a cluster
  // of that size can be scheduled (then so can every smaller one)
  static bool configured = false;
  const auto kernel = sample_step_kernel<T>;
  if (!configured) {
    const size_t most = smem_bytes(kCtaVocab, true);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = cluster_config(1, most, stream, &attr);
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    configured = true;
  }
  cudaLaunchConfig_t cfg = cluster_config(batch, smem_bytes(p.chunk, filters), stream, &attr);
  e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(logits), static_cast<uint8_t*>(seen),
      static_cast<long long*>(codes), static_cast<long long*>(lengths),
      static_cast<uint8_t*>(finished), static_cast<long long*>(tok),
      static_cast<const uint32_t*>(key), p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One decode step of ``batch`` rows of ``vocab`` logits (``dtype`` 0 bf16,
// 1 fp32; every pointer to contiguous device memory; any vocab >= 1, on
// the wide path past 65536), each row over a cluster of 8 CTAs: writes the (B,)
// int64 tokens to ``tok`` and updates ``seen`` (B, vocab) bool, ``codes``
// (B, code_stride) int64 at column ``step``, ``lengths`` (B,) int64 and
// ``finished`` (B,) bool in place.  ``key`` is the step's int32 (2,) device key; row r draws
// at flat indices offset + r * vocab + j.  ``mass`` is float32(typical
// mass), ``top_p_thr`` float32(1 - top_p).  Returns a CUDA error code (0:
// launched); a cluster that cannot be scheduled is refused.
extern "C" int sample_step(const void* logits, int dtype, void* seen, void* codes,
                           void* lengths, void* finished, void* tok, const void* key,
                           int batch, int vocab, int code_stride, int step, int penalty_on,
                           float penalty, int temperature_on, float temperature,
                           int typical_on, float mass, int top_p_on, float top_p_thr,
                           int stop, int force_full, unsigned long long offset,
                           void* stream) {
  if (batch <= 0) return 0;
  if (vocab < 1 || step < 0 || step >= code_stride || stop < 0 || stop >= vocab) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.vocab = vocab;
  p.code_stride = code_stride;
  p.step = step;
  p.stop = stop;
  p.chunk = (vocab + kCluster - 1) / kCluster;
  p.index_bits = vocab > 1 ? 32 - __builtin_clz(static_cast<unsigned>(vocab - 1)) : 0;
  p.cache = 0;
  p.penalty_on = penalty_on != 0;
  p.temperature_on = temperature_on != 0;
  p.typical_on = typical_on != 0;
  p.top_p_on = top_p_on != 0;
  p.force_full = force_full != 0;
  p.penalty = penalty;
  p.temperature = temperature;
  // the masses' unit: 2^-40 on the shared path, 2^-60 on the wide one
  const double scale = p.chunk <= kCtaVocab ? 1099511627776.0 : 1152921504606846976.0;
  p.typical_thr = fixed_threshold(mass, true, scale);
  p.top_p_thr = fixed_threshold(top_p_thr, false, scale);
  p.offset = offset;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<__nv_bfloat16>(logits, p, batch, seen, codes, lengths, finished, tok, key, s);
    case 1:
      return launch<float>(logits, p, batch, seen, codes, lengths, finished, tok, key, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch's shape: the CTAs a row and the threads a CTA.
extern "C" int sample_step_shape(int* cluster, int* threads) {
  *cluster = kCluster;
  *threads = kThreads;
  return 0;
}

// An empty kernel on the sample step's grid (``batch`` clusters of 8 CTAs of
// kThreads threads): its launch-to-launch time is the floor a launch of the
// step meets.
extern "C" int sample_step_floor(int batch, void* stream) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(batch, 0, static_cast<cudaStream_t>(stream), &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, empty_kernel);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

extern "C" const char* sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
