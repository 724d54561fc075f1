// The decode step's sampler for Hopper (sm_90a), CUDA C++ with plain C
// entries: one launch a step does what the JAX package's ``body_fn``
// (detail_tts_tpu/models/gpt.py:356-377) does around the GPT's logits, which
// XLA lowers with no ``pallas_call``: ``sample_token``
// (detail_tts_tpu/ops/sampling.py:86: repetition penalty, temperature,
// typical filtering, top-p, ``jax.random.categorical``) and the step's
// bookkeeping (the stop token for finished rows, ``codes[:, step]``,
// ``seen[r, tok]``, ``lengths``, ``finished``).
//
// Two kernels, one a launch:
//
// * ``sample_step_kernel`` (V <= 8 x kCtaVocab = 65,536, the decode's
//   8194 among them): a row over a thread-block cluster of kCluster = 8
//   CTAs of kThreads threads, CTA c owning the row's tokens [c chunk, (c +
//   1) chunk), chunk = ceil(V / 8), held in shared memory, 16 B a token
//   (the logit, its key's value bits, its fixed-point mass).  B rows are 8
//   B CTAs, one wave of an H100's 132 SMs up to B = 16; past that the grid
//   wraps.  The CTAs meet through distributed shared memory: each pushes its
//   partials into every CTA's slots and a ``cluster.sync()`` publishes them.
//   Each CTA arrives at a cluster barrier on entry and waits on it after
//   loading its tokens, before its first push, so no CTA writes into one
//   that has not started.  Thread t of a CTA owns its tokens t, t +
//   kThreads, ... in every pass.
// * ``sample_step_kernel_wide`` (every larger V, up to the C entry's int
//   2^31 - 1): a row over a group of G CTAs, G = min(SMs, ceil(V /
//   kWideMinChunk)), a function of V and of the card only, never of B (the
//   float sums run in a fixed order over the CTAs, so a row's token must
//   not depend on its batch mates).  The grid is a cooperative launch of
//   as many groups as the card holds at once, up to B; a group takes rows
//   g, g + groups, ... in turn (a persistent grid).  A grid that cannot be
//   co-resident (the occupancy call finds fewer than G CTAs' room) is
//   refused.  The first pass reads the CTA's chunk of the row from global
//   memory once, applies the penalty and the temperature, and keeps up to
//   ``Wide.cache`` of the tokens in shared memory (44,672 a CTA on an H100,
//   4 B a token: 132 CTAs hold ~5.9 M); every later pass reads them there
//   and re-reads only the rest (V past ~5.9 M), one token a thread at a
//   time, which is likely in L2.  The first read takes the body of the
//   CTA's chunk in 16-token units, each 16-byte loads of its logits and seen
//   bytes; row r starts at element r V, so the body starts at the first
//   token whose seen byte lies on a 16-byte boundary, and a head and a tail
//   are read one token at a time.  That read only caches and takes the max,
//   which is exact in any order; every later pass gives thread i the same
//   tokens (its cached ones i, i + kThreads, ..., then the rest likewise),
//   whatever the row's alignment or batch, so its float sums run in one
//   order.  Every pass recomputes a token's value, key and mass from its
//   penalized, tempered logit by the same code for a cached and a re-read
//   token, so a token the typical filter removed is recognised again by its
//   key against the boundary.
//
//   The group's CTAs meet through a workspace in global memory, one block
//   a group: a barrier (a counter that each CTA adds one to and waits on
//   until it reaches the next multiple of G; the launch is cooperative, so
//   all G are resident and the spin ends), each CTA's float partials in a
//   slot of its own, read back and combined in CTA order, and three
//   256-bin histograms (mass and count) used in turn, into which each CTA
//   adds its non-empty bins with integer atomics (exact in any order).
//   The workspace belongs to the library: one per (device, stream) pair,
//   allocated and cleared at the pair's first wide launch (launches on one
//   stream run in order, so two launches never share one at once), sized
//   for as many groups as the card holds at once, and left as it was found
//   at the end of each launch (the last CTA of a group to leave clears its
//   barrier and histograms).  A stream must not be destroyed while a wide
//   launch on it may run: a new stream given its handle would share the
//   workspace.
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
// warp's in shared memory, on the wide path as 32-bit words: shared memory
// adds those natively, and a 64-bit atomic there is a compare-and-swap loop;
// the warps' and then the CTAs' added),
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
// thread holds a few tokens.  The wide path reads the row from HBM once,
// with up to every SM of the card on it; its later passes walk shared
// memory, and each exchange is a barrier in global memory (about a
// microsecond), so at a V of a few hundred thousand the barriers set its
// time and at V in the millions the first read and the passes over ~50,000
// tokens a CTA do.  It is not a path the decode runs at ``Config()``, and no
// configuration of this repository sends a V past 65,536: V in the millions
// are cases it is held correct at, not shapes it is tuned for.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <mutex>
#include <utility>
#include <vector>

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

// ---------------------------------------------------------------- the wide path

// A wide row's CTAs: one for every kWideMinChunk tokens, up to every SM.  At
// the least wide V (65,537), where the barriers set the time, fewer and
// larger chunks were slower on an H100: top-p took 1.5x as long at 4096 and
// 2.2x at 8192 (PERF.md).
constexpr int kWideMinChunk = 2048;
constexpr int kWideMaxCtas = 256;  // a group's slots in the workspace
constexpr int kUnit = 16;     // tokens of one 16-byte load of seen flags
constexpr int kWideBufs = 3;  // the group's histograms in global memory, used in turn
// each warp's histogram in shared memory: two mass words and a count word a bin
constexpr size_t kWideHistBytes = 3 * 4 * static_cast<size_t>(kWarps * kBins);

// A group's block of the workspace: the barrier's count at 0 and the count
// of CTAs that have left at 128 (each on a line of its own), the histograms'
// masses [kWideBufs][kBins] and counts [kWideBufs][kBins], the float
// partials [kExchanges][kWideMaxCtas], and the argmax's values and indices
// [2][kWideMaxCtas] (by the parity of the group's row).
constexpr size_t kWsMass = 256;
constexpr size_t kWsCount = kWsMass + 8 * kWideBufs * kBins;
constexpr size_t kWsPartial = kWsCount + 4 * kWideBufs * kBins;
constexpr size_t kWsBestVal = kWsPartial + 4 * kExchanges * kWideMaxCtas;
constexpr size_t kWsBestIdx = kWsBestVal + 4 * 2 * kWideMaxCtas;
constexpr size_t kWsGroupBytes = (kWsBestIdx + 4 * 2 * kWideMaxCtas + 127) / 128 * 128;

// The wide launch's shape and workspace (``groups`` blocks of kWsGroupBytes).
struct Wide {
  unsigned char* ws;
  int ctas, groups, batch;  // G CTAs a row; rows in flight; rows
  int chunk;                // tokens a CTA: ceil(V / G)
  int cache;                // tokens a CTA keeps in shared memory: its chunk, or a multiple of 32
};

struct GroupWs {
  unsigned* barrier;
  unsigned* left;
  unsigned long long* mass;
  unsigned* count;
  float* partial;
  float* best_val;
  int* best_idx;
};

__device__ __forceinline__ GroupWs group_ws(unsigned char* b) {
  return GroupWs{reinterpret_cast<unsigned*>(b), reinterpret_cast<unsigned*>(b + 128),
                 reinterpret_cast<unsigned long long*>(b + kWsMass),
                 reinterpret_cast<unsigned*>(b + kWsCount), reinterpret_cast<float*>(b + kWsPartial),
                 reinterpret_cast<float*>(b + kWsBestVal), reinterpret_cast<int*>(b + kWsBestIdx)};
}

// The CTA's small slots on the wide path (static shared memory).
struct WideSlots {
  float red[kWarps];                  // block reductions
  float parts[kWideMaxCtas];          // the group's partials, read back
  float value;                        // a combined value, broadcast
  unsigned long long wscan[kWarps];   // the warps' bin totals
  unsigned long long bexcl[kBins];    // each bin's exclusive prefix
  unsigned bcount[kBins];             // and count
  unsigned wfirst[kWarps], wlast[kWarps];
  float warp_val[kWarps];
  int warp_idx[kWarps];
  int last;
};

// One CTA's share of one row.
template <typename T>
struct WideRow {
  const T* logits;      // the CTA's first logit
  const uint8_t* seen;  // and seen flag
  unsigned xs;          // the cached tokens, penalized and tempered (at swizzle(t)): a shared address
  int n, nc;            // the CTA's tokens and how many of them are cached
};

#ifdef SAMPLE_TRACE
// Built with SAMPLE_TRACE defined (ab_serving_kernel.py --sample --trace):
// clock64 stamps of CTA 0's thread 0 at the wide kernel's phases, tagged 1
// start, 2 first read, 3 arrival at a group barrier, 4 release from it, 5
// end of a radix sweep, 6 draw, 7 end; read back with sample_trace_read.
__device__ unsigned long long g_trace[1024];
__device__ unsigned g_trace_n;
#define TRACE(tag)                                                              \
  do {                                                                          \
    if (blockIdx.x == 0 && threadIdx.x == 0 && g_trace_n < 512) {               \
      g_trace[2 * g_trace_n] = (tag);                                           \
      g_trace[2 * g_trace_n + 1] = clock64();                                   \
      ++g_trace_n;                                                              \
    }                                                                           \
  } while (0)
#else
#define TRACE(tag) \
  do {             \
  } while (0)
#endif

// Shared memory by its 32-bit address, taken once: a generic pointer into
// it makes each access recompute the CTA's window (S2R SR_CgaCtaId on sm_90).
__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float load_shared(unsigned a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void store_shared(unsigned a, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(a), "f"(v) : "memory");
}

__device__ __forceinline__ void store_shared4(unsigned a, float x, float y, float z, float w) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a), "f"(x), "f"(y), "f"(z),
               "f"(w)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Every CTA of the group arrives and waits for the rest.  Thread 0 adds one
// to the count with release semantics (after the CTA's barrier, so the
// CTA's writes go before it) and waits with acquiring loads until it
// reaches G times the barriers so far (``passed``, thread 0's): the count
// starts at 0 in each launch and every barrier takes exactly G arrivals.
// The launch is cooperative, so all G CTAs are resident and the wait ends.
__device__ __forceinline__ void group_sync(unsigned* count, int ctas, unsigned& passed) {
  __syncthreads();
  if (threadIdx.x == 0) {
    TRACE(3);
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
    passed += ctas;
    while (load_acquire(count) < passed) {
    }
    TRACE(4);
  }
  __syncthreads();
}

// Where cached token t lives: 4-token blocks permuted inside each 32-token
// group, so that a warp's reads of tokens t, t + 1, ..., t + 31 and its
// 16-byte stores of units of 16 tokens meet no bank conflict.
__device__ __forceinline__ int swizzle(int t) {
  const int q = t >> 2;
  return ((q ^ ((q >> 3) & 7)) << 2) | (t & 3);
}

// A logit after the repetition penalty and the temperature, as scaled_logit.
__device__ __forceinline__ float penalize(float x, uint32_t seen_flag, const Params& p) {
  if (p.penalty_on && seen_flag) x = x > 0.0f ? __fdiv_rn(x, p.penalty) : __fmul_rn(x, p.penalty);
  if (p.temperature_on) x = __fdiv_rn(x, p.temperature);
  return x;
}

// 16 logits from 16-byte loads of 16-byte aligned memory.
__device__ __forceinline__ void load_unit(const float* a, float (&x)[kUnit]) {
  const float4* v = reinterpret_cast<const float4*>(a);
#pragma unroll
  for (int i = 0; i < kUnit / 4; ++i) {
    const float4 f = __ldg(v + i);
    x[4 * i] = f.x;
    x[4 * i + 1] = f.y;
    x[4 * i + 2] = f.z;
    x[4 * i + 3] = f.w;
  }
}

__device__ __forceinline__ void load_unit(const __nv_bfloat16* a, float (&x)[kUnit]) {
  const uint4* v = reinterpret_cast<const uint4*>(a);
#pragma unroll
  for (int i = 0; i < kUnit / 8; ++i) {
    const uint4 q = __ldg(v + i);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[8 * i + 2 * k] = __uint_as_float(w[k] << 16);
      x[8 * i + 2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
    }
  }
}

// The one read of the CTA's tokens from global memory: each penalized and
// tempered, the first nc kept in the cache, and their max returned.  The body
// goes in units of 16 tokens, each 16-byte loads of its logits and of its seen
// flags; it starts at the first token whose seen flag lies on a 16-byte
// boundary (row r starts at element r V, so a head of up to 15 tokens goes
// before it), and the head and the tail are read one token at a time.  The
// max is exact in any order, so the row's alignment changes nothing.
template <typename T>
__device__ float first_read(const WideRow<T>& rw, const Params& p) {
  float m = -INFINITY;
  const auto keep = [&](int t, float x) {
    if (t < rw.nc) store_shared(rw.xs + 4 * swizzle(t), x);
    m = fmaxf(m, x);
  };
  int head = static_cast<int>((0 - reinterpret_cast<uintptr_t>(rw.seen)) & 15);
  if (head > rw.n || (reinterpret_cast<uintptr_t>(rw.logits + head) & 15) != 0) {
    head = rw.n;  // the logits and the flags are not aligned alike: all one by one
  }
  const int units = (rw.n - head) / kUnit, tail = head + units * kUnit;
  for (int t = threadIdx.x; t < head; t += kThreads) keep(t, scaled_logit(rw.logits, rw.seen, t, p));
  for (int t = tail + threadIdx.x; t < rw.n; t += kThreads) {
    keep(t, scaled_logit(rw.logits, rw.seen, t, p));
  }
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const int t0 = head + u * kUnit;
    float x[kUnit];
    load_unit(rw.logits + t0, x);
    uint4 f = make_uint4(0u, 0u, 0u, 0u);
    if (p.penalty_on) f = __ldg(reinterpret_cast<const uint4*>(rw.seen + t0));
    const uint32_t fw[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int k = 0; k < kUnit; ++k) x[k] = penalize(x[k], (fw[k >> 2] >> (8 * (k & 3))) & 0xFFu, p);
    if ((t0 & 3) == 0 && t0 + kUnit <= rw.nc) {
#pragma unroll
      for (int i = 0; i < kUnit / 4; ++i) {
        store_shared4(rw.xs + 4 * swizzle(t0 + 4 * i), x[4 * i], x[4 * i + 1], x[4 * i + 2],
                      x[4 * i + 3]);
      }
#pragma unroll
      for (int k = 0; k < kUnit; ++k) m = fmaxf(m, x[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kUnit; ++k) keep(t0 + k, x[k]);
    }
  }
  return m;
}

// f(t, x) for each of the CTA's tokens t, x its penalized, tempered logit:
// thread i takes its cached tokens i, i + kThreads, ... from shared memory,
// then the rest, nc + i, nc + i + kThreads, ..., from global memory.  The
// order is the same in every pass and whatever the row's alignment or batch,
// so a thread's float sums run in one order.
template <typename T, typename F>
__device__ __forceinline__ void each_token(const WideRow<T>& rw, const Params& p, F f) {
  for (int t = threadIdx.x; t < rw.nc; t += kThreads) f(t, load_shared(rw.xs + 4 * swizzle(t)));
  for (int t = rw.nc + threadIdx.x; t < rw.n; t += kThreads) {
    f(t, scaled_logit(rw.logits, rw.seen, t, p));
  }
}

// Adds a candidate's mass word (< 2^61) and a count of one to its bin of the
// warp's histogram (``h``, the shared address of its low words, then its high
// words and its counts, kBins each) with 32-bit atomics, which shared memory
// does natively (a 64-bit one is a compare-and-swap loop): the low word, its
// carry (seen in the old value returned) with the high word, and the count.
// The sums are exact in any order: a bin's mass is high 2^32 + low.
__device__ __forceinline__ void hist_add(unsigned bin, unsigned long long q, unsigned h) {
  const unsigned a = h + 4 * bin, l = static_cast<unsigned>(q);
  unsigned old;
  asm volatile("atom.shared.add.u32 %0, [%1], %2;" : "=r"(old) : "r"(a), "r"(l) : "memory");
  const unsigned hi = static_cast<unsigned>(q >> 32) + (old + l < old ? 1u : 0u);
  asm volatile("red.shared.add.u32 [%0], %1;" ::"r"(a + 4 * kBins), "r"(hi) : "memory");
  asm volatile("red.shared.add.u32 [%0], 1;" ::"r"(a + 8 * kBins) : "memory");
}

// The CTA's sum (max) of v: each warp's butterfly, then over the warps, as
// row_sum (row_max); the same value in every thread.
__device__ __forceinline__ float cta_sum(float v, WideSlots& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();  // red is free
  if (lane == 0) s.red[warp] = v;
  __syncthreads();
  return warp_sum(lane < kWarps ? s.red[lane] : 0.0f);
}

__device__ __forceinline__ float cta_max(float v, WideSlots& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();  // red is free
  if (lane == 0) s.red[warp] = v;
  __syncthreads();
  return warp_max(lane < kWarps ? s.red[lane] : -INFINITY);
}

// One float a CTA combined over the group: CTA c's ``v`` into slot c, then
// each CTA reads the G slots and folds them with ``op`` in CTA order.
template <typename Op>
__device__ float group_combine(float v, float* slots, const GroupWs& g, int c, int ctas,
                               unsigned& passed, WideSlots& s, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) __stcg(slots + c, v);
  group_sync(g.barrier, ctas, passed);
  if (warp == 0) {
    for (int k = lane; k < ctas; k += 32) s.parts[k] = __ldcg(slots + k);
    __syncwarp();
    if (lane == 0) {
      float acc = s.parts[0];
#pragma unroll 8
      for (int k = 1; k < ctas; ++k) acc = op(acc, s.parts[k]);
      s.value = acc;
    }
  }
  __syncthreads();
  return s.value;
}

// The boundary key of one filter by radix select over the group's tokens,
// the passes of radix_select: in each, every thread adds its candidates
// into its warp's histogram (hist_add), the CTA adds its non-empty
// bins into the group's histogram in global memory (buffer ``pass`` %
// kWideBufs, exact in any order), and after the group's barrier every CTA
// scans it.  CTA 0 then clears the buffer that the pass after next adds
// into: every CTA read it before this pass's barrier.  ``key_of(t, x)`` and
// ``mass_of(t, x)`` give a token's key and mass word (the latter only for a
// token whose key matches the prefix); ``total_bits``: the key's width.
template <bool kTopP, typename T, typename KeyFn, typename MassFn>
__device__ void radix_select_group(const WideRow<T>& rw, const Params& p, KeyFn key_of,
                                   MassFn mass_of, int total_bits, unsigned long long thr,
                                   unsigned* hist, const GroupWs& g, int c, int ctas,
                                   unsigned& passed, int& pass, WideSlots& s,
                                   unsigned long long& prefix_out, int& shift_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // this warp's histogram: the masses' low and high words, the counts
  const unsigned wh = shared_addr(hist + warp * 3 * kBins);
  unsigned long long prefix = 0, carried = 0;  // carried: the mass below the prefix
  int shift = total_bits;
  while (shift > 0) {
    const int bits = min(kRadixBits, shift);
    shift -= bits;
    const unsigned long long digit = (1ULL << bits) - 1;
    each_token(rw, p, [&](int t, float x) {
      const unsigned long long key = key_of(t, x);
      if ((key >> (shift + bits)) != prefix) return;
      const unsigned long long q = mass_of(t, x);
      if (kTopP && q == 0) return;
      hist_add(static_cast<unsigned>((key >> shift) & digit), q, wh);
    });
    TRACE(5);
    __syncthreads();
    // the CTA's histogram, the warps' added, into the group's
    unsigned long long* gm = g.mass + (pass % kWideBufs) * kBins;
    unsigned* gc = g.count + (pass % kWideBufs) * kBins;
    const int bin = threadIdx.x;
    if (bin < kBins) {
      unsigned long long h = 0;
      unsigned n = 0;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) {
        unsigned* w = hist + k * 3 * kBins + bin;
        h += (static_cast<unsigned long long>(w[kBins]) << 32) + w[0];
        n += w[2 * kBins];
        w[0] = 0;
        w[kBins] = 0;
        w[2 * kBins] = 0;
      }
      if (n != 0) {
        atomicAdd(gm + bin, h);
        atomicAdd(gc + bin, n);
      }
    }
    group_sync(g.barrier, ctas, passed);
    // the group's histogram and its inclusive scan
    unsigned long long h = 0, excl = 0;
    unsigned n = 0;
    if (bin < kBins) {
      h = __ldcg(gm + bin);
      n = __ldcg(gc + bin);
      if (c == 0) {
        const int clear = (pass + 2) % kWideBufs;
        g.mass[clear * kBins + bin] = 0;
        g.count[clear * kBins + bin] = 0;
      }
      unsigned long long incl = h;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) s.wscan[warp] = incl;
      excl = incl - h;
    }
    ++pass;
    __syncthreads();
    if (bin < kBins) {
      for (int v = 0; v < warp; ++v) excl += s.wscan[v];
      s.bexcl[bin] = excl;
      s.bcount[bin] = n;
      const unsigned long long cum = carried + excl + h;
      const unsigned first = n != 0 && (kTopP ? cum > thr : cum >= thr) ? bin : kBins;
      const unsigned last = n != 0 ? bin + 1 : 0;  // one past the last non-empty bin
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
    if (s.bcount[b] == 1) break;  // one candidate left: the boundary
  }
  prefix_out = prefix;
  shift_out = shift;
}

// The wide path (V > 8 x kCtaVocab): the filters and the draw of
// sample_step_kernel, a row over the G CTAs of a group (see the header).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sample_step_kernel_wide(const T* __restrict__ logits, uint8_t* __restrict__ seen,
                            long long* __restrict__ codes, long long* __restrict__ lengths,
                            uint8_t* __restrict__ finished, long long* __restrict__ tok_out,
                            const uint32_t* __restrict__ key, const Params p, const Wide w) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ WideSlots s;
#ifdef SAMPLE_TRACE
  if (blockIdx.x == 0 && threadIdx.x == 0) g_trace_n = 0;
#endif
  TRACE(1);
  const int V = p.vocab, G = w.ctas;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = static_cast<int>(blockIdx.x) % G, group = static_cast<int>(blockIdx.x) / G;
  const GroupWs g = group_ws(w.ws + static_cast<long long>(group) * kWsGroupBytes);
  unsigned* hist = reinterpret_cast<unsigned*>(smem);  // [kWarps][3][kBins]: hist_add's words
  float* xs = reinterpret_cast<float*>(hist + kWarps * 3 * kBins);
  for (int i = threadIdx.x; i < kWarps * 3 * kBins; i += kThreads) hist[i] = 0;
  const uint32_t k0 = __ldg(key), k1 = __ldg(key + 1);
  const int j0 = c * w.chunk;                  // this CTA's first token
  const int n = max(0, min(w.chunk, V - j0));  // its count
  unsigned passed = 0;                         // thread 0: the group's arrivals awaited so far
  int pass = 0;                                // the group's histogram passes so far
  for (int r = group, it = 0; r < w.batch; r += w.groups, ++it) {
    const long long row = static_cast<long long>(r) * V + j0;
    const WideRow<T> rw{logits + row, seen + row, shared_addr(xs), n, min(n, w.cache)};

    // the one read from global memory: penalty and temperature, the cache,
    // the row max
    const float m = first_read(rw, p);
    __syncthreads();  // the cache is written
    TRACE(2);

    const bool filters = p.typical_on || p.top_p_on;
    int slot = 0;
    const auto sum_op = [](float a, float b) { return __fadd_rn(a, b); };
    const auto max_op = [](float a, float b) { return fmaxf(a, b); };
    float m0 = 0.0f;
    if (filters) {
      m0 = group_combine(cta_max(m, s), g.partial + kWideMaxCtas * slot++, g, c, G, passed, s,
                         max_op);
    }

    // typical: removed where the key of |-log p - H| lies above the boundary
    float tls = 0.0f, th = 0.0f;
    unsigned long long tprefix = 0;
    int tshift = 0;
    if (p.typical_on) {
      float v = 0.0f;
      each_token(rw, p, [&](int, float x) { v = __fadd_rn(v, expf(__fsub_rn(x, m0))); });
      tls = logf(group_combine(cta_sum(v, s), g.partial + kWideMaxCtas * slot++, g, c, G, passed,
                               s, sum_op));
      v = 0.0f;
      each_token(rw, p, [&](int, float x) {  // the entropy
        const float lp = log_prob(x, m0, tls), pj = expf(lp);
        v = __fadd_rn(v, pj > 0.0f ? __fmul_rn(pj, lp) : 0.0f);
      });
      th = -group_combine(cta_sum(v, s), g.partial + kWideMaxCtas * slot++, g, c, G, passed, s,
                          sum_op);
      radix_select_group<false>(
          rw, p,
          [&](int, float x) {
            return static_cast<unsigned long long>(order_bits(typical_distance(x, m0, tls, th)));
          },
          [&](int, float x) { return wide_mass(expf(log_prob(x, m0, tls))); }, 32,
          p.typical_thr, hist, g, c, G, passed, pass, s, tprefix, tshift);
    }
    const auto x_typical = [&](float x) {
      if (!p.typical_on) return x;
      const unsigned long long k = order_bits(typical_distance(x, m0, tls, th));
      return (k >> tshift) > tprefix ? -INFINITY : x;
    };

    // top-p: removed where the (value, index) key lies below the boundary
    const auto top_p_key = [&](float x, int t) {
      return (static_cast<unsigned long long>(order_bits(x)) << p.index_bits) |
             (static_cast<unsigned>(j0) + static_cast<unsigned>(t));
    };
    unsigned long long pprefix = 0;
    int pshift = 0;
    if (p.top_p_on) {
      float pm = m0;  // the max after typical filtering
      if (p.typical_on) {
        float v = -INFINITY;
        each_token(rw, p, [&](int, float x) { v = fmaxf(v, x_typical(x)); });
        pm = group_combine(cta_max(v, s), g.partial + kWideMaxCtas * slot++, g, c, G, passed, s,
                           max_op);
      }
      float v = 0.0f;
      each_token(rw, p, [&](int, float x) { v = __fadd_rn(v, expf(__fsub_rn(x_typical(x), pm))); });
      const float sum = group_combine(cta_sum(v, s), g.partial + kWideMaxCtas * slot++, g, c, G,
                                      passed, s, sum_op);
      radix_select_group<true>(
          rw, p, [&](int t, float x) { return top_p_key(x_typical(x), t); },
          [&](int, float x) {
            return wide_mass(__fdiv_rn(expf(__fsub_rn(x_typical(x), pm)), sum));
          },
          32 + p.index_bits, p.top_p_thr, hist, g, c, G, passed, pass, s, pprefix,
          pshift);
    }

    // the Gumbels of the kept tokens and the argmax, the first index on ties;
    // -inf is drawn only where every token is (then token 0 wins below)
    const unsigned long long base = p.offset + static_cast<unsigned long long>(r) * V;
    float best = -INFINITY;
    int arg = V;  // none yet
    each_token(rw, p, [&](int t, float x) {
      x = x_typical(x);
      if (x == -INFINITY || (p.top_p_on && (top_p_key(x, t) >> pshift) < pprefix)) return;
      const int j = j0 + t;
      const float v = __fadd_rn(threefry::gumbel(threefry::random_bits(k0, k1, base + j)), x);
      if (v > best || (v == best && j < arg)) {
        best = v;
        arg = j;
      }
    });
    TRACE(6);

    // the CTA's best, then the group's on CTA 0, and the step's bookkeeping
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
    float* best_val = g.best_val + (it & 1) * kWideMaxCtas;
    int* best_idx = g.best_idx + (it & 1) * kWideMaxCtas;
    if (warp == 0) {
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
        __stcg(best_val + c, best);
        __stcg(best_idx + c, arg);
      }
    }
    group_sync(g.barrier, G, passed);
    if (c == 0 && warp == 0) {
      best = -INFINITY;
      arg = V;
      for (int k = lane; k < G; k += 32) {
        const float v = __ldcg(best_val + k);
        const int i = __ldcg(best_idx + k);
        if (v > best || (v == best && i < arg)) {
          best = v;
          arg = i;
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
        if (arg == V) arg = 0;  // every value -inf: torch.argmax's first index
        // the step's bookkeeping (body_fn): finished rows emit the stop token
        const bool done = finished[r] != 0;
        const long long tok = done ? p.stop : arg;
        codes[static_cast<long long>(r) * p.code_stride + p.step] = tok;
        seen[static_cast<long long>(r) * V + tok] = 1;
        if (!done) lengths[r] += 1;
        if (!p.force_full && tok == p.stop) finished[r] = 1;
        tok_out[r] = tok;
      }
    }
  }

  // leave the workspace as it was found: the last CTA of the group to leave
  // (every other one is past its last barrier) clears its barrier and histograms
  TRACE(7);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s.last = atomicAdd(g.left, 1u) == static_cast<unsigned>(G - 1);
  }
  __syncthreads();
  if (s.last) {
    __threadfence();
    for (int i = threadIdx.x; i < kWideBufs * kBins; i += kThreads) {
      g.mass[i] = 0;
      g.count[i] = 0;
    }
    if (threadIdx.x == 0) {
      *g.barrier = 0;
      *g.left = 0;
    }
  }
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

// G, the CTAs of a wide row: a function of V and of the card only.
int wide_ctas(int vocab, int sms) {
  const long long g = (static_cast<long long>(vocab) + kWideMinChunk - 1) / kWideMinChunk;
  return static_cast<int>(std::min<long long>(g, std::min(sms, kWideMaxCtas)));
}

// What the wide kernel needs of a device, found at its first wide launch
// there: the SMs, the most tokens a CTA caches (what the opt-in shared memory
// holds beside the static slots and the histograms), the CTAs an SM holds at
// that shared memory (the occupancy call; a smaller launch fits as many or
// more), the groups a workspace holds (as many as fit at the least G, V =
// 65,537), and a workspace for each stream that launched there.
struct WideDevice {
  int sms = 0;  // 0 until found
  int cache = 0, per_sm = 0, groups = 0;
  std::vector<std::pair<cudaStream_t, unsigned char*>> ws;
};

// The wide launch at (batch, vocab): G, the chunk and the cache, the dynamic
// shared memory, the groups (as many as the card holds at once, up to the
// batch) and, with ``workspace``, the stream's workspace, allocated and
// cleared at its first wide launch.  Launches on one stream run one after
// another, so no two of them use one workspace at once.  A card that cannot
// hold G CTAs at once refuses: the barriers would wait for a CTA that never
// runs.
template <typename T>
int wide_plan(int vocab, int batch, bool workspace, cudaStream_t stream, Wide* w, size_t* smem) {
  const auto kernel = sample_step_kernel_wide<T>;
  static std::mutex mu;
  static WideDevice known[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(mu);
  WideDevice& d = known[dev];
  if (d.sms == 0) {
    int sms = 0, optin = 0, coop = 0, per_sm = 0;
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (!coop) return static_cast<int>(cudaErrorNotSupported);
    const long long room = optin - static_cast<long long>(fa.sharedSizeBytes) -
                           static_cast<long long>(kWideHistBytes);
    if (room < 4 * 32) return static_cast<int>(cudaErrorLaunchOutOfResources);
    const int cache = static_cast<int>(room / 4 / 32 * 32);
    const size_t most = kWideHistBytes + 4 * static_cast<size_t>(cache);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(most));
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, most);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    d.cache = cache;
    d.per_sm = per_sm;
    d.groups = per_sm * sms / wide_ctas(kCluster * kCtaVocab + 1, sms);
    d.sms = sms;
  }
  w->ctas = wide_ctas(vocab, d.sms);
  const int room = d.per_sm * d.sms;
  if (room < w->ctas) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  w->chunk = static_cast<int>((static_cast<long long>(vocab) + w->ctas - 1) / w->ctas);
  w->cache = std::min(w->chunk, d.cache);
  *smem = kWideHistBytes + 4 * static_cast<size_t>((w->cache + 31) / 32 * 32);
  w->groups = std::min(std::min(batch, room / w->ctas), d.groups);
  w->batch = batch;
  w->ws = nullptr;
  if (!workspace) return 0;
  for (const auto& entry : d.ws) {
    if (entry.first == stream) {
      w->ws = entry.second;
      return 0;
    }
  }
  const size_t bytes = static_cast<size_t>(d.groups) * kWsGroupBytes;
  void* ptr = nullptr;
  e = cudaMalloc(&ptr, bytes);
  if (e == cudaSuccess) e = cudaMemsetAsync(ptr, 0, bytes, stream);
  if (e != cudaSuccess) {
    cudaFree(ptr);
    return static_cast<int>(e);
  }
  w->ws = static_cast<unsigned char*>(ptr);
  d.ws.emplace_back(stream, w->ws);
  return 0;
}

template <typename T>
int launch_wide(const void* logits, const Params& p, int batch, void* seen, void* codes,
                void* lengths, void* finished, void* tok, const void* key, cudaStream_t stream) {
  Wide w;
  size_t smem = 0;
  const int rc = wide_plan<T>(p.vocab, batch, true, stream, &w, &smem);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(w.groups * w.ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, sample_step_kernel_wide<T>, static_cast<const T*>(logits),
      static_cast<uint8_t*>(seen), static_cast<long long*>(codes),
      static_cast<long long*>(lengths), static_cast<uint8_t*>(finished),
      static_cast<long long*>(tok), static_cast<const uint32_t*>(key), p, w);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* logits, const Params& p, int batch, void* seen, void* codes,
           void* lengths, void* finished, void* tok, const void* key, cudaStream_t stream) {
  const bool filters = p.typical_on || p.top_p_on;
  cudaLaunchAttribute attr;
  cudaError_t e;
  if (p.chunk > kCtaVocab) {  // the wide path
    return launch_wide<T>(logits, p, batch, seen, codes, lengths, finished, tok, key, stream);
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
// 1 fp32; every pointer to contiguous device memory; any vocab >= 1), each
// row over a cluster of 8 CTAs up to 65536, past it over a group of G CTAs
// (the wide path): writes the (B,) int64 tokens to ``tok`` and updates
// ``seen`` (B, vocab) bool, ``codes`` (B, code_stride) int64 at column
// ``step``, ``lengths`` (B,) int64 and ``finished`` (B,) bool in place.
// ``key`` is the step's int32 (2,) device key; row r draws at flat indices
// offset + r * vocab + j.  ``mass`` is float32(typical mass), ``top_p_thr``
// float32(1 - top_p).  Returns a CUDA error code (0: launched); a cluster
// that cannot be scheduled, or a wide grid that cannot be resident at once,
// is refused.
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
  p.chunk = static_cast<int>((static_cast<long long>(vocab) + kCluster - 1) / kCluster);
  p.index_bits = vocab > 1 ? 32 - __builtin_clz(static_cast<unsigned>(vocab - 1)) : 0;
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

// The wide path's launch at (``batch``, ``vocab``), without launching:
// ``ctas`` (G, the CTAs a row), ``groups`` (the rows in flight) and
// ``cache`` (the tokens a CTA keeps in shared memory).  ``dtype`` as
// sample_step's.
extern "C" int sample_step_wide_shape(int vocab, int batch, int dtype, int* ctas, int* groups,
                                      int* cache) {
  if (vocab <= kCluster * kCtaVocab || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  Wide w;
  size_t smem = 0;
  int rc;
  switch (dtype) {
    case 0: rc = wide_plan<__nv_bfloat16>(vocab, batch, false, nullptr, &w, &smem); break;
    case 1: rc = wide_plan<float>(vocab, batch, false, nullptr, &w, &smem); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  *ctas = w.ctas;
  *groups = w.groups;
  *cache = w.cache;
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

#ifdef SAMPLE_TRACE
// The wide kernel's phase stamps of its last launch: ``out`` gets (tag,
// clock64) pairs, ``n`` their count.
extern "C" int sample_trace_read(unsigned long long* out, unsigned* n) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, g_trace_n, sizeof(unsigned));
  return static_cast<int>(e);
}
#endif
