// The decode step's sampler for Hopper (sm_90a), CUDA C++ with plain C
// entries: one launch a step does what the JAX package's ``body_fn``
// (detail_tts_tpu/models/gpt.py:356-377) does around the GPT's logits, which
// XLA lowers with no ``pallas_call``: ``sample_token``
// (detail_tts_tpu/ops/sampling.py:86: repetition penalty, temperature,
// typical filtering, top-p, ``jax.random.categorical``) and the step's
// bookkeeping (the stop token for finished rows, ``codes[:, step]``,
// ``seen[r, tok]``, ``lengths``, ``finished``).
//
// One CTA of 1024 threads a row; thread t owns tokens t, t + 1024, ...
// in every pass, so it reads back only what it wrote, and the threads meet
// only in the block-wide reductions.  The row's logits are read once from
// device memory (bf16 or fp32, cast exactly as ``.float()`` does) with its
// ``seen`` row, penalised and tempered (IEEE division, as the plain version
// divides), and kept in shared memory; every later pass reads them there:
//
// * typical filtering, when ``mass < 1``: fp32 log-softmax and entropy;
//   the plain version's stable sort of |-logp - H|, its scan of p in that
//   order and the threshold at count(cum < mass) (see below); what lies
//   above the threshold removed;
// * top-p, when ``top_p < 1``: fp32 softmax; the plain version's stable
//   ascending sort of the values, its scan and k = min(count(cum <= 1 -
//   top_p), V - 1) (see below); HF's tie rule: kept where value > the
//   boundary's, or equal to it at an index at or after the boundary's;
// * a Gumbel for each kept token only, drawn in registers at flat index
//   offset + r V + j under the step's device key (threefry.cuh: the bits and
//   transform of ``threefry_draw``), and the argmax of gumbel + x over the
//   kept tokens, the first index on ties; a removed token is -inf in the
//   plain version and cannot win, so its draw changes nothing.
//
// Neither filter needs the sorted order itself, only the element at which
// the ascending scan passes its threshold.  Each token gets a 46-bit key,
// its value's bits made order-preserving (-0.0 made +0.0 first: the two
// compare equal, and a stable sort orders them by index) above its 14-bit
// index; every key is distinct, and key order is the stable sort's order.
// With M(K) the mass of the keys at or below K (a block sum in a fixed
// order, so monotone in K and the same from run to run), the boundary is
// the least key K with M(K) past the threshold, found by bisection over the
// key bits: 46 block sums over the row in shared memory, no sort, no scan.
// The position of that key in the sorted order is the plain version's
// count; where the total never passes, the largest key (the clamp to
// V - 1).  Both filters off: no bisection.  The sums run in another order
// than PyTorch's sort-then-cumsum, so the kept set can differ from the
// plain version's only where its cumulative mass at the boundary lies
// within a few ulp of the threshold; penalty, temperature and the Gumbels
// are bit-identical (one rounding an operation, no contraction).
//
// What bounds it on the H100: neither bytes nor operations.  A (8, 8194)
// fp32 step reads 328 KB and writes 8 tokens, ~0.1 us at 3.35 TB/s; a
// launch costs more.  One CTA a row leaves 124 of 132 SMs idle at batch 8,
// and each of the 46 bisection steps ends in a block-wide sum: the kernel
// is latency-bound within the CTA.  A row split over a cluster's CTAs
// (distributed shared memory) would shorten each sum; the point of this
// design is the launch count.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "threefry.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kIndexBits = 14;  // a key: 32 value bits above the index
constexpr int kKeyBits = 32 + kIndexBits;
// the row's logits, masses and keys in shared memory: 16 B a token, 192 KB
constexpr int kMaxVocab = 12288;

struct Params {
  int vocab, code_stride, step, stop;
  bool penalty_on, temperature_on, typical_on, top_p_on, force_full;
  float penalty, temperature, mass, top_p_thr;
  unsigned long long offset;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Float bits made order-preserving as unsigned; -0.0 becomes +0.0 first.
__device__ __forceinline__ uint32_t order_bits(float v) {
  const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

__device__ __forceinline__ unsigned long long make_key(float v, int j) {
  return (static_cast<unsigned long long>(order_bits(v)) << kIndexBits) |
         static_cast<unsigned long long>(j);
}

__device__ __forceinline__ float key_value(unsigned long long k) {
  return from_order_bits(static_cast<uint32_t>(k >> kIndexBits));
}

__device__ __forceinline__ int key_index(unsigned long long k) {
  return static_cast<int>(k & ((1ULL << kIndexBits) - 1));
}

// Block reductions of 1024 threads: each warp by shuffles, then warp 0 over
// the warps' results; every thread returns the result.  ``red`` holds
// kWarps + 1 values.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  return red[kWarps];
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  return red[kWarps];
}

__device__ unsigned long long block_max_key(const unsigned long long* keys, int n,
                                           unsigned long long* red) {
  unsigned long long v = 0;
  for (int j = threadIdx.x; j < n; j += kThreads) v = max(v, keys[j]);
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = red[lane];
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
    if (lane == 0) red[kWarps] = v;
  }
  __syncthreads();
  return red[kWarps];
}

// M(K): the mass of the keys at or below K, each thread's tokens in index
// order, then the block's tree; every thread returns it.
__device__ float mass_at_or_below(const unsigned long long* keys, const float* mass, int n,
                                  unsigned long long k, float* red) {
  float s = 0.0f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    if (keys[j] <= k) s = __fadd_rn(s, mass[j]);
  }
  return block_sum(s, red);
}

// The key at which the ascending scan of ``mass`` in key order first
// passes ``thr`` (cum >= thr when kAtLeast, else cum > thr): the least K
// with M(K) past it, by bisection over the key bits.  Its position in key
// order is count(cum < thr) (count(cum <= thr)); where M never passes, the
// largest key.
template <bool kAtLeast>
__device__ unsigned long long boundary_key(const unsigned long long* keys, const float* mass,
                                           int n, float thr, float* red,
                                           unsigned long long* redk) {
  auto passes = [&](float m) { return kAtLeast ? m >= thr : m > thr; };
  const unsigned long long top = (1ULL << kKeyBits) - 1;
  if (!passes(mass_at_or_below(keys, mass, n, top, red))) return block_max_key(keys, n, redk);
  unsigned long long r = 0;  // the least key lies in [r, r + 2^(b + 1) - 1]
  for (int b = kKeyBits - 1; b >= 0; --b) {
    if (!passes(mass_at_or_below(keys, mass, n, r + ((1ULL << b) - 1), red))) r += 1ULL << b;
  }
  return r;
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sample_step_kernel(const T* __restrict__ logits, uint8_t* __restrict__ seen,
                       long long* __restrict__ codes, long long* __restrict__ lengths,
                       uint8_t* __restrict__ finished, long long* __restrict__ tok_out,
                       const uint32_t* __restrict__ key, const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps + 1];
  __shared__ unsigned long long redk[kWarps + 1];
  __shared__ float best_val[kWarps];
  __shared__ int best_idx[kWarps];
  const int V = p.vocab, r = blockIdx.x;
  const int row_bytes = ((4 * V + 15) / 16) * 16;
  float* xs = reinterpret_cast<float*>(smem);  // the row's logits, then -inf where removed
  float* mass = reinterpret_cast<float*>(smem + row_bytes);  // each token's probability
  auto* keys = reinterpret_cast<unsigned long long*>(smem + 2 * row_bytes);
  const T* row = logits + static_cast<long long>(r) * V;
  uint8_t* seen_row = seen + static_cast<long long>(r) * V;

  // penalty and temperature, each skipped at 1.0 as the plain version skips it
  for (int j = threadIdx.x; j < V; j += kThreads) {
    float x = to_float(row[j]);
    if (p.penalty_on && seen_row[j]) {
      x = x > 0.0f ? __fdiv_rn(x, p.penalty) : __fmul_rn(x, p.penalty);
    }
    if (p.temperature_on) x = __fdiv_rn(x, p.temperature);
    xs[j] = x;
  }
  __syncthreads();

  if (p.typical_on) {
    float m = -INFINITY;
    for (int j = threadIdx.x; j < V; j += kThreads) m = fmaxf(m, xs[j]);
    m = block_max(m, red);
    float s = 0.0f;
    for (int j = threadIdx.x; j < V; j += kThreads) s = __fadd_rn(s, expf(__fsub_rn(xs[j], m)));
    const float log_s = logf(block_sum(s, red));
    float plogp = 0.0f;
    for (int j = threadIdx.x; j < V; j += kThreads) {
      const float lp = log_prob(xs[j], m, log_s), pj = expf(lp);
      if (pj > 0.0f) plogp = __fadd_rn(plogp, __fmul_rn(pj, lp));
      mass[j] = pj;
    }
    const float h = -block_sum(plogp, red);  // the entropy
    for (int j = threadIdx.x; j < V; j += kThreads) {
      keys[j] = make_key(typical_distance(xs[j], m, log_s, h), j);
    }
    __syncthreads();
    const float thresh = key_value(boundary_key<true>(keys, mass, V, p.mass, red, redk));
    for (int j = threadIdx.x; j < V; j += kThreads) {
      if (key_value(keys[j]) > thresh) xs[j] = -INFINITY;
    }
    __syncthreads();
  }

  if (p.top_p_on) {
    float m = -INFINITY;
    for (int j = threadIdx.x; j < V; j += kThreads) m = fmaxf(m, xs[j]);
    m = block_max(m, red);
    float s = 0.0f;
    for (int j = threadIdx.x; j < V; j += kThreads) s = __fadd_rn(s, expf(__fsub_rn(xs[j], m)));
    s = block_sum(s, red);
    for (int j = threadIdx.x; j < V; j += kThreads) {
      mass[j] = __fdiv_rn(expf(__fsub_rn(xs[j], m)), s);
      keys[j] = make_key(xs[j], j);
    }
    __syncthreads();
    const unsigned long long k = boundary_key<false>(keys, mass, V, p.top_p_thr, red, redk);
    const float bv = key_value(k);
    const int bi = key_index(k);
    for (int j = threadIdx.x; j < V; j += kThreads) {
      const float x = xs[j];
      if (x < bv || (x == bv && j < bi)) xs[j] = -INFINITY;
    }
    __syncthreads();
  }

  // the Gumbels of the kept tokens and the argmax, the first index on ties
  const uint32_t k0 = key[0], k1 = key[1];
  const unsigned long long base = p.offset + static_cast<unsigned long long>(r) * V;
  float best = -INFINITY;
  int arg = V;  // none yet
  for (int j = threadIdx.x; j < V; j += kThreads) {
    const float x = xs[j];
    if (x == -INFINITY) continue;  // removed, or -inf: wins only if all are
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    best_val[warp] = best;
    best_idx[warp] = arg;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (best_val[w] > best || (best_val[w] == best && best_idx[w] < arg)) {
        best = best_val[w];
        arg = best_idx[w];
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

__global__ void empty_kernel() {}

template <typename T>
int launch(const void* logits, const Params& p, int batch, void* seen, void* codes,
           void* lengths, void* finished, void* tok, const void* key, cudaStream_t stream) {
  static bool configured = false;
  const int row_bytes = ((4 * p.vocab + 15) / 16) * 16;
  const int bytes = p.typical_on || p.top_p_on ? 2 * row_bytes + 8 * p.vocab : row_bytes;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        sample_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 16 * kMaxVocab);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  sample_step_kernel<T><<<batch, kThreads, bytes, stream>>>(
      static_cast<const T*>(logits), static_cast<uint8_t*>(seen),
      static_cast<long long*>(codes), static_cast<long long*>(lengths),
      static_cast<uint8_t*>(finished), static_cast<long long*>(tok),
      static_cast<const uint32_t*>(key), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One decode step of ``batch`` rows of ``vocab`` logits (``dtype`` 0 bf16,
// 1 fp32; every pointer to contiguous device memory): writes the (B,) int64
// tokens to ``tok`` and updates ``seen`` (B, vocab) bool, ``codes`` (B,
// code_stride) int64 at column ``step``, ``lengths`` (B,) int64 and
// ``finished`` (B,) bool in place.  ``key`` is the step's int32 (2,) device
// key; row r draws at flat indices offset + r * vocab + j.  ``top_p_thr`` is
// float32(1 - top_p).  Returns a CUDA error code (0: launched).
extern "C" int sample_step(const void* logits, int dtype, void* seen, void* codes,
                           void* lengths, void* finished, void* tok, const void* key,
                           int batch, int vocab, int code_stride, int step, int penalty_on,
                           float penalty, int temperature_on, float temperature,
                           int typical_on, float mass, int top_p_on, float top_p_thr,
                           int stop, int force_full, unsigned long long offset,
                           void* stream) {
  if (batch <= 0) return 0;
  if (vocab < 1 || vocab > kMaxVocab || step < 0 || step >= code_stride || stop < 0 ||
      stop >= vocab) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.vocab = vocab;
  p.code_stride = code_stride;
  p.step = step;
  p.stop = stop;
  p.penalty_on = penalty_on != 0;
  p.temperature_on = temperature_on != 0;
  p.typical_on = typical_on != 0;
  p.top_p_on = top_p_on != 0;
  p.force_full = force_full != 0;
  p.penalty = penalty;
  p.temperature = temperature;
  p.mass = mass;
  p.top_p_thr = top_p_thr;
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

// An empty kernel on the sample step's grid (``batch`` CTAs of 1024
// threads): its launch-to-launch time is the floor a launch of the step
// meets.
extern "C" int sample_step_floor(int batch, void* stream) {
  empty_kernel<<<batch, kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sample_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
