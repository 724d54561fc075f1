// JAX's threefry2x32 random draws for Hopper (sm_90a), CUDA C++ with plain C
// entries.  The port's counterpart of XLA's threefry lowering, as the JAX
// package's serving path reaches it through ``jax.random`` with
// ``jax_threefry_partitionable`` on (jax/_src/prng.py, jax/_src/random.py):
//
// * ``threefry_draw``: element i of a draw of shape S under key k is
//   threefry2x32(k; hi(j), lo(j)) with j = offset + i, its flat index in S,
//   split in two 32-bit words; the two output words are XORed into the
//   element's 32 random bits (``_threefry_random_bits_partitionable``).  One
//   transform follows: the bits, a uniform on [0, 1) (the 23 high bits as a
//   mantissa of [1, 2), minus 1), a standard normal (sqrt(2) * erfinv of a
//   uniform on (-1, 1): XLA's float32 ErfInv polynomial, xla math.cc
//   ErfInv32), or a standard Gumbel in JAX's mode "low" (-log(-log(u)),
//   u uniform on [tiny, 1)), which ``jax.random.categorical`` adds to the
//   logits.  Float results are multiplied by ``scale`` (the diffusion's
//   temperature, 1 elsewhere).  Every element depends on the key and its
//   flat index only, so a batch's row r is the same whatever rows follow it,
//   and a data rank draws its rows alone by starting at ``offset``.
// * ``threefry_keys``: the keys a request's loops use, written to a device
//   buffer once: the decode's chain ``rng, key = split(rng)`` a step (one
//   thread, sequential by nature), or the diffusion's ``split(key, n)`` (one
//   thread a key).  A decode step then reads its key from that buffer, so it
//   is one launch with no host work.
//
// The key is read from device memory (``key`` non-null: a row of a key
// buffer) or passed by value (k0, k1).  The float arithmetic is written with
// __fmul_rn / __fadd_rn so that nvcc contracts nothing into an FMA: the
// plain PyTorch version (detail_tts_tpu_torch/ops/prng.py) rounds after each
// operation, and with the same libdevice logf / log1pf / sqrtf the two agree
// bit for bit.
//
// What bounds ``threefry_draw`` on the H100: integer operations.  Each
// element takes 20 rounds of add, rotate, xor (60 operations) and 6 key
// injections (12 adds), plus the final xor, ~73 32-bit integer operations,
// against 4 bytes written.  At 64 INT32 results a clock on each of 132 SMs
// (1.98 GHz) that is ~7 us for the diffusion's (8, 1600, 128) draw, against
// ~2 us to write its 6.6 MB at 3.35 TB/s.  The decode's (8, 8194) draw is far
// below a launch's own cost.  The kernel keeps each element's state in
// registers, one element a thread in a grid-stride loop, and reads the key
// once a thread; the transforms' float work runs on the FP32 pipes beside
// the integer ones.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

enum Kind : int { kBits = 0, kUniform = 1, kNormal = 2, kGumbel = 3 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// threefry2x32 with 20 rounds, as jax/_src/prng.py _threefry2x32_lowering.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
#define TF_ROUNDS_A TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
#define TF_ROUNDS_B TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  TF_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  TF_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  TF_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  TF_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  TF_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef TF_ROUNDS_B
#undef TF_ROUNDS_A
#undef TF_ROUND
}

// A uniform float on [0, 1) from 32 random bits (jax.random._uniform).
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __fadd_rn(__uint_as_float((bits >> 9) | 0x3F800000u), -1.0f);
}

// XLA's float32 ErfInv (Giles' polynomial in w = -log1p(-x^2), two ranges).
__device__ __forceinline__ float erfinv32(float x) {
  const float lt5[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                        -0.00417768164f,  0.246640727f,    1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                        0.00943887047f,   1.00167406f,     2.83297682f};
  float w = -log1pf(-__fmul_rn(x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fadd_rn(w, -2.5f) : __fadd_rn(sqrtf(w), -3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fadd_rn(lt ? lt5[i] : ge5[i], __fmul_rn(p, w));
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7F800000)) : __fmul_rn(p, x);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
    draw_kernel(const uint32_t* __restrict__ key, uint32_t k0, uint32_t k1,
                void* __restrict__ out, unsigned long long offset, long long n,
                float scale) {
  if (key != nullptr) {
    k0 = key[0];
    k1 = key[1];
  }
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long j = offset + static_cast<unsigned long long>(i);
    uint32_t x0 = static_cast<uint32_t>(j >> 32), x1 = static_cast<uint32_t>(j);
    threefry2x32(k0, k1, x0, x1);
    const uint32_t bits = x0 ^ x1;
    if constexpr (KIND == kBits) {
      static_cast<uint32_t*>(out)[i] = bits;
    } else {
      const float f = unit_float(bits);
      float v;
      if constexpr (KIND == kUniform) {
        v = fmaxf(0.0f, f);
      } else if constexpr (KIND == kNormal) {
        // uniform on [nextafter(-1, 0), 1): f * (1 - lo) + lo, 1 - lo == 2
        const float lo = -0.99999994f;
        const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, 2.0f), lo));
        v = __fmul_rn(1.41421356f, erfinv32(u));
      } else {
        // uniform on [tiny, 1): f * (1 - tiny) + tiny, 1 - tiny == 1
        const float tiny = 1.17549435e-38f;
        const float u = fmaxf(tiny, __fadd_rn(f, tiny));
        v = -logf(-logf(u));
      }
      static_cast<float*>(out)[i] = __fmul_rn(v, scale);
    }
  }
}

// The decode's keys: from rng, n times (rng, key) = split(rng); out[s] = key.
__global__ void chain_kernel(uint32_t k0, uint32_t k1, int n, uint32_t* __restrict__ out) {
  for (int s = 0; s < n; ++s) {
    uint32_t a0 = 0, a1 = 0, b0 = 0, b1 = 1;
    threefry2x32(k0, k1, a0, a1);
    threefry2x32(k0, k1, b0, b1);
    out[2 * s] = b0;
    out[2 * s + 1] = b1;
    k0 = a0;
    k1 = a1;
  }
}

// split(key, n): key i = threefry2x32(key; 0, i), both words.
__global__ void split_kernel(uint32_t k0, uint32_t k1, int n, uint32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    uint32_t x0 = 0, x1 = static_cast<uint32_t>(i);
    threefry2x32(k0, k1, x0, x1);
    out[2 * i] = x0;
    out[2 * i + 1] = x1;
  }
}

int blocks_for(long long n) {
  // grid-stride beyond 16 CTAs an SM of an H100
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132LL * 16 ? blocks : 132LL * 16);
}

}  // namespace

// Draw n = prod(shape) elements of kind ``kind`` (0 bits as uint32, 1
// uniform, 2 normal, 3 gumbel, as float32 times ``scale``) at flat indices
// [offset, offset + n) into ``out``.  The key is key[0..1] on the device when
// ``key`` is non-null, else (k0, k1).  Returns a CUDA error code (0: launched).
extern "C" int threefry_draw(const void* key, uint32_t k0, uint32_t k1, void* out,
                             unsigned long long offset, long long n, int kind, float scale,
                             void* stream) {
  if (n <= 0) return 0;
  const dim3 grid(blocks_for(n));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* kp = static_cast<const uint32_t*>(key);
  switch (kind) {
    case kBits:
      draw_kernel<kBits><<<grid, kThreads, 0, s>>>(kp, k0, k1, out, offset, n, scale);
      break;
    case kUniform:
      draw_kernel<kUniform><<<grid, kThreads, 0, s>>>(kp, k0, k1, out, offset, n, scale);
      break;
    case kNormal:
      draw_kernel<kNormal><<<grid, kThreads, 0, s>>>(kp, k0, k1, out, offset, n, scale);
      break;
    case kGumbel:
      draw_kernel<kGumbel><<<grid, kThreads, 0, s>>>(kp, k0, k1, out, offset, n, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// n keys (n, 2) uint32 into ``out`` from the key (k0, k1): the decode's
// chain when ``chain`` is non-zero, else split(key, n).
extern "C" int threefry_keys(uint32_t k0, uint32_t k1, int n, int chain, void* out,
                             void* stream) {
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint32_t*>(out);
  if (chain) {
    chain_kernel<<<1, 1, 0, s>>>(k0, k1, n, o);
  } else {
    split_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(k0, k1, n, o);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* threefry_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
