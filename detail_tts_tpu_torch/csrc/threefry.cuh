// JAX's threefry2x32 on the device, shared by the kernels that draw from it
// (threefry.cu: the draws and key buffers; sample.cu: the decode step's
// Gumbels).  One copy of the bits and of the transforms, so a Gumbel drawn
// inside the sample step is the one ``threefry_draw`` writes for the same
// key and flat index.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace threefry {

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

// The 32 random bits of flat index j under (k0, k1): threefry2x32(k; hi(j),
// lo(j)), the two words XORed (_threefry_random_bits_partitionable).
__device__ __forceinline__ uint32_t random_bits(uint32_t k0, uint32_t k1,
                                                unsigned long long j) {
  uint32_t x0 = static_cast<uint32_t>(j >> 32), x1 = static_cast<uint32_t>(j);
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

// A uniform float on [0, 1) from 32 random bits (jax.random._uniform).
__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __fadd_rn(__uint_as_float((bits >> 9) | 0x3F800000u), -1.0f);
}

// A standard Gumbel in JAX's mode "low" from 32 random bits: -log(-log(u)),
// u uniform on [tiny, 1): f * (1 - tiny) + tiny, and 1 - tiny == 1.
__device__ __forceinline__ float gumbel(uint32_t bits) {
  const float tiny = 1.17549435e-38f;
  const float u = fmaxf(tiny, __fadd_rn(unit_float(bits), tiny));
  return -logf(-logf(u));
}

}  // namespace threefry
