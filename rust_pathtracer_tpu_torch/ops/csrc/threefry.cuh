// Threefry-2x32 draws in registers, bit for bit the JAX package's
// legacy per-purpose stream (rust_pathtracer_tpu_torch/sampling.py,
// rust_pathtracer_tpu/sampling.py):
//
//   fold_in(k, d)          = threefry2x32(k, (0, d))
//   bounce key of purpose  = fold_in(lane key, bounce * 8 + purpose)
//   uniform i of a key kp  = f32 bits ((x0 ^ x1) >> 9) | 0x3f800000, minus 1,
//                            with (x0, x1) = threefry2x32(kp, (0, i)).
//
// One block is 20 rounds of add, rotate and xor, plus six key injections:
// about 80 int32 operations, in registers.  On the card the rotations are
// funnel shifts; on the host (g++, for the CPU tests that compile this
// header) plain shifts, with the same bits.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define RPT_HD __host__ __device__ __forceinline__
#else
#define RPT_HD inline
#endif

namespace rpt {

// purpose tags (sampling.py P_*)
constexpr uint32_t P_LAMBERT = 2, P_FUZZ = 3, P_SCHLICK = 4, P_ROULETTE = 5;
constexpr uint32_t PURPOSE_STRIDE = 8;

RPT_HD uint32_t rotl32(uint32_t x, int r) {
#ifdef __CUDA_ARCH__
  return __funnelshift_l(x, x, r);
#else
  return (x << r) | (x >> (32 - r));
#endif
}

// the spec threefry-2x32, 20 rounds: (x0, x1) in, the two words out
RPT_HD void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define RPT_TF_ROUND(r) \
  x0 += x1;             \
  x1 = rotl32(x1, r);   \
  x1 ^= x0;
#define RPT_TF_EVEN RPT_TF_ROUND(13) RPT_TF_ROUND(15) RPT_TF_ROUND(26) RPT_TF_ROUND(6)
#define RPT_TF_ODD RPT_TF_ROUND(17) RPT_TF_ROUND(29) RPT_TF_ROUND(16) RPT_TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  RPT_TF_EVEN x0 += k1; x1 += k2 + 1u;
  RPT_TF_ODD  x0 += k2; x1 += k0 + 2u;
  RPT_TF_EVEN x0 += k0; x1 += k1 + 3u;
  RPT_TF_ODD  x0 += k1; x1 += k2 + 4u;
  RPT_TF_EVEN x0 += k2; x1 += k0 + 5u;
#undef RPT_TF_ODD
#undef RPT_TF_EVEN
#undef RPT_TF_ROUND
}

// a lane key (k0, k1) -> the key of one bounce's purpose
RPT_HD void bounce_key(uint32_t k0, uint32_t k1, uint32_t bounce, uint32_t purpose,
                       uint32_t& p0, uint32_t& p1) {
  p0 = 0u;
  p1 = bounce * PURPOSE_STRIDE + purpose;  // modulo 2**32, as fold_in
  threefry2x32(k0, k1, p0, p1);
}

// uniform i in [0, 1) of a purpose key, as jax.random.uniform makes it
RPT_HD float uniform_at(uint32_t p0, uint32_t p1, uint32_t i) {
  uint32_t x0 = 0u, x1 = i;
  threefry2x32(p0, p1, x0, x1);
  const uint32_t bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
#ifdef __CUDA_ARCH__
  const float f = __uint_as_float(bits);
#else
  float f;
  static_assert(sizeof(f) == sizeof(bits), "f32 is 32 bits");
  __builtin_memcpy(&f, &bits, sizeof(f));
#endif
  return f - 1.0f;
}

}  // namespace rpt
