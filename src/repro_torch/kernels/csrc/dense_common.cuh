// What the two dense-matching kernels share: the exact SAD of two 16-byte
// descriptors, the constants of the candidate fold, the energy with a
// power-of-two divisor, and cp.async copies from global to shared memory.
//
// A descriptor is 16 signed bytes.  Stored in offset binary (each byte
// XOR 0x80, so -128..127 maps to 0..255 in order), four __vsadu4 give the
// exact sum of absolute differences of two descriptors: the plain
// version's int32 SAD, bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "xla_math.cuh"

namespace ielas {

constexpr float kBigF = 1e9f;          // the plain version's BIGF: an energy that never wins
constexpr unsigned kFlip = 0x80808080u;

// Signed bytes to offset binary (its own inverse).
__device__ __forceinline__ uint4 flip(uint4 a) {
  a.x ^= kFlip; a.y ^= kFlip; a.z ^= kFlip; a.w ^= kFlip;
  return a;
}

// SAD of two descriptors, both in offset binary.
__device__ __forceinline__ int sad16(const uint4 a, const uint4 b) {
  return (int)(__vsadu4(a.x, b.x) + __vsadu4(a.y, b.y) + __vsadu4(a.z, b.z) +
               __vsadu4(a.w, b.w));
}

// The descriptor's texture (its SAD against the zero descriptor), from its
// offset-binary form.
__device__ __forceinline__ int texture16(const uint4 a) {
  return sad16(a, make_uint4(kFlip, kFlip, kFlip, kFlip));
}

// The dense energy for a two_s2 that is a power of two, with the division
// by it done as a multiply by its reciprocal `inv` (exact).  x / 2^k and
// x * 2^-k are one real number, so both round to the same float32 (normal,
// subnormal, zero, infinity or NaN alike): the result is dense_energy's
// (xla_math.cuh) bit for bit, without the division's instruction sequence.
__device__ __forceinline__ float dense_energy_pow2(int sad, float df, float mu, float beta,
                                                   float gamma, float inv) {
  const float diff = __fsub_rn(df, mu);
  const float x = __fmul_rn(-__fmul_rn(diff, diff), inv);
  const float prior = -xla_logf(__fadd_rn(gamma, xla_expf(x)));
  return __fmaf_rn(beta, (float)sad, prior);
}

// dense_energy, or dense_energy_pow2 when inv (the host's pow2_reciprocal of
// two_s2) is not 0.
__device__ __forceinline__ float energy(int sad, float df, float mu, float beta, float gamma,
                                        float two_s2, float inv) {
  return inv != 0.0f ? dense_energy_pow2(sad, df, mu, beta, gamma, inv)
                     : dense_energy(sad, df, mu, beta, gamma, two_s2);
}

// 1 / x when x is a power of two whose reciprocal is a float32 too (so the
// multiply equals the division), else 0.  Host side.
inline float pow2_reciprocal(float x) {
  int e = 0;
  if (!(x > 0.0f) || !isfinite(x) || frexpf(x, &e) != 0.5f) return 0.0f;
  const float inv = 1.0f / x;
  return isfinite(inv) && inv * x == 1.0f ? inv : 0.0f;
}

// Asynchronous copies of 4 and 16 bytes from global to shared memory
// (cp.async, sm_80 and later); wait_all waits for every copy the thread
// issued.  The 16-byte copy needs 16-byte aligned addresses.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace ielas
