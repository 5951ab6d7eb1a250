// The dense energy as XLA:CPU rounds it, for the card.
//
// XLA:CPU evaluates float32 exp and log with the Cephes polynomials as
// Eigen writes them (pexp_float, plog_float), and contracts the energy's
// final beta * SAD + prior into a fused multiply-add.  The functions below
// are the same sequence of float32 operations, each FMA an explicit
// __fmaf_rn; the sources that include this header are built with
// --fmad=false and without fast math, so no other multiply and add is
// fused.  Their plain PyTorch twins are xla_exp_f32, xla_log_f32 and
// dense_energy in src/repro_torch/kernels/ref.py; the order of every
// operation matters (another order changes the last bit of a few percent
// of the results), so keep the two in step.
#pragma once

#include <cuda_runtime.h>

namespace ielas {

__device__ __forceinline__ float pow2i(int n) {  // 2^n, n in [-126, 127]
  return __int_as_float((n + 127) << 23);
}

__device__ __forceinline__ float xla_expf(float x) {
  x = fminf(fmaxf(x, -88.3762626647949f), 88.3762626647950f);
  const float fx = floorf(__fmaf_rn(x, 1.44269504088896341f, 0.5f));
  float r = __fmaf_rn(fx, -0.693359375f, x);
  r = __fmaf_rn(fx, 2.12194440e-4f, r);
  const float z = __fmul_rn(r, r);
  float y = 1.9875691500e-4f;
  y = __fmaf_rn(y, r, 1.3981999507e-3f);
  y = __fmaf_rn(y, r, 8.3334519073e-3f);
  y = __fmaf_rn(y, r, 4.1665795894e-2f);
  y = __fmaf_rn(y, r, 1.6666665459e-1f);
  y = __fmaf_rn(y, r, 5.0000001201e-1f);
  y = __fadd_rn(__fmaf_rn(y, z, r), 1.0f);
  // ldexp(y, fx) in two exact steps; XLA:CPU flushes a subnormal result
  // to zero (for x below about -87.34).
  const int n = (int)fx;
  const int half = n >> 1;
  const float out = __fmul_rn(__fmul_rn(y, pow2i(half)), pow2i(n - half));
  return out < 1.17549435e-38f ? 0.0f : out;
}

// For positive normal x (the energy takes it on [gamma, gamma + 1]).
__device__ __forceinline__ float xla_logf(float x) {
  const int bits = __float_as_int(x);
  float e = (float)(((bits >> 23) & 0xff) - 126);
  const float m = __int_as_float((bits & 0x807fffff) | 0x3f000000);  // [0.5, 1)
  if (m < 0.707106781186547524f) {
    e = __fsub_rn(e, 1.0f);
    x = __fadd_rn(__fsub_rn(m, 1.0f), m);
  } else {
    x = __fsub_rn(m, 1.0f);
  }
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  float y = __fmaf_rn(__fmaf_rn(x, 7.0376836292e-2f, -1.1514610310e-1f), x, 1.1676998740e-1f);
  const float y1 =
      __fmaf_rn(__fmaf_rn(x, -1.2420140846e-1f, 1.4249322787e-1f), x, -1.6668057665e-1f);
  const float y2 =
      __fmaf_rn(__fmaf_rn(x, 2.0000714765e-1f, -2.4999993993e-1f), x, 3.3333331174e-1f);
  y = __fmaf_rn(y, x3, y1);
  y = __fmaf_rn(y, x3, y2);
  y = __fmaf_rn(y, x3, __fmul_rn(e, -2.12194440e-4f));
  x = __fadd_rn(__fmaf_rn(x2, -0.5f, x), y);
  return __fmaf_rn(e, 0.693359375f, x);
}

// beta * sad - log(gamma + exp(-(d - mu)^2 / two_s2)), rounded as XLA:CPU
// rounds it (the division is a true division, as in the plain version).
__device__ __forceinline__ float dense_energy(int sad, float df, float mu, float beta,
                                              float gamma, float two_s2) {
  const float diff = __fsub_rn(df, mu);
  const float x = __fdiv_rn(-__fmul_rn(diff, diff), two_s2);
  const float prior = -xla_logf(__fadd_rn(gamma, xla_expf(x)));
  return __fmaf_rn(beta, (float)sad, prior);
}

}  // namespace ielas
