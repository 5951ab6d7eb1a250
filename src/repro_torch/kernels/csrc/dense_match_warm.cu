// Warm-start dense matching: the band-only scan around a previous frame's
// disparity, both views in one launch, for Hopper (sm_90a).
//
// Replaces the reference's XLA scan src/repro/core/dense.py
// ::dense_match_warm_xla, whose tile body is the oracle
// src/repro/kernels/ref.py::dense_match_rows_warm_ref (no Pallas kernel
// exists for it).  Its plain PyTorch version is
// src/repro_torch/kernels/ref.py::dense_match_rows_warm_ref; the output must
// equal it bit for bit.
//
// What the kernel computes: for each pixel and view the candidates are only
// the band clip(rint(mu) -/+ band, disp_min, disp_min + D - 1) cut to the
// image (left view u - d >= 0, right view u + d < W); the result is the
// candidate of least energy
//     beta * SAD - 1 / (1 + (d - mu)^2 * inv_2s2),
// the smallest d on ties (the scan's strict <), INVALID (-1) when the band
// holds no in-image d or the pixel's texture is below match_texture.
//
// What bounds it on an H100: instruction issue in the candidate loop.  A
// KITTI frame (375 x 1242) has about 15 M in-image band candidates at band
// 8, each a 16-byte SAD (four VABSDIFF4, a reduced-rate instruction) and a
// rational energy, against the 22 MB of descriptors, priors and outputs it
// moves once (L2-resident on the path: the frame's descriptors were just
// written).
//
// The design: a block per image row of a frame, a thread per pixel of the
// row (in as few equal passes of at most 1024 as it takes).
//  1. Staging.  The row's two descriptor rows go to shared memory once,
//     flipped to offset binary on the way (the flip needs the registers, so
//     the copy is a 16-byte load and store, not cp.async); no candidate
//     reads global memory or flips again.  Rows too wide for shared memory
//     are read from global memory and flipped as read.
//  2. Each thread walks its left pixel's band, then its right pixel's, each
//     lane only its own band's candidates in ascending d.
//  3. The prior's division is the loop's costliest step.  For a pixel whose
//     every candidate has q = 1 + diff^2 * inv_2s2 in [1, 2^126) (its band's
//     largest |d - mu| decides, once per pixel), 1 / q is rcp.approx and one
//     Newton step, which is the correctly rounded reciprocal for every float
//     in [1, 2^126) (chip_smoke.py checks all of them against a division);
//     any other pixel divides.
// Measured and not kept (dense_profile.py): the left view's SADs in a
// shared table read by the right view (the diagonal identity; 76-82% of
// right-view candidates share their SAD), every lane walking 2 band + 1
// predicated steps, a true division for every candidate, 512-thread blocks,
// and a half-warp per pixel's band.  All were slower on the card.
// The fold order (ascending d, strict < from (BIGF, 0)) and each energy are
// the plain version's, so the bits are too.  The band test is done on
// integers, which equals the plain version's float compare because the
// clipped band ends are integral floats of at most disp_min + D - 1 < 2^24;
// a NaN prior gives an empty band, as its float compares do.  The energy is
// XLA:CPU's float32 sequence: the square rounded, 1 + square * inv_2s2 as
// one FMA, a correctly rounded reciprocal, and beta * SAD + prior as one
// FMA (built with --fmad=false, no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 227 * 1024;    // an H100 block's dynamic shared memory

struct Params {
  const uint4* dl;
  const uint4* dr;
  const float* mu_l;
  const float* mu_r;
  float* out_l;
  float* out_r;
  int w, num_disp, disp_min, band;
  float beta, inv_2s2;
  int match_texture;
};

// 1 / q, correctly rounded, for q in [1, 2^126): rcp.approx's estimate and
// one Newton step on FMAs.
__device__ __forceinline__ float reciprocal(float q) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(q));
  return __fmaf_rn(r, __fmaf_rn(-q, r, 1.0f), r);
}

// The warm energy of candidate d (df = d as float32) for a pixel with prior
// mu; kFast: q is known to lie in [1, 2^126).
template <bool kFast>
__device__ __forceinline__ float warm_energy(int sad, float df, float mu, float beta,
                                             float inv_2s2) {
  const float diff = __fsub_rn(df, mu);
  const float q = __fmaf_rn(__fmul_rn(diff, diff), inv_2s2, 1.0f);
  const float prior = kFast ? -reciprocal(q) : -__fdiv_rn(1.0f, q);
  return __fmaf_rn(beta, (float)sad, prior);
}

// Whether every candidate of the band [lo, hi] has q in [1, 2^126): |d - mu|
// is largest at an end, and each rounding step is monotonic.
__device__ __forceinline__ bool fast_band(int lo, int hi, float mu, float inv_2s2) {
  const float m = fmaxf(fabsf(__fsub_rn((float)lo, mu)), fabsf(__fsub_rn((float)hi, mu)));
  return inv_2s2 >= 0.0f && __fmaf_rn(__fmul_rn(m, m), inv_2s2, 1.0f) < 0x1p126f;
}

// A pixel's band [lo, hi] before the image cut: the plain version's float
// clamps of rint(mu) -/+ band; empty (lo > hi) for a NaN prior.
__device__ __forceinline__ int2 band_of(float mu, const Params& p) {
  const float r = rintf(mu);
  if (r != r) return make_int2(1, 0);
  const float lo_d = (float)p.disp_min, hi_d = (float)(p.disp_min + p.num_disp - 1);
  return make_int2((int)fminf(fmaxf(__fsub_rn(r, (float)p.band), lo_d), hi_d),
                   (int)fminf(fmaxf(__fadd_rn(r, (float)p.band), lo_d), hi_d));
}

// The running (best energy, best d) of one pixel: the strict < from (BIGF, 0).
struct Best {
  float e = ielas::kBigF;
  int d = 0;
  __device__ __forceinline__ void fold(float ed, int dd) {
    if (ed < e) {
      e = ed;
      d = dd;
    }
  }
  __device__ __forceinline__ float result(uint4 a, int match_texture) const {
    return e < ielas::kBigF && ielas::texture16(a) >= match_texture ? (float)d : -1.0f;
  }
};

// Folds the candidates d = lo .. hi in ascending order; sad_of(d) is the SAD.
template <bool kFast, class Sad>
__device__ __forceinline__ void walk(int lo, int hi, float mu, const Params& p, Best& best,
                                     Sad&& sad_of) {
#pragma unroll 4
  for (int d = lo; d <= hi; ++d) {
    best.fold(warm_energy<kFast>(sad_of(d), (float)d, mu, p.beta, p.inv_2s2), d);
  }
}

// The least-energy candidate of one pixel's band [lo, hi] (cut to the image).
template <class Sad>
__device__ __forceinline__ Best scan(int lo, int hi, float mu, const Params& p, Sad&& sad_of) {
  Best best;
  if (fast_band(lo, hi, mu, p.inv_2s2)) {
    walk<true>(lo, hi, mu, p, best, sad_of);
  } else {
    walk<false>(lo, hi, mu, p, best, sad_of);
  }
  return best;
}

template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads) dense_match_warm_kernel(const Params p) {
  extern __shared__ uint4 smem[];
  const int w = p.w;
  const size_t row_px = (size_t)blockIdx.x * w;       // frame * h + image row
  const uint4* gl = p.dl + row_px;
  const uint4* gr = p.dr + row_px;
  const float* mu_l = p.mu_l + row_px;
  const float* mu_r = p.mu_r + row_px;
  uint4* sl = smem;                                     // the staged rows
  uint4* sr = smem + w;
  // Column x of each view, in offset binary.
  auto left_col = [&](int x) { return kStaged ? sl[x] : ielas::flip(gl[x]); };
  auto right_col = [&](int x) { return kStaged ? sr[x] : ielas::flip(gr[x]); };

  if (kStaged) {
    for (int x = threadIdx.x; x < w; x += blockDim.x) {
      sl[x] = ielas::flip(gl[x]);
      sr[x] = ielas::flip(gr[x]);
    }
    __syncthreads();
  }

  // Left view: pixel x at d matches right column x - d (d <= x).
  for (int x = threadIdx.x; x < w; x += blockDim.x) {
    const uint4 a = left_col(x);
    const float mu = mu_l[x];
    const int2 b = band_of(mu, p);
    const Best best = scan(b.x, min(b.y, x), mu, p,
                           [&](int d) { return ielas::sad16(a, right_col(x - d)); });
    p.out_l[row_px + x] = best.result(a, p.match_texture);
  }
  // Right view: pixel u at d matches left column u + d (< w).
  for (int u = threadIdx.x; u < w; u += blockDim.x) {
    const uint4 a = right_col(u);
    const float mu = mu_r[u];
    const int2 b = band_of(mu, p);
    const Best best = scan(b.x, min(b.y, w - 1 - u), mu, p,
                           [&](int d) { return ielas::sad16(a, left_col(u + d)); });
    p.out_r[row_px + u] = best.result(a, p.match_texture);
  }
}

template <bool kStaged>
cudaError_t launch(const Params& p, int rows, int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_match_warm_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dense_match_warm_kernel<kStaged><<<rows, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

__global__ void warm_reciprocal_kernel(const float* q, float* out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = reciprocal(q[i]);
}

}  // namespace

// Launch on `stream` over `batch` frames of `h` rows.  desc_* are
// (batch, h, w, 16) int8, 16-byte aligned; mu_* and out_* are (batch, h, w)
// float32.  inv_2s2 is float32(1 / (2 sigma^2)).  Returns the cudaError_t of
// the launch (0 on success; cudaErrorInvalidValue for a bad range or band).
extern "C" int ielas_dense_match_warm(const void* desc_l, const void* desc_r, const void* mu_l,
                                      const void* mu_r, void* out_l, void* out_r, int batch,
                                      int h, int w, int num_disp, int disp_min, int band,
                                      float beta, float inv_2s2, int match_texture,
                                      void* stream) {
  if (num_disp < 1 || disp_min < 0 || band < 0 || batch < 0 || h < 0 || w < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long rows = (long long)batch * h;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (rows == 0 || w == 0) return (int)cudaSuccess;
  Params p;
  p.dl = static_cast<const uint4*>(desc_l);
  p.dr = static_cast<const uint4*>(desc_r);
  p.mu_l = static_cast<const float*>(mu_l);
  p.mu_r = static_cast<const float*>(mu_r);
  p.out_l = static_cast<float*>(out_l);
  p.out_r = static_cast<float*>(out_r);
  p.w = w;
  p.num_disp = num_disp;
  p.disp_min = disp_min;
  p.band = band;
  p.beta = beta;
  p.inv_2s2 = inv_2s2;
  p.match_texture = match_texture;
  // Threads: the row's pixels in as few equal passes of at most kMaxThreads
  // as it takes (KITTI's 1242 in 2 of 640, Tsukuba's 640 in 1).
  const int passes = (w + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((w + passes - 1) / passes + 31) / 32 * 32;
  const size_t staged = 2 * (size_t)w * sizeof(uint4);
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(staged <= kMaxSmem ? launch<true>(p, (int)rows, threads, staged, s)
                                  : launch<false>(p, (int)rows, threads, 0, s));
}

// out[i] = the kernel's reciprocal of q[i] (meaningful for q in [1, 2^126))
// for n float32 values, on `stream`.  Returns the cudaError_t of the launch.
extern "C" int ielas_warm_reciprocal(const void* q, void* out, long long n, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  warm_reciprocal_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
