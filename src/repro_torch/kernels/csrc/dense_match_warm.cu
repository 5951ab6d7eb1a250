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
// What bounds it on an H100: operations.  A KITTI frame (375 x 1242) needs
// at most 17 candidates a pixel and view at band 8, each a 16-byte SAD and
// a rational energy with one division: about 15.8 M candidates against the
// 22 MB of descriptors, priors and outputs it moves once.
//
// The design (simple first): one thread per (pixel, view), a block a tile of
// 128 pixels of a row (left-view warps, then right-view warps); each thread
// walks its band in ascending d, reading the matching column's descriptor
// from global memory (neighbouring threads read neighbouring columns, and
// the rows stay in L1/L2), and folds with the strict <.
// Bit-exactness: the band test is done on integers, which equals the plain
// version's float compare because the clipped band ends are integral floats
// of at most disp_min + D - 1; a NaN prior gives an empty band, as its
// float compares do.  The energy is XLA:CPU's float32 sequence: the square
// rounded, 1 + square * inv_2s2 as one FMA, a true division, and
// beta * SAD + prior as one FMA (built with --fmad=false, no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_common.cuh"

namespace {

constexpr int kTile = 128;              // pixels of a row per block
constexpr int kThreads = 2 * kTile;     // one thread per (pixel, view)
constexpr int kMaxRows = 65535;         // grid y limit; more rows go to grid z

// The warm energy of candidate d (df = d as float32) for a pixel with prior mu.
__device__ __forceinline__ float warm_energy(int sad, float df, float mu, float beta,
                                             float inv_2s2) {
  const float diff = __fsub_rn(df, mu);
  const float q = __fmaf_rn(__fmul_rn(diff, diff), inv_2s2, 1.0f);
  const float prior = -__fdiv_rn(1.0f, q);
  return __fmaf_rn(beta, (float)sad, prior);
}

__global__ void __launch_bounds__(kThreads) dense_match_warm_kernel(
    const uint4* __restrict__ desc_l, const uint4* __restrict__ desc_r,
    const float* __restrict__ mu_l, const float* __restrict__ mu_r,
    float* __restrict__ out_l, float* __restrict__ out_r, int rows, int w, int num_disp,
    int disp_min, int band, float beta, float inv_2s2, int match_texture) {
  const int row = blockIdx.z * kMaxRows + blockIdx.y;      // frame * h + image row
  if (row >= rows) return;
  const bool left = threadIdx.x < kTile;
  const int u = blockIdx.x * kTile + (left ? threadIdx.x : threadIdx.x - kTile);
  if (u >= w) return;
  const size_t row_px = (size_t)row * w;
  const size_t px = row_px + u;
  const uint4 a = ielas::flip((left ? desc_l : desc_r)[px]);
  const float mu = (left ? mu_l : mu_r)[px];
  // The column d = i matches: left view dst[-i], right view dst[i].
  const uint4* dst = (left ? desc_r : desc_l) + px;

  float best_e = ielas::kBigF;
  int best_d = 0;
  const float r = rintf(mu);
  if (r == r) {
    const float lo_d = (float)disp_min, hi_d = (float)(disp_min + num_disp - 1);
    const int lo = (int)fminf(fmaxf(__fsub_rn(r, (float)band), lo_d), hi_d);
    const int hi = min((int)fminf(fmaxf(__fadd_rn(r, (float)band), lo_d), hi_d),
                       left ? u : w - 1 - u);
    for (int d = lo; d <= hi; ++d) {
      const int sad = ielas::sad16(a, ielas::flip(dst[left ? -d : d]));
      const float e = warm_energy(sad, (float)d, mu, beta, inv_2s2);
      if (e < best_e) {
        best_e = e;
        best_d = d;
      }
    }
  }
  (left ? out_l : out_r)[px] =
      (best_e < ielas::kBigF && ielas::texture16(a) >= match_texture) ? (float)best_d : -1.0f;
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
  if (num_disp < 1 || disp_min < 0 || band < 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)batch * h;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTile - 1) / kTile, rows < kMaxRows ? (unsigned)rows : kMaxRows,
                  (unsigned)((rows + kMaxRows - 1) / kMaxRows));
  dense_match_warm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(desc_l), static_cast<const uint4*>(desc_r),
      static_cast<const float*>(mu_l), static_cast<const float*>(mu_r),
      static_cast<float*>(out_l), static_cast<float*>(out_r), (int)rows, w, num_disp, disp_min,
      band, beta, inv_2s2, match_texture);
  return (int)cudaGetLastError();
}
