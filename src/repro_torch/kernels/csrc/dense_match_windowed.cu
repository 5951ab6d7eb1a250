// Candidate-window dense matching, both views in one launch, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dense_match.py
// ::dense_match_pallas, whose body is the oracle
// src/repro/kernels/ref.py::dense_match_rows_windowed_ref (its three
// gather_impl formulations, take / onehot / slice, are bitwise equal, and
// this kernel computes that one function).  Its plain PyTorch version is
// src/repro_torch/kernels/ref.py::dense_match_rows_windowed_ref; the
// output must equal it bit for bit.
//
// What bounds it on an H100: bytes.  Each pixel of each view reads its C
// int32 candidates (C = 25: 20 grid-vector values and 5 around the plane
// prior), so the two candidate tensors are most of the traffic: at KITTI
// 2 x 375 x 1242 x 25 x 4 B = 93 MB of ~115 MB a frame (28 us at
// 3.35 TB/s), against 2 x C SADs and energies a pixel.
//
// What the simple design does about it:
//   * one block per image row (a 2-D grid: row, frame of the wave); the
//     row's two descriptor rows are staged in shared memory (2 x W x 16 B)
//     in offset binary (byte ^ 0x80), so four __vsadu4 give the exact SAD
//     of two signed descriptors;
//   * one thread per (pixel, view) pair over the row's 2 W pairs, each
//     looping over its C candidates: left view SAD(dl[u], dr[u - d]),
//     right view SAD(dr[u], dl[u + d]); a candidate whose matching column
//     is off the image has energy BIGF;
//   * the fold keeps the minimum energy and, at equal energy, the smallest
//     candidate value (the reference's argmin-over-d tie-break), starting
//     from (BIGF, disp_min + num_disp); valid = emin < BIGF && texture >=
//     match_texture.
// Bit-exactness: the energy is XLA:CPU's float32 sequence (xla_math.cuh),
// built with --fmad=false and without fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "xla_math.cuh"

namespace {

constexpr float kBigF = 1e9f;
constexpr int kThreads = 256;
constexpr unsigned kFlip = 0x80808080u;

__device__ __forceinline__ int sad16(const uint4 a, const uint4 b) {
  return (int)(__vsadu4(a.x, b.x) + __vsadu4(a.y, b.y) + __vsadu4(a.z, b.z) +
               __vsadu4(a.w, b.w));
}

__device__ __forceinline__ uint4 flip(uint4 a) {
  a.x ^= kFlip; a.y ^= kFlip; a.z ^= kFlip; a.w ^= kFlip;
  return a;
}

__global__ void __launch_bounds__(kThreads) dense_match_windowed_kernel(
    const uint4* __restrict__ desc_l, const uint4* __restrict__ desc_r,
    const float* __restrict__ mu_l, const float* __restrict__ mu_r,
    const int* __restrict__ cand_l, const int* __restrict__ cand_r,
    float* __restrict__ out_l, float* __restrict__ out_r, int h, int w, int c,
    int num_disp, int disp_min, float beta, float gamma, float two_s2, int match_texture) {
  extern __shared__ uint4 smem[];
  uint4* sl = smem;
  uint4* sr = smem + w;

  const size_t v = (size_t)blockIdx.y * h + blockIdx.x;   // frame * h + row
  for (int u = threadIdx.x; u < w; u += blockDim.x) {
    sl[u] = flip(desc_l[v * w + u]);
    sr[u] = flip(desc_r[v * w + u]);
  }
  __syncthreads();

  const uint4 zero = make_uint4(kFlip, kFlip, kFlip, kFlip);
  for (int t = threadIdx.x; t < 2 * w; t += blockDim.x) {
    const bool left = t < w;
    const int u = left ? t : t - w;
    const size_t px = v * w + u;
    const uint4* src = left ? sl : sr;
    const uint4* dst = left ? sr : sl;
    const int sign = left ? -1 : 1;
    const int* cands = (left ? cand_l : cand_r) + px * c;
    const float mu = (left ? mu_l : mu_r)[px];
    const uint4 a = src[u];

    float emin = kBigF;
    int best = disp_min + num_disp;
    for (int k = 0; k < c; ++k) {
      const int d = cands[k];
      const int uc = u + sign * d;
      const float e = (uc >= 0 && uc < w)
          ? ielas::dense_energy(sad16(a, dst[uc]), (float)d, mu, beta, gamma, two_s2)
          : kBigF;
      if (e < emin || (e == emin && d < best)) best = d;
      emin = fminf(emin, e);
    }
    const bool valid = emin < kBigF && sad16(a, zero) >= match_texture;
    (left ? out_l : out_r)[px] = valid ? (float)best : -1.0f;
  }
}

}  // namespace

// Launch on `stream` over `batch` frames of `h` rows.  desc_* are
// (batch, h, w, 16) int8, 16-byte aligned; mu_* and out_* are (batch, h, w)
// float32; cand_* are (batch, h, w, c) int32.  two_s2 is float32(2 sigma^2).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ielas_dense_match_windowed(
    const void* desc_l, const void* desc_r, const void* mu_l, const void* mu_r,
    const void* cand_l, const void* cand_r, void* out_l, void* out_r, int batch, int h,
    int w, int c, int num_disp, int disp_min, float beta, float gamma, float two_s2,
    int match_texture, void* stream) {
  const size_t smem = (size_t)w * 2 * sizeof(uint4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_match_windowed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dense_match_windowed_kernel<<<dim3(h, batch), kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(desc_l), static_cast<const uint4*>(desc_r),
      static_cast<const float*>(mu_l), static_cast<const float*>(mu_r),
      static_cast<const int*>(cand_l), static_cast<const int*>(cand_r),
      static_cast<float*>(out_l), static_cast<float*>(out_r), h, w, c, num_disp, disp_min,
      beta, gamma, two_s2, match_texture);
  return (int)cudaGetLastError();
}
