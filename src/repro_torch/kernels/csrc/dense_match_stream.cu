// Streaming gather-free dense matching, both views in one launch, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dense_match.py
// ::dense_match_stream_pallas, whose body is the oracle
// src/repro/kernels/ref.py::dense_match_rows_stream_ref.  Its plain PyTorch
// version is src/repro_torch/kernels/ref.py::dense_match_rows_stream_ref;
// the output must equal it bit for bit.
//
// What bounds it on an H100: operations.  The inputs are read once (KITTI:
// 14.9 MB of descriptors, 3.7 MB of priors, 6.0 MB of bitmasks; 3.7 MB out,
// about 8 us of HBM time), but each pixel sweeps D disparities for two
// views, and every candidate that passes the mask costs a 16-lane SAD plus
// the energy's float32 exp and log.
//
// What the simple design does about it:
//   * one block per image row (a 2-D grid: row, frame of the wave, so one
//     launch covers a whole wave); the row's two descriptor rows are staged in
//     shared memory (2 x W x 16 B) in offset binary (byte ^ 0x80), so four
//     __vsadu4 give the exact SAD of two descriptors;
//   * threads stride over the row's pixels and loop d over
//     [disp_min, disp_min + D) in ascending order;
//   * the candidate mask (the cell's bitmask byte OR the prior band
//     clip(rint(mu) -/+ R)) is tested first, and the SAD and the energy
//     are computed only for candidates that pass it: a masked-out step is
//     BIGF, which never wins the strict-< fold, so skipping it changes no
//     bit;
//   * left view: SAD(dl[u], dr[u - d]), valid where u >= d; right view:
//     SAD(dl[u + d], dr[u]), valid where u + d < W -- the diagonal
//     CV_R[d, u] = CV[d, u + d] of the same sweep.
// Bit-exactness: the energy is XLA:CPU's float32 sequence (xla_math.cuh:
// Eigen's exp and log polynomials, the last multiply-add fused), built
// with --fmad=false and without fast math; rintf for round-half-to-even,
// BIGF = 1e9f, best d starting at 0, and valid = emin < BIGF && texture >=
// match_texture.
//
// The source also exports ielas_xla_exp_log, which evaluates the header's
// exp and log on an array, so their bits can be held against the plain
// version's on the card.

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

__global__ void __launch_bounds__(kThreads) dense_match_stream_kernel(
    const uint4* __restrict__ desc_l, const uint4* __restrict__ desc_r,
    const float* __restrict__ mu_l, const float* __restrict__ mu_r,
    const unsigned char* __restrict__ gmask_l, const unsigned char* __restrict__ gmask_r,
    float* __restrict__ out_l, float* __restrict__ out_r, int h, int w, int cw, int num_disp,
    int disp_min, int plane_radius, int cell_px, float beta, float gamma, float two_s2,
    int match_texture) {
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
  const float lo_d = (float)disp_min;
  const float hi_d = (float)(disp_min + num_disp - 1);
  const float radius = (float)plane_radius;

  for (int u = threadIdx.x; u < w; u += blockDim.x) {
    const size_t px = v * w + u;
    const size_t cell = (v * cw + min(u / cell_px, cw - 1)) * num_disp;
    const unsigned char* ml = gmask_l + cell;
    const unsigned char* mr = gmask_r + cell;
    const float m_l = mu_l[px];
    const float m_r = mu_r[px];
    const float rl = rintf(m_l), rr = rintf(m_r);
    const float lo_l = fminf(fmaxf(rl - radius, lo_d), hi_d);
    const float hi_l = fminf(fmaxf(rl + radius, lo_d), hi_d);
    const float lo_r = fminf(fmaxf(rr - radius, lo_d), hi_d);
    const float hi_r = fminf(fmaxf(rr + radius, lo_d), hi_d);
    const uint4 a = sl[u];
    const uint4 b = sr[u];

    float best_el = kBigF, best_er = kBigF;
    int best_dl = 0, best_dr = 0;
    for (int i = 0; i < num_disp; ++i) {
      const int d = disp_min + i;
      const float df = (float)d;
      if (u >= d && (ml[i] || (df >= lo_l && df <= hi_l))) {
        const float e =
            ielas::dense_energy(sad16(a, sr[u - d]), df, m_l, beta, gamma, two_s2);
        if (e < best_el) {
          best_el = e;
          best_dl = d;
        }
      }
      if (u + d < w && (mr[i] || (df >= lo_r && df <= hi_r))) {
        const float e =
            ielas::dense_energy(sad16(sl[u + d], b), df, m_r, beta, gamma, two_s2);
        if (e < best_er) {
          best_er = e;
          best_dr = d;
        }
      }
    }
    out_l[px] = (best_el < kBigF && sad16(a, zero) >= match_texture) ? (float)best_dl : -1.0f;
    out_r[px] = (best_er < kBigF && sad16(b, zero) >= match_texture) ? (float)best_dr : -1.0f;
  }
}

__global__ void xla_exp_log_kernel(const float* __restrict__ x, float* __restrict__ ex,
                                   float* __restrict__ lg, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    ex[i] = ielas::xla_expf(x[i]);
    lg[i] = ielas::xla_logf(x[i]);
  }
}

}  // namespace

// Launch on `stream` over `batch` frames of `h` rows.  desc_* are
// (batch, h, w, 16) int8, 16-byte aligned; mu_* and out_* are (batch, h, w)
// float32; gmask_* are (batch, h, cw, num_disp) bytes (0/1).  two_s2 is
// float32(2 * sigma * sigma).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int ielas_dense_match_stream(
    const void* desc_l, const void* desc_r, const void* mu_l, const void* mu_r,
    const void* gmask_l, const void* gmask_r, void* out_l, void* out_r, int batch, int h,
    int w, int cw,
    int num_disp, int disp_min, int plane_radius, int cell_px, float beta, float gamma,
    float two_s2, int match_texture, void* stream) {
  const size_t smem = (size_t)w * 2 * sizeof(uint4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_match_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dense_match_stream_kernel<<<dim3(h, batch), kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(desc_l), static_cast<const uint4*>(desc_r),
      static_cast<const float*>(mu_l), static_cast<const float*>(mu_r),
      static_cast<const unsigned char*>(gmask_l), static_cast<const unsigned char*>(gmask_r),
      static_cast<float*>(out_l), static_cast<float*>(out_r), h, w, cw, num_disp, disp_min,
      plane_radius, cell_px, beta, gamma, two_s2, match_texture);
  return (int)cudaGetLastError();
}

// ex[i] = XLA's expf(x[i]) and lg[i] = XLA's logf(x[i]) for n float32
// values (lg only for positive normal x), on `stream`.  Returns the
// cudaError_t of the launch.
extern "C" int ielas_xla_exp_log(const void* x, void* ex, void* lg, long long n,
                                 void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  xla_exp_log_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(ex), static_cast<float*>(lg), n);
  return (int)cudaGetLastError();
}
