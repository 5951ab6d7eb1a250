// Streaming support-point disparity search (paper Fig. 6) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/support_match.py
// ::support_match_pallas, whose body is the oracle
// src/repro/kernels/ref.py::support_match_rows_streaming.  Its plain PyTorch
// version is src/repro_torch/kernels/ref.py::support_match_rows_streaming;
// the output must equal it bit for bit.
//
// What bounds it on an H100: integer operations, not bytes.  A frame's
// candidate rows are a few MB of descriptors (KITTI: 2 x 75 x 1242 x 16 B =
// 3.0 MB) read once, but every (column, d) pair costs a 16-lane SAD plus a
// 4-deep register insert: ~ GH x (W + GW) x D x 16 byte differences, about
// 0.23 G for KITTI at D = 128.
//
// What the simple design does about it:
//   * one block per candidate row (a 2-D grid: row, frame of the wave, so
//     one launch covers a whole wave and B = 4 fills the 132 SMs that one
//     KITTI frame's 75 rows leave idle); the row's two descriptor rows are staged
//     once in shared memory (2 x W x 16 B, ~40 KB at KITTI width), stored in
//     offset binary (byte ^ 0x80) so one __vsadu4 gives the exact SAD of 4
//     signed bytes (|(a+128) - (b+128)| = |a - b|);
//   * pass A: threads stride over all W columns and fold the right view's
//     registers, CV_R[d, u] = SAD(dl[u + d], dr[u]), stopping at the right
//     edge (BIG entries never change strict-< registers);
//   * pass B: threads fold the left view at the GW candidate columns,
//     CV[d, u] = SAD(dl[u], dr[u - d]), then apply the texture / ratio /
//     L-R tests.  The cross-check reads the right view's argmin and its
//     verdict from shared memory at clip(u - best, 0, W - 1), which replaces
//     the reference's one-hot matmul.
//   Each thread folds d in ascending order with strict <, from registers
//   initialised to (BIG, d = 0), so ties keep the smallest d as argmin does.
//   As in the reference, d runs over [0, num_disp) whatever disp_min is;
//   disp_min only enters the margin test u >= disp_min + 2.
//   The ratio test is float32: (float)min1 < ratio * (float)min2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 1 << 28;
constexpr int kThreads = 512;
constexpr unsigned kFlip = 0x80808080u;

struct Regs4 {
  int v[4];
  int i[4];
};

__device__ __forceinline__ void init4(Regs4& r) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    r.v[k] = kBig;
    r.i[k] = 0;
  }
}

// ref._insert4: sorted insert, strict < (ties keep the earlier d).
__device__ __forceinline__ void insert4(Regs4& r, int v, int d) {
  const bool b1 = v < r.v[0], b2 = v < r.v[1], b3 = v < r.v[2], b4 = v < r.v[3];
  const int nv1 = b1 ? v : r.v[0];
  const int ni1 = b1 ? d : r.i[0];
  const int nv2 = b1 ? r.v[0] : (b2 ? v : r.v[1]);
  const int ni2 = b1 ? r.i[0] : (b2 ? d : r.i[1]);
  const int nv3 = b2 ? r.v[1] : (b3 ? v : r.v[2]);
  const int ni3 = b2 ? r.i[1] : (b3 ? d : r.i[2]);
  const int nv4 = b3 ? r.v[2] : (b4 ? v : r.v[3]);
  const int ni4 = b3 ? r.i[2] : (b4 ? d : r.i[3]);
  r.v[0] = nv1; r.v[1] = nv2; r.v[2] = nv3; r.v[3] = nv4;
  r.i[0] = ni1; r.i[1] = ni2; r.i[2] = ni3; r.i[3] = ni4;
}

// ref._finalize4: best, min1, and min2 outside |d - best| <= 1.
__device__ __forceinline__ void finalize4(const Regs4& r, int& best, int& min1, int& min2) {
  best = r.i[0];
  min1 = r.v[0];
  min2 = kBig;
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    const int dist = r.i[k] - best;
    if (dist > 1 || dist < -1) min2 = min(min2, r.v[k]);
  }
}

// Exact SAD of two 16-byte descriptors held in offset binary.
__device__ __forceinline__ int sad16(const uint4 a, const uint4 b) {
  return (int)(__vsadu4(a.x, b.x) + __vsadu4(a.y, b.y) + __vsadu4(a.z, b.z) +
               __vsadu4(a.w, b.w));
}

__device__ __forceinline__ uint4 flip(uint4 a) {
  a.x ^= kFlip; a.y ^= kFlip; a.z ^= kFlip; a.w ^= kFlip;
  return a;
}

__device__ __forceinline__ bool unique(int min1, int min2, float ratio) {
  return (float)min1 < ratio * (float)min2 && min1 < kBig;
}

__global__ void __launch_bounds__(kThreads) support_match_kernel(
    const uint4* __restrict__ desc_l, const uint4* __restrict__ desc_r,
    float* __restrict__ out, int gh, int w, int gw, int num_disp, int step, int offset,
    int support_texture, float ratio, int lr_threshold, int disp_min) {
  extern __shared__ uint4 smem[];
  uint4* sl = smem;
  uint4* sr = smem + w;
  int* best_r = reinterpret_cast<int*>(smem + 2 * w);
  unsigned char* ok_r = reinterpret_cast<unsigned char*>(best_r + w);

  const size_t row = (size_t)blockIdx.y * gh + blockIdx.x;   // frame * gh + row
  for (int u = threadIdx.x; u < w; u += blockDim.x) {
    sl[u] = flip(desc_l[row * w + u]);
    sr[u] = flip(desc_r[row * w + u]);
  }
  __syncthreads();
  const uint4 zero = make_uint4(kFlip, kFlip, kFlip, kFlip);

  // Pass A: right view at every column.
  for (int u = threadIdx.x; u < w; u += blockDim.x) {
    const uint4 b = sr[u];
    Regs4 r;
    init4(r);
    const int dmax = min(num_disp, w - u);
    for (int d = 0; d < dmax; ++d) insert4(r, sad16(sl[u + d], b), d);
    int best, min1, min2;
    finalize4(r, best, min1, min2);
    best_r[u] = best;
    ok_r[u] = unique(min1, min2, ratio) && sad16(b, zero) >= support_texture;
  }
  __syncthreads();

  // Pass B: left view at the candidate columns, then the decision.
  for (int j = threadIdx.x; j < gw; j += blockDim.x) {
    const int u = offset + j * step;
    const uint4 a = sl[u];
    Regs4 r;
    init4(r);
    const int dmax = min(num_disp, u + 1);
    for (int d = 0; d < dmax; ++d) insert4(r, sad16(a, sr[u - d]), d);
    int best, min1, min2;
    finalize4(r, best, min1, min2);
    const bool ok_l = unique(min1, min2, ratio) && sad16(a, zero) >= support_texture;
    const int ur = min(max(u - best, 0), w - 1);
    const int diff = best - best_r[ur];
    const bool consistent = diff <= lr_threshold && -diff <= lr_threshold;
    const bool valid = ok_l && ok_r[ur] && consistent && u >= disp_min + 2;
    out[row * gw + j] = valid ? (float)best : -1.0f;
  }
}

}  // namespace

// Launch on `stream` over `batch` frames of `gh` candidate rows.  desc_l /
// desc_r are (batch, gh, w, 16) int8, 16-byte aligned; out is (batch, gh,
// gw) float32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int ielas_support_match(const void* desc_l, const void* desc_r, void* out,
                                   int batch, int gh, int w, int gw, int num_disp, int step,
                                   int offset, int support_texture, float ratio,
                                   int lr_threshold, int disp_min, void* stream) {
  const size_t smem = (size_t)w * (2 * sizeof(uint4) + sizeof(int) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        support_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  support_match_kernel<<<dim3(gh, batch), kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(desc_l), static_cast<const uint4*>(desc_r),
      static_cast<float*>(out), gh, w, gw, num_disp, step, offset, support_texture, ratio,
      lr_threshold, disp_min);
  return (int)cudaGetLastError();
}
