// Valid-aware 3x3 median for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/median.py
// ::median3x3_pallas, whose body is the oracle
// src/repro/kernels/ref.py::median3x3_rows_ref.  Its plain PyTorch version
// is src/repro_torch/kernels/ref.py::median3x3_rows_ref on the edge-padded
// map; the output must equal it bit for bit.
//
// What bounds it on an H100: bytes.  Each pixel reads one float (its eight
// neighbours come from the L1 cache) and writes one: 8 B a pixel, 3.7 MB
// for a KITTI frame (1.1 us of HBM time), against 19 min/max pairs and 9
// selects a pixel.
//
// What the simple design does about it: one thread per output pixel; a 2-D
// grid whose y axis walks the rows of every map of the stack (a whole wave
// in one launch) and whose x axis covers a row, consecutive threads on
// consecutive columns.  Edge padding by clamped indices; an invalid (-1)
// neighbour takes the centre's value and an invalid centre stays -1, as in
// the reference.  The median is Paeth's 19-op min/max network, the plain
// version's: any exact median-of-9 gives the same value, and disparities
// hold no NaN and no -0.0.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInvalid = -1.0f;

__device__ __forceinline__ void sort2(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

__global__ void __launch_bounds__(kThreads) median3x3_kernel(
    const float* __restrict__ disp, float* __restrict__ out, int rows, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {   // map * h + y
    const int y = row % h;
    const float* map = disp + (size_t)(row - y) * w;
    const size_t i = (size_t)row * w + x;
    const float centre = disp[i];
    if (centre == kInvalid) {
      out[i] = kInvalid;
      continue;
    }
    float v[9];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* r = map + (size_t)min(max(y + dy - 1, 0), h - 1) * w;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float nb = r[min(max(x + dx - 1, 0), w - 1)];
        v[3 * dy + dx] = nb == kInvalid ? centre : nb;
      }
    }
    // Paeth, "Median Finding on a 3x3 Grid" (Graphics Gems).
    sort2(v[1], v[2]); sort2(v[4], v[5]); sort2(v[7], v[8]);
    sort2(v[0], v[1]); sort2(v[3], v[4]); sort2(v[6], v[7]);
    sort2(v[1], v[2]); sort2(v[4], v[5]); sort2(v[7], v[8]);
    sort2(v[0], v[3]); sort2(v[5], v[8]); sort2(v[4], v[7]);
    sort2(v[3], v[6]); sort2(v[1], v[4]); sort2(v[2], v[5]);
    sort2(v[4], v[7]); sort2(v[4], v[2]); sort2(v[6], v[4]);
    sort2(v[4], v[2]);
    out[i] = v[4];
  }
}

}  // namespace

// Launch on `stream` over `n` maps of (h, w) float32; out has the same
// shape.  Returns the cudaError_t of the launch (0 on success).
extern "C" int ielas_median3x3(const void* disp, void* out, int n, int h, int w,
                               void* stream) {
  const int rows = n * h;
  const dim3 grid((w + kThreads - 1) / kThreads, rows < 65535 ? rows : 65535);
  median3x3_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(disp), static_cast<float*>(out), rows, h, w);
  return (int)cudaGetLastError();
}
