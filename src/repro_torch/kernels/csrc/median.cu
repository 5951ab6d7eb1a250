// Valid-aware 3x3 median for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/median.py
// ::median3x3_pallas, whose body is the oracle
// src/repro/kernels/ref.py::median3x3_rows_ref.  Its plain PyTorch version
// is src/repro_torch/kernels/ref.py::median3x3_rows_ref on the edge-padded
// map; the output must equal it bit for bit.
//
// What it computes: for each pixel with a valid centre c, the median of its
// 3x3 window (edges replicated) after every invalid (-1) neighbour is
// replaced by c; an invalid centre stays -1.
//
// What bounds it on an H100: bytes.  Each pixel reads one float and writes
// one: 8 B a pixel, 3.7 MB for a KITTI frame (1.1 us of HBM time).  At that
// size one trip to memory and the launch take about as long, so the design
// keeps each thread's loads few, wide and independent, and its arithmetic
// short.
//
// What the design does about it:
//   * a warp takes 128 columns of kRows output rows, a thread 4 columns; it
//     loads the kRows + 2 input rows once (16 bytes a row where the row's
//     address allows, else two 8-byte or four 4-byte loads: KITTI's
//     1242-float rows alternate; the columns beside its own from the
//     neighbouring lanes by shuffles), keeps the window in registers and
//     stores 16 bytes a row where it can: kRows + 2 row loads a thread for
//     4 x kRows outputs, where the simple design made 9 clamped loads a
//     pixel;
//   * each output's 9 neighbours come from those registers, an invalid one
//     replaced by the centre, and Paeth's network picks the median -- the
//     plain version's network, so the kernel returns its bits;
//   * the grid's z axis walks the maps of a stack (a wave), so rows of
//     different maps never meet, and no index is divided.
// Tried and slower on the path's maps (dense_profile.py, PERF.md): medians
// from sorted columns shared between neighbouring outputs (exact as
// clamp(centre, median with -1 as -inf, median with -1 as +inf)), which
// needs two medians where a window may hold -1 (15% / 26% of a KITTI /
// Tsukuba map's pixels are -1, so a branch to one median would rarely find
// a warp's windows free of them).
// Disparities hold no NaN and no -0.0 (pinned by tests/test_torch_median.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 2;              // output rows a thread walks
constexpr int kWarps = 4;             // warps a block, stacked down the rows
constexpr int kSpan = 32 * 4;         // columns a warp (4 a thread)
constexpr float kInvalid = -1.0f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void sort2(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// The median of x[0..8]: Paeth, "Median Finding on a 3x3 Grid" (Graphics
// Gems), the plain version's network.
__device__ __forceinline__ float median9(float x[9]) {
  sort2(x[1], x[2]); sort2(x[4], x[5]); sort2(x[7], x[8]);
  sort2(x[0], x[1]); sort2(x[3], x[4]); sort2(x[6], x[7]);
  sort2(x[1], x[2]); sort2(x[4], x[5]); sort2(x[7], x[8]);
  sort2(x[0], x[3]); sort2(x[5], x[8]); sort2(x[4], x[7]);
  sort2(x[3], x[6]); sort2(x[1], x[4]); sort2(x[2], x[5]);
  sort2(x[4], x[7]); sort2(x[4], x[2]); sort2(x[6], x[4]);
  sort2(x[4], x[2]);
  return x[4];
}

// Columns x0 - 1 .. x0 + 4 of one row (edge-clamped) into v[0..5]: the
// lane's four by the widest load the address allows (the same for every
// lane of the warp, whose columns start 16 bytes apart), the two beside them
// from the neighbouring lanes, or loaded at the warp's ends.  Every lane of
// the warp calls it (the shuffles need them all).
__device__ __forceinline__ void load_row(const float* __restrict__ r, int x0, int w, int lane,
                                         float v[6]) {
  if (x0 + 3 < w) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(r + x0);
    if ((a & 15) == 0) {
      const float4 q = *reinterpret_cast<const float4*>(r + x0);
      v[1] = q.x; v[2] = q.y; v[3] = q.z; v[4] = q.w;
    } else if ((a & 7) == 0) {
      const float2 p = *reinterpret_cast<const float2*>(r + x0);
      const float2 q = *reinterpret_cast<const float2*>(r + x0 + 2);
      v[1] = p.x; v[2] = p.y; v[3] = q.x; v[4] = q.y;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[1 + k] = r[x0 + k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[1 + k] = r[min(x0 + k, w - 1)];
  }
  const float left = __shfl_up_sync(kFull, v[4], 1);
  const float right = __shfl_down_sync(kFull, v[1], 1);
  v[0] = lane > 0 ? left : r[max(x0 - 1, 0)];
  v[5] = lane < 31 ? right : r[min(x0 + 4, w - 1)];
}

// o[0..3] to columns x0 .. x0 + 3 of a row, those inside it.
__device__ __forceinline__ void store_row(float* __restrict__ r, int x0, int w,
                                          const float o[4]) {
  if (x0 + 3 < w) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(r + x0);
    if ((a & 15) == 0) {
      *reinterpret_cast<float4*>(r + x0) = make_float4(o[0], o[1], o[2], o[3]);
    } else if ((a & 7) == 0) {
      *reinterpret_cast<float2*>(r + x0) = make_float2(o[0], o[1]);
      *reinterpret_cast<float2*>(r + x0 + 2) = make_float2(o[2], o[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) r[x0 + k] = o[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (x0 + k < w) r[x0 + k] = o[k];
  }
}

__global__ void __launch_bounds__(32 * kWarps) median3x3_kernel(
    const float* __restrict__ disp, float* __restrict__ out, int n, int h, int w) {
  const int lane = threadIdx.x & 31;
  const int y0 = (blockIdx.y * kWarps + (threadIdx.x >> 5)) * kRows;
  if (y0 >= h) return;                                    // the whole warp
  const int x0 = blockIdx.x * kSpan + 4 * lane;
  for (int map = blockIdx.z; map < n; map += gridDim.z) {
    const float* src = disp + (size_t)map * h * w;
    float* dst = out + (size_t)map * h * w;
    // Input rows y0 - 1 .. y0 + kRows, edge-clamped.
    float v[kRows + 2][6];
#pragma unroll
    for (int i = 0; i < kRows + 2; ++i)
      load_row(src + (size_t)min(max(y0 - 1 + i, 0), h - 1) * w, x0, w, lane, v[i]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (y0 + r >= h) break;                             // the whole warp
      float o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float c = v[r + 1][k + 1];
        float x[9];
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          const float nb = v[r + i / 3][k + i % 3];
          x[i] = nb == kInvalid ? c : nb;
        }
        o[k] = c == kInvalid ? kInvalid : median9(x);
      }
      store_row(dst + (size_t)(y0 + r) * w, x0, w, o);
    }
  }
}

}  // namespace

// Launch on `stream` over `n` maps of (h, w) float32; out has the same
// shape.  Returns the cudaError_t of the launch (0 on success).
extern "C" int ielas_median3x3(const void* disp, void* out, int n, int h, int w,
                               void* stream) {
  const int rows_a_block = kWarps * kRows;
  const dim3 grid((w + kSpan - 1) / kSpan, (h + rows_a_block - 1) / rows_a_block,
                  n < 65535 ? n : 65535);
  median3x3_kernel<<<grid, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(disp), static_cast<float*>(out), n, h, w);
  return (int)cudaGetLastError();
}
