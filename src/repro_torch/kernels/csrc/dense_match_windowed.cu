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
// What the kernel computes: for each pixel and view, the energy e at each
// of its C int32 candidates d, BIGF where the matching column (left view
// u - d, right view u + d) is off the image, and the reference's
// min(where(e == emin, d, S)) over the slots, S = disp_min + num_disp: the
// smallest value of least energy, capped at S when some slot lies above the
// least energy (only values at or above S, which candidate_set never
// makes, meet the cap).  That depends on the set of (energy, value) pairs
// alone: not on the order of the slots, and not on repeats (same energy,
// same value).  An off-image slot only tells that some slot lies above a
// valid minimum, so it is noted and not evaluated.
//
// What bounds it on an H100: instruction issue, then bytes.  The two
// candidate tensors are most of the traffic (KITTI, C = 25: 93 MB of
// ~115 MB a frame, ~34 us at 3.35 TB/s), but the kernel takes as long with
// every warp reading one row's windows from L2 as with its own: the time
// goes to instructions.  A window holds the cell's K grid-vector values
// (repeats when the cell has fewer distinct disparities) and the 2R + 1
// band values: 5.2 M distinct in-image values in 22 M in-image slots at
// KITTI, so an energy per slot would be 4x the work the data needs.
//
// What the design does about it:
//   * the grid is flat over the frame's (or wave's) pixels: a warp owns 32
//     consecutive pixels of one view, a block 4 such warps;
//   * a warp stages its 32 windows through shared memory, 16-byte cp.async
//     (4-byte at unaligned ends), kChunk ints a pass;
//   * each lane walks its own window in shared memory, skips a value equal
//     to the slot before (a run of repeats costs one compare a slot), and
//     marks the in-image values of [disp_min, disp_min + 128) in a 128-bit
//     seen set in registers;
//   * then walks the set bits with __ffsll in one flat loop: each distinct
//     value is evaluated once, and a warp pays for its busiest lane's count
//     of distinct values, not for C slots; an in-image value outside the
//     set's range is rare (candidate_set never makes one) and is evaluated
//     from global memory, every time;
//   * the matching descriptor is a 16-byte __ldg of the other view's row
//     (neighbouring lanes read neighbouring columns, so mostly L1 hits);
//   * 2 sigma^2 = 2 (sigma = 1) is a power of two, so the energy's division
//     by it is a multiply by its reciprocal, which rounds the same
//     (dense_common.cuh); any other sigma divides.
// Bit-exactness: the energy is XLA:CPU's float32 sequence (xla_math.cuh),
// built with --fmad=false and without fast math; the fold keeps the least
// energy (a NaN sticks, as in jnp.min), the smallest value at it and
// whether any slot lies above it, and valid = emin < BIGF && texture >=
// match_texture.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_common.cuh"
#include "xla_math.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 1024;      // ints staged per warp and pass (4 KB; one pass for C <= 32)
constexpr unsigned kSeen = 128;   // the seen bitset covers disp_min + [0, 128)

__global__ void __launch_bounds__(kThreads) dense_match_windowed_kernel(
    const uint4* __restrict__ desc_l, const uint4* __restrict__ desc_r,
    const float* __restrict__ mu_l, const float* __restrict__ mu_r,
    const int* __restrict__ cand_l, const int* __restrict__ cand_r,
    float* __restrict__ out_l, float* __restrict__ out_r, int npx, int w, int c,
    int num_disp, int disp_min, float beta, float gamma, float two_s2, float inv,
    int match_texture) {
  // A warp's staged candidates, 16-byte aligned where global memory is (4
  // words of slack).
  __shared__ int4 s_win[kWarps][kChunk / 4 + 1];

  const bool left = blockIdx.y == 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int px0 = (blockIdx.x * kWarps + warp) * 32;
  if (px0 >= npx) return;                       // a whole warp past the end
  const int px = px0 + lane;
  const bool active = px < npx;
  const int pxa = active ? px : npx - 1;
  const uint4 a = ielas::flip((left ? desc_l : desc_r)[pxa]);
  const float mu = (left ? mu_l : mu_r)[pxa];
  const int u = pxa % w;
  const unsigned uw = (unsigned)w;

  // The warp's windows are the ints [0, total) from `window`; lane l's slots
  // are [l * c, l * c + c) of them.  Each lane marks its in-image values in
  // [disp_min, disp_min + 128) in a 128-bit seen set, and notes whether a
  // slot is off the image and whether an in-image value lies outside the set.
  const int* window = (left ? cand_l : cand_r) + (size_t)px0 * c;
  const int total = (min(npx, px0 + 32) - px0) * c;
  const int mine = lane * c;
  int* buf = reinterpret_cast<int*>(s_win[warp]);
  unsigned long long seen_lo = 0, seen_hi = 0;
  bool off = false, far = false;
  for (int b0 = 0; b0 < total; b0 += kChunk) {
    const int len = min(kChunk, total - b0);
    const int* src = window + b0;
    const int shift = (int)(((uintptr_t)src >> 2) & 3);   // src[e] goes to buf[shift + e]
    __syncwarp();                               // the last pass's reads are done
    // 16-byte copies where both ends are 16-byte aligned (every one, for an
    // aligned tensor and a whole warp), 4-byte ones at the pass's ends.
    const int head = min((4 - shift) & 3, len), body = (len - head) >> 2;
    for (int q = lane; q < body; q += 32)
      ielas::cp_async16(buf + shift + head + 4 * q, src + head + 4 * q);
    if (lane < head + ((len - head) & 3)) {
      const int e = lane < head ? lane : 4 * body + lane;
      ielas::cp_async4(buf + shift + e, src + e);
    }
    ielas::cp_async_wait_all();
    __syncwarp();
    if (active) {
      const int first = shift + max(mine, b0) - b0, last = shift + min(mine + c, b0 + len) - b0;
      int prev = buf[first] ^ 1;
      for (int e = first; e < last; ++e) {
        const int d = buf[e];
        if (d == prev) continue;                // a repeat of the slot before
        prev = d;
        const unsigned col = left ? (unsigned)u - (unsigned)d : (unsigned)u + (unsigned)d;
        const unsigned i = (unsigned)d - (unsigned)disp_min;
        const bool in = col < uw;
        off |= !in;
        far |= in && i >= kSeen;
        const unsigned long long bit = in && i < kSeen ? 1ull << (i & 63) : 0ull;
        if (i < 64) {
          seen_lo |= bit;
        } else {
          seen_hi |= bit;
        }
      }
    }
  }
  if (!active) return;

  // The fold: the least energy (a NaN sticks), the smallest value at it, and
  // whether some slot lies above it (an off-image slot, energy BIGF, does).
  const float inf = __int_as_float(0x7f800000);
  const int sentinel = disp_min + num_disp;
  const uint4* dst = left ? desc_r + pxa : desc_l + pxa;
  const int step = left ? -1 : 1;
  float emin = inf;
  int best = sentinel;
  bool above = off;
  auto fold = [&](int d) {
    const uint4 m = ielas::flip(__ldg(dst + step * d));
    const float e = ielas::energy(ielas::sad16(a, m), (float)d, mu, beta, gamma, two_s2, inv);
    if (e < emin) {
      above |= emin < inf;
      best = d;
    } else if (e == emin) {
      best = min(best, d);
    } else if (e > emin) {
      above = true;
    }
    if (e < emin || e != e) emin = e;
  };
  // Each marked value once, in one flat loop (a warp pays for its busiest
  // lane's count).
  unsigned long long bits = seen_lo;
  int base = 0;
  for (;;) {
    if (bits == 0 && base == 0) {
      bits = seen_hi;
      base = 64;
    }
    if (bits == 0) break;
    const int i = base + __ffsll(bits) - 1;
    bits &= bits - 1;
    fold(disp_min + i);
  }
  if (far) {                                    // in-image values outside the set: every slot
    for (int k = 0; k < c; ++k) {
      const int d = window[mine + k];
      const unsigned col = left ? (unsigned)u - (unsigned)d : (unsigned)u + (unsigned)d;
      if (col < uw && (unsigned)d - (unsigned)disp_min >= kSeen) fold(d);
    }
  }
  if (above) best = min(best, sentinel);
  (left ? out_l : out_r)[px] =
      (emin < ielas::kBigF && ielas::texture16(a) >= match_texture) ? (float)best : -1.0f;
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
  // Pixel offsets are ints: a frame stack of 2^31 pixels would hold over
  // 200 GB of candidates.
  const long long npx = (long long)batch * h * w;
  if (npx > 0x7fffffffLL - 32 || c > (1 << 24)) return (int)cudaErrorInvalidValue;
  dense_match_windowed_kernel<<<dim3((unsigned)((npx + kThreads - 1) / kThreads), 2), kThreads,
                                0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(desc_l), static_cast<const uint4*>(desc_r),
      static_cast<const float*>(mu_l), static_cast<const float*>(mu_r),
      static_cast<const int*>(cand_l), static_cast<const int*>(cand_r),
      static_cast<float*>(out_l), static_cast<float*>(out_r), (int)npx, w, c, num_disp,
      disp_min, beta, gamma, two_s2, ielas::pow2_reciprocal(two_s2), match_texture);
  return (int)cudaGetLastError();
}
