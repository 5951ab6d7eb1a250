// Streaming gather-free dense matching, both views in one launch, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dense_match.py
// ::dense_match_stream_pallas, whose body is the oracle
// src/repro/kernels/ref.py::dense_match_rows_stream_ref.  Its plain PyTorch
// version is src/repro_torch/kernels/ref.py::dense_match_rows_stream_ref;
// the output must equal it bit for bit.
//
// What the kernel computes: for each pixel and view, the candidate set is
// the pixel's cell's bitmask over d in [disp_min, disp_min + D) OR the
// prior band clip(rint(mu) -/+ R), AND the d whose matching column lies in
// the image (left view u - d >= 0, right view u + d < W); the result is the
// candidate of least energy, the smallest d on ties (the scan's strict <).
//
// What bounds it on an H100: instruction issue.  The data needs few
// candidates: at KITTI (375 x 1242, D = 128) 5.2 M of the 119 M (pixel, d,
// view) triples, under 6 a pixel and view, each a 16-byte SAD and the
// energy's exp and log (about 100 instructions with the walk that finds
// it).  Moving the inputs once (28 MB: descriptors, priors, bitmask bytes,
// outputs) takes about 8.5 us at 3.35 TB/s, and the kernel takes as long
// with every block reading one row's data from L2 as with its own: the
// time goes to instructions, not bytes.  A scan over all D steps, as the
// TPU kernel does, spends its issue slots on mask tests and leaves a warp
// paying for the union of its lanes' branches.
//
// What the design does about it:
//   * one block per tile of kTile pixels of an image row, one thread per
//     (pixel, view) (left-view warps, then right-view warps): a KITTI
//     frame is 3,750 blocks of 8 warps;
//   * the block issues all its loads before waiting on any: the descriptor
//     columns the tile matches against (kTile + D - 1 of each view, 16-byte
//     cp.async into shared memory), the thread's own descriptor and prior,
//     and the tile's bitmask bytes, 16 at a time, packed to bits in shared
//     memory (a flat bit array of the tile's cells, so a cell's word k is
//     one funnel shift);
//   * each thread builds its candidate words once per 32 d -- cell word OR
//     band bits AND in-image bits -- and walks the set bits in ascending d
//     with __ffs, folding with the scan's strict <; the walk is one flat
//     loop, so a warp's energy step runs converged and the warp pays for
//     its busiest lane's count (93% of lanes busy at KITTI), not for the
//     union of its lanes' sets;
//   * 2 sigma^2 = 2 (sigma = 1) is a power of two, so the energy's division
//     by it is a multiply by its reciprocal, which rounds the same
//     (dense_common.cuh); any other sigma divides.
// D is at most kMaxDisp (the wrapper raises above it on every device), so
// the staging fits in shared memory.
// Bit-exactness: the same set in the same order as the scan; the energy is
// XLA:CPU's float32 sequence (xla_math.cuh), built with --fmad=false and
// without fast math; rintf for round-half-to-even; best d starts at 0 and
// valid = emin < BIGF && texture >= match_texture.  The band test is done
// on integers, which equals the plain version's float compare because an
// in-image d is below W <= 2^24 (the wrapper's limit) and so exact.
//
// The source also exports ielas_xla_exp_log, which evaluates the header's
// exp and log on an array, so their bits can be held against the plain
// version's on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_common.cuh"
#include "xla_math.cuh"

namespace {

constexpr int kTile = 128;              // pixels of a row per block
constexpr int kThreads = 2 * kTile;     // one thread per (pixel, view)
constexpr int kMaxDisp = 1024;          // num_disp limit (kernels/dense_match.py)
constexpr int kMaxRows = 65535;         // grid y limit; more rows go to grid z

// Bits lo..hi of a 32-bit word, clipped to [0, 31]; 0 when empty.
__device__ __forceinline__ unsigned span_bits(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 31);
  return lo > hi ? 0u : (0xffffffffu >> (31 - hi)) & (0xffffffffu << lo);
}

// Four 0/1 bytes to four bits (byte j to bit j).
__device__ __forceinline__ unsigned nibble(unsigned x) {
  return (x | x >> 7 | x >> 14 | x >> 21) & 0xfu;
}

__global__ void __launch_bounds__(kThreads) dense_match_stream_kernel(
    const uint4* __restrict__ desc_l, const uint4* __restrict__ desc_r,
    const float* __restrict__ mu_l, const float* __restrict__ mu_r,
    const unsigned char* __restrict__ gmask_l, const unsigned char* __restrict__ gmask_r,
    float* __restrict__ out_l, float* __restrict__ out_r, int rows, int w, int cw,
    int num_disp, int disp_min, int plane_radius, int cell_px, int mask_words,
    float beta, float gamma, float two_s2, float inv, int match_texture) {
  extern __shared__ uint4 smem[];
  const int span = kTile + num_disp - 1;
  // Right-view columns [u0 - disp_min - D + 1, +span) for the left view,
  // left-view columns [u0 + disp_min, +span) for the right view.
  uint4* s_dr = smem;
  uint4* s_dl = smem + span;
  unsigned* s_bits = reinterpret_cast<unsigned*>(smem + 2 * span);   // 2 x mask_words

  const int row = blockIdx.z * kMaxRows + blockIdx.y;      // frame * h + image row
  if (row >= rows) return;
  const int u0 = blockIdx.x * kTile;
  const int n = min(kTile, w - u0);
  const size_t row_px = (size_t)row * w;
  const bool left = threadIdx.x < kTile;
  const int t = left ? threadIdx.x : threadIdx.x - kTile;
  const int u = u0 + min(t, n - 1);
  const size_t px = row_px + u;

  // Every global load of the block is issued before any is waited on: this
  // thread's descriptor and prior, the staged columns (cp.async, flipped to
  // offset binary where they are read), and the bitmask bytes (16 at a
  // time).
  const uint4 a = ielas::flip((left ? desc_l : desc_r)[px]);
  const float mu = (left ? mu_l : mu_r)[px];
  const long long first_r = (long long)u0 - disp_min - num_disp + 1;
  const long long first_l = (long long)u0 + disp_min;
  for (int j = threadIdx.x; j < span; j += kThreads) {
    const long long cr = first_r + j, cl = first_l + j;
    if (cr >= 0 && cr < w) ielas::cp_async16(s_dr + j, desc_r + row_px + cr);
    if (cl < w) ielas::cp_async16(s_dl + j, desc_l + row_px + cl);
  }

  // The bitmask bytes of the tile's cells c0..c1, from the 16-byte boundary
  // at or below the first, packed to bits in shared memory: bit mis + (c -
  // c0) * D + i of a view's array is the byte of cell c at d = disp_min + i.
  const int c0 = min(u0 / cell_px, cw - 1);
  const int c1 = min((u0 + n - 1) / cell_px, cw - 1);
  const size_t mask_row = ((size_t)row * cw + c0) * num_disp;
  const size_t mask_len = (size_t)rows * cw * num_disp;
  const int mis_l = (int)((uintptr_t)(gmask_l + mask_row) & 15);
  const int mis_r = (int)((uintptr_t)(gmask_r + mask_row) & 15);
  const int nbytes = (c1 - c0 + 1) * num_disp;
  const int chunks_l = (mis_l + nbytes + 15) >> 4;
  const int chunks_r = (mis_r + nbytes + 15) >> 4;
  unsigned short* s_half = reinterpret_cast<unsigned short*>(s_bits);
  for (int q = threadIdx.x; q < chunks_l + chunks_r; q += kThreads) {
    const bool right = q >= chunks_l;
    const int qq = right ? q - chunks_l : q;
    const unsigned char* m = right ? gmask_r : gmask_l;
    const unsigned char* at = m + mask_row - (right ? mis_r : mis_l) + 16 * qq;
    unsigned half = 0;
    if (at >= m && at + 16 <= m + mask_len) {
      const uint4 v = *reinterpret_cast<const uint4*>(at);
      half = nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 | nibble(v.w) << 12;
    } else {                                  // a chunk across either end of the tensor
      for (int b = 0; b < 16; ++b)
        if (at + b >= m && at + b < m + mask_len && at[b]) half |= 1u << b;
    }
    s_half[(right ? 2 * mask_words : 0) + qq] = (unsigned short)half;
  }
  ielas::cp_async_wait_all();
  __syncthreads();
  if (t >= n) return;

  float best_e = ielas::kBigF;
  int best_d = 0;
  // d = disp_min + i is in the image for i <= lim.
  const int lim = (left ? u : w - 1 - u) - disp_min;
  if (lim >= 0) {
    const int imax = min(lim, num_disp - 1);
    const int kmax = imax >> 5;
    const float r = rintf(mu);
    const float lo_d = (float)disp_min, hi_d = (float)(disp_min + num_disp - 1);
    const int blo = (int)fminf(fmaxf(r - (float)plane_radius, lo_d), hi_d) - disp_min;
    const int bhi = min((int)fminf(fmaxf(r + (float)plane_radius, lo_d), hi_d) - disp_min, imax);
    const unsigned* bits = s_bits + (left ? 0 : mask_words);
    const int bit0 = (left ? mis_l : mis_r) + (min(u / cell_px, cw - 1) - c0) * num_disp;
    // The column d = disp_min + i matches: left dst[-i], right dst[i].
    const uint4* dst = left ? s_dr + t + num_disp - 1 : s_dl + t;
    const int step = left ? -1 : 1;
    const unsigned last = span_bits(0, imax - 32 * kmax);

    auto word = [&](int k) {
      const int o = bit0 + 32 * k;
      const unsigned cell = __funnelshift_r(bits[o >> 5], bits[(o >> 5) + 1], o & 31);
      return (cell | span_bits(blo - 32 * k, bhi - 32 * k)) & (k < kmax ? ~0u : last);
    };
    int k = 0;
    unsigned cand = word(0);
    for (;;) {
      while (cand == 0 && k < kmax) cand = word(++k);
      if (cand == 0) break;
      const int i = 32 * k + __ffs(cand) - 1;
      cand &= cand - 1;
      const int d = disp_min + i;
      const int sad = ielas::sad16(a, ielas::flip(dst[step * i]));
      const float e = ielas::energy(sad, (float)d, mu, beta, gamma, two_s2, inv);
      if (e < best_e) {
        best_e = e;
        best_d = d;
      }
    }
  }
  (left ? out_l : out_r)[px] =
      (best_e < ielas::kBigF && ielas::texture16(a) >= match_texture) ? (float)best_d : -1.0f;
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
// float32; gmask_* are (batch, h, cw, num_disp) bytes (0/1), num_disp <=
// 1024.  two_s2 is float32(2 * sigma * sigma).  Returns the cudaError_t of
// the launch (0 on success; cudaErrorInvalidValue for num_disp out of range).
extern "C" int ielas_dense_match_stream(
    const void* desc_l, const void* desc_r, const void* mu_l, const void* mu_r,
    const void* gmask_l, const void* gmask_r, void* out_l, void* out_r, int batch, int h,
    int w, int cw, int num_disp, int disp_min, int plane_radius, int cell_px, float beta,
    float gamma, float two_s2, int match_texture, void* stream) {
  if (num_disp < 1 || num_disp > kMaxDisp) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)batch * h;
  if (rows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTile - 1) / kTile, rows < kMaxRows ? (unsigned)rows : kMaxRows,
                  (unsigned)((rows + kMaxRows - 1) / kMaxRows));
  // Cells one tile can touch, and the words of their packed bits: up to 15
  // bits before the first (the 16-byte boundary), and one more word for the
  // funnel shift's high half.
  const int reach = (kTile - 1) / cell_px + 2;
  const int cells = cw < reach ? cw : reach;
  const int mask_words = (cells * num_disp + 15 + 31) / 32 + 1;
  const size_t smem =
      2 * (size_t)(kTile + num_disp - 1) * sizeof(uint4) + 2 * (size_t)mask_words * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_match_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dense_match_stream_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(desc_l), static_cast<const uint4*>(desc_r),
      static_cast<const float*>(mu_l), static_cast<const float*>(mu_r),
      static_cast<const unsigned char*>(gmask_l), static_cast<const unsigned char*>(gmask_r),
      static_cast<float*>(out_l), static_cast<float*>(out_r), (int)rows, w, cw, num_disp,
      disp_min, plane_radius, cell_px, mask_words, beta, gamma, two_s2,
      ielas::pow2_reciprocal(two_s2), match_texture);
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
