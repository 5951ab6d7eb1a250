// 3x3 Sobel (du and dv) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sobel.py::sobel_pallas,
// whose body is the oracle src/repro/kernels/ref.py::sobel_rows_ref.  Its
// plain PyTorch version is src/repro_torch/kernels/ref.py::sobel_rows_ref
// on the edge-padded image of the grey levels cast to int32; the output
// must equal it bit for bit.
//
// What bounds it on an H100: bytes, and at these sizes the latency of a
// trip to memory and the launch.  The main path hands it uint8 grey levels:
// 1 B in and 2 B out a pixel, 2.8 MB for both views of a KITTI frame
// (0.83 us at 3.35 TB/s), against ~30 integer operations a pixel.
//
// What the design does about it:
//   * the kernel reads the grey levels in their own type (uint8, int32 or
//     float32; a float truncates toward zero, cvt.rzi.s32.f32, as
//     Tensor.to(torch.int32) does on the card), so no cast kernel runs
//     before it;
//   * a thread takes 16 adjacent columns down kRows rows of one image (a
//     register strip walk), keeping the three rows around the current one
//     in registers, so each input row is loaded once a thread.  One launch
//     covers the whole (n, h, w) stack: both views of a frame or a wave;
//   * a uint8 row comes in as the two (or three) aligned 16-byte chunks
//     that hold its 18 bytes, brought into registers by funnel shifts;
//     columns -1 and w, the chunks at a row's two ends, and int32 and
//     float32 images are read element by element with clamped columns;
//   * output rows start at any byte offset, so a thread stores the aligned
//     16 bytes that start inside its columns, the bytes past them taken
//     from the next lane by a shuffle; the bytes at a row's ends (and where
//     the next lane holds another row) go out as single bytes.
// No load leaves the image stack.  Why 2 rows a thread: in one call
// (dense_profile.py; NVIDIA H100 80GB HBM3, 700 W) 2 rows took 5.00 / 3.88
// us at KITTI / Tsukuba, 4 and 8 rows 6.79 / 5.86 and 10.70 / 9.54 (fewer
// threads to cover a trip to memory), and the earlier design (a thread per
// aligned 16-byte output chunk of the flat stack) 5.52 / 4.62.
// g // 4 is floor division in the reference: an arithmetic shift right by
// two.  The sums wrap in 32 bits, as the reference's int32 arithmetic does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;                 // columns a thread
constexpr int kRows = 2;                   // rows a thread walks

enum Kind { kU8 = 0, kI32 = 1, kF32 = 2 };

__device__ __forceinline__ int grey(uint8_t v) { return v; }
__device__ __forceinline__ int grey(int v) { return v; }
__device__ __forceinline__ int grey(float v) { return __float2int_rz(v); }

__device__ __forceinline__ unsigned pack(int g) {
  return (unsigned)min(max(g >> 2, -128), 127) & 0xffu;
}

// Wrapping int32 arithmetic (the reference's), without signed overflow.
__device__ __forceinline__ int add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }

// 18 bytes starting `off` bytes into three consecutive 16-byte chunks
// (off < 16), as ints.
template <int kQ>
__device__ __forceinline__ void bytes18_at(const unsigned* w, int sh, int* v) {
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const unsigned word = __funnelshift_r(w[j + kQ], w[j + kQ + 1], sh);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (4 * j + k < 18) v[4 * j + k] = (int)__byte_perm(word, 0u, 0x4440 + k);
    }
  }
}

__device__ __forceinline__ void bytes18(const uint4 a, const uint4 b, const uint4 c, int off,
                                        int* v) {
  const unsigned w[12] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w};
  const int sh = 8 * (off & 3);
  switch (off >> 2) {
    case 0: bytes18_at<0>(w, sh, v); break;
    case 1: bytes18_at<1>(w, sh, v); break;
    case 2: bytes18_at<2>(w, sh, v); break;
    default: bytes18_at<3>(w, sh, v); break;
  }
}

// The grey levels of columns x0 - 1 .. x0 + 16 of `row`, clamped to the
// row, as ints.
template <typename T>
__device__ __forceinline__ void load_row(const T* row, int x0, int w, const T*, int* v) {
#pragma unroll
  for (int k = 0; k < kChunk + 2; ++k) v[k] = grey(row[min(max(x0 - 1 + k, 0), w - 1)]);
}

// uint8: the aligned 16-byte chunks that hold the 18 bytes, when none of
// the columns needs clamping and the chunks lie inside the stack (which
// ends at `end`; x0 >= 16 keeps the first chunk after the stack's start).
template <>
__device__ __forceinline__ void load_row(const uint8_t* row, int x0, int w, const uint8_t* end,
                                         int* v) {
  const uintptr_t a = (uintptr_t)(row + x0 - 1);
  const uintptr_t base = a & ~(uintptr_t)15;
  const int off = (int)(a & 15);
  if (x0 >= kChunk && x0 + kChunk < w && base + (off == 15 ? 48 : 32) <= (uintptr_t)end) {
    const uint4* c = reinterpret_cast<const uint4*>(base);
    bytes18(c[0], c[1], off == 15 ? c[2] : make_uint4(0u, 0u, 0u, 0u), off, v);
  } else {
#pragma unroll
    for (int k = 0; k < kChunk + 2; ++k) v[k] = row[min(max(x0 - 1 + k, 0), w - 1)];
  }
}

// Four packed results (each's low byte) as one word, first in the low byte.
__device__ __forceinline__ unsigned pack4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// The 16 pixels of a chunk from its rows' 18 grey levels, packed.  The 3 x 3
// sums are separable: with s = top + 2 mid + bot and e = top - bot of each
// column, gx = s[l] - s[r] and gy = e[l] + 2 e[c] + e[r], the same sums in
// another order (exact in wrapping int32 arithmetic).
__device__ __forceinline__ void sobel_chunk(const int (*v)[18], unsigned* ox, unsigned* oy) {
  int sm[kChunk + 2], df[kChunk + 2];
#pragma unroll
  for (int c = 0; c < kChunk + 2; ++c) {
    sm[c] = add(add(v[0][c], v[2][c]), add(v[1][c], v[1][c]));
    df[c] = sub(v[0][c], v[2][c]);
  }
#pragma unroll
  for (int q = 0; q < kChunk / 4; ++q) {
    unsigned px[4], py[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = 4 * q + i;
      px[i] = pack(sub(sm[p], sm[p + 2]));
      py[i] = pack(add(add(df[p], df[p + 2]), add(df[p + 1], df[p + 1])));
    }
    ox[q] = pack4(px[0], px[1], px[2], px[3]);
    oy[q] = pack4(py[0], py[1], py[2], py[3]);
  }
}

// Bytes kQ * 4 .. kQ * 4 + 15 of the 32 in c[8], shifted right by sh bits.
template <int kQ>
__device__ __forceinline__ uint4 join_at(const unsigned* c, int sh) {
  return make_uint4(__funnelshift_r(c[kQ], c[kQ + 1], sh),
                    __funnelshift_r(c[kQ + 1], c[kQ + 2], sh),
                    __funnelshift_r(c[kQ + 2], c[kQ + 3], sh),
                    __funnelshift_r(c[kQ + 3], c[kQ + 4], sh));
}

// Store a thread's nv output bytes `own` at `out`.  `next` is the next
// lane's 16 (nvn of them in the row) when has_next: the next columns of
// the same row.  With q bytes from `out` to the next 16-byte boundary, the
// thread stores own[q, 16) + next[0, q) as one aligned 16 bytes when it
// can, and the bytes nobody else stores as single bytes; own[0, q) is the
// previous lane's when that lane could (has_prev and nv >= q).
__device__ __forceinline__ void store_chunk(int8_t* out, const unsigned* own,
                                            const unsigned* next, int nv, int nvn,
                                            bool has_prev, bool has_next) {
  const int q = (16 - (int)((uintptr_t)out & 15)) & 15;
  if (q == 0 && nv == kChunk) {
    *reinterpret_cast<uint4*>(out) = make_uint4(own[0], own[1], own[2], own[3]);
    return;
  }
  const bool prev_joins = q > 0 && has_prev && nv >= q;
  const bool joins = q > 0 && nv == kChunk && has_next && nvn >= q;
  const int lo = prev_joins ? q : 0, hi = joins ? q : nv;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    if (k >= lo && k < hi) out[k] = (int8_t)((own[k >> 2] >> (8 * (k & 3))) & 0xffu);
  }
  if (joins) {
    const unsigned c[8] = {own[0], own[1], own[2], own[3], next[0], next[1], next[2], next[3]};
    const int sh = 8 * (q & 3);
    uint4 v;
    switch (q >> 2) {
      case 0: v = join_at<0>(c, sh); break;
      case 1: v = join_at<1>(c, sh); break;
      case 2: v = join_at<2>(c, sh); break;
      default: v = join_at<3>(c, sh); break;
    }
    *reinterpret_cast<uint4*>(out + q) = v;
  }
}

// Thread t takes chunk t % cw (columns 16 (t % cw) ..) of strip t / cw of
// the stack (strip s of image s / strips: rows kRows (s % strips) ..).
// Lanes past the last chunk run the loop (they take part in the shuffles)
// and store nothing.
template <typename T>
__global__ void __launch_bounds__(kThreads) sobel_kernel(
    const T* __restrict__ image, int8_t* __restrict__ gx, int8_t* __restrict__ gy, int n, int h,
    int w, int cw, int strips, long long threads) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool active = t < threads;
  const long long tt = active ? t : threads - 1;
  int j, s;
  long long img;
  if (threads <= 0x7fffffffLL) {               // 32-bit division when it fits
    const unsigned u = (unsigned)tt, strip = u / (unsigned)cw;
    j = (int)(u - strip * (unsigned)cw);
    img = strip / (unsigned)strips;
    s = (int)(strip - (unsigned)img * (unsigned)strips);
  } else {
    j = (int)(tt % cw);
    img = tt / cw / strips;
    s = (int)(tt / cw % strips);
  }
  const int lane = threadIdx.x & 31;
  const int y0 = s * kRows, x0 = kChunk * j;
  const int nv = min(kChunk, w - x0), nvn = min(kChunk, w - x0 - kChunk);
  const bool has_prev = lane > 0 && j > 0, has_next = lane < 31 && j + 1 < cw;
  const T* im = image + img * h * (long long)w;
  const T* end = image + (long long)n * h * w;
  int v[3][kChunk + 2];
  load_row(im + (long long)max(y0 - 1, 0) * w, x0, w, end, v[0]);
  load_row(im + (long long)min(y0, h - 1) * w, x0, w, end, v[1]);
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int y = y0 + k;
    load_row(im + (long long)min(y + 1, h - 1) * w, x0, w, end, v[2]);
    unsigned ox[4] = {0u, 0u, 0u, 0u}, oy[4] = {0u, 0u, 0u, 0u};
    sobel_chunk(v, ox, oy);
    unsigned nx[4], ny[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      nx[i] = __shfl_down_sync(0xffffffffu, ox[i], 1);
      ny[i] = __shfl_down_sync(0xffffffffu, oy[i], 1);
    }
    if (active && y < h) {
      const long long f = (img * h + y) * (long long)w + x0;
      store_chunk(gx + f, ox, nx, nv, nvn, has_prev, has_next);
      store_chunk(gy + f, oy, ny, nv, nvn, has_prev, has_next);
    }
#pragma unroll
    for (int i = 0; i < kChunk + 2; ++i) {
      v[0][i] = v[1][i];
      v[1][i] = v[2][i];
    }
  }
}

}  // namespace

// Launch on `stream` over `n` images of (h, w) grey levels each (`kind`: 0
// uint8, 1 int32, 2 float32; elements at their natural alignment, rows at
// any byte offset); gx / gy are (n, h, w) int8, at any byte offset.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ielas_sobel(const void* image, void* gx, void* gy, int n, int h, int w,
                           int kind, void* stream) {
  const int cw = (w + kChunk - 1) / kChunk, strips = (h + kRows - 1) / kRows;
  const long long threads = (long long)n * strips * cw;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = (cudaStream_t)stream;
  int8_t* ox = static_cast<int8_t*>(gx);
  int8_t* oy = static_cast<int8_t*>(gy);
  switch (kind) {
    case kU8:
      sobel_kernel<uint8_t><<<grid, kThreads, 0, s>>>(static_cast<const uint8_t*>(image), ox,
                                                       oy, n, h, w, cw, strips, threads);
      break;
    case kI32:
      sobel_kernel<int><<<grid, kThreads, 0, s>>>(static_cast<const int*>(image), ox, oy, n, h,
                                                  w, cw, strips, threads);
      break;
    case kF32:
      sobel_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(image), ox, oy, n,
                                                     h, w, cw, strips, threads);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
