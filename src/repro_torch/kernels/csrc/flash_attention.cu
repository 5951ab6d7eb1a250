// Flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_pallas.  Its plain PyTorch version is
// src/repro_torch/kernels/ref.py::flash_attention_ref (softmax attention in
// float32, a masked score is -1e30); the kernel sums in another order, so
// it agrees with it within a stated tolerance, not bit for bit.
//
// What it computes, per (batch * head, query row): softmax(q k^T / sqrt(D))
// v over the key positions, in float32 whatever the input type (float32 or
// bfloat16, read with the intrinsics), the result cast to the input type.
// With `causal`, key position j is visible to query position i iff j <= i,
// both counted from 0 (also when Sq != Skv).  The result is divided by
// max(l, 1e-30), l the row's sum of exponentials, as the Pallas body does.
//
// What bounds it on an H100: operations.  4 * Sq * Skv * D flops per head
// (halved when causal) against 2 * (Sq + Skv) * D elements moved: at
// S = 4096, D = 128 that is ~1000 flops a byte.  This kernel runs scalar
// float32 FMAs, so its ceiling is the 67 TFLOP/s of the CUDA cores, not the
// tensor cores' 989 (bf16); wgmma and TMA are a later redesign.
//
// What the simple design does about it:
//  * one block of 256 threads per (64-row query tile, batch * head); the
//    Pallas grid's sequential kv axis becomes a loop inside the block, which
//    carries the online-softmax state (m, l, acc) in registers -- blocks on
//    Hopper run in no order and share no scratch;
//  * the query tile and each 64-row key and value tile are staged in shared
//    memory as float32 (rows padded by 4 floats so the float4 reads of
//    sixteen different rows hit different banks);
//  * each thread owns 4 query rows x 4 key columns of the score tile (two
//    FMAs per shared-memory float read) and 4 rows x D/16 output columns;
//    a row's max and sum are reduced over the 16 lanes that share it with
//    shuffles; the probabilities go through shared memory to the P V step;
//  * with `causal`, the loop stops at the last key tile that a row of the
//    query tile can see: a fully hidden tile is never loaded (the Pallas
//    kernel's pl.when skip), and the query tiles are scheduled heaviest
//    first so the short ones fill the tail.
// The first key tile always holds position 0, which every row sees, so a
// row's running max is finite after it and no row divides by 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows of a block
constexpr int kBK = 64;          // key rows of a tile
constexpr int kThreads = 256;    // 16 x 16: ty -> 4 query rows, tx -> columns
constexpr int kLdP = kBK + 4;    // padded row of the probability tile
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(p2[0]);
  const float2 hi = __bfloat1622float2(p2[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);   // round to nearest even, as torch's cast
}

// Rows [row0, row0 + 64) of a (rows, D) matrix into a padded float32 tile;
// rows past the end are zeros.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0, int rows,
                                          int tid) {
  constexpr int kVec = D / 4;
  for (int idx = tid; idx < kBQ * kVec; idx += kThreads) {
    const int r = idx / kVec, c = (idx % kVec) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) val = load4(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = val;
  }
}

__device__ __forceinline__ float row_reduce_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float row_reduce_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)3 * kBQ * (D + 4) + (size_t)kBQ * kLdP);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int sq, int skv, int causal, float scale) {
  constexpr int kLd = D + 4;
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][kLd]
  float* ks = qs + kBQ * kLd;                    // [kBK][kLd]
  float* vs = ks + kBK * kLd;                    // [kBK][kLd]
  float* ps = vs + kBK * kLd;                    // [kBQ][kLdP]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;    // heaviest tiles first
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * sq * D;
  const T* kb = k + bh * skv * D;
  const T* vb = v + bh * skv * D;

  load_tile<D>(qs, qb, q0, sq, tid);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // Key positions past the tile's last query row are hidden from every row.
  const int kv_end = causal ? min(skv, min(q0 + kBQ, sq)) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();               // the previous tile's readers are done
    load_tile<D>(ks, kb, k0, skv, tid);
    load_tile<D>(vs, vb, k0, skv, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * kLd + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kLd + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= skv) x = -INFINITY;                  // past the end: weight 0
        else if (causal && kpos > qpos) x = kMasked;     // the reference's mask value
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
      const float m_new = fmaxf(m[i], row_reduce_max(mc));
      const float r = expf(m[i] - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty * 4 + i) * kLdP + tx + 16 * j] = p;
        lsum += p;
      }
      l[i] = l[i] * r + row_reduce_sum(lsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= r;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kLdP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = vs + (c + cc) * kLd + tx;
#pragma unroll
        for (int col = 0; col < kCols; ++col) {
          const float vv = vrow[16 * col];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pi = cc == 0 ? p[i].x : cc == 1 ? p[i].y : cc == 2 ? p[i].z : p[i].w;
            acc[i][col] = fmaf(pi, vv, acc[i][col]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (bh * sq + row) * D + tx;
#pragma unroll
    for (int col = 0; col < kCols; ++col) store(o + 16 * col, acc[i][col] / denom);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int sq, int skv,
           int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<D, T>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, skv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int bh, int sq, int skv,
             int d, int causal, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, T>(q, k, v, out, bh, sq, skv, causal, scale, stream);
    case 32: return launch<32, T>(q, k, v, out, bh, sq, skv, causal, scale, stream);
    case 64: return launch<64, T>(q, k, v, out, bh, sq, skv, causal, scale, stream);
    case 128: return launch<128, T>(q, k, v, out, bh, sq, skv, causal, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch on `stream`: q (bh, sq, d), k and v (bh, skv, d), out like q, all
// contiguous, of one type: dtype 0 float32, 1 bfloat16.  d is 16, 32, 64 or
// 128; bh at most 65535.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int ielas_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int bh, int sq, int skv, int d, int dtype, int causal,
                                     float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return dispatch<float>(q, k, v, out, bh, sq, skv, d, causal, scale, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, out, bh, sq, skv, d, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
