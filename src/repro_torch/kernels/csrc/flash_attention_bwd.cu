// Flash attention backward for Hopper (sm_90a): dQ, dK and dV.
//
// Replaces no Pallas kernel: the reference trains attention through XLA's
// autodiff of its plain-JAX blockwise_attention (src/repro/models/
// attention.py:172); the port's attention is the hand-written forward kernel
// (flash_attention.cu), whose output needs a gradient of its own.  Its plain
// version is autograd through src/repro_torch/kernels/ref.py::
// flash_attention_ref; the kernel sums in another order, so it agrees with it
// within a stated tolerance, not bit for bit.
//
// What it computes, per (batch * head): with s = q k^T the raw scores, c the
// scores the forward normalised (s * scale, capped to cap * tanh(s * scale /
// cap) when softcap > 0, masked as the forward masks: causal, the sliding
// window, keys past the end) and P = softmax(c) recomputed from the forward's
// log-sum-exp of each row (flash_attention.cu writes m + log2(l) in the log2
// domain, from the same scores, so P is the forward's own):
//   dP = dO V^T,  Delta = rowsum(dO * O),  dC = P * (dP - Delta),
//   dS = dC * scale (* (1 - tanh^2) under the cap),
//   dV = P^T dO,  dK = dS^T Q,  dQ = dS K.
// A masked score has P = 0 and so no gradient, as in the plain version.  Every
// sum is in float32; the inputs are float32 or bfloat16 and the gradients are
// rounded to the inputs' type.
//
// What bounds it on an H100: operations.  The five products are 2.5 times the
// forward's (halved when causal; with a window only the visible pairs count);
// this design recomputes S and dP in both passes, 3.5 times, on the CUDA
// cores (67 TFLOP/s float32), where a wgmma design would reach the tensor
// cores' 989 in bf16 (ROADMAP.md, queue 2).
//
// Design: deterministic, no float atomics, three kernels in one launch call:
//  1. flash_bwd_delta: Delta = rowsum(dO * O), a warp a row;
//  2. flash_bwd_dkdv: a block per (batch * head, 64-key tile) holds K^T and
//     V^T in shared memory and walks the query tiles (32 rows) that can see
//     its keys, recomputing S and dP and accumulating dV and dK in registers
//     (a thread: 4 keys x D / 16 columns of each);
//  3. flash_bwd_dq: a block per (batch * head, 64-row query tile) holds Q^T
//     and dO^T and walks the key tiles (64 keys) its rows can see, as the
//     forward does, accumulating dQ in registers (4 rows x D / 16 columns).
// Each product reads both operands along the summed index from shared memory
// as float4 / float2 rows (operands are staged twice where two products sum
// over different indices: Q and dO as rows and transposed).  Tiles are
// loaded with plain loads and converted to float on the way in; nothing
// overlaps the loads with the arithmetic yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 256;     // 16 (tx) x 16 (ty)

// As flash_attention.cu's ScoreMap: scale, then the cap, then log2(e).
struct ScoreMap {
  float scale_log2;   // scale * log2(e)
  float scale;
  float cap;
  float inv_cap;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The exponent the forward gave the score s (log2 domain), and in *dcap the
// derivative of the capped score with respect to s, scale * (1 - tanh^2).
// The same expressions as flash_attention.cu's log2_score, so that P is
// recomputed from the forward's own values.
template <bool kCap>
__device__ __forceinline__ float log2_score(float s, ScoreMap f, float* dcap) {
  if constexpr (kCap) {
    const float t = tanhf(s * f.scale * f.inv_cap);
    *dcap = f.scale * (1.f - t * t);
    return f.cap * t * kLog2e;
  } else {
    *dcap = f.scale;
    return s * f.scale_log2;
  }
}

template <bool kWin>
__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int skv, int causal,
                                        int window) {
  if (qpos >= sq || kpos >= skv) return false;
  if (causal && kpos > qpos) return false;
  if (kWin && qpos - kpos >= window) return false;
  return true;
}

// Output columns of thread tx: D / 16 of them, as float4 where D >= 64
// (flash_attention.cu's mapping).
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (D >= 128) return (c / 4) * 64 + tx * 4 + (c % 4);
  else if constexpr (D == 64) return tx * 4 + c;
  else return tx * (D / 16) + c;
}

template <int D>
__device__ __forceinline__ void load_cols(float (&x)[D / 16], const float* row, int tx) {
  if constexpr (D >= 64) {
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const float4 a = *reinterpret_cast<const float4*>(row + g * 64 + tx * 4);
      x[4 * g] = a.x; x[4 * g + 1] = a.y; x[4 * g + 2] = a.z; x[4 * g + 3] = a.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) x[c] = row[out_col<D>(tx, c)];
  }
}

// Rows [row0, row0 + ROWS) of a (rows, D) matrix, converted to float, rows past
// the end as zeros: transposed into t[d * LDT + r] and, when rm is non-null,
// as rows into rm[r * (D + 4) + d].
template <int D, int ROWS, int LDT, typename T>
__device__ __forceinline__ void stage(float* t, float* rm, const T* src, int row0, int rows,
                                      int tid) {
  for (int e = tid; e < ROWS * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const float x = row0 + r < rows ? to_float(src[(size_t)(row0 + r) * D + d]) : 0.f;
    t[d * LDT + r] = x;
    if (rm != nullptr) rm[r * (D + 4) + d] = x;
  }
}

// ---------------------------------------------------------------------------
// 1. Delta = rowsum(dO * O): a warp a row, 8 rows a block.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(const T* __restrict__ out,
                                                            const T* __restrict__ dout,
                                                            float* __restrict__ delta,
                                                            int rows, int d) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + (size_t)row * d;
  const T* g = dout + (size_t)row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += to_float(o[c]) * to_float(g[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dK, dV: a block per (batch * head, key tile), walking the query tiles.
// ---------------------------------------------------------------------------
namespace kv {

constexpr int kBK = 64;           // keys of the block
constexpr int kBQ = 32;           // query rows of a tile
constexpr int kLdK = kBK + 4;     // a row of K^T, V^T, P, dS
constexpr int kLdQ = kBQ + 4;     // a row of Q^T, dO^T

template <int D>
constexpr size_t smem_floats() {
  return 2 * (size_t)D * kLdK + 2 * (size_t)D * kLdQ + 2 * (size_t)kBQ * (D + 4) +
         2 * (size_t)kBQ * kLdK + 2 * kBQ;
}

template <int D, bool kCap, bool kWin, typename T>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int sq, int skv, int causal, int window,
    ScoreMap f) {
  constexpr int kC = D / 16;
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);   // [D][kLdK] K^T
  float* vt = kt + D * kLdK;                      // [D][kLdK] V^T
  float* qt = vt + D * kLdK;                      // [D][kLdQ] Q^T
  float* ot = qt + D * kLdQ;                      // [D][kLdQ] dO^T
  float* qr = ot + D * kLdQ;                      // [kBQ][D + 4] Q
  float* orw = qr + kBQ * (D + 4);                // [kBQ][D + 4] dO
  float* ps = orw + kBQ * (D + 4);                // [kBQ][kLdK] P
  float* dss = ps + kBQ * kLdK;                   // [kBQ][kLdK] dS
  float* lse_s = dss + kBQ * kLdK;                // [kBQ]
  float* delta_s = lse_s + kBQ;                   // [kBQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kBK;
  const T* qb = q + bh * sq * D;
  const T* ob = dout + bh * sq * D;

  stage<D, kBK, kLdK>(kt, nullptr, k + bh * skv * D, k0, skv, tid);
  stage<D, kBK, kLdK>(vt, nullptr, v + bh * skv * D, k0, skv, tid);

  // The query rows that can see a key of this tile: from the tile holding k0
  // when causal, up to k0 + kBK - 2 + window with a window.
  const int q_begin = causal ? (k0 / kBQ) * kBQ : 0;
  const int q_end = kWin ? min(sq, k0 + kBK - 1 + window) : sq;

  float acc_k[4][kC], acc_v[4][kC];   // keys ty * 4 + j, columns out_col(tx, c)
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc_k[j][c] = acc_v[j][c] = 0.f;

  for (int q0 = q_begin; q0 < q_end; q0 += kBQ) {
    __syncthreads();                 // the previous tile is done with qt .. delta_s
    stage<D, kBQ, kLdQ>(qt, qr, qb, q0, sq, tid);
    stage<D, kBQ, kLdQ>(ot, orw, ob, q0, sq, tid);
    if (tid < kBQ) {
      const bool in = q0 + tid < sq;
      lse_s[tid] = in ? lse[bh * sq + q0 + tid] : 0.f;
      delta_s[tid] = in ? delta[bh * sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // S and dP: rows ty * 2 + i, keys tx * 4 + j.
    float s[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float2 a = *reinterpret_cast<const float2*>(qt + d * kLdQ + ty * 2);
      const float2 g = *reinterpret_cast<const float2*>(ot + d * kLdQ + ty * 2);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * kLdK + tx * 4);
      const float4 w = *reinterpret_cast<const float4*>(vt + d * kLdK + tx * 4);
      const float av[2] = {a.x, a.y}, gv[2] = {g.x, g.y};
      const float bv[4] = {b.x, b.y, b.z, b.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], bv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], wv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = ty * 2 + i, qpos = q0 + r;
      float p[4], ds[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dcap;
        const float x = log2_score<kCap>(s[i][j], f, &dcap);
        const bool vis = visible<kWin>(qpos, k0 + tx * 4 + j, sq, skv, causal, window);
        p[j] = vis ? exp2f(x - lse_s[r]) : 0.f;
        ds[j] = p[j] * (dp[i][j] - delta_s[r]) * dcap;
      }
      *reinterpret_cast<float4*>(ps + r * kLdK + tx * 4) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dss + r * kLdK + tx * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dV += P^T dO, dK += dS^T Q over this tile's rows.
#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(ps + r * kLdK + ty * 4);
      const float4 sv = *reinterpret_cast<const float4*>(dss + r * kLdK + ty * 4);
      float g[kC], x[kC];
      load_cols<D>(g, orw + r * (D + 4), tx);
      load_cols<D>(x, qr + r * (D + 4), tx);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w}, sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          acc_v[j][c] = fmaf(pa[j], g[c], acc_v[j][c]);
          acc_k[j][c] = fmaf(sa[j], x[c], acc_k[j][c]);
        }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int kpos = k0 + ty * 4 + j;
    if (kpos >= skv) continue;
    T* dk_row = dk + (bh * skv + kpos) * D;
    T* dv_row = dv + (bh * skv + kpos) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      dk_row[out_col<D>(tx, c)] = from_float<T>(acc_k[j][c]);
      dv_row[out_col<D>(tx, c)] = from_float<T>(acc_v[j][c]);
    }
  }
}

}  // namespace kv

// ---------------------------------------------------------------------------
// 3. dQ: a block per (batch * head, query tile), walking the key tiles.
// ---------------------------------------------------------------------------
namespace qd {

constexpr int kBQ = 64;           // query rows of the block
constexpr int kBK = 64;           // keys of a tile
constexpr int kLd = 68;           // a row of Q^T, dO^T, K^T, V^T, dS^T

template <int D>
constexpr size_t smem_floats() {
  return 4 * (size_t)D * kLd + (size_t)kBK * (D + 4) + (size_t)kBK * kLd + 2 * kBQ;
}

template <int D, bool kCap, bool kWin, typename T>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int sq, int skv, int causal, int window, ScoreMap f) {
  constexpr int kC = D / 16;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][kLd] Q^T
  float* ot = qt + D * kLd;                       // [D][kLd] dO^T
  float* kt = ot + D * kLd;                       // [D][kLd] K^T
  float* vt = kt + D * kLd;                       // [D][kLd] V^T
  float* kr = vt + D * kLd;                       // [kBK][D + 4] K
  float* dst = kr + kBK * (D + 4);                // [kBK][kLd] dS^T
  float* lse_s = dst + kBK * kLd;                 // [kBQ]
  float* delta_s = lse_s + kBQ;                   // [kBQ]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;    // heaviest tiles first
  const T* kb = k + bh * skv * D;
  const T* vb = v + bh * skv * D;

  stage<D, kBQ, kLd>(qt, nullptr, q + bh * sq * D, q0, sq, tid);
  stage<D, kBQ, kLd>(ot, nullptr, dout + bh * sq * D, q0, sq, tid);
  if (tid < kBQ) {
    const bool in = q0 + tid < sq;
    lse_s[tid] = in ? lse[bh * sq + q0 + tid] : 0.f;
    delta_s[tid] = in ? delta[bh * sq + q0 + tid] : 0.f;
  }

  // The forward's key range: up to the last row's diagonal when causal, from
  // the tile holding q0 - window + 1 with a window.
  const int kv_end = causal ? min(skv, min(q0 + kBQ, sq)) : skv;
  const int t_begin = kWin ? max(0, q0 - window + 1) / kBK : 0;
  const int tiles = (kv_end + kBK - 1) / kBK;

  float acc[4][kC];                   // rows ty * 4 + i, columns out_col(tx, c)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;

  for (int t = t_begin; t < tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                 // the previous tile is done with kt .. dst
    stage<D, kBK, kLd>(kt, kr, kb, k0, skv, tid);
    stage<D, kBK, kLd>(vt, nullptr, vb, k0, skv, tid);
    __syncthreads();

    // S and dP: rows ty * 4 + i, keys tx * 4 + j.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kLd + ty * 4);
      const float4 g = *reinterpret_cast<const float4*>(ot + d * kLd + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * kLd + tx * 4);
      const float4 w = *reinterpret_cast<const float4*>(vt + d * kLd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, gv[4] = {g.x, g.y, g.z, g.w};
      const float bv[4] = {b.x, b.y, b.z, b.w}, wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], bv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], wv[j], dp[i][j]);
        }
    }
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dcap;
        const float x = log2_score<kCap>(s[i][j], f, &dcap);
        const bool vis = visible<kWin>(qpos, k0 + tx * 4 + j, sq, skv, causal, window);
        const float p = vis ? exp2f(x - lse_s[r]) : 0.f;
        ds[i][j] = p * (dp[i][j] - delta_s[r]) * dcap;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(dst + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
    __syncthreads();

    // dQ += dS K over this tile's keys.
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 sv = *reinterpret_cast<const float4*>(dst + j * kLd + ty * 4);
      float x[kC];
      load_cols<D>(x, kr + j * (D + 4), tx);
      const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[i][c] = fmaf(sa[i], x[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    T* dq_row = dq + (bh * sq + row) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) dq_row[out_col<D>(tx, c)] = from_float<T>(acc[i][c]);
  }
}

}  // namespace qd

template <int D, bool kCap, bool kWin, typename T>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* delta, void* dq, void* dk, void* dv, int bh, int sq,
           int skv, int causal, int window, ScoreMap f, cudaStream_t stream) {
  const T *qp = static_cast<const T*>(q), *kp = static_cast<const T*>(k),
          *vp = static_cast<const T*>(v), *gp = static_cast<const T*>(dout);
  const int rows = bh * sq;
  flash_bwd_delta<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(
      static_cast<const T*>(out), gp, delta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dkdv = kv::flash_bwd_dkdv<D, kCap, kWin, T>;
  const int smem_kv = (int)(kv::smem_floats<D>() * sizeof(float));
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3(bh, (skv + kv::kBK - 1) / kv::kBK), kThreads, smem_kv, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, causal,
      window, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dqk = qd::flash_bwd_dq<D, kCap, kWin, T>;
  const int smem_q = (int)(qd::smem_floats<D>() * sizeof(float));
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3(bh, (sq + qd::kBQ - 1) / qd::kBQ), kThreads, smem_q, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<T*>(dq), sq, skv, causal, window, f);
  return (int)cudaGetLastError();
}

template <bool kCap, bool kWin, typename T>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, int bh, int sq,
             int skv, int d, int causal, int window, ScoreMap f, cudaStream_t s) {
  switch (d) {
    case 16: return launch<16, kCap, kWin, T>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh,
                                              sq, skv, causal, window, f, s);
    case 32: return launch<32, kCap, kWin, T>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh,
                                              sq, skv, causal, window, f, s);
    case 64: return launch<64, kCap, kWin, T>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh,
                                              sq, skv, causal, window, f, s);
    case 128: return launch<128, kCap, kWin, T>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh,
                                                sq, skv, causal, window, f, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool kCap, bool kWin>
int dispatch_type(const void* q, const void* k, const void* v, const void* out,
                  const void* dout, const float* lse, float* delta, void* dq, void* dk,
                  void* dv, int bh, int sq, int skv, int d, int dtype, int causal, int window,
                  ScoreMap f, cudaStream_t s) {
  if (dtype == 0)
    return dispatch<kCap, kWin, float>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, sq, skv,
                                       d, causal, window, f, s);
  if (dtype == 1)
    return dispatch<kCap, kWin, __nv_bfloat16>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh,
                                               sq, skv, d, causal, window, f, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`: q, out, dout and dq (bh, sq, d); k, v, dk and dv (bh,
// skv, d); all contiguous, of one type (dtype 0 float32, 1 bfloat16); lse
// (bh, sq) float32 from ielas_flash_attention_lse on the same q, k, v and
// options; delta (bh, sq) float32 scratch.  d is 16, 32, 64 or 128; sq, skv
// >= 1; causal, window and softcap as the forward's (window > 0 needs causal
// and sq <= skv).  Returns the cudaError_t of the launches (0 on success).
extern "C" int ielas_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* out, const void* dout, const void* lse,
                                         void* delta, void* dq, void* dk, void* dv, int bh,
                                         int sq, int skv, int d, int dtype, int causal,
                                         int window, float scale, float softcap,
                                         void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bh < 1 || sq < 1 || skv < 1 || window < 0 || !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  if (window > 0 && (!causal || sq > skv)) return (int)cudaErrorInvalidValue;
  if ((size_t)bh * sq > (size_t)INT32_MAX) return (int)cudaErrorInvalidValue;
  const bool cap = softcap > 0.f, win = window > 0;
  const ScoreMap f{scale * kLog2e, scale, softcap, cap ? 1.f / softcap : 0.f};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (cap && win)
    return dispatch_type<true, true>(q, k, v, out, dout, l, dl, dq, dk, dv, bh, sq, skv, d,
                                      dtype, causal, window, f, s);
  if (cap)
    return dispatch_type<true, false>(q, k, v, out, dout, l, dl, dq, dk, dv, bh, sq, skv, d,
                                       dtype, causal, 0, f, s);
  if (win)
    return dispatch_type<false, true>(q, k, v, out, dout, l, dl, dq, dk, dv, bh, sq, skv, d,
                                       dtype, causal, window, f, s);
  return dispatch_type<false, false>(q, k, v, out, dout, l, dl, dq, dk, dv, bh, sq, skv, d,
                                      dtype, causal, 0, f, s);
}
