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
// forward's (halved when causal; with a window only the visible pairs count).
// This design recomputes S and dP in both of its passes, 3.5 times the
// forward's, so that no pass needs atomics: at (2, 32, 4096, 4096, 128) bf16
// causal that is 9.6e11 flops, ~0.97 ms at the tensor cores' 989 TFLOP/s.
//
// Deterministic, no float atomics: three kernels in one launch call, each
// output element written by one thread, every sum in a fixed order (two calls
// give the same bits; the training replay relies on it):
//  1. flash_bwd_delta: Delta = rowsum(dO * O), a warp a row;
//  2. dK and dV: a block per (batch * head, key tile) holds its keys' K and V
//     and walks the query tiles that can see them, recomputing S and dP and
//     accumulating dV and dK in registers;
//  3. dQ: a block per (batch * head, query tile) holds Q and dO and walks the
//     key tiles its rows can see, as the forward does, accumulating dQ.
//
// bfloat16 (flash_bwd_dkdv_bf16, flash_bwd_dq_bf16), the tensor-core path,
// built from the forward's Hopper pieces (flash_common.cuh):
//  * 384 threads: a producer warpgroup, whose one thread keeps TMA loads in
//    flight, and two consumer warpgroups of 64 rows each -- 64 keys (dK/dV)
//    or 64 query rows (dQ); setmaxnreg moves registers from the producer (24)
//    to the consumers (240).  A block's own rows (K and V of 128 keys, or Q
//    and dO of 128 rows) arrive once; the other side streams through a
//    2-stage ring of 64-row tiles (Q and dO, or K and V) with full/empty
//    mbarriers, through the forward's 3-D tensor maps (ragged tiles read
//    zeros); D < 64 is one zero-filled 64-column box and only D columns are
//    stored;
//  * dK/dV: S^T = K Q^T and dP^T = V dO^T are wgmma m64n64k16 with both
//    operands K-major in shared memory, committed as two groups so that P^T
//    is made while dP^T's product runs (a call 6% faster, mostly in dQ, than
//    waiting for both: flash_profile.py, in turns); P^T and dS^T are made on
//    the accumulator fragments (a query tile's lse and Delta arrive beside it by
//    TMA, copied by flash_bwd_delta into rows of 16-byte strides) and
//    repacked, as the forward repacks P, into the A operand of dV += P^T dO
//    and dK += dS^T Q, wgmma with A in registers and dO and Q read MN-major
//    through the transpose bit -- each streamed tile read twice from one copy;
//    causal, the walk starts at the tile holding the block's first key, with
//    a window it ends at the last query that sees its last key; key tiles run
//    in order, so the heaviest (causal) go first;
//  * dQ: S = Q K^T and dP = dO V^T by wgmma from shared memory (P made while
//    dP runs), dS in registers, dQ += dS K with K read MN-major, over the
//    forward's key range; query tiles heaviest first;
//  * P^T and dS^T enter their products as bfloat16 (a relative error of 2^-9
//    an entry, well inside the tolerance of 4 bfloat16 steps of each
//    gradient's largest magnitude); the mask runs only on tiles that cross
//    the diagonal, the window's lower edge or an end; the softcap's
//    derivative uses tanhf, as the forward's cap does.
//  The loads overlap the arithmetic (the TMA ring); a warpgroup's
//  elementwise work overlaps only its own dP product and the other
//  warpgroup's products.  Not yet: one pass with dQ split and reduced (2.5
//  times the forward's work instead of 3.5), a tile's elementwise work
//  overlapped with the next tile's products, a GQA-aware pass that reads
//  each KV head once; the dK/dV consumers at D = 128 spill a few hundred
//  bytes (their accumulators alone are 128 of the 240 registers).
//
// float32 (flash_bwd_dkdv, flash_bwd_dq), the CUDA-core path, explicit fmaf
// (TF32 would round the inputs to 10 bits and miss the float32 tolerance):
//  * dK/dV: a block per (batch * head, 64-key tile) holds K^T and V^T in
//    shared memory and walks the query tiles (32 rows) that can see its keys
//    (a thread: 4 keys x D / 16 columns of each);
//  * dQ: a block per (batch * head, 64-row query tile) holds Q^T and dO^T and
//    walks the key tiles (64 keys) its rows can see (4 rows x D / 16 columns);
//  * each product reads both operands along the summed index from shared
//    memory as float4 / float2 rows (operands are staged twice where two
//    products sum over different indices: Q and dO as rows and transposed);
//    tiles are loaded with plain loads; nothing overlaps the loads with the
//    arithmetic.

#include "flash_common.cuh"

namespace {

constexpr int kThreads = 256;     // the float32 kernels and Delta: 16 (tx) x 16 (ty)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

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

// Rows [row0, row0 + ROWS) of a (rows, D) float32 matrix, rows past the end as
// zeros: transposed into t[d * LDT + r] and, when rm is non-null,
// as rows into rm[r * (D + 4) + d].
template <int D, int ROWS, int LDT>
__device__ __forceinline__ void stage(float* t, float* rm, const float* src, int row0, int rows,
                                      int tid) {
  for (int e = tid; e < ROWS * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const float x = row0 + r < rows ? src[(size_t)(row0 + r) * D + d] : 0.f;
    t[d * LDT + r] = x;
    if (rm != nullptr) rm[r * (D + 4) + d] = x;
  }
}

// ---------------------------------------------------------------------------
// 1. Delta = rowsum(dO * O): a warp a row, 8 rows a block.  Row r, position i
// of head b, goes to delta[b * ld + i]; when `stats` is not null the row's
// log-sum-exp is copied to stats[b * ld + i] (the bfloat16 path reads both
// through one tensor map, whose rows need 16-byte strides: ld = sq rounded up
// to 4; the float32 path passes ld = sq and no copy).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(
    const T* __restrict__ out, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ stats, float* __restrict__ delta, int rows, int sq, int ld, int d) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* o = out + (size_t)row * d;
  const T* g = dout + (size_t)row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += to_float(o[c]) * to_float(g[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const size_t at = (size_t)(row / sq) * ld + row % sq;
    delta[at] = acc;
    if (stats != nullptr) stats[at] = lse[row];
  }
}

template <typename T>
int launch_delta(const void* out, const void* dout, const float* lse, float* stats, float* delta,
                 int bh, int sq, int ld, int d, cudaStream_t stream) {
  const int rows = bh * sq;
  flash_bwd_delta<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, stream>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), lse, stats, delta, rows, sq, ld, d);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 2. float32 dK, dV: a block per (batch * head, key tile), walking the query
// tiles.
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

template <int D, bool kCap, bool kWin>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int sq, int skv, int causal, int window,
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
  const float* qb = q + bh * sq * D;
  const float* ob = dout + bh * sq * D;

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
    float* dk_row = dk + (bh * skv + kpos) * D;
    float* dv_row = dv + (bh * skv + kpos) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      dk_row[out_col<D>(tx, c)] = acc_k[j][c];
      dv_row[out_col<D>(tx, c)] = acc_v[j][c];
    }
  }
}

}  // namespace kv

// ---------------------------------------------------------------------------
// 3. float32 dQ: a block per (batch * head, query tile), walking the key tiles.
// ---------------------------------------------------------------------------
namespace qd {

constexpr int kBQ = 64;           // query rows of the block
constexpr int kBK = 64;           // keys of a tile
constexpr int kLd = 68;           // a row of Q^T, dO^T, K^T, V^T, dS^T

template <int D>
constexpr size_t smem_floats() {
  return 4 * (size_t)D * kLd + (size_t)kBK * (D + 4) + (size_t)kBK * kLd + 2 * kBQ;
}

template <int D, bool kCap, bool kWin>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int sq, int skv, int causal, int window, ScoreMap f) {
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
  const float* kb = k + bh * skv * D;
  const float* vb = v + bh * skv * D;

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
    float* dq_row = dq + (bh * sq + row) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) dq_row[out_col<D>(tx, c)] = acc[i][c];
  }
}

}  // namespace qd


// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), TMA
// ---------------------------------------------------------------------------
namespace bf16 {

constexpr int kTcThreads = 384;        // producer warpgroup + two consumer warpgroups
constexpr int kStages = 2;             // streamed tiles in flight
constexpr int kConsumerArrivals = 8;   // one per consumer warp releases a stage
// At least this much shared memory a block, so that two blocks never share an
// SM: their consumers' setmaxnreg.inc could then wait for each other's
// registers (as the forward).
constexpr int kMinSmem = 120 * 1024;
constexpr int kBM = 64;                // a consumer warpgroup's rows: keys (dK/dV) or queries (dQ)
constexpr int kOwn = 2 * kBM;          // a block's own rows: K and V, or Q and dO
constexpr int kBN = 64;                // rows of a streamed tile: queries (dK/dV) or keys (dQ)
constexpr int kStatBytes = 1024;       // a query tile's lse and Delta (2 x kBN floats), padded

template <int D, bool kStats>
struct Tiles {
  static constexpr int kCols = D < kBoxCols ? kBoxCols : D;   // columns staged (zeros past D)
  static constexpr int kBoxes = kCols / kBoxCols;             // boxes a row
  static constexpr int kOwnBytes = kBoxes * kOwn * kRowBytes;   // one of the block's own tiles
  static constexpr int kTileBytes = kBoxes * kBN * kRowBytes;   // one streamed tile
  // A stage: the two streamed tiles, then (kStats) the query tile's lse and Delta.
  static constexpr int kStageBytes = 2 * kTileBytes + (kStats ? kStatBytes : 0);
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr int kUsed = 1024 + 2 * kOwnBytes + kStages * kStageBytes + kBarBytes;
  static constexpr int kSmem = kUsed > kMinSmem ? kUsed : kMinSmem;
};

// own_full, full[kStages], empty[kStages], from `bars` on.
__device__ __forceinline__ void init_barriers(uint32_t bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 + 8 * s, 1);
      mbar_init(bars + 8 * (1 + kStages) + 8 * s, kConsumerArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer's one thread: the block's own two tiles (rows own0 .. own0 +
// kOwn - 1 of own_a and own_b), then `tiles` streamed pairs (rows row0 + kBN *
// i of tile_a and tile_b) through the ring, each with its query rows' lse and
// Delta when kStats.
template <int D, bool kStats>
__device__ __forceinline__ void produce(const CUtensorMap* own_a, const CUtensorMap* own_b,
                                        int own0, const CUtensorMap* tile_a,
                                        const CUtensorMap* tile_b, const CUtensorMap* stats,
                                        int row0, int tiles, int bh, uint32_t own_s,
                                        uint32_t stage_s, uint32_t bars) {
  using T = Tiles<D, kStats>;
  const uint32_t own_full = bars, full0 = bars + 8, empty0 = bars + 8 * (1 + kStages);
  mbar_expect_tx(own_full, 2 * T::kOwnBytes);
  for (int b = 0; b < T::kBoxes; ++b) {
    const uint32_t off = b * kOwn * kRowBytes;
    tma_load(own_s + off, own_a, own_full, b * kBoxCols, own0, bh);
    tma_load(own_s + T::kOwnBytes + off, own_b, own_full, b * kBoxCols, own0, bh);
  }
  for (int i = 0; i < tiles; ++i) {
    const int stage = i % kStages, r = row0 + kBN * i;
    // The consumers released this stage's previous tile (i - kStages).
    if (i >= kStages) mbar_wait(empty0 + 8 * stage, ((i / kStages) + 1) & 1);
    const uint32_t full = full0 + 8 * stage, dst = stage_s + stage * T::kStageBytes;
    mbar_expect_tx(full, 2 * T::kTileBytes + (kStats ? 2 * kBN * 4 : 0));
    for (int b = 0; b < T::kBoxes; ++b) {
      const uint32_t off = b * kBN * kRowBytes;
      tma_load(dst + off, tile_a, full, b * kBoxCols, r, bh);
      tma_load(dst + T::kTileBytes + off, tile_b, full, b * kBoxCols, r, bh);
    }
    if constexpr (kStats) {
      tma_load(dst + 2 * T::kTileBytes, stats, full, r, bh, 0);             // lse
      tma_load(dst + 2 * T::kTileBytes + kBN * 4, stats, full, r, bh, 1);   // Delta
    }
  }
}

// dK, dV of consumer warpgroup c: keys k0 + 64c .. + 63 (K and V at own_s),
// over the query tiles q_begin + kBN * i, i < tiles (the i-th in stage i %
// kStages at stage_s; stage_p is stage_s as a generic pointer).
template <int D, bool kCap, bool kWin>
__device__ __forceinline__ void consume_dkdv(uint32_t own_s, uint32_t stage_s,
                                             const uint8_t* stage_p, uint32_t bars,
                                             __nv_bfloat16* __restrict__ dk,
                                             __nv_bfloat16* __restrict__ dv, int bh, int k0,
                                             int q_begin, int tiles, int sq, int skv,
                                             int causal, int window, ScoreMap f, int c) {
  using T = Tiles<D, true>;
  constexpr int kO = T::kCols / 2;          // an accumulator: 64 x kCols over 128 threads
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int quad_row = lane / 4, quad_col = lane % 4;
  const int kw0 = k0 + kBM * c;                        // the warpgroup's first key
  const int key0 = kw0 + 16 * warp + quad_row;         // this thread's keys: key0, key0 + 8
  const uint32_t own_full = bars, full0 = bars + 8, empty0 = bars + 8 * (1 + kStages);

  float dk_acc[kO], dv_acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(own_full, 0);
  const uint32_t k_wg = own_s + kBM * c * kRowBytes, v_wg = k_wg + T::kOwnBytes;

  for (int i = 0; i < tiles; ++i) {
    const int stage = i % kStages, q0 = q_begin + kBN * i;
    mbar_wait(full0 + 8 * stage, (i / kStages) & 1);
    const uint32_t q_t = stage_s + stage * T::kStageBytes, o_t = q_t + T::kTileBytes;
    const float* lse_t =
        reinterpret_cast<const float*>(stage_p + stage * T::kStageBytes + 2 * T::kTileBytes);
    const float* delta_t = lse_t + kBN;

    // S^T = K Q^T, then dP^T = V dO^T, over d in steps of 16 (a 128-byte row
    // holds four); P^T is made while dP^T runs.
    float st[kBN / 2], dpt[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss(st, smem_desc(k_wg + (kk / 4) * kOwn * kRowBytes + col, 16),
               smem_desc(q_t + (kk / 4) * kBN * kRowBytes + col, 16), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss(dpt, smem_desc(v_wg + (kk / 4) * kOwn * kRowBytes + col, 16),
               smem_desc(o_t + (kk / 4) * kBN * kRowBytes + col, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T and dS^T on the fragments, packed as the A operand of m64nNk16:
    // register h of k-slice kk holds entries 8kk + 2h and 8kk + 2h + 1, key
    // key0 + 8 * (h % 2), queries q0 + qc and q0 + qc + 1.  st keeps P^T
    // times the score map's derivative for dS^T.  Tiles inside the visible
    // band and before both ends need no mask.
    const bool edge = q0 + kBN > sq || kw0 + kBM > skv || (causal && kw0 + kBM - 1 > q0) ||
                      (kWin && q0 + kBN - 1 - kw0 >= window);
    uint32_t pa[kBN / 16][4], da[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int qc = 16 * kk + 8 * (h >> 1) + 2 * quad_col;
        const float2 ls = *reinterpret_cast<const float2*>(lse_t + qc);
        float p2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 8 * kk + 2 * h + e;
          float dcap;
          const float x = log2_score<kCap>(st[idx], f, &dcap);
          float p = exp2f(x - (e ? ls.y : ls.x));
          if (edge && !visible<kWin>(q0 + qc + e, key0 + 8 * (h & 1), sq, skv, causal, window))
            p = 0.f;
          p2[e] = p;
          st[idx] = p * dcap;
        }
        pa[kk][h] = bits(__floats2bfloat162_rn(p2[0], p2[1]));
      }
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int qc = 16 * kk + 8 * (h >> 1) + 2 * quad_col;
        const float2 dl = *reinterpret_cast<const float2*>(delta_t + qc);
        const int idx = 8 * kk + 2 * h;
        da[kk][h] = bits(__floats2bfloat162_rn(st[idx] * (dpt[idx] - dl.x),
                                               st[idx + 1] * (dpt[idx + 1] - dl.y)));
      }

    // dV += P^T dO, dK += dS^T Q over the tile's queries in steps of 16 (16
    // rows of 128 bytes; dO and Q MN-major as stored).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      wgmma_rs(dv_acc, pa[kk], smem_desc(o_t + kk * 16 * kRowBytes, kBN * kRowBytes));
      wgmma_rs(dk_acc, da[kk], smem_desc(q_t + kk * 16 * kRowBytes, kBN * kRowBytes));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);   // this warp is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= skv) continue;
    __nv_bfloat16* dk_row = dk + ((size_t)bh * skv + key) * D;
    __nv_bfloat16* dv_row = dv + ((size_t)bh * skv + key) * D;
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      const int col = 8 * j + 2 * quad_col;
      if (col < D) {
        *reinterpret_cast<__nv_bfloat162*>(dk_row + col) =
            __floats2bfloat162_rn(dk_acc[4 * j + 2 * r], dk_acc[4 * j + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv_row + col) =
            __floats2bfloat162_rn(dv_acc[4 * j + 2 * r], dv_acc[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int D, bool kCap, bool kWin>
__global__ void __launch_bounds__(kTcThreads, 1) flash_bwd_dkdv_bf16(
    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_stats, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int sq, int skv, int causal, int window, ScoreMap f) {
  using T = Tiles<D, true>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // 128-byte swizzle: 1024
  const uint32_t own_s = base;                    // K, then V
  const uint32_t stage_s = own_s + 2 * T::kOwnBytes;
  const uint32_t bars = stage_s + kStages * T::kStageBytes;

  const int bh = blockIdx.x, k0 = blockIdx.y * kOwn;   // causal: the heaviest key tiles first
  // The query rows that can see a key of the block (producer and consumers
  // agree): from k0 when causal, up to k0 + kOwn - 2 + window with a window.
  const int q_begin = causal ? k0 : 0;
  const long long last = (long long)k0 + kOwn - 1 + window;
  const int q_end = kWin && last < sq ? (int)last : sq;
  const int tiles = q_end > q_begin ? (q_end - q_begin + kBN - 1) / kBN : 0;

  init_barriers(bars);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0)
      produce<D, true>(&map_k, &map_v, k0, &map_q, &map_do, &map_stats, q_begin, tiles, bh,
                       own_s, stage_s, bars);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume_dkdv<D, kCap, kWin>(own_s, stage_s, smem_raw + (stage_s - raw), bars, dk, dv, bh,
                                k0, q_begin, tiles, sq, skv, causal, window, f, wg - 1);
  }
}

// dQ of consumer warpgroup c: query rows q0 + 64c .. + 63 (Q and dO at
// own_s), over the key tiles t_begin .. tiles - 1 (the i-th in stage i %
// kStages).  lse and Delta of head bh: rows of stats (lse copies, then
// Delta), ld apart.
template <int D, bool kCap, bool kWin>
__device__ __forceinline__ void consume_dq(uint32_t own_s, uint32_t stage_s, uint32_t bars,
                                           __nv_bfloat16* __restrict__ dq,
                                           const float* __restrict__ stats, int ld, int bh,
                                           int q0, int t_begin, int tiles, int sq, int skv,
                                           int causal, int window, ScoreMap f, int c) {
  using T = Tiles<D, false>;
  constexpr int kO = T::kCols / 2;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int quad_row = lane / 4, quad_col = lane % 4;
  const int qw0 = q0 + kBM * c;                        // the warpgroup's first row
  const int row0 = qw0 + 16 * warp + quad_row;         // this thread's rows: row0, row0 + 8
  const uint32_t own_full = bars, full0 = bars + 8, empty0 = bars + 8 * (1 + kStages);

  const float* lse_h = stats + (size_t)bh * ld;
  const float* delta_h = stats + ((size_t)gridDim.x + bh) * ld;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse_r[r] = row < sq ? lse_h[row] : 0.f;
    delta_r[r] = row < sq ? delta_h[row] : 0.f;
  }

  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;

  mbar_wait(own_full, 0);
  const uint32_t q_wg = own_s + kBM * c * kRowBytes, o_wg = q_wg + T::kOwnBytes;

  for (int t = t_begin; t < tiles; ++t) {
    const int i = t - t_begin, stage = i % kStages, k0 = t * kBN;
    mbar_wait(full0 + 8 * stage, (i / kStages) & 1);
    const uint32_t k_t = stage_s + stage * T::kStageBytes, v_t = k_t + T::kTileBytes;

    // S = Q K^T, then dP = dO V^T; P is made while dP runs.
    float s[kBN / 2], dp[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss(s, smem_desc(q_wg + (kk / 4) * kOwn * kRowBytes + col, 16),
               smem_desc(k_t + (kk / 4) * kBN * kRowBytes + col, 16), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss(dp, smem_desc(o_wg + (kk / 4) * kOwn * kRowBytes + col, 16),
               smem_desc(v_t + (kk / 4) * kBN * kRowBytes + col, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    // P times the score map's derivative, in s; entry 4j + e is row row0 + 8
    // * (e / 2), key k0 + 8j + 2 * quad_col + e % 2.  Rows past the end are
    // never stored, so only the key side's ends, the diagonal and the
    // window's edge need the mask.
    const bool edge = k0 + kBN > skv || (causal && k0 + kBN - 1 > qw0) ||
                      (kWin && qw0 + kBM - 1 - k0 >= window);
#pragma unroll
    for (int idx = 0; idx < kBN / 2; ++idx) {
      const int r = (idx >> 1) & 1, key = k0 + 8 * (idx >> 2) + 2 * quad_col + (idx & 1);
      float dcap;
      const float x = log2_score<kCap>(s[idx], f, &dcap);
      float p = exp2f(x - lse_r[r]);
      if (edge && !visible<kWin>(row0 + 8 * r, key, sq, skv, causal, window)) p = 0.f;
      s[idx] = p * dcap;
    }

    // dS, packed as the A operand: register h of k-slice kk holds entries
    // 8kk + 2h and 8kk + 2h + 1 (row row0 + 8 * (h % 2)).
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int idx = 8 * kk + 2 * h;
        da[kk][h] = bits(__floats2bfloat162_rn(s[idx] * (dp[idx] - delta_r[h & 1]),
                                               s[idx + 1] * (dp[idx + 1] - delta_r[h & 1])));
      }

    // dQ += dS K over the tile's keys in steps of 16 (K MN-major as stored).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_rs(acc, da[kk], smem_desc(k_t + kk * 16 * kRowBytes, kBN * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    __nv_bfloat16* dq_row = dq + ((size_t)bh * sq + row) * D;
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      const int col = 8 * j + 2 * quad_col;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(dq_row + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

template <int D, bool kCap, bool kWin>
__global__ void __launch_bounds__(kTcThreads, 1) flash_bwd_dq_bf16(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_do,
    const __grid_constant__ CUtensorMap map_k, const __grid_constant__ CUtensorMap map_v,
    __nv_bfloat16* __restrict__ dq, const float* __restrict__ stats, int ld, int sq, int skv,
    int causal, int window, ScoreMap f) {
  using T = Tiles<D, false>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t own_s = base;                    // Q, then dO
  const uint32_t stage_s = own_s + 2 * T::kOwnBytes;
  const uint32_t bars = stage_s + kStages * T::kStageBytes;

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;    // heaviest tiles first
  // The forward's key range: up to the last row's diagonal when causal, from
  // the tile holding q0 - window + 1 with a window.
  const int kv_end = causal ? min(skv, min(q0 + kOwn, sq)) : skv;
  const int tiles = (kv_end + kBN - 1) / kBN;
  const int t_begin = kWin ? max(0, q0 - window + 1) / kBN : 0;

  init_barriers(bars);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0)
      produce<D, false>(&map_q, &map_do, q0, &map_k, &map_v, nullptr, t_begin * kBN,
                        tiles - t_begin, bh, own_s, stage_s, bars);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume_dq<D, kCap, kWin>(own_s, stage_s, bars, dq, stats, ld, bh, q0, t_begin, tiles, sq,
                              skv, causal, window, f, wg - 1);
  }
}

// lse copies and Delta, (2, bh, sq) float32 with rows ld apart, as a 3-D map
// (sq, bh, 2) of kBN-float boxes, zeros past sq.
CUresult encode_stats(CUtensorMap* map, const float* base, int bh, int sq, int ld) {
  const cuuint64_t dims[3] = {(cuuint64_t)sq, (cuuint64_t)bh, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 4, (cuuint64_t)bh * ld * 4};
  const cuuint32_t box[3] = {(cuuint32_t)kBN, 1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D, bool kCap, bool kWin>
int launch(const void* q, const void* k, const void* v, const void* out, const void* dout,
           const float* lse, float* scratch, void* dq, void* dk, void* dv, int bh, int sq,
           int skv, int causal, int window, ScoreMap f, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  if ((sq + kOwn - 1) / kOwn > 65535 || (skv + kOwn - 1) / kOwn > 65535)
    return (int)cudaErrorInvalidValue;
  const int ld = (sq + 3) / 4 * 4;
  float* stats = scratch;                         // lse copies, then Delta
  // Delta first: a runtime call makes the device's context current on this
  // thread (autograd runs the backward on a thread of its own), which
  // cuTensorMapEncodeTiled needs.
  int err = launch_delta<__nv_bfloat16>(out, dout, lse, stats, stats + (size_t)bh * ld, bh, sq,
                                        ld, D, stream);
  if (err != cudaSuccess) return err;

  CUtensorMap q_own, do_own, k_own, v_own, q_tile, do_tile, k_tile, v_tile, map_stats;
  if (encode(&q_own, q, bh, sq, D, kOwn) != CUDA_SUCCESS ||
      encode(&do_own, dout, bh, sq, D, kOwn) != CUDA_SUCCESS ||
      encode(&k_own, k, bh, skv, D, kOwn) != CUDA_SUCCESS ||
      encode(&v_own, v, bh, skv, D, kOwn) != CUDA_SUCCESS ||
      encode(&q_tile, q, bh, sq, D, kBN) != CUDA_SUCCESS ||
      encode(&do_tile, dout, bh, sq, D, kBN) != CUDA_SUCCESS ||
      encode(&k_tile, k, bh, skv, D, kBN) != CUDA_SUCCESS ||
      encode(&v_tile, v, bh, skv, D, kBN) != CUDA_SUCCESS ||
      encode_stats(&map_stats, stats, bh, sq, ld) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;

  auto dkdv = flash_bwd_dkdv_bf16<D, kCap, kWin>;
  const int smem_kv = Tiles<D, true>::kSmem;
  cudaError_t e = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e != cudaSuccess) return (int)e;
  dkdv<<<dim3(bh, (skv + kOwn - 1) / kOwn), kTcThreads, smem_kv, stream>>>(
      k_own, v_own, q_tile, do_tile, map_stats, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sq, skv, causal, window, f);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  auto dqk = flash_bwd_dq_bf16<D, kCap, kWin>;
  const int smem_q = Tiles<D, false>::kSmem;
  e = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return (int)e;
  dqk<<<dim3(bh, (sq + kOwn - 1) / kOwn), kTcThreads, smem_q, stream>>>(
      q_own, do_own, k_tile, v_tile, static_cast<__nv_bfloat16*>(dq), stats, ld, sq, skv, causal,
      window, f);
  return (int)cudaGetLastError();
}

}  // namespace bf16

template <int D, bool kCap, bool kWin>
int launch_f32(const void* q, const void* k, const void* v, const void* out, const void* dout,
               const float* lse, float* delta, void* dq, void* dk, void* dv, int bh, int sq,
               int skv, int causal, int window, ScoreMap f, cudaStream_t stream) {
  const float *qp = static_cast<const float*>(q), *kp = static_cast<const float*>(k),
              *vp = static_cast<const float*>(v), *gp = static_cast<const float*>(dout);
  int e = launch_delta<float>(out, dout, nullptr, nullptr, delta, bh, sq, sq, D, stream);
  if (e != cudaSuccess) return e;

  auto dkdv = kv::flash_bwd_dkdv<D, kCap, kWin>;
  const int smem_kv = (int)(kv::smem_floats<D>() * sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_kv);
  if (err != cudaSuccess) return (int)err;
  dkdv<<<dim3(bh, (skv + kv::kBK - 1) / kv::kBK), kThreads, smem_kv, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), sq, skv, causal,
      window, f);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto dqk = qd::flash_bwd_dq<D, kCap, kWin>;
  const int smem_q = (int)(qd::smem_floats<D>() * sizeof(float));
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  dqk<<<dim3(bh, (sq + qd::kBQ - 1) / qd::kBQ), kThreads, smem_q, stream>>>(
      qp, kp, vp, gp, lse, delta, static_cast<float*>(dq), sq, skv, causal, window, f);
  return (int)cudaGetLastError();
}

template <bool kBf16, bool kCap, bool kWin>
int dispatch(const void* q, const void* k, const void* v, const void* out, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, int bh, int sq,
             int skv, int d, int causal, int window, ScoreMap f, cudaStream_t s) {
#define IELAS_FLASH_BWD_CASE(D)                                                               \
  case D:                                                                                     \
    return kBf16 ? bf16::launch<D, kCap, kWin>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, \
                                               sq, skv, causal, window, f, s)                 \
                 : launch_f32<D, kCap, kWin>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh,  \
                                             sq, skv, causal, window, f, s);
  switch (d) {
    IELAS_FLASH_BWD_CASE(16)
    IELAS_FLASH_BWD_CASE(32)
    IELAS_FLASH_BWD_CASE(64)
    IELAS_FLASH_BWD_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef IELAS_FLASH_BWD_CASE
}

template <bool kCap, bool kWin>
int dispatch_type(const void* q, const void* k, const void* v, const void* out,
                  const void* dout, const float* lse, float* delta, void* dq, void* dk,
                  void* dv, int bh, int sq, int skv, int d, int dtype, int causal, int window,
                  ScoreMap f, cudaStream_t s) {
  if (dtype == 0)
    return dispatch<false, kCap, kWin>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, sq, skv,
                                       d, causal, window, f, s);
  if (dtype == 1)
    return dispatch<true, kCap, kWin>(q, k, v, out, dout, lse, delta, dq, dk, dv, bh, sq, skv,
                                      d, causal, window, f, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`: q, out, dout and dq (bh, sq, d); k, v, dk and dv (bh,
// skv, d); all contiguous, of one type (dtype 0 float32, 1 bfloat16), the
// bfloat16 ones 16-byte aligned (TMA); lse (bh, sq) float32 from
// ielas_flash_attention_lse on the same q, k, v and options; delta float32
// scratch of 2 * bh * ld floats, ld = sq rounded up to a multiple of 4.  d is
// 16, 32, 64 or 128; sq, skv >= 1; causal, window and softcap as the
// forward's (window > 0 needs causal and sq <= skv).  Returns the cudaError_t
// of the launches (0 on success).
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
