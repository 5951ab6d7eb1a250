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
// bfloat16), the result rounded to the input type.  With `causal`, key
// position j is visible to query position i iff j <= i, both counted from 0
// (also when Sq != Skv).  A masked score is -1e30, a key past the end -inf
// (weight exactly 0); the result is divided by max(l, 1e-30), l the row's
// sum of exponentials, as the Pallas body does.
//
// gemma2's two options, which the reference computes in plain JAX
// (src/repro/models/attention.py: blockwise_attention, decode_attention),
// each a template parameter so that the kernels without them stay as they
// were: a softcap (each scaled score s becomes cap * tanh(s / cap) before
// the mask; tanhf, whose error of ~2 ulps keeps the one-ulp bf16 tolerance
// where tanh.approx's 2^-11 would move a score at cap 50 by ~0.02) and a
// causal sliding window (row i sees keys i - window + 1 .. i: the key loop
// starts at the tile that holds the block's first row's first key, and the
// mask also runs on the tiles that cross the window's lower edge).
//
// What bounds it on an H100: operations.  4 * Sq * Skv * D flops per head
// (halved when causal) against 2 * (Sq + Skv) * D elements moved: at
// S = 4096, D = 128 that is ~1000 flops a byte.  The ceiling is the tensor
// cores' 989 TFLOP/s for bfloat16 and the CUDA cores' 67 TFLOP/s for
// float32 (TF32 would round the inputs to 10 bits and miss the tolerance).
// With a window only the visible (query, key) pairs count.  The softcap adds
// a tanhf to each score's exp2 (more SFU and FMA work a score, against the
// tensor cores' 64 flops a score at D = 128).
//
// For training each row's log-sum-exp is written too, m + log2(l) in the log2 domain of the scaled, capped scores: the
// backward kernel (flash_attention_bwd.cu) recomputes P from it.  The store
// runs only when its pointer is not null, so the serving path's launches do
// not change.
//
// Both paths share the outer design: one block per (query tile, batch *
// head), the Pallas grid's sequential kv axis a loop inside the block that
// carries the online-softmax state (m, l, acc) in registers -- Hopper
// blocks run in no order and share no scratch; with `causal` the loop ends
// at the last key tile a row of the query tile can see (the Pallas kernel's
// pl.when skip), and the grid runs the heaviest query tiles first (blockIdx.y
// reversed, batch * head on x) so the short ones fill the tail.  Every row
// sees its own position (a window needs Sq <= Skv), so a row's running max
// is finite once it has passed that key and no row divides by 0; a row that
// sees no key of the block's first tiles (below its window) gives their
// masked scores weight exp2(0) until then, and the first finite max scales
// that away by exp2(kMasked - m) = 0, as the reference's blockwise scan
// does.  No split over keys and no atomics: a call is deterministic.
//
// bfloat16 (flash_attention_bf16_kernel), the tensor-core path (its mbarrier,
// TMA and wgmma helpers in flash_common.cuh, shared with the backward):
//  * 384 threads: a producer warpgroup, whose one thread keeps TMA loads in
//    flight, and two consumer warpgroups of 64 query rows each (BQ = 128);
//    setmaxnreg moves registers from the producer (24) to the consumers (240);
//  * TMA copies the Q tile once and a 2-stage ring of 128-key K and V tiles
//    through 3-D tensor maps (D, S, B * H), so a ragged tile reads zeros, not
//    the next head; full/empty mbarrier pairs sit between producer and
//    consumers.  Each box is 64 columns (one 128-byte row, 128-byte swizzle,
//    the layout the wgmma descriptors name); D = 128 is two boxes, and
//    D = 16 or 32 is one box whose columns past D are zero-filled;
//  * S = Q K^T is wgmma m64n128k16 with both operands in shared memory,
//    K-major as stored;
//  * the online softmax runs on the accumulator fragment: each thread holds
//    two rows, whose max is reduced over a quad with two shuffles (the sum
//    only once, at the end); the mask runs only on tiles that cross the
//    diagonal, the window's lower edge or the end of the keys;
//  * O += P V is wgmma with A (P) in registers, repacked from the S fragment,
//    and B (V, MN-major as stored) through a descriptor with the transpose
//    bit.  bf16(P) alone would move ~10% of the outputs by more than one
//    bf16 ulp, so P is split into hi = bf16(P) and lo = bf16(P - hi) and
//    both products are summed in float32 (1.5x the tensor work of a plain
//    flash kernel; the split leaves an error of ~2^-17 of P);
//  * the output is divided and rounded in registers and stored with checked
//    bf16 pair stores.
//
// float32 (flash_attention_f32_kernel), the CUDA-core path, explicit fmaf:
//  * 256 threads per 128-row query tile, 64-key tiles, one block an SM:
//    two warps on each SM sub-partition hide each other's shared-memory
//    latency (a 64-row block of 128 threads, one warp a sub-partition, was
//    slower on the card);
//  * each thread owns 8 rows x 4 keys of the score tile and 8 rows x D/16
//    columns of the output;
//  * Q and each K tile are staged transposed (d-major) in shared memory, so
//    a d step of the score product is two float4 reads of Q^T (two
//    addresses a warp, broadcast) and one of K^T for 32 FMAs; the
//    probabilities are stored transposed too, so a key step of P V is two
//    float4 reads of P^T and two of V for 64 FMAs;
//  * cp.async overlaps the copies with the arithmetic: the next K tile
//    loads during this tile's softmax and P V, the next V tile during the
//    next score product (the K^T copies are 4-byte, laid out so that a
//    warp's 32 stores hit 32 banks).

#include "flash_common.cuh"

namespace {

template <bool kCap>
__device__ __forceinline__ float log2_score(float s, ScoreMap f) {
  if constexpr (kCap) return f.cap * tanhf(s * f.scale * f.inv_cap) * kLog2e;
  else return s * f.scale_log2;
}

// The first key tile of a block whose first query row is q0: with a window
// (kWin) the tile that holds q0 - window + 1, the first key that row sees
// (tiles wholly below it are never loaded); else tile 0.
template <bool kWin, int BK>
__device__ __forceinline__ int first_tile(int q0, int window) {
  if constexpr (kWin) return max(0, q0 - window + 1) / BK;
  else return 0;
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kBQ = 128;          // query rows of a block
constexpr int kBK = 64;           // key rows of a tile
constexpr int kThreads = 256;     // 16 (tx: keys / output columns) x 16 (ty: query rows)
constexpr int kUnroll = 32;       // steps unrolled, so that shared loads run ahead of the FMAs
constexpr int kLdQ = kBQ + 8;     // a row of Q^T; the +8 spreads the transposing stores
constexpr int kLdK = kBK + 8;     // a row of K^T, likewise
constexpr int kLdP = kBQ + 4;     // a row of P^T
static_assert(kBQ == 8 * (kThreads / 16) && kBK == 4 * 16, "a thread: 8 rows x 4 keys");

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)D * kLdQ + (size_t)D * kLdK + (size_t)kBK * D + (size_t)kBK * kLdP);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a (rows, D) matrix into dst[d * LD + row],
// rows past the end as zeros.  A warp copies an 8-row x 4-column block a
// step (lane = 8 * column + row), so with LD = 8 (mod 32) its 32 stores hit
// 32 banks.  Warp w takes column blocks w, w + warps, ...: every address is
// the thread's base plus a constant.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_transposed(float* dst, const float* src, int row0, int rows,
                                                int tid) {
  constexpr int kWarps = kThreads / 32, kColBlocks = D / 4;
  constexpr int kPerRowBlock = kColBlocks >= kWarps ? kColBlocks / kWarps : 1;
  constexpr int kSteps = (ROWS / 8) * kColBlocks / kWarps;
  const int lane = tid & 31, warp = tid >> 5;
  const int rs = lane & 7, ds = lane >> 3;
  const int d0 = (warp % kColBlocks) * 4 + ds, r0 = (warp / kColBlocks) * 8 + rs;
  const float* s0 = src + (size_t)(row0 + r0) * D + d0;
  float* t0 = dst + d0 * LD + r0;
  const bool whole = row0 + ROWS <= rows;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    // step i: column block warp + kWarps * (i % kPerRowBlock) of row block ...
    const int dr = kColBlocks >= kWarps ? 8 * (i / kPerRowBlock) : 8 * (kWarps / kColBlocks) * i;
    const int dd = kColBlocks >= kWarps ? 4 * kWarps * (i % kPerRowBlock) : 0;
    const bool valid = whole || row0 + r0 + dr < rows;
    cp_async4(t0 + dd * LD + dr, valid ? s0 + (size_t)dr * D + dd : src, valid);
  }
}

// Rows [row0, row0 + kBK) of a (rows, D) matrix as stored, rows past the end
// as zeros.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int row0, int rows,
                                          int tid) {
  constexpr int kVec = D / 4, kSteps = kBK * kVec / kThreads;
  const int r0 = tid / kVec, c = (tid % kVec) * 4;
  constexpr int kRowStep = kThreads / kVec;
  const bool whole = row0 + kBK <= rows;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const int r = r0 + i * kRowStep;
    const bool valid = whole || row0 + r < rows;
    cp_async16(dst + r * D + c, valid ? src + (size_t)(row0 + r) * D + c : src, valid);
  }
}

__device__ __forceinline__ float reduce_max16(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float reduce_sum16(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// N values of a row: float4s at c, c + GAP, ...
template <int N, int GAP>
__device__ __forceinline__ void load_n(float (&x)[N], const float* row, int c) {
#pragma unroll
  for (int g = 0; g < N / 4; ++g) {
    const float4 a = *reinterpret_cast<const float4*>(row + c + g * GAP);
    x[4 * g] = a.x; x[4 * g + 1] = a.y; x[4 * g + 2] = a.z; x[4 * g + 3] = a.w;
  }
}

// Output columns of thread tx: D / 16 of them, as float4 where D >= 64.
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (D >= 128) return (c / 4) * 64 + tx * 4 + (c % 4);
  else if constexpr (D == 64) return tx * 4 + c;
  else return tx * (D / 16) + c;
}

template <int D>
__device__ __forceinline__ void load_v(float (&x)[D / 16], const float* row, int tx) {
  if constexpr (D >= 64) {
    load_n<D / 16, 64>(x, row, tx * 4);
  } else {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) x[c] = row[out_col<D>(tx, c)];
  }
}

template <int D, bool kCap, bool kWin>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, float* __restrict__ lse, int sq, int skv, int causal, int window,
    ScoreMap f) {
  constexpr int kC = D / 16;
  constexpr int kHalf = kBQ / 2;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][kLdQ]   Q^T
  float* kt = qt + D * kLdQ;                     // [D][kLdK]   K^T
  float* vs = kt + D * kLdK;                     // [kBK][D]    V
  float* pt = vs + kBK * D;                      // [kBK][kLdP] P^T

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;    // heaviest tiles first
  const float* qb = q + bh * sq * D;
  const float* kb = k + bh * skv * D;
  const float* vb = v + bh * skv * D;
  // This thread's rows of the tile: ty*4 + i and kBQ/2 + ty*4 + i (i < 4); its
  // keys of a tile: tx*4 + j (j < 4).
  auto row_of = [&](int i) { return (i / 4) * kHalf + ty * 4 + (i % 4); };

  const int kv_end = causal ? min(skv, min(q0 + kBQ, sq)) : skv;
  const int tiles = (kv_end + kBK - 1) / kBK;
  const int t_begin = first_tile<kWin, kBK>(q0, window);

  load_transposed<D, kBQ, kLdQ>(qt, qb, q0, sq, tid);
  cp_async_commit();
  load_transposed<D, kBK, kLdK>(kt, kb, t_begin * kBK, skv, tid);
  cp_async_commit();
  load_rows<D>(vs, vb, t_begin * kBK, skv, tid);
  cp_async_commit();

  float m[8], l[8], o[8][kC];     // m in the log2 domain
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) o[i][c] = 0.f;
  }

  for (int t = t_begin; t < tiles; ++t) {
    const int k0 = t * kBK;
    const bool more = t + 1 < tiles;
    cp_async_wait<1>();              // Q and this K tile are in; this V tile may not be
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll kUnroll
    for (int d = 0; d < D; ++d) {
      float a[8], b[4];
      load_n<8, kHalf>(a, qt + d * kLdQ, ty * 4);
      load_n<4, 4>(b, kt + d * kLdK, tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    __syncthreads();                 // every thread is done with this K tile
    if (more) {
      load_transposed<D, kBK, kLdK>(kt, kb, k0 + kBK, skv, tid);
      cp_async_commit();
    }

    // Tiles inside the visible band and before the end need no mask: the
    // upper edge is the diagonal, the lower (kWin) the window's start of
    // the tile's last row.
    const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > q0) ||
                      (kWin && k0 <= q0 + kBQ - 1 - window);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q0 + row_of(i);
      float mc = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = log2_score<kCap>(s[i][j], f);
        if (edge) {
          const int kpos = k0 + tx * 4 + j;
          if (kpos >= skv) x = -INFINITY;                 // past the end: weight 0
          else if (causal && kpos > qpos) x = kMasked;    // the reference's mask value
          else if (kWin && qpos - kpos >= window) x = kMasked;
        }
        s[i][j] = x;
        mc = fmaxf(mc, x);
      }
      const float m_new = fmaxf(m[i], reduce_max16(mc));
      const float r = exp2f(m[i] - m_new);
      float lsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        lsum += s[i][j];
      }
      l[i] = l[i] * r + lsum;        // this thread's share; summed over the row at the end
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kC; ++c) o[i][c] *= r;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* dst = pt + (tx * 4 + j) * kLdP + ty * 4;
      *reinterpret_cast<float4*>(dst) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      *reinterpret_cast<float4*>(dst + kHalf) = make_float4(s[4][j], s[5][j], s[6][j], s[7][j]);
    }
    if (more) cp_async_wait<1>();    // this V tile is in; the next K tile may not be
    else cp_async_wait<0>();
    __syncthreads();                 // P^T and V visible to every thread

#pragma unroll kUnroll
    for (int kk = 0; kk < kBK; ++kk) {
      float p[8], vv[kC];
      load_n<8, kHalf>(p, pt + kk * kLdP, ty * 4);
      load_v<D>(vv, vs + kk * D, tx);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < kC; ++c) o[i][c] = fmaf(p[i], vv[c], o[i][c]);
    }
    __syncthreads();                 // every thread is done with V and P^T
    if (more) {
      load_rows<D>(vs, vb, k0 + kBK, skv, tid);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float denom = fmaxf(reduce_sum16(l[i]), 1e-30f);
    const int row = q0 + row_of(i);
    if (row >= sq) continue;
    if (lse != nullptr && tx == 0) lse[bh * sq + row] = m[i] + log2f(denom);
    float* o_row = out + (bh * sq + row) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) o_row[out_col<D>(tx, c)] = o[i][c] / denom;
  }
}

template <int D, bool kCap, bool kWin>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int bh, int sq,
           int skv, int causal, int window, ScoreMap f, cudaStream_t stream) {
  auto kernel = flash_attention_f32_kernel<D, kCap, kWin>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), lse, sq, skv, causal, window, f);
  return (int)cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (wgmma), TMA
// ---------------------------------------------------------------------------
namespace bf16 {

constexpr int kBQ = 128;          // query rows of a block: two consumer warpgroups of 64
constexpr int kBK = 128;          // key rows of a tile
constexpr int kStages = 2;        // K/V tiles in flight (a third measured no faster)
constexpr int kThreads = 384;     // producer warpgroup + two consumer warpgroups
constexpr int kConsumerArrivals = 8;   // one per consumer warp releases a stage
// At least this much shared memory a block, so that two blocks never share an
// SM: their consumers' setmaxnreg.inc could then wait for each other's
// registers.
constexpr int kMinSmem = 120 * 1024;

template <int D>
struct Tiles {
  static constexpr int kCols = D < kBoxCols ? kBoxCols : D;   // columns staged (zeros past D)
  static constexpr int kBoxes = kCols / kBoxCols;             // boxes a row
  static constexpr int kQBytes = kBoxes * kBQ * kRowBytes;
  static constexpr int kKVBytes = kBoxes * kBK * kRowBytes;   // one K or one V tile
  static constexpr int kBarBytes = 8 * (1 + 2 * kStages);
  static constexpr int kUsed = 1024 + kQBytes + 2 * kStages * kKVBytes + kBarBytes;
  static constexpr int kSmem = kUsed > kMinSmem ? kUsed : kMinSmem;
};

// The consumer warpgroup `c` (0 or 1): query rows q0 + 64c .. + 63, over key
// tiles t_begin .. tiles - 1 (the i-th in stage i % kStages).
template <int D, bool kCap, bool kWin>
__device__ __forceinline__ void consume(uint32_t q_s, uint32_t k_s, uint32_t v_s, uint32_t bars,
                                        __nv_bfloat16* __restrict__ out,
                                        float* __restrict__ lse, int bh, int q0,
                                        int t_begin, int tiles, int sq, int skv, int causal,
                                        int window, ScoreMap f, int c) {
  using T = Tiles<D>;
  constexpr int kO = T::kCols / 2;          // output accumulator: 64 x kCols over 128 threads
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int quad_row = lane / 4, quad_col = lane % 4;
  // This thread's rows: row0 and row0 + 8.
  const int row0 = q0 + 64 * c + 16 * warp + quad_row;
  const uint32_t q_full = bars, full0 = bars + 8, empty0 = bars + 8 * (1 + kStages);

  float o[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};   // in the log2 domain

  mbar_wait(q_full, 0);
  const uint32_t q_wg = q_s + 64 * c * kRowBytes;

  for (int t = t_begin; t < tiles; ++t) {
    const int i = t - t_begin, stage = i % kStages;
    mbar_wait(full0 + 8 * stage, (i / kStages) & 1);
    const uint32_t k_t = k_s + stage * T::kKVBytes, v_t = v_s + stage * T::kKVBytes;

    // S = Q K^T over d in steps of 16 (a 128-byte row holds four).
    float s[kBK / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss(s, smem_desc(q_wg + (kk / 4) * kBQ * kRowBytes + col, 16),
               smem_desc(k_t + (kk / 4) * kBK * kRowBytes + col, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Online softmax on the fragment: s[4j + e] is row row0 + 8 * (e / 2),
    // key k0 + 8j + 2 * quad_col + e % 2.
    const int k0 = t * kBK;
    const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > q0 + 64 * c) ||
                      (kWin && k0 <= q0 + 64 * c + 63 - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = log2_score<kCap>(s[4 * j + e], f);
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * quad_col + (e & 1);
          const int qpos = row0 + 8 * (e >> 1);
          if (kpos >= skv) x = -INFINITY;                       // weight 0
          else if (causal && kpos > qpos) x = kMasked;          // the reference's mask
          else if (kWin && qpos - kpos >= window) x = kMasked;
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float alpha = exp2f(m[r] - mx[r]);
      l[r] *= alpha;
      m[r] = mx[r];
#pragma unroll
      for (int j = 0; j < kO / 4; ++j) {
        o[4 * j + 2 * r] *= alpha;
        o[4 * j + 2 * r + 1] *= alpha;
      }
    }

    // P as the A operand of m64nNk16: register h of k-slice kk holds the
    // pair s[8kk + 2h], s[8kk + 2h + 1] (row h % 2).  hi = bf16(P), lo =
    // bf16(P - hi).
    uint32_t p_hi[kBK / 16][4], p_lo[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float p0 = exp2f(s[8 * kk + 2 * h] - m[h & 1]);
        const float p1 = exp2f(s[8 * kk + 2 * h + 1] - m[h & 1]);
        l[h & 1] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 back = __bfloat1622float2(hi);
        p_hi[kk][h] = bits(hi);
        p_lo[kk][h] = bits(__floats2bfloat162_rn(p0 - back.x, p1 - back.y));
      }

    // O += P_hi V + P_lo V over the keys in steps of 16 (16 rows of 128 bytes).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t desc_v = smem_desc(v_t + kk * 16 * kRowBytes, kBK * kRowBytes);
      wgmma_rs(o, p_hi[kk], desc_v);
      wgmma_rs(o, p_lo[kk], desc_v);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);   // this warp is done with the stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    if (lse != nullptr && quad_col == 0) lse[(size_t)bh * sq + row] = m[r] + log2f(denom);
    __nv_bfloat16* o_row = out + ((size_t)bh * sq + row) * D;
#pragma unroll
    for (int j = 0; j < kO / 4; ++j) {
      const int col = 8 * j + 2 * quad_col;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(o_row + col) = __floats2bfloat162_rn(
            o[4 * j + 2 * r] / denom, o[4 * j + 2 * r + 1] / denom);
    }
  }
}

template <int D, bool kCap, bool kWin>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_bf16_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int sq, int skv, int causal, int window, ScoreMap f) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;   // 128-byte swizzle: 1024
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + T::kQBytes;                          // + stage * kKVBytes
  const uint32_t v_s = k_s + kStages * T::kKVBytes;
  const uint32_t bars = v_s + kStages * T::kKVBytes;  // q_full, full[kStages], empty[kStages]
  const uint32_t q_full = bars, full0 = bars + 8, empty0 = bars + 8 * (1 + kStages);

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;    // heaviest tiles first
  const int kv_end = causal ? min(skv, min(q0 + kBQ, sq)) : skv;
  const int tiles = (kv_end + kBK - 1) / kBK;
  const int t_begin = first_tile<kWin, kBK>(q0, window);   // producer and consumers agree

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // Producer: one thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
      for (int b = 0; b < T::kBoxes; ++b)
        tma_load(q_s + b * kBQ * kRowBytes, &map_q, q_full, b * kBoxCols, q0, bh);
      for (int t = t_begin; t < tiles; ++t) {
        const int i = t - t_begin, stage = i % kStages;
        // The consumers released this stage's previous tile (i - kStages).
        if (i >= kStages) mbar_wait(empty0 + 8 * stage, ((i / kStages) + 1) & 1);
        const uint32_t full = full0 + 8 * stage;
        mbar_expect_tx(full, 2 * T::kKVBytes);
        for (int b = 0; b < T::kBoxes; ++b) {
          const uint32_t off = stage * T::kKVBytes + b * kBK * kRowBytes;
          tma_load(k_s + off, &map_k, full, b * kBoxCols, t * kBK, bh);
          tma_load(v_s + off, &map_v, full, b * kBoxCols, t * kBK, bh);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<D, kCap, kWin>(q_s, k_s, v_s, bars, out, lse, bh, q0, t_begin, tiles, sq, skv,
                           causal, window, f, wg - 1);
  }
}

template <int D, bool kCap, bool kWin>
int launch(const void* q, const void* k, const void* v, void* out, float* lse, int bh, int sq,
           int skv, int causal, int window, ScoreMap f, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap map_q, map_k, map_v;
  if (encode(&map_q, q, bh, sq, D, kBQ) != CUDA_SUCCESS ||
      encode(&map_k, k, bh, skv, D, kBK) != CUDA_SUCCESS ||
      encode(&map_v, v, bh, skv, D, kBK) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_attention_bf16_kernel<D, kCap, kWin>;
  const int smem = Tiles<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(map_q, map_k, map_v,
                                           static_cast<__nv_bfloat16*>(out), lse, sq, skv,
                                           causal, window, f);
  return (int)cudaGetLastError();
}

}  // namespace bf16

template <bool kBf16, bool kCap, bool kWin>
int dispatch(const void* q, const void* k, const void* v, void* out, float* lse, int bh, int sq,
             int skv, int d, int causal, int window, ScoreMap f, cudaStream_t stream) {
#define IELAS_FLASH_CASE(D)                                                                   \
  case D:                                                                                     \
    return kBf16 ? bf16::launch<D, kCap, kWin>(q, k, v, out, lse, bh, sq, skv, causal, window, \
                                               f, stream)                                     \
                 : f32::launch<D, kCap, kWin>(q, k, v, out, lse, bh, sq, skv, causal, window,  \
                                              f, stream);
  switch (d) {
    IELAS_FLASH_CASE(16)
    IELAS_FLASH_CASE(32)
    IELAS_FLASH_CASE(64)
    IELAS_FLASH_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef IELAS_FLASH_CASE
}

template <bool kCap, bool kWin>
int dispatch_type(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                  int sq, int skv, int d, int dtype, int causal, int window, ScoreMap f,
                  cudaStream_t s) {
  if (dtype == 0)
    return dispatch<false, kCap, kWin>(q, k, v, out, lse, bh, sq, skv, d, causal, window, f, s);
  if (dtype == 1)
    return dispatch<true, kCap, kWin>(q, k, v, out, lse, bh, sq, skv, d, causal, window, f, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launch on `stream`: q (bh, sq, d), k and v (bh, skv, d), out like q, all
// contiguous and 16-byte aligned, of one type: dtype 0 float32, 1 bfloat16.
// d is 16, 32, 64 or 128; sq, skv >= 1; sq / 64 tiles at most 65535.
// window > 0 (causal, sq <= skv, so that every row sees its own position):
// row i sees keys i - window + 1 .. i; softcap > 0 caps each scaled score to
// softcap * tanh(s / softcap) before the mask.  Each option is a template
// parameter: with window 0 and softcap 0 the kernels are those without them.
// lse, when not null: (bh, sq) float32, each row's log-sum-exp of its scores
// in the log2 domain, m + log2(l) (the backward's input, flash_attention_bwd.cu).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ielas_flash_attention_lse(const void* q, const void* k, const void* v, void* out,
                                         void* lse, int bh, int sq, int skv, int d, int dtype,
                                         int causal, int window, float scale, float softcap,
                                         void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bh < 1 || sq < 1 || skv < 1 || window < 0 || !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  if (window > 0 && (!causal || sq > skv)) return (int)cudaErrorInvalidValue;
  const bool cap = softcap > 0.f, win = window > 0;
  const ScoreMap f{scale * kLog2e, scale, softcap, cap ? 1.f / softcap : 0.f};
  float* l = static_cast<float*>(lse);
  if (cap && win)
    return dispatch_type<true, true>(q, k, v, out, l, bh, sq, skv, d, dtype, causal, window, f,
                                     s);
  if (cap)
    return dispatch_type<true, false>(q, k, v, out, l, bh, sq, skv, d, dtype, causal, 0, f, s);
  if (win)
    return dispatch_type<false, true>(q, k, v, out, l, bh, sq, skv, d, dtype, causal, window, f,
                                      s);
  return dispatch_type<false, false>(q, k, v, out, l, bh, sq, skv, d, dtype, causal, 0, f, s);
}
