// Streaming support-point disparity search (paper Fig. 6) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/support_match.py
// ::support_match_pallas, whose body is the oracle
// src/repro/kernels/ref.py::support_match_rows_streaming.  Its plain PyTorch
// version is src/repro_torch/kernels/ref.py::support_match_rows_streaming;
// the output must equal it bit for bit.
//
// What it computes, per candidate row: the right view at every column u
// (CV_R[d, u] = SAD(dl[u + d], dr[u]), d < min(D, W - u)) and the left view
// at the candidate columns u = offset + j * step (CV[d, u] = SAD(dl[u],
// dr[u - d]), d < min(D, u + 1)), each reduced to 4-deep (cost, d)
// registers; then the texture, uniqueness and L/R tests (the cross-check
// reads the right view at clip(u - best, 0, W - 1)).  d runs over
// [0, num_disp) whatever disp_min is; disp_min only enters the margin test.
//
// What bounds it on an H100: the SAD's VABSDIFF4, a video instruction the
// integer pipe issues at a fraction of its rate.  A KITTI frame is 13.6 M
// (column, d) pairs (75 rows x (150,848 right + 30,119 left)), each a
// 16-byte SAD (4 VABSDIFF4) and a register insert, on 3 MB of descriptors.
// Per-pixel descriptors have no aggregation window, so no pair's SAD can be
// reused: the gains are fewer instructions per pair and a full card.  With
// every insert replaced by one add the kernel takes 24.9 of its 27.0 us at
// KITTI (dense_profile.py "SAD only"; NVIDIA H100 80GB HBM3, 700 W).
//
// Two facts make the work divisible (tests/test_torch_support_facts.py
// proves them on the plain side against kernels/ref.py's _insert4):
//   * the registers are order-free: strict-< inserts from ascending d keep
//     the four lexicographically least (cost, d) pairs among the in-image
//     d, padded with (BIG, 0).  So d may be split into chunks folded on
//     their own and merged, in any order;
//   * the packed key cost << 10 | d (cost <= 16 * 255 = 4080, d < 1024)
//     orders as (cost, d), so the registers are a few float min/max (the
//     float whose bits are 2^23 + the key is positive and normal); and instead of
//     the four least, the kernel keeps the two least of each class of d
//     mod 4 (3 ops an insert instead of 7): the least key is best, and
//     min2 (the least cost outside |d - best| <= 1) is in each class its
//     least key or, if that one's d lies inside, its second, so (best,
//     min1, min2) are _finalize4's.  The empty key decodes to (BIG, 0), so
//     min2 and the float ratio test see what they see with the plain
//     registers.
//
// What the design does about it:
//   * a cluster of K blocks per candidate row (K = 8 when the rows alone
//     leave a third of the SMs idle, as a KITTI frame's 75 do, and the row
//     is 256 columns or wider; else 1, or 2, 4 or 8 when a block's span
//     would not fit shared memory), each owning a span of the row's
//     columns: the right view over its span, the left view at the
//     candidates in it.  The cross-check reads
//     the right view's verdict at clip(u - best) from whichever block of
//     the cluster owns that column, in its shared memory (distributed
//     shared memory), so no column is searched twice and the wave stays
//     one launch;
//   * the block stages its descriptor columns once (left: span + halo,
//     right: halo + span, halo = the d it searches) with cp.async, all in
//     flight at once, and turns them to offset binary (byte ^ 0x80), so a
//     chain of four VABSDIFF4 with accumulate gives the exact SAD of 16
//     signed bytes;
//   * an item is 4 adjacent right-view columns (or one left candidate)
//     and a chunk of 32 d; a thread slides a 4-descriptor window over the
//     left row, so one 16-byte shared load serves 4 pairs.  The chunks of
//     one column group sit on adjacent lanes and merge by shuffles;
//   * an item whose pairs are all in the image and in range runs without
//     masks; one at an edge replaces the out-of-range keys by the empty key.
// Per pair in the unmasked right-view loop (cuobjdump -sass, counted by
// dense_profile.py): 8.8 instructions (4 VABSDIFF4, 3 FMNMX, 1.2 IMAD, a
// quarter of an LDS.128), against 26.5 in the first design's loop (8 SEL, 4.25
// ISETP, 4 VABSDIFF4, 4 VIMNMX, 3 IMAD, 1 LDS.128, ...).
// Limits (the wrapper raises beyond them on every device): num_disp <= 1024
// (the key's d field) and width <= 32768 (shared memory at K = 8).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kBig = 1 << 28;
// A key is the float32 whose bits are kBias + cost * 1024 + d: a positive
// normal float, so float order is the order of (cost, d) and the register
// network runs on float min/max.  The empty register is the largest float.
constexpr int kBias = 1 << 23;
constexpr int kFillBits = 0x7f7fffff;  // an empty register: (BIG, d = 0)
constexpr int kMaxDisp = 1024;         // d < 2^10, the key's low bits
constexpr int kMaxWidth = 32768;       // shared memory at K = 8
constexpr int kChunk = 32;             // d per item
constexpr int kCols = 4;               // right-view columns per item
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;
constexpr unsigned kFlip = 0x80808080u;

// A column's registers: for each class of d mod 4, the two least keys, in
// ascending order (k[2 * b] <= k[2 * b + 1] for class b).
struct Keys {
  float k[8];
};

struct Params {
  const uint4* dl;
  const uint4* dr;
  float* out;
  long long frame_l, row_l, frame_r, row_r;   // strides, in 16-byte descriptors
  int gh, w, gw, num_disp, step, offset, texture;
  float ratio;
  int lr, disp_min;
  int span;      // columns a block owns (a multiple of kCols)
  int chunks;    // d items per column: a power of two, chunks * kChunk >= num_disp
};

__device__ __forceinline__ void fill(Keys& r) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r.k[k] = __int_as_float(kFillBits);
}

// Insert `key`, whose d is b mod 4, into class b's two least.
__device__ __forceinline__ void insert(Keys& r, int b, float key) {
  const float m = fmaxf(r.k[2 * b], key);
  r.k[2 * b] = fminf(r.k[2 * b], key);
  r.k[2 * b + 1] = fminf(r.k[2 * b + 1], m);
}

// The two least of each class of two lists.
__device__ __forceinline__ void merge(Keys& a, const Keys& b) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float lo = fminf(a.k[2 * c], b.k[2 * c]);
    const float hi = fminf(fmaxf(a.k[2 * c], b.k[2 * c]), fminf(a.k[2 * c + 1], b.k[2 * c + 1]));
    a.k[2 * c] = lo;
    a.k[2 * c + 1] = hi;
  }
}

// Merge the lists of `width` adjacent lanes (a power of two); every lane of
// the group ends with the merged list.
__device__ __forceinline__ void merge_lanes(Keys& r, int width) {
  for (int m = 1; m < width; m <<= 1) {
    Keys o;
#pragma unroll
    for (int k = 0; k < 8; ++k) o.k[k] = __shfl_xor_sync(0xffffffffu, r.k[k], m);
    merge(r, o);
  }
}

__device__ __forceinline__ int cost_of(float key) {
  const int bits = __float_as_int(key);
  return bits == kFillBits ? kBig : (bits - kBias) >> 10;
}
__device__ __forceinline__ int d_of(float key) {
  const int bits = __float_as_int(key);
  return bits == kFillBits ? 0 : (bits - kBias) & (kMaxDisp - 1);
}

// ref._finalize4's result from the classes: best is the least key; min2,
// the least cost of a d outside |d - best| <= 1, is in each class its least
// key or, when that one's d is inside (at most one d of a class can be),
// its second.  (The four lexicographically least pairs hold the least one
// outside, since at most three lie inside, so this is _finalize4's min2.)
// Then the uniqueness (float32 ratio) and texture tests.  Returns best |
// ok << 16.
__device__ __forceinline__ int verdict(const Keys& r, int texture, const Params& p) {
  const float least = fminf(fminf(r.k[0], r.k[2]), fminf(r.k[4], r.k[6]));
  const int best = d_of(least), min1 = cost_of(least);
  int min2 = kBig;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int dist = d_of(r.k[2 * c]) - best;
    const bool inside = dist <= 1 && dist >= -1;
    min2 = min(min2, cost_of(inside ? r.k[2 * c + 1] : r.k[2 * c]));
  }
  const bool ok = (float)min1 < p.ratio * (float)min2 && min1 < kBig && texture >= p.texture;
  return best | (ok ? 1 << 16 : 0);
}

__device__ __forceinline__ uint4 flip(uint4 a) {
  a.x ^= kFlip; a.y ^= kFlip; a.z ^= kFlip; a.w ^= kFlip;
  return a;
}

// |a - b| summed over 4 unsigned bytes, plus c: one VABSDIFF4 with
// accumulate, so a SAD is a chain of four.
__device__ __forceinline__ unsigned sad4_acc(unsigned a, unsigned b, unsigned c) {
  unsigned d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Exact SAD of two descriptors held in offset binary.
__device__ __forceinline__ int sad16(const uint4 a, const uint4 b) {
  return (int)sad4_acc(a.w, b.w, sad4_acc(a.z, b.z, sad4_acc(a.y, b.y, sad4_acc(a.x, b.x, 0u))));
}

// A 16-byte copy from global to shared memory that does not hold a
// register (cp.async, sm_80 and later); copy_wait waits for the thread's.
__device__ __forceinline__ void copy16_async(uint4* smem, const uint4* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ int texture16(const uint4 a) {
  return sad16(a, make_uint4(kFlip, kFlip, kFlip, kFlip));
}

// The key of (sad, d), given dbias = kBias + d.
__device__ __forceinline__ float key_of(int sad, int dbias) {
  return __int_as_float(sad * 1024 + dbias);
}

// Right view, columns u0 .. u0 + kCols - 1, d = d0 + j for j < kChunk: the
// pair (i, j) reads dl[u0 + i + d0 + j] = src[i + j], from a window of
// kCols descriptors that slides along src (slot s holds src[index = s mod
// kCols]).  With kMask, a pair with j >= dlim (d >= D) or i + j >= xlim
// (past the right edge) inserts the empty key, which changes nothing.
template <bool kMask>
__device__ __forceinline__ void right_scan(const uint4* src, const uint4* own, int d0,
                                           int dlim, int xlim, Keys* r) {
  uint4 win[kCols];
#pragma unroll
  for (int s = 0; s < kCols - 1; ++s) win[s] = src[s];
#pragma unroll 1
  for (int j0 = 0; j0 < kChunk; j0 += 4) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = j0 + t;
      win[(t + kCols - 1) % kCols] = src[j + kCols - 1];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        float key = key_of(sad16(win[(t + i) % kCols], own[i]), kBias + d0 + j);
        if (kMask && (j >= dlim || i + j >= xlim)) key = __int_as_float(kFillBits);
        insert(r[i], t, key);                 // d = d0 + j0 + t: class t
      }
    }
  }
}

// Left view at column u, d = d0 + j: reads dr[u - d0 - j] = src[-j].
template <bool kMask>
__device__ __forceinline__ void left_scan(const uint4* src, const uint4 own, int d0, int dlim,
                                          Keys& r) {
#pragma unroll 1
  for (int j0 = 0; j0 < kChunk; j0 += 4) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j = j0 + t;
      float key = key_of(sad16(own, src[-j]), kBias + d0 + j);
      if (kMask && j >= dlim) key = __int_as_float(kFillBits);
      insert(r, t, key);                      // d = d0 + j0 + t: class t
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads) support_match_kernel(const Params p) {
  extern __shared__ uint4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();            // the span: blockIdx.x
  const int row = blockIdx.y, frame = blockIdx.z;
  const int halo = p.chunks * kChunk;
  const int c0 = rank * p.span, c1 = min(c0 + p.span, p.w);
  const int ncols = max(c1 - c0, 0);
  uint4* sl = smem;                                      // dl[c0, c0 + span + halo)
  uint4* sr = sl + p.span + halo;                        // dr[c0 - halo, c0 + span)
  int* right = reinterpret_cast<int*>(sr + p.span + halo);   // verdicts of the span
  int* left = right + p.span;                            // verdicts of its candidates

  // ---- stage the block's descriptor columns (zero outside the image) ----
  // Every copy of the block in flight at once (cp.async), then one pass to
  // offset binary.  smem[i] is sl[i] for i < span + halo, else sr.
  const uint4* gl = p.dl + frame * p.frame_l + row * p.row_l;
  const uint4* gr = p.dr + frame * p.frame_r + row * p.row_r;
  const int staged = 2 * (p.span + halo);
  for (int i = threadIdx.x; i < staged; i += blockDim.x) {
    const bool is_left = i < p.span + halo;
    const int x = is_left ? c0 + i : c0 - halo + (i - p.span - halo);
    if (x >= 0 && x < p.w) {
      copy16_async(smem + i, (is_left ? gl : gr) + x);
    } else {
      smem[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  copy_wait();
  __syncthreads();
  for (int i = threadIdx.x; i < staged; i += blockDim.x) smem[i] = flip(smem[i]);
  __syncthreads();
  const uint4 zero = make_uint4(kFlip, kFlip, kFlip, kFlip);

  const int lane = threadIdx.x & 31;
  const int warp_base = threadIdx.x & ~31;

  // ---- right view: items (column group, d chunk), chunks on adjacent lanes ----
  const int items_r = (ncols + kCols - 1) / kCols * p.chunks;
  for (int base = warp_base; base < ((items_r + 31) & ~31); base += blockDim.x) {
    const int item = base + lane;
    const int g = item / p.chunks, c = item % p.chunks;
    const int u0 = c0 + kCols * g, d0 = c * kChunk;
    Keys r[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) fill(r[i]);
    uint4 own[kCols];
#pragma unroll
    for (int i = 0; i < kCols; ++i) own[i] = item < items_r ? sr[u0 - c0 + halo + i] : zero;
    if (item < items_r && d0 < p.num_disp && u0 + d0 < p.w) {
      const uint4* src = sl + (u0 - c0) + d0;
      const int dlim = p.num_disp - d0, xlim = p.w - u0 - d0;
      if (dlim >= kChunk && xlim >= kChunk + kCols - 1) {
        right_scan<false>(src, own, d0, dlim, xlim, r);
      } else {
        right_scan<true>(src, own, d0, dlim, xlim, r);
      }
    }
#pragma unroll
    for (int i = 0; i < kCols; ++i) merge_lanes(r[i], p.chunks);
    if (item < items_r && c == 0) {
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        if (u0 + i < c1) right[u0 + i - c0] = verdict(r[i], texture16(own[i]), p);
      }
    }
  }

  // ---- left view: items (candidate, d chunk) ----
  const int jlo = ncols ? max(0, (c0 - p.offset + p.step - 1) / p.step) : 0;
  const int jhi = ncols ? min(p.gw, (c1 - p.offset + p.step - 1) / p.step) : 0;
  const int ncand = max(jhi - jlo, 0);
  const int items_l = ncand * p.chunks;
  for (int base = warp_base; base < ((items_l + 31) & ~31); base += blockDim.x) {
    const int item = base + lane;
    const int j = jlo + item / p.chunks, c = item % p.chunks;
    const int u = p.offset + j * p.step, d0 = c * kChunk;
    Keys r;
    fill(r);
    const uint4 own = sl[min(max(u - c0, 0), p.span + halo - 1)];
    const int dlim = min(p.num_disp, u + 1) - d0;
    if (item < items_l && dlim > 0) {
      const uint4* src = sr + (u - c0 + halo) - d0;
      if (dlim >= kChunk) {
        left_scan<false>(src, own, d0, dlim, r);
      } else {
        left_scan<true>(src, own, d0, dlim, r);
      }
    }
    merge_lanes(r, p.chunks);
    if (item < items_l && c == 0) left[item / p.chunks] = verdict(r, texture16(own), p);
  }

  // ---- decide, with the right view's verdicts of the whole cluster ----
  cluster.sync();
  for (int i = threadIdx.x; i < ncand; i += blockDim.x) {
    const int j = jlo + i, u = p.offset + j * p.step;
    const int v = left[i], best = v & 0xffff;
    const int ur = min(max(u - best, 0), p.w - 1);
    const int owner = ur / p.span;
    const int vr = cluster.map_shared_rank(right, owner)[ur - owner * p.span];
    const int diff = best - (vr & 0xffff);
    const bool valid = (v >> 16) && (vr >> 16) && diff <= p.lr && -diff <= p.lr &&
                       u >= p.disp_min + 2;
    p.out[((long long)frame * p.gh + row) * p.gw + j] = valid ? (float)best : -1.0f;
  }
  cluster.sync();      // no block leaves while another may read its verdicts
}

constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 227 * 1024;    // an H100 block's dynamic shared memory

// The current device's SM count, asked once per device.
int sm_count(int device) {
  static std::atomic<int> sms[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 132;
  int n = sms[device].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      n = 132;
    }
    sms[device].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Lets the kernel take up to kMaxSmem of dynamic shared memory on the
// current device: set once per device, when a launch first needs more than
// the default 48 KB.
cudaError_t allow_smem(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (device >= 0 && device < kMaxDevices && done[device].load(std::memory_order_relaxed)) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      support_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && device >= 0 && device < kMaxDevices) {
    done[device].store(true, std::memory_order_relaxed);
  }
  return err;
}

size_t smem_bytes(int span, int halo) {
  return (size_t)2 * (span + halo) * sizeof(uint4) + (size_t)2 * span * sizeof(int);
}

}  // namespace

// Launch on `stream` over `batch` frames of `gh` candidate rows of `w`
// descriptors (16 int8 each, 16-byte aligned): row r of frame b of a view
// starts at desc + b * frame_stride + r * row_stride, strides in
// descriptors.  out is (batch, gh, gw) float32, contiguous.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ielas_support_match(const void* desc_l, const void* desc_r, void* out,
                                   long long frame_stride_l, long long row_stride_l,
                                   long long frame_stride_r, long long row_stride_r,
                                   int batch, int gh, int w, int gw, int num_disp, int step,
                                   int offset, int support_texture, float ratio,
                                   int lr_threshold, int disp_min, void* stream) {
  if (num_disp < 1 || num_disp > kMaxDisp || w < 1 || w > kMaxWidth || gh > 65535 ||
      batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  int chunks = 1;
  while (chunks * kChunk < num_disp) chunks *= 2;
  const int halo = chunks * kChunk;
  // Blocks a row: one when the rows alone cover two thirds of the SMs (the
  // fastest on a Tsukuba frame and on the waves) or the row is narrow, else
  // a cluster of 8 (the fastest on a KITTI frame's 75 rows; dense_profile.py's
  // sweep); 2, 4 or 8 when one block's span would not fit shared memory.
  int k = 3LL * batch * gh >= 2LL * sm_count(device) || w < 8 * 32 ? 1 : kMaxCluster;
  auto span_of = [&](int kk) { return ((w + kk - 1) / kk + kCols - 1) / kCols * kCols; };
  while (k < kMaxCluster && smem_bytes(span_of(k), halo) > kMaxSmem) k *= 2;
  const int span = span_of(k);
  const size_t smem = smem_bytes(span, halo);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 && (err = allow_smem(device)) != cudaSuccess) return (int)err;
  // Threads: the larger item count of the two views, in as few equal rounds
  // of at most kMaxThreads as it takes.
  const int items = max((span / kCols) * chunks, (span / step + 1) * chunks);
  const int rounds = (items + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((items + rounds - 1) / rounds + 31) / 32 * 32;

  Params p;
  p.dl = static_cast<const uint4*>(desc_l);
  p.dr = static_cast<const uint4*>(desc_r);
  p.out = static_cast<float*>(out);
  p.frame_l = frame_stride_l;
  p.row_l = row_stride_l;
  p.frame_r = frame_stride_r;
  p.row_r = row_stride_r;
  p.gh = gh;
  p.w = w;
  p.gw = gw;
  p.num_disp = num_disp;
  p.step = step;
  p.offset = offset;
  p.texture = support_texture;
  p.ratio = ratio;
  p.lr = lr_threshold;
  p.disp_min = disp_min;
  p.span = span;
  p.chunks = chunks;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k, gh, batch);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, support_match_kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
