#!/usr/bin/env python3
"""What bounds the stereo kernels on one card: variants timed in turns.

    python3 dense_profile.py [--rounds N] [--reps N] [--sass-of PARENT_SUPPORT_CU]
                             [--median-of PARENT_MEDIAN_CU] [--warm-of PARENT_WARM_CU]
    python3 dense_profile.py --plain

For ``elas-kitti`` and ``elas-tsukuba`` (seed 0) it prepares one frame's
inputs on the card, builds variants of
``src/repro_torch/kernels/csrc/dense_match_stream.cu``,
``dense_match_windowed.cu``, ``support_match.cu``, ``sobel.cu``, ``median.cu``
and ``dense_match_warm.cu`` (text
substitutions into copies under ``build/dense_profile/``; the sources
themselves are not changed), and times each with CUDA events over
``--reps`` back-to-back launches, in ``--rounds`` rounds of alternating
order (minimum kept): a launch's time inside a CUDA graph of ``--reps``
launches (CUDA events around its replay, no host launch cost between
launches), and back to back from the host (CUDA events, which the host's
launch rate bounds below ~10 us):

* ``as built``: the kernel as committed (checked against its plain version);
* ``L2-resident``: every block (stream, support) or warp (windowed) reads the
  inputs of one row in the middle of the frame, so the inputs stay in L2 and
  the time is the instructions' (the output is wrong, and not checked);
* ``no energy`` (dense): the energy's exp and log replaced by one
  multiply-add, so the difference to ``as built`` is what the energies cost;
* ``SAD only`` (support): each register insert replaced by one add, so the
  difference to ``as built`` is what the float min/max inserts cost;
* ``1 / 2 / 4 / 8 blocks a row`` (support): the kernel with its count of
  blocks a row fixed (as built it picks 8 on a KITTI frame, 1 on a Tsukuba
  one; checked against its plain version);
* ``1 / 4 rows a thread`` (Sobel): the strip each thread walks (2 as
  built; checked against its plain version);
* ``direct 3 x 3 sums`` (Sobel: each pixel's sums from its 9 neighbours, not
  from the columns' separable sums; checked against its plain version);
* ``no arithmetic`` (Sobel: the 3 x 3 sums replaced by one add, loads,
  shuffles and stores kept);
* ``loads only`` (stream: return after the block's loads and barrier;
  support: after staging the block's descriptors; Sobel: the rows' loads
  and one byte stored a row) and ``staging only`` (windowed: stage the
  windows, mark nothing);
* median (on the map the path hands it, elas-kitti's and elas-tsukuba's
  frame): ``loads and stores only`` (each median replaced by one add),
  ``1 / 4 rows a thread`` (2 as built; checked), ``8 warps a block`` (4 as
  built; checked), and with ``--median-of`` another ``median.cu`` (e.g. a
  parent's; checked);
* warm band kernel (frame 1 of a pan seeded by the card's cold output of
  frame 0, band 8): ``L2-resident`` (every block reads one row's inputs),
  ``no division`` (the prior's reciprocal replaced by a negation), ``SAD
  only`` (the energy replaced by one FMA), ``no candidates`` (staging and
  the stores only), and, checked against the plain version, ``true
  division`` (every candidate divides, as the parent's source), ``uniform
  trip count`` (every lane walks 2 band + 1 predicated steps), ``512
  threads a block``, ``SAD table`` (the left view's SADs in a shared table
  that the right view reads where its candidate lies in the left pixel's
  band), the four together, ``half-warp per
  pixel`` (16 lanes a pixel's band, the lanes' results met by shuffles),
  and with ``--warm-of`` another ``dense_match_warm.cu`` (e.g. a parent's).

It also prints the candidate counts per pixel and view (from the bitmasks and
priors) and the share of a warp's lanes busy while it walks them (the mean
count over the warp's busiest lane's), the warm band's candidates and the
share of right-view ones whose SAD the left view also needs, and, from
``cuobjdump -sass`` of the support library (and of ``--sass-of``, e.g. a
parent commit's source), the instructions of each loop that computes SADs,
per (column, d) pair.  With ``--plain`` it builds no variant and times
instead the plain version of each kernel (``kernels/ref.py``: support,
stream and windowed dense, Sobel, median, warm band) on each config's frame,
the device time of a call: every device row of a torch.profiler trace of
``PLAIN_REPS`` calls over the calls, from two traces whose device
operations agree within one in a hundred (``flash_profile.traced_device_ms``;
``chip_smoke.py`` times them only at elas-kitti).  Each line carries the card's name and power limit.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# calls of a plain version in one traced timing (--plain)
PLAIN_REPS = 1

STUB = ('#include "xla_math.cuh"\n', '#include "xla_math.cuh"\n'
        'namespace ielas {\n'
        '__device__ __forceinline__ float stub_energy(int sad, float df, float mu, float beta,\n'
        '    float, float, float) { return __fmaf_rn(beta, (float)sad, df - mu); }\n'
        '}  // namespace ielas\n')
NO_ENERGY = [STUB, ("ielas::energy(", "ielas::stub_energy(")]
# Warm kernel variants.  The left view's SADs in a shared table (d - lo, x)
# that the right view reads where its candidate lies in the left pixel's
# band (right pixel u at d and left pixel u + d at d share a SAD).
WARM_TABLE = [
    ("  uint4* sr = smem + w;\n",
     "  uint4* sr = smem + w;\n"
     "  int2* bands = reinterpret_cast<int2*>(smem + 2 * w);\n"
     "  uint16_t* table = reinterpret_cast<uint16_t*>(bands + w);\n"),
    ("      sr[x] = ielas::flip(gr[x]);\n",
     "      sr[x] = ielas::flip(gr[x]);\n      bands[x] = band_of(mu_l[x], p);\n"),
    ("[&](int d) { return ielas::sad16(a, right_col(x - d)); }",
     "[&](int d) { const int s = ielas::sad16(a, right_col(x - d));\n"
     "      table[(d - b.x) * w + x] = (uint16_t)s; return s; }"),
    ("  // Right view: pixel u at d", "  __syncthreads();\n  // Right view: pixel u at d"),
    ("[&](int d) { return ielas::sad16(a, left_col(u + d)); }",
     "[&](int d) { const int2 c = bands[u + d];\n"
     "      return d >= c.x && d <= c.y ? (int)table[(d - c.x) * w + u + d]\n"
     "                                  : ielas::sad16(a, left_col(u + d)); }"),
    ("  const size_t staged = 2 * (size_t)w * sizeof(uint4);\n",
     "  const size_t staged = 2 * (size_t)w * sizeof(uint4) + (size_t)w * sizeof(int2) +\n"
     "                        (size_t)(2 * band + 1) * w * sizeof(uint16_t);\n"),
]
# Every lane walks min(2 band + 1, D) predicated steps.
WARM_UNIFORM = [(
    "  for (int d = lo; d <= hi; ++d) {\n"
    "    best.fold(warm_energy<kFast>(sad_of(d), (float)d, mu, p.beta, p.inv_2s2), d);\n"
    "  }\n",
    "  const int steps = min(2 * p.band + 1, p.num_disp);\n"
    "  for (int k = 0; k < steps; ++k) {\n"
    "    const int d = lo + k;\n"
    "    if (d <= hi)\n"
    "      best.fold(warm_energy<kFast>(sad_of(d), (float)d, mu, p.beta, p.inv_2s2), d);\n"
    "  }\n")]
WARM_DIVISION = [("  return inv_2s2 >= 0.0f && ", "  return false && inv_2s2 >= 0.0f && ")]
WARM_512 = [("constexpr int kMaxThreads = 1024;", "constexpr int kMaxThreads = 512;")]
# A half-warp per pixel: lane j of 16 walks d = lo + j, lo + j + 16, ..., and
# the 16 lanes' (energy, d) meet by shuffles, the least energy and then the
# least d winning (the strict-< fold's result).
WARM_HALF_WARP = [
    (("  // Left view: pixel x at d matches", "template <bool kStaged>\ncudaError_t launch"), r"""
  const int lane = threadIdx.x & 15, slots = blockDim.x >> 4, first = threadIdx.x >> 4;
  const int passes = (w + slots - 1) / slots;
  auto half = [&](int lo, int hi, float mu, auto&& sad_of) {
    Best best;
    const bool fast = fast_band(lo, hi, mu, p.inv_2s2);
    for (int d = lo + lane; d <= hi; d += 16) {
      const int sad = sad_of(d);
      best.fold(fast ? warm_energy<true>(sad, (float)d, mu, p.beta, p.inv_2s2)
                     : warm_energy<false>(sad, (float)d, mu, p.beta, p.inv_2s2), d);
    }
    for (int o = 8; o > 0; o >>= 1) {
      const float e = __shfl_xor_sync(0xffffffffu, best.e, o);
      const int d = __shfl_xor_sync(0xffffffffu, best.d, o);
      if (e < best.e || (e == best.e && d < best.d)) { best.e = e; best.d = d; }
    }
    return best;
  };
  for (int i = 0; i < passes; ++i) {
    const int x = first + i * slots, xx = x < w ? x : 0;
    const uint4 a = left_col(xx);
    const float mu = mu_l[xx];
    const int2 b = band_of(mu, p);
    const Best best = half(b.x, x < w ? min(b.y, xx) : b.x - 1, mu,
                           [&](int d) { return ielas::sad16(a, right_col(xx - d)); });
    if (x < w && lane == 0) p.out_l[row_px + x] = best.result(a, p.match_texture);
  }
  for (int i = 0; i < passes; ++i) {
    const int u = first + i * slots, uu = u < w ? u : 0;
    const uint4 a = right_col(uu);
    const float mu = mu_r[uu];
    const int2 b = band_of(mu, p);
    const Best best = half(b.x, u < w ? min(b.y, w - 1 - uu) : b.x - 1, mu,
                           [&](int d) { return ielas::sad16(a, left_col(uu + d)); });
    if (u < w && lane == 0) p.out_r[row_px + u] = best.result(a, p.match_texture);
  }
}

"""),
    ("  const int passes = (w + kMaxThreads - 1) / kMaxThreads;\n"
     "  const int threads = ((w + passes - 1) / passes + 31) / 32 * 32;\n",
     "  const int threads = kMaxThreads;\n"),
]
VARIANTS = {
    "dense_match_stream": {
        "as built": [],
        "L2-resident": [("  if (row >= rows) return;\n",
                         "  if (row >= rows) return;\n  const int mid_row = rows / 2;\n"
                         "#define row mid_row\n")],
        "no energy": NO_ENERGY,
        "loads only": [("  if (t >= n) return;\n",
                        "  if (t >= n) return;\n"
                        "  (left ? out_l : out_r)[px] = 0.0f;\n  return;\n")],
    },
    "dense_match_windowed": {
        "as built": [],
        "L2-resident": [("  if (px0 >= npx) return;",
                         "  if (px0 >= npx) return;\n"
                         "  const int mid_px0 = (npx / 2 & ~31) + 32 * warp;\n"
                         "#define px0 mid_px0\n")],
        "no energy": NO_ENERGY,
        "staging only": [("    if (active) {\n      const int first",
                          "    if (false) {\n      const int first"),
                         ("  if (!active) return;\n",
                          "  if (!active) return;\n"
                          "  (left ? out_l : out_r)[px] = (float)buf[lane];\n  return;\n")],
    },
    "support_match": {
        "as built": [],
        "L2-resident": [("  const int row = blockIdx.y, frame = blockIdx.z;\n",
                         "  const int row = gridDim.y / 2, frame = 0;\n")],
        "SAD only": [("__device__ __forceinline__ void insert(Keys& r, int b, float key) {\n",
                      "__device__ __forceinline__ void insert(Keys& r, int b, float key) {\n"
                      "  r.k[0] += key;\n  return;\n")],
        **{f"{k} blocks a row": [("  int k = 3LL * batch * gh >= 2LL * sm_count(device) || "
                                  "w < 8 * 32 ? 1 : kMaxCluster;\n", f"  int k = {k};\n")]
           for k in (1, 2, 4, 8)},
        "loads only": [("  __syncthreads();\n  const uint4 zero",
                        "  __syncthreads();\n"
                        "  if (threadIdx.x == 0) p.out[((long long)frame * p.gh + row) * p.gw] = "
                        "(float)sl[rank].x;\n  return;\n  const uint4 zero")],
    },
    "sobel": {
        "as built": [],
        **{f"{r} row{'s' * (r > 1)} a thread": [("constexpr int kRows = 2;",
                                                    f"constexpr int kRows = {r};")]
           for r in (1, 4)},
        "direct 3 x 3 sums": [(
            "      px[i] = pack(sub(sm[p], sm[p + 2]));\n"
            "      py[i] = pack(add(add(df[p], df[p + 2]), add(df[p + 1], df[p + 1])));\n",
            "      px[i] = pack(sub(add(add(v[0][p], v[2][p]), add(v[1][p], v[1][p])),\n"
            "          add(add(v[0][p + 2], v[2][p + 2]), add(v[1][p + 2], v[1][p + 2]))));\n"
            "      py[i] = pack(sub(add(add(v[0][p], v[0][p + 2]),\n"
            "          add(v[0][p + 1], v[0][p + 1])),\n"
            "          add(add(v[2][p], v[2][p + 2]), add(v[2][p + 1], v[2][p + 1]))));\n")],
        "no arithmetic": [("    sobel_chunk(v, ox, oy);\n",
                           "    ox[0] = (unsigned)(v[0][0] + v[1][9] + v[2][17]);\n")],
        "loads only": [("    sobel_chunk(v, ox, oy);\n",
                        "    ox[0] = (unsigned)(v[0][0] + v[1][9] + v[2][17]);\n"),
                       ("      store_chunk(gx + f, ox, nx, nv, nvn, has_prev, has_next);\n"
                        "      store_chunk(gy + f, oy, ny, nv, nvn, has_prev, has_next);\n",
                        "      gx[f] = (int8_t)(ox[0] + nx[0]);\n")],
    },
    "median": {
        "as built": [],
        "loads and stores only": [(
            "        const float c = v[r + 1][k + 1];\n"
            "        float x[9];\n"
            "#pragma unroll\n"
            "        for (int i = 0; i < 9; ++i) {\n"
            "          const float nb = v[r + i / 3][k + i % 3];\n"
            "          x[i] = nb == kInvalid ? c : nb;\n"
            "        }\n"
            "        o[k] = c == kInvalid ? kInvalid : median9(x);\n",
            "        o[k] = v[r][k] + v[r + 2][k + 2];\n")],
        **{f"{r} row{'s' * (r > 1)} a thread": [("constexpr int kRows = 2;",
                                                    f"constexpr int kRows = {r};")]
           for r in (1, 4)},
        "8 warps a block": [("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")],
    },
    "dense_match_warm": {
        "as built": [],
        "L2-resident": [("  const size_t row_px = (size_t)blockIdx.x * w;",
                         "  const size_t row_px = (size_t)(gridDim.x / 2) * w;")],
        "no division": [("  const float prior = kFast ? -reciprocal(q) : -__fdiv_rn(1.0f, q);\n",
                         "  const float prior = -q;\n")],
        "SAD only": [("  const float diff = __fsub_rn(df, mu);\n",
                      "  return __fmaf_rn(beta, (float)sad, __fsub_rn(df, mu));\n"
                      "  const float diff = __fsub_rn(df, mu);\n")],
        "no candidates": [("  for (int d = lo; d <= hi; ++d) {\n",
                           "  for (int d = lo; d < lo; ++d) {\n")],
        "true division": WARM_DIVISION,
        "uniform trip count": WARM_UNIFORM,
        "512 threads a block": WARM_512,
        "SAD table": WARM_TABLE,
        "SAD table, uniform trip count, true division, 512 threads": (
            WARM_TABLE + WARM_UNIFORM + WARM_DIVISION + WARM_512),
        "half-warp per pixel": WARM_HALF_WARP,
    },
}


def sad_loops(library: Path) -> list[str]:
    """The loops of support_match_kernel's SASS that compute SADs: for each,
    its instructions by opcode and per (column, d) pair (a 16-byte SAD is 4
    VABSDIFF4, so pairs = VABSDIFF4 / 4)."""
    cuobjdump = Path(_nvcc_dir()) / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "support_match_kernel" in line
        elif inside:
            body.append(line)
    instrs = []                              # (address, instruction)
    for line in body:
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(.*?);", line)
        if m:
            instrs.append((int(m.group(1), 16), m.group(2).strip()))
    index = {addr: i for i, (addr, _) in enumerate(instrs)}
    out = []
    for end, (addr, ins) in enumerate(instrs):
        m = re.search(r"BRA(?:\.\w+)?\s+(?:\w+,\s*)?0x([0-9a-f]+)", ins)
        if not m or int(m.group(1), 16) > addr or int(m.group(1), 16) not in index:
            continue                         # not a backward branch
        loop = [i for _, i in instrs[index[int(m.group(1), 16)] : end + 1]]
        ops = Counter(re.sub(r"^@!?U?P\w+\s+", "", i).split()[0].split(".")[0] for i in loop)
        pairs = ops.get("VABSDIFF4", 0) / 4
        if pairs and ops.get("SHFL", 0) == 0:
            top = ", ".join(f"{op} {n / pairs:.2f}" for op, n in ops.most_common(10))
            out.append(f"loop {m.group(1)}-{addr:x} of {len(loop)} instructions, {pairs:g} "
                       f"pairs: {len(loop) / pairs:.2f} a pair ({top})")
    return out or ["no loop with VABSDIFF4 found"]


def _nvcc_dir() -> str:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    return str(Path(_build._nvcc()).parent)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--sass-of", default=None,
                    help="another support_match.cu (e.g. a parent's) to count SASS of")
    ap.add_argument("--median-of", default=None,
                    help="another median.cu (e.g. a parent's) to time beside the median")
    ap.add_argument("--warm-of", default=None,
                    help="another dense_match_warm.cu (e.g. a parent's) to time beside it")
    ap.add_argument("--plain", action="store_true",
                    help="time the kernels' plain versions instead of the variants")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("dense_profile: no CUDA device is available", file=sys.stderr)
        return 1

    sys.path.insert(0, str(ROOT / "src"))
    from flash_profile import traced_device_ms
    from repro_torch.configs.elas_stereo import KITTI, TSUKUBA
    from repro_torch.core import pipeline
    from repro_torch.core.dense import candidate_bitmask_rows, candidate_set
    from repro_torch.core.postprocess import gap_interpolation, lr_consistency
    from repro_torch.data.stereo import synthetic_stereo_pair, synthetic_stereo_sequence
    from repro_torch.kernels import _build, ref
    from repro_torch.core.support import candidate_rows
    from repro_torch.kernels import dense_match as dense_kernel
    from repro_torch.kernels import median as median_kernel
    from repro_torch.kernels import sobel as sobel_kernel
    from repro_torch.kernels import support_match as support_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    dev = torch.device("cuda", 0)
    out_dir = ROOT / "build" / "dense_profile"
    out_dir.mkdir(parents=True, exist_ok=True)

    def start_build(text: str, name: str) -> tuple:
        """Start nvcc on `text` (a variant's source) into build/dense_profile/."""
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                                 "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, so

    jobs = {}
    for src, table in ({} if args.plain else VARIANTS).items():
        for label, subs in table.items():
            text = (_build.CSRC / f"{src}.cu").read_text()
            for old, new in subs:
                # A pair (start, end) replaces the text from start up to end.
                first, last = old if isinstance(old, tuple) else (old, None)
                i = text.find(first)
                j = i + len(first) if last is None else text.find(last, i)
                if i < 0 or j < 0:
                    raise RuntimeError(f"{src}.cu no longer holds {old!r}: update dense_profile.py")
                text = text[:i] + new + text[j:]
            jobs[(src, label)] = start_build(text, f"{src}-{re.sub('[^A-Za-z0-9-]+', '_', label)}")
    if args.sass_of:
        jobs[("sass-of", "")] = start_build(Path(args.sass_of).read_text(), "support_match-sass_of")
    if args.median_of:
        jobs[("median", "given source")] = start_build(Path(args.median_of).read_text(),
                                                      "median-given")
    if args.warm_of:
        jobs[("dense_match_warm", "given source")] = start_build(
            Path(args.warm_of).read_text(), "dense_match_warm-given")
    libs = {}
    for key, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        libs[key] = so
    for key, so in (("as built", libs.get(("support_match", "as built"))),
                    (args.sass_of, libs.get(("sass-of", "")))):
        if so is not None:
            for line in sad_loops(so):
                print(f"support_match SASS ({key}): {line}")
    libs.pop(("sass-of", ""), None)
    libs = {key: ctypes.CDLL(str(so)) for key, so in libs.items()}

    def event_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    def graph_ms(fn) -> float:
        """Time a launch of `fn` inside a CUDA graph of --reps launches
        (CUDA events around its replay): no host launch cost between them."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(args.reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    for cfg, d_max in ((KITTI, 100.0), (TSUKUBA, 48.0)):
        p = cfg.params
        h, w = cfg.height, cfg.width
        il, ir, _ = synthetic_stereo_pair(height=h, width=w, d_max=d_max, seed=0)
        dl, dr, sup = pipeline.ielas_support_stage(torch.as_tensor(il, device=dev),
                                                   torch.as_tensor(ir, device=dev), p)
        sup = pipeline.ielas_interpolate_stage(sup, p)
        mu_l, mu_r, gv_l, gv_r = pipeline._dense_priors(sup, h, w, p)
        gm_l, gm_r = candidate_bitmask_rows(gv_l, p, h), candidate_bitmask_rows(gv_r, p, h)
        cand_l, cand_r = candidate_set(mu_l, gv_l, p), candidate_set(mu_r, gv_r, p)
        skw = dict(num_disp=p.num_disp, disp_min=p.disp_min, plane_radius=p.plane_radius,
                   cell_px=p.grid_size, beta=p.beta, gamma=p.gamma, sigma=p.sigma,
                   match_texture=p.match_texture)
        wkw = dict(num_disp=p.num_disp, disp_min=p.disp_min, beta=p.beta, gamma=p.gamma,
                   sigma=p.sigma, match_texture=p.match_texture)
        sargs = (dl, dr, mu_l, mu_r, gm_l, gm_r)
        wargs = (dl, dr, mu_l, mu_r, cand_l, cand_r)

        # Candidates per (pixel, view), and the busy share of 32-pixel warps.
        cw = gm_l.shape[1]
        cx = (torch.arange(w, device=dev) // p.grid_size).clamp(max=cw - 1)
        d = torch.arange(p.num_disp, device=dev, dtype=torch.float32) + p.disp_min
        u = torch.arange(w, device=dev)[:, None]
        counts = []
        for mu, gm, inside in ((mu_l, gm_l, u >= d), (mu_r, gm_r, u + d < w)):
            r = torch.round(mu)[..., None]
            lo = (r - p.plane_radius).clamp(p.disp_min, p.disp_min + p.num_disp - 1)
            hi = (r + p.plane_radius).clamp(p.disp_min, p.disp_min + p.num_disp - 1)
            counts.append(((gm[:, cx, :] | ((d >= lo) & (d <= hi))) & inside[None]).sum(-1))
        total = sum(int(c.sum()) for c in counts)
        busiest = 0
        for c in counts:
            padded = torch.nn.functional.pad(c, (0, (-w) % 32)).reshape(h, -1, 32)
            busiest += 32 * int(padded.max(-1).values.sum())
        print(f"{cfg.name} {h}x{w} D={p.num_disp}: {total} candidates, "
              f"{total / (2 * h * w):.3f} per pixel and view; lanes busy while warps walk "
              f"them {total / busiest:.3f} {card}")

        out_l = torch.empty((h, w), device=dev)
        out_r = torch.empty_like(out_l)
        step = p.candidate_step
        rows = (candidate_rows(dl, step), candidate_rows(dr, step))
        gh, gw = rows[0].shape[0], w // step
        sup_out = torch.empty((gh, gw), device=dev)
        supkw = dict(num_disp=p.num_disp, step=step, offset=step // 2,
                     support_texture=p.support_texture, support_ratio=p.support_ratio,
                     lr_threshold=p.lr_threshold, disp_min=p.disp_min)
        strides = [*support_kernel._strides(rows[0]), *support_kernel._strides(rows[1])]
        views = torch.stack([torch.as_tensor(il, device=dev), torch.as_tensor(ir, device=dev)])
        gx = torch.empty_like(views, dtype=torch.int8)
        gy = torch.empty_like(gx)
        # The median's input on the path, and the warm kernel's: frame 1 of a
        # pan, seeded by the card's cold output of frame 0.
        med_in = gap_interpolation(lr_consistency(*dense_kernel.dense_match_stream(*sargs, **skw),
                                                  p), p)
        med_out = torch.empty_like(med_in)
        seq = synthetic_stereo_sequence(2, height=h, width=w, d_max=d_max, motion=2, seed=0)
        prev = pipeline.ielas_disparity(seq[0][0], seq[0][1], p)
        wdl, wdr = pipeline.ielas_descriptor_stage_batched(
            torch.as_tensor(seq[1][0], device=dev)[None], torch.as_tensor(seq[1][1], device=dev)[None])
        wmu_l, wmu_r = pipeline._warm_priors(prev, h, w, p)
        warm_args = (wdl[0], wdr[0], wmu_l, wmu_r)
        warm_kw = dict(num_disp=p.num_disp, disp_min=p.disp_min, warm_band=8, beta=p.beta,
                       sigma=p.sigma, match_texture=p.match_texture)
        print(f"{cfg.name}: median input {int((med_in == -1).sum())} invalid pixels of "
              f"{med_in.numel()} {card}")
        left, right, shared = ref.warm_band_counts(wmu_l, wmu_r, num_disp=p.num_disp,
                                                   disp_min=p.disp_min, warm_band=8)
        print(f"{cfg.name} warm band 8: {left} left and {right} right candidates, {shared} "
              f"right ones ({shared / max(right, 1):.4f}) sharing the left view's SAD, "
              f"{left + right - shared} distinct SADs {card}")

        if args.plain:
            plain = {
                "support_match": lambda: ref.support_match_rows_streaming(*rows, **supkw),
                "dense_match_stream": lambda: ref.dense_match_rows_stream_ref(*sargs, **skw),
                "dense_match_windowed": lambda: ref.dense_match_rows_windowed_ref(*wargs, **wkw),
                "sobel": lambda: ref.sobel_rows_ref(*ref.edge_row_views(views.to(torch.int32))),
                "median3x3": lambda: ref.median3x3_rows_ref(*ref.edge_row_views(med_in)),
                "dense_match_warm": lambda: ref.dense_match_rows_warm_ref(*warm_args, **warm_kw),
            }
            for name, fn in plain.items():
                ms = traced_device_ms(torch, fn, PLAIN_REPS, f"the plain {name}")
                print(f"{cfg.name} plain {name}: {ms:.4f} ms device a call (torch.profiler, "
                      f"{PLAIN_REPS} calls) {card}", flush=True)
            continue

        def current() -> int:
            return torch.cuda.current_stream().cuda_stream

        def bind(lib, symbol, argtypes):
            fn = getattr(lib, symbol)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            return fn

        def launch(src, lib):
            """(the launch, the plain version's mismatches after it)."""
            if src == "dense_match_stream":
                fn = bind(lib, "ielas_dense_match_stream", dense_kernel.ARGTYPES)
                return (lambda: fn(*(t.data_ptr() for t in (*sargs, out_l, out_r)), 1, h, w, cw,
                                   p.num_disp, p.disp_min, p.plane_radius, p.grid_size, p.beta,
                                   p.gamma, 2.0 * p.sigma ** 2, p.match_texture, current()),
                        lambda: sum(int((o != x).sum()) for o, x in zip(
                            (out_l, out_r), ref.dense_match_rows_stream_ref(*sargs, **skw))))
            if src == "dense_match_windowed":
                fn = bind(lib, "ielas_dense_match_windowed", dense_kernel.WINDOWED_ARGTYPES)
                return (lambda: fn(*(t.data_ptr() for t in (*wargs, out_l, out_r)), 1, h, w,
                                   cand_l.shape[-1], p.num_disp, p.disp_min, p.beta, p.gamma,
                                   2.0 * p.sigma ** 2, p.match_texture, current()),
                        lambda: sum(int((o != x).sum()) for o, x in zip(
                            (out_l, out_r), ref.dense_match_rows_windowed_ref(*wargs, **wkw))))
            if src == "support_match":
                fn = bind(lib, "ielas_support_match", support_kernel.ARGTYPES)
                return (lambda: fn(rows[0].data_ptr(), rows[1].data_ptr(), sup_out.data_ptr(),
                                   *strides, 1, gh, w, gw, p.num_disp, step, step // 2,
                                   p.support_texture, p.support_ratio, p.lr_threshold,
                                   p.disp_min, current()),
                        lambda: int((sup_out != ref.support_match_rows_streaming(
                            *rows, **supkw)).sum()))
            if src == "median":
                fn = bind(lib, "ielas_median3x3", median_kernel.ARGTYPES)
                return (lambda: fn(med_in.data_ptr(), med_out.data_ptr(), 1, h, w, current()),
                        lambda: int((med_out != ref.median3x3_rows_ref(
                            *ref.edge_row_views(med_in))).sum()))
            if src == "dense_match_warm":
                fn = bind(lib, "ielas_dense_match_warm", dense_kernel.WARM_ARGTYPES)
                return (lambda: fn(*(t.data_ptr() for t in (*warm_args, out_l, out_r)), 1, h, w,
                                   p.num_disp, p.disp_min, 8, p.beta, 1.0 / (2.0 * p.sigma ** 2),
                                   p.match_texture, current()),
                        lambda: sum(int((o != x).sum()) for o, x in zip(
                            (out_l, out_r), ref.dense_match_rows_warm_ref(*warm_args, **warm_kw))))
            fn = bind(lib, "ielas_sobel", sobel_kernel.ARGTYPES)
            return (lambda: fn(views.data_ptr(), gx.data_ptr(), gy.data_ptr(), 2, h, w,
                               sobel_kernel.KINDS[views.dtype], current()),
                    lambda: sum(int((o != x).sum()) for o, x in zip(
                        (gx, gy), ref.sobel_rows_ref(*ref.edge_row_views(views.to(torch.int32))))))

        runs = {}
        for (src, label), lib in libs.items():
            call, check = launch(src, lib)
            if call() != 0:
                raise RuntimeError(f"{src} {label}: launch failed")
            checked = label in ("as built", "given source", "8 warps a block", "true division",
                                "uniform trip count", "512 threads a block",
                                "half-warp per pixel") or label.startswith("SAD table") or \
                label.endswith(("blocks a row", "a thread", "sums"))
            if checked and check():
                raise AssertionError(f"{src} {label} disagrees with its plain version")
            runs[(src, label)] = call
        times = {key: [] for key in runs}
        device = {key: [] for key in runs}
        for rnd in range(args.rounds):
            for key in (list(runs) if rnd % 2 == 0 else list(reversed(list(runs)))):
                times[key].append(event_ms(runs[key]))
                device[key].append(graph_ms(runs[key]))
        for (src, label), ts in times.items():
            print(f"{cfg.name} {src} {label}: {min(device[(src, label)]) * 1e3:.2f} us a launch "
                  f"in a CUDA graph, {min(ts) * 1e3:.2f} us a launch back to back (CUDA events; "
                  f"the host's launch rate bounds it below ~10 us); min of {args.rounds} rounds "
                  f"of {args.reps} {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
