#!/usr/bin/env python3
"""What bounds the two dense kernels on one card: variants timed in turns.

    python3 dense_profile.py [--rounds N] [--reps N]

For ``elas-kitti`` and ``elas-tsukuba`` (seed 0) it prepares one frame's
dense-stage inputs on the card, builds variants of
``src/repro_torch/kernels/csrc/dense_match_stream.cu`` and
``dense_match_windowed.cu`` (text substitutions into copies under
``build/dense_profile/``; the sources themselves are not changed), and times
each with CUDA events over ``--reps`` back-to-back launches, in ``--rounds``
rounds of alternating order (minimum kept):

* ``as built``: the kernel as committed (checked against its plain version);
* ``L2-resident``: every block (stream) or warp (windowed) reads the inputs of
  one image row in the middle of the frame, so the inputs stay in L2 and the
  time is the instructions' (the output is wrong, and not checked);
* ``no energy``: the energy's exp and log replaced by one multiply-add, so
  the difference to ``as built`` is what the energies cost;
* ``loads only`` (stream: return after the block's loads and barrier) and
  ``staging only`` (windowed: stage the windows, mark nothing).

It also prints the candidate counts per pixel and view (from the bitmasks and
priors) and the share of a warp's lanes busy while it walks them (the mean
count over the warp's busiest lane's).  Each line carries the card's name and
power limit.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

STUB = ('#include "xla_math.cuh"\n', '#include "xla_math.cuh"\n'
        'namespace ielas {\n'
        '__device__ __forceinline__ float stub_energy(int sad, float df, float mu, float beta,\n'
        '    float, float, float) { return __fmaf_rn(beta, (float)sad, df - mu); }\n'
        '}  // namespace ielas\n')
NO_ENERGY = [STUB, ("ielas::energy(", "ielas::stub_energy(")]
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
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("dense_profile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.elas_stereo import KITTI, TSUKUBA
    from repro_torch.core import pipeline
    from repro_torch.core.dense import candidate_bitmask_rows, candidate_set
    from repro_torch.data.stereo import synthetic_stereo_pair
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import dense_match as dense_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    dev = torch.device("cuda", 0)
    out_dir = ROOT / "build" / "dense_profile"
    out_dir.mkdir(parents=True, exist_ok=True)

    def build(source: str, label: str, subs) -> ctypes.CDLL:
        text = (_build.CSRC / f"{source}.cu").read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{source}.cu no longer holds {old!r}: update dense_profile.py")
            text = text.replace(old, new, 1)
        name = f"{source}-{label.replace(' ', '_')}"
        cu, so = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        cu.write_text(text)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                        str(so), str(cu)], check=True, capture_output=True, text=True)
        return ctypes.CDLL(str(so))

    libs = {(src, label): build(src, label, subs)
            for src, table in VARIANTS.items() for label, subs in table.items()}

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

        stream = torch.cuda.current_stream().cuda_stream
        out_l = torch.empty((h, w), device=dev)
        out_r = torch.empty_like(out_l)
        runs = {}
        for (src, label), lib in libs.items():
            if src == "dense_match_stream":
                fn = lib.ielas_dense_match_stream
                fn.argtypes, fn.restype = dense_kernel.ARGTYPES, ctypes.c_int
                call = (lambda fn=fn: fn(*(t.data_ptr() for t in (*sargs, out_l, out_r)), 1, h,
                                         w, cw, p.num_disp, p.disp_min, p.plane_radius,
                                         p.grid_size, p.beta, p.gamma, 2.0 * p.sigma ** 2,
                                         p.match_texture, stream))
                plain = ref.dense_match_rows_stream_ref if label == "as built" else None
                args_, kw = sargs, skw
            else:
                fn = lib.ielas_dense_match_windowed
                fn.argtypes, fn.restype = dense_kernel.WINDOWED_ARGTYPES, ctypes.c_int
                call = (lambda fn=fn: fn(*(t.data_ptr() for t in (*wargs, out_l, out_r)), 1, h,
                                         w, cand_l.shape[-1], p.num_disp, p.disp_min, p.beta,
                                         p.gamma, 2.0 * p.sigma ** 2, p.match_texture, stream))
                plain = ref.dense_match_rows_windowed_ref if label == "as built" else None
                args_, kw = wargs, wkw
            if call() != 0:
                raise RuntimeError(f"{src} {label}: launch failed")
            if plain is not None:
                want = plain(*args_, **kw)
                mism = int((out_l != want[0]).sum()) + int((out_r != want[1]).sum())
                if mism:
                    raise AssertionError(f"{src} as built disagrees with its plain version")
            runs[(src, label)] = call
        times = {key: [] for key in runs}
        for rnd in range(args.rounds):
            for key in (list(runs) if rnd % 2 == 0 else list(reversed(list(runs)))):
                times[key].append(event_ms(runs[key]))
        for (src, label), ts in times.items():
            print(f"{cfg.name} {src} {label}: {min(ts) * 1e3:.2f} us a launch (CUDA events, "
                  f"min of {args.rounds} rounds of {args.reps}) {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
