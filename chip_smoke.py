#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of iELAS on one CUDA card.

    python3 chip_smoke.py        # from the repository root; needs nvcc and one card

Phases (any failure exits nonzero):
 1. device: card name and count, ``nvidia-smi`` name and power limit, versions;
 2. build: compile every ``src/repro_torch/kernels/csrc/*.cu`` in parallel;
 3. kernels: each CUDA kernel against its plain PyTorch version on the card,
    at the frame path's shapes (elas-kitti, elas-tsukuba, and a disp_min=4
    dense case); outputs must be identical; kernel, plain and bound times;
 4. end to end: ``ielas_disparity`` for elas-kitti and elas-tsukuba, one
    warm-up frame and five timed frames each, with every kernel's launch
    count rising by one per frame; per-stage and end-to-end times, the
    bad-pixel rate against the synthetic ground truth, the output against
    the port's CPU output of the same frame, and one profiled frame (device
    busy share, kernels by device time);
 5. golden frame: the card's output against the port's CPU output and the
    pinned sha256;
 6. a JSON line of per-kernel numbers, then ``{"ok": true, "device": ...}``.

Imports nothing of JAX and nothing of the reference package ``repro``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor
# float32 rate, used here for every 32-bit scalar operation (integer rates
# are no higher, so the bound stays a lower bound on time).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Scalar operations per unit of work.  A 16-lane SAD: 16 differences, 16
# absolute values, 15 adds.  A 4-deep register insert: 4 compares, 8 selects.
# A dense candidate's energy: subtract, square, negate, divide, exp, add, log,
# negate, convert, scale, add, compare-and-keep (12).  A dense mask test: a
# bitmask load, two band compares, a bounds compare (4).
OPS_SAD = 47
OPS_INSERT4 = 12
OPS_ENERGY = 12
OPS_MASK = 4

GOLDEN_SHA256 = "91e3ce9df8a9d01f9b9905bd2aabe4f0791dd06329e1c6f015557054988c018b"
# Card vs CPU output.  The port evaluates the energy's exp/log correctly
# rounded on both, so the expected count is 0; the tolerance (about 0.1% of
# the pixels) covers a last-bit difference between the two float64 libraries
# landing on a float32 rounding edge.
GOLDEN_TOLERANCE = 4      # pixels of 57 x 83
FRAME_TOLERANCE = 1e-3    # share of a full frame's pixels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.elas_stereo import KITTI, SYNTH, TSUKUBA
    from repro_torch.core import pipeline
    from repro_torch.core.dense import candidate_bitmask_rows
    from repro_torch.core.descriptor import extract
    from repro_torch.core.support import candidate_coords
    from repro_torch.data.stereo import synthetic_stereo_pair
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import dense_match as dense_kernel
    from repro_torch.kernels import support_match as support_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. device -------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name} (count {count})")
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    card = f"[{smi}]"

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {len(logs)} of {len(_build.sources())} kernels compiled in "
          f"{time.perf_counter() - t0:.2f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {src}: {line.strip()}")

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def bound(nbytes: int, ops: int) -> tuple[float, str]:
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def frame_inputs(cfg, d_max: float, seed: int = 0):
        il, ir, gt = synthetic_stereo_pair(
            height=cfg.height, width=cfg.width, d_max=d_max, seed=seed
        )
        return il, ir, gt

    # ---- 3. kernels against their plain versions ----------------------------
    results = {}

    def check_support(label, cfg, d_max):
        p = cfg.params
        il, ir, _ = frame_inputs(cfg, d_max)
        dl = extract(torch.as_tensor(il, device=dev))
        dr = extract(torch.as_tensor(ir, device=dev))
        vs, _ = candidate_coords(cfg.height, cfg.width, p.candidate_step, dev)
        rows_l, rows_r = dl[vs].contiguous(), dr[vs].contiguous()
        kw = dict(num_disp=p.num_disp, step=p.candidate_step, offset=p.candidate_step // 2,
                  support_texture=p.support_texture, support_ratio=p.support_ratio,
                  lr_threshold=p.lr_threshold, disp_min=p.disp_min)
        got = support_kernel.support_match(rows_l, rows_r, **kw)
        want = ref.support_match_rows_streaming(rows_l, rows_r, **kw)
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        err = float((got - want).abs().max())
        gh, w, _ = rows_l.shape
        gw = w // p.candidate_step
        us = torch.arange(gw) * p.candidate_step + p.candidate_step // 2
        pairs = gh * (sum(min(p.num_disp, w - u) for u in range(w))
                      + int(torch.clamp(us + 1, max=p.num_disp).sum()))
        nbytes = 2 * rows_l.numel() + 4 * gh * gw
        b_ms, b_by = bound(nbytes, pairs * (OPS_SAD + OPS_INSERT4))
        ms = cuda_ms(lambda: support_kernel.support_match(rows_l, rows_r, **kw), 50)
        plain = cuda_ms(lambda: ref.support_match_rows_streaming(rows_l, rows_r, **kw), 3)
        print(f"kernel support_match {label} rows {tuple(rows_l.shape)} D={p.num_disp}: "
              f"mismatches {mism} of {got.numel()}, max_abs_err {err}, kernel {ms:.4f} ms, "
              f"plain {plain:.3f} ms, bound {b_ms:.5f} ms ({b_by}; {nbytes} B, "
              f"{pairs} (column, d) pairs) {card}")
        if mism:
            raise AssertionError(f"support kernel disagrees with its plain version ({label})")
        results[("support", label)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                           bound_ms=b_ms, bound_by=b_by)

    def dense_inputs(cfg, d_max, p):
        il, ir, _ = frame_inputs(cfg, d_max)
        dl, dr, sup = pipeline.ielas_support_stage(
            torch.as_tensor(il, device=dev), torch.as_tensor(ir, device=dev), p)
        sup = pipeline.ielas_interpolate_stage(sup, p)
        mu_l, mu_r, gv_l, gv_r = pipeline._dense_priors(sup, cfg.height, cfg.width, p)
        gm_l = candidate_bitmask_rows(gv_l, p, cfg.height)
        gm_r = candidate_bitmask_rows(gv_r, p, cfg.height)
        return dl, dr, mu_l, mu_r, gm_l, gm_r

    def dense_candidates(inputs, p) -> int:
        """(pixel, d, view) triples whose candidate mask holds and whose
        matching column is inside the image: the work this data needs."""
        dl, _, mu_l, mu_r, gm_l, gm_r = inputs
        h, w = mu_l.shape
        cw = gm_l.shape[1]
        cx = (torch.arange(w, device=dev) // p.grid_size).clamp(max=cw - 1)
        d = torch.arange(p.num_disp, device=dev, dtype=torch.float32) + p.disp_min
        u = torch.arange(w, device=dev)[:, None]
        total = 0
        for mu, gm, inside in ((mu_l, gm_l, u >= d), (mu_r, gm_r, u + d < w)):
            r = torch.round(mu)[..., None]
            lo = (r - p.plane_radius).clamp(p.disp_min, p.disp_min + p.num_disp - 1)
            hi = (r + p.plane_radius).clamp(p.disp_min, p.disp_min + p.num_disp - 1)
            mask = gm[:, cx, :] | ((d >= lo) & (d <= hi))
            total += int((mask & inside[None]).sum())
        return total

    def check_dense(label, cfg, d_max, p, time_it=True):
        inputs = dense_inputs(cfg, d_max, p)
        kw = dict(num_disp=p.num_disp, disp_min=p.disp_min, plane_radius=p.plane_radius,
                  cell_px=p.grid_size, beta=p.beta, gamma=p.gamma, sigma=p.sigma,
                  match_texture=p.match_texture)
        got = dense_kernel.dense_match_stream(*inputs, **kw)
        want = ref.dense_match_rows_stream_ref(*inputs, **kw)
        torch.cuda.synchronize()
        mism = sum(int((g != x).sum()) for g, x in zip(got, want))
        err = max(float((g - x).abs().max()) for g, x in zip(got, want))
        line = (f"kernel dense_match_stream {label} {tuple(inputs[0].shape[:2])} "
                f"D={p.num_disp} disp_min={p.disp_min}: mismatches {mism} of "
                f"{2 * got[0].numel()}, max_abs_err {err}")
        if time_it:
            h, w = inputs[2].shape
            cands = dense_candidates(inputs, p)
            nbytes = sum(t.numel() * t.element_size() for t in inputs) + 2 * 4 * h * w
            ops = cands * (OPS_SAD + OPS_ENERGY) + 2 * h * w * p.num_disp * OPS_MASK
            b_ms, b_by = bound(nbytes, ops)
            ms = cuda_ms(lambda: dense_kernel.dense_match_stream(*inputs, **kw), 20)
            plain = cuda_ms(lambda: ref.dense_match_rows_stream_ref(*inputs, **kw), 3)
            line += (f", kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {b_ms:.5f} ms "
                     f"({b_by}; {nbytes} B, {cands} candidates of "
                     f"{2 * h * w * p.num_disp})")
            results[("dense", label)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                             bound_ms=b_ms, bound_by=b_by)
        print(f"{line} {card}")
        if mism:
            raise AssertionError(f"dense kernel disagrees with its plain version ({label})")

    check_support("elas-kitti", KITTI, 100.0)
    check_support("elas-tsukuba", TSUKUBA, 48.0)
    check_dense("elas-kitti", KITTI, 100.0, KITTI.params)
    check_dense("elas-tsukuba", TSUKUBA, 48.0, TSUKUBA.params)
    check_dense("elas-kitti", KITTI, 100.0, dataclasses.replace(KITTI.params, disp_min=4),
                time_it=False)

    def profile_frame(cfg, il, ir, p):
        """One more frame under torch.profiler: the device's busy share of
        the frame and the kernels that take its device time."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            pipeline.ielas_disparity(il, ir, p)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = [(getattr(e, "self_device_time_total", 0.0), e.count, e.key)
                for e in prof.key_averages()
                if getattr(e, "self_device_time_total", 0.0) > 0]
        busy_us = sum(r[0] for r in rows)
        if not rows:
            print(f"profile {cfg.name}: no device time in the trace (not measured) {card}")
            return
        top = "; ".join(f"{k[:48]} x{n} {t:.1f} us" for t, n, k in sorted(rows, reverse=True)[:8])
        print(f"profile {cfg.name}: frame {wall_us:.1f} us wall under the profiler, device "
              f"busy {busy_us:.1f} us ({100 * busy_us / wall_us:.1f}%), "
              f"{sum(r[1] for r in rows)} device ops; top: {top} {card}")

    # ---- 4. end to end ---------------------------------------------------
    kernels = (support_kernel, dense_kernel)
    launches = {k: 0 for k in kernels}
    frames = 6
    for cfg, d_max in ((KITTI, 100.0), (TSUKUBA, 48.0)):
        p = cfg.params
        il, ir, gt = frame_inputs(cfg, d_max)
        for k in kernels:
            k.launches = 0
        warm = pipeline.ielas_disparity(il, ir, p)          # the entry point, on cuda:0
        torch.cuda.synchronize()
        stage_ms = {"support": [], "interpolation": [], "dense": []}
        wall = []
        for _ in range(frames - 1):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            t0 = time.perf_counter()
            ev[0].record()
            dl, dr, sup = pipeline.ielas_support_stage(
                torch.as_tensor(il, device=dev), torch.as_tensor(ir, device=dev), p)
            ev[1].record()
            sup = pipeline.ielas_interpolate_stage(sup, p)
            ev[2].record()
            out = pipeline.ielas_dense_stage(dl, dr, sup, p)
            ev[3].record()
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
            for i, key in enumerate(stage_ms):
                stage_ms[key].append(ev[i].elapsed_time(ev[i + 1]))
            if not torch.equal(out, warm):
                raise AssertionError(f"{cfg.name}: frames of one input differ")
        counts = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
        for k in kernels:
            if k.launches != frames:
                raise AssertionError(f"{cfg.name}: {counts} launches for {frames} frames")
            launches[k] += k.launches
        if out.shape != (cfg.height, cfg.width) or out.dtype != torch.float32:
            raise AssertionError(f"{cfg.name}: output {tuple(out.shape)} {out.dtype}")
        # The range and coverage checks of tests/test_system.py.
        valid = out != -1.0
        if not bool(torch.isfinite(out).all()) or float(valid.float().mean()) <= 0.5:
            raise AssertionError(f"{cfg.name}: non-finite output or under half the pixels valid")
        if float(out[valid].min()) < p.disp_min or float(out[valid].max()) > p.disp_max:
            raise AssertionError(f"{cfg.name}: disparities outside [disp_min, disp_max]")
        on_cpu = pipeline.ielas_disparity(il, ir, p, device="cpu")
        cpu_mism = int((out.cpu() != on_cpu).sum())
        if cpu_mism > FRAME_TOLERANCE * out.numel():
            raise AssertionError(f"{cfg.name}: card vs CPU differ in {cpu_mism} pixels")
        gt_t = torch.as_tensor(gt, device=dev)
        bad = float(pipeline.bad_pixel_rate(out, gt_t))
        err = float(pipeline.disparity_error(out, gt_t))
        med = {key: sorted(v)[len(v) // 2] for key, v in stage_ms.items()}
        wall_med = sorted(wall)[len(wall) // 2]
        print(f"e2e {cfg.name} {cfg.height}x{cfg.width} D={p.num_disp}: launches {counts} "
              f"in {frames} frames; median of {frames - 1} frames: support "
              f"{med['support']:.3f} ms, interpolation {med['interpolation']:.3f} ms, "
              f"dense {med['dense']:.3f} ms (CUDA events), frame {wall_med * 1e3:.3f} ms "
              f"wall = {1.0 / wall_med:.2f} fps; bad-pixel rate (tau 3) {bad:.4f}, "
              f"Eq.1 error {err:.4f}; card vs CPU mismatches {cpu_mism} of {out.numel()} "
              f"{card}")
        profile_frame(cfg, il, ir, p)

    # ---- 5. golden frame across devices -------------------------------------
    il, ir, _ = synthetic_stereo_pair(height=57, width=83, d_max=24, seed=11)
    on_card = pipeline.ielas_disparity(il, ir, SYNTH.params).cpu().numpy()
    on_cpu = pipeline.ielas_disparity(il, ir, SYNTH.params, device="cpu").numpy()
    sha_card = hashlib.sha256(on_card.tobytes()).hexdigest()
    sha_cpu = hashlib.sha256(on_cpu.tobytes()).hexdigest()
    mism = int((on_card != on_cpu).sum())
    print(f"golden 57x83: card sha256 {sha_card}, cpu sha256 {sha_cpu}, pinned "
          f"{GOLDEN_SHA256}; card vs cpu mismatches {mism} of {on_cpu.size} "
          f"(tolerance {GOLDEN_TOLERANCE}) {card}")
    if sha_cpu != GOLDEN_SHA256:
        raise AssertionError("the port's CPU output left the pinned golden digest")
    if mism > GOLDEN_TOLERANCE:
        raise AssertionError(f"card output differs from the CPU output in {mism} pixels")

    # ---- 6. summary --------------------------------------------------------
    entries = []
    for kind, module, kname, source, replaces in (
        ("support", support_kernel, "support_match",
         "src/repro_torch/kernels/csrc/support_match.cu",
         "src/repro/kernels/support_match.py:79"),
        ("dense", dense_kernel, "dense_match_stream",
         "src/repro_torch/kernels/csrc/dense_match_stream.cu",
         "src/repro/kernels/dense_match.py:190"),
    ):
        r = results[(kind, "elas-kitti")]
        entries.append({
            "name": kname,
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[module], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
