"""Quickstart on the PyTorch/CUDA port: iELAS stereo matching on a synthetic
scene (the port's counterpart of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py                # the first CUDA card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu   # plain PyTorch versions

Generates a stereo pair with known disparity, runs (a) the paper's fully
on-device interpolated pipeline and (b) the hybrid host-Delaunay baseline
it replaces, and prints accuracy + speed for both -- the paper's Tables
I/III/IV in one script.  Without a card and without ``--device`` it raises.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.elas_stereo import SYNTH
from repro_torch.core import pipeline
from repro_torch.data.stereo import synthetic_stereo_pair
from repro_torch.device import resolve_device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device=None, height: int = 240, width: int = 320) -> dict:
    """The quickstart on ``device`` (default: the first CUDA card) at the
    scene's ``height`` x ``width``: what it printed, and both disparity maps
    (numpy, on the host)."""
    dev = resolve_device(device)
    p = SYNTH.params
    print(f"generating synthetic stereo scene ({height}x{width}, d_max=40)...")
    il, ir, gt = synthetic_stereo_pair(height=height, width=width, d_max=40,
                                       n_objects=5, seed=7)
    il_f = np.asarray(il, np.float32)
    ir_f = np.asarray(ir, np.float32)
    gt_t = torch.as_tensor(gt, device=dev)

    print("first call + running iELAS (kernel build or load, CUDA context set-up)...")
    t0 = time.perf_counter()
    d_i = pipeline.ielas_disparity(il_f, ir_f, p, device=dev)
    _sync(dev)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_i = pipeline.ielas_disparity(il_f, ir_f, p, device=dev)
    _sync(dev)
    ielas_s = time.perf_counter() - t0

    print("running hybrid baseline (host Delaunay round-trip)...")
    pipeline.elas_baseline_disparity(il_f, ir_f, p, device=dev)   # its first call
    _sync(dev)
    t0 = time.perf_counter()
    d_b = pipeline.elas_baseline_disparity(il_f, ir_f, p, device=dev)
    d_b_host = d_b.cpu().numpy()
    hybrid_s = time.perf_counter() - t0

    bad_i = float(pipeline.bad_pixel_rate(d_i, gt_t))
    bad_b = float(pipeline.bad_pixel_rate(d_b, gt_t))
    err_i = float(pipeline.disparity_error(d_i, gt_t))
    err_b = float(pipeline.disparity_error(d_b, gt_t))
    d_i_host = d_i.cpu().numpy()
    valid = float(np.mean(d_i_host != p.invalid))

    print(f"\n{'':24}{'iELAS (ours)':>16}{'hybrid baseline':>18}")
    print(f"{'bad-pixel rate (>3px)':24}{bad_i:>16.3f}{bad_b:>18.3f}")
    print(f"{'rel. error (Eq. 1)':24}{err_i:>16.3f}{err_b:>18.3f}")
    print(f"{'time / frame':24}{ielas_s*1e3:>14.0f}ms{hybrid_s*1e3:>16.0f}ms")
    print(f"{'speedup':24}{hybrid_s/ielas_s:>15.1f}x")
    print(f"\nvalid pixels: {valid:.1%}; first call (kernel build or load, CUDA context "
          f"set-up): {first_s:.1f}s")
    print("the speedup is the paper's core claim: regularising triangulation"
          "\nremoves the host round-trip, so the whole frame stays on the device.")
    return {"ielas": d_i_host, "baseline": d_b_host,
            "bad_ielas": bad_i, "bad_baseline": bad_b, "err_ielas": err_i,
            "err_baseline": err_b, "valid": valid, "ielas_s": ielas_s,
            "hybrid_s": hybrid_s, "first_call_s": first_s}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; raises without one)")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
