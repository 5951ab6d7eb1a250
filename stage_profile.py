#!/usr/bin/env python3
"""Device time and device operations of the port's dense stage on one card.

    python3 stage_profile.py [--src DIR] [--label NAME] [--frames N]

``--src`` is the directory that holds the ``repro_torch`` package to
measure (default: this checkout's ``src``), so two trees, e.g. a commit and
its parent unpacked by ``git archive``, can be compared in turns within one
run on one card.  For ``elas-kitti`` and ``elas-tsukuba`` (seed 0) it
prepares one frame's dense-stage inputs on the card, then measures:

* ``ielas_dense_stage`` (priors, grid vectors, bitmasks, the stream kernel,
  post-processing): median CUDA-event time of ``--frames`` calls after a
  warm-up, and under ``torch.profiler`` the device time (kernel, copy and
  set rows only) and the number of device operations of one call;
* ``_dense_priors`` (the priors and grid vectors alone), the same way.

Each line carries the card's name and power limit.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--frames", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("stage_profile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.elas_stereo import KITTI, TSUKUBA
    from repro_torch.core import pipeline
    from repro_torch.data.stereo import synthetic_stereo_pair

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    dev = torch.device("cuda", 0)

    def event_ms(fn, n: int) -> float:
        times = []
        for _ in range(n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    def device_profile(fn) -> tuple[float, int]:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        return sum(e.self_device_time_total for e in rows) / 1e3, sum(e.count for e in rows)

    for cfg, d_max in ((KITTI, 100.0), (TSUKUBA, 48.0)):
        p = cfg.params
        il, ir, _ = synthetic_stereo_pair(height=cfg.height, width=cfg.width, d_max=d_max,
                                          seed=0)
        dl, dr, sup = pipeline.ielas_support_stage(
            torch.as_tensor(il, device=dev), torch.as_tensor(ir, device=dev), p)
        sup = pipeline.ielas_interpolate_stage(sup, p)
        h, w = cfg.height, cfg.width
        for stage, fn in (
            ("dense stage", lambda: pipeline.ielas_dense_stage(dl, dr, sup, p)),
            ("priors", lambda: pipeline._dense_priors(sup, h, w, p)),
        ):
            fn()
            torch.cuda.synchronize()
            ms = event_ms(fn, args.frames)
            busy, ops = device_profile(fn)
            print(f"stage_profile {args.label} {cfg.name} {stage}: {ms:.4f} ms (median of "
                  f"{args.frames} calls, CUDA events), device time {busy:.4f} ms in {ops} "
                  f"device operations (one profiled call) {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
