"""Serving launcher for the stereo service (counterpart of the ``stereo``
subcommand of ``repro/launch/serve.py``; the ``lm`` subcommand waits for
the LM stack):

  PYTHONPATH=src python -m repro_torch.launch.serve stereo --frames 8 --batch 4 \\
      --height 120 --width 160 [--device cuda]
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs.elas_stereo import SYNTH
from repro_torch.data.stereo import synthetic_stereo_pair
from repro_torch.serving.stereo_service import StereoService


def serve_stereo(args) -> int:
    p = SYNTH.params
    svc = StereoService(p, batch=args.batch, depth=2, device=args.device,
                        max_pending=max(64, args.frames)).start()
    svc.warmup([(args.height, args.width)])
    frames = [
        synthetic_stereo_pair(height=args.height, width=args.width,
                              d_max=40, seed=s)[:2]
        for s in range(args.frames)
    ]
    # submit everything up front so waves fill to `batch` (a serial
    # submit-then-wait loop would dispatch padded single-frame waves)
    t0 = time.monotonic()
    for i, (l, r) in enumerate(frames):
        svc.submit(i, l, r)
    results = svc.results(args.frames, timeout=600.0)
    wall = time.monotonic() - t0
    st = svc.stats()
    svc.stop()
    fps = len(results) / wall
    print(f"{args.frames} frames in {wall:.2f}s -> {fps:.1f} fps "
          f"({args.height}x{args.width}, batch={args.batch}, device {st.backend})")
    print(f"waves={st.waves} occupancy={st.wave_occupancy:.2f} "
          f"cache={st.cache_hits}h/{st.cache_misses}m "
          f"p95={st.latency_p95_ms:.0f}ms")
    failed = sum(d is None for _, d in results)
    if len(results) != args.frames or failed:
        print(f"{len(results)} of {args.frames} frames delivered, {failed} failed")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)

    st = sub.add_parser("stereo")
    st.add_argument("--frames", type=int, default=8)
    st.add_argument("--batch", type=int, default=1)
    st.add_argument("--height", type=int, default=120)
    st.add_argument("--width", type=int, default=160)
    st.add_argument("--device", default="cuda",
                    help="where the waves run (default: the first CUDA card)")

    args = ap.parse_args(argv)
    return serve_stereo(args)


if __name__ == "__main__":
    raise SystemExit(main())
