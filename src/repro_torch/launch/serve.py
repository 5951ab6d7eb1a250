"""Serving launchers: LM generation and the continuous-batching stereo
service (counterpart of ``repro/launch/serve.py``):

  PYTHONPATH=src python -m repro_torch.launch.serve lm --arch yi-9b --reduced \\
      --requests 4 --prompt-len 16 --max-new 24 [--device cuda]
  PYTHONPATH=src python -m repro_torch.launch.serve lm --arch gemma2-27b [--device cuda]
  PYTHONPATH=src python -m repro_torch.launch.serve lm --arch deepseek-v2-lite-16b [--device cuda]
  PYTHONPATH=src python -m repro_torch.launch.serve lm --arch jamba-1.5-large-398b [--device cuda]
  PYTHONPATH=src python -m repro_torch.launch.serve lm --arch xlstm-350m [--device cuda]
  PYTHONPATH=src python -m repro_torch.launch.serve stereo --frames 8 --batch 4 \\
      --height 120 --width 160 [--device cuda]

Both run on the first CUDA card unless ``--device`` names another (``cpu``
runs the plain PyTorch versions).  As in the reference, ``--reduced`` is
always on for ``lm``, and ``lm`` refuses the archs with a stub frontend
(qwen2-vl-7b, musicgen-large), whose inputs are embeddings, not tokens.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.elas_stereo import SYNTH
from repro_torch.data.stereo import synthetic_stereo_pair
from repro_torch.models.model import LMModel
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.stereo_service import StereoService


def serve_lm(args) -> int:
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.frontend != "none":
        raise SystemExit(f"{args.arch} has a stub frontend; LM serving demo "
                         "uses token archs")
    model = LMModel(cfg, device=args.device).init(0)
    engine = ServeEngine(model, batch=args.batch,
                         max_len=args.prompt_len + args.max_new + 1)
    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(0, cfg.vocab_size, size=rng.integers(4, args.prompt_len + 1))
        for _ in range(args.requests)
    ]
    t0 = time.monotonic()
    outs = engine.generate(prompts, max_new_tokens=args.max_new)
    dt = time.monotonic() - t0
    tokens = sum(len(o) for o in outs)
    print(f"{args.requests} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s, {cfg.name}, device {model.device})")
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: {o[:12]}{'...' if len(o) > 12 else ''}")
    return 0


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

    lm = sub.add_parser("lm")
    lm.add_argument("--arch", choices=ARCH_IDS, default="yi-9b")
    lm.add_argument("--reduced", action="store_true", default=True)
    lm.add_argument("--requests", type=int, default=4)
    lm.add_argument("--batch", type=int, default=2)
    lm.add_argument("--prompt-len", type=int, default=16)
    lm.add_argument("--max-new", type=int, default=16)
    lm.add_argument("--device", default="cuda",
                    help="where the model runs (default: the first CUDA card)")

    st = sub.add_parser("stereo")
    st.add_argument("--frames", type=int, default=8)
    st.add_argument("--batch", type=int, default=1)
    st.add_argument("--height", type=int, default=120)
    st.add_argument("--width", type=int, default=160)
    st.add_argument("--device", default="cuda",
                    help="where the waves run (default: the first CUDA card)")

    args = ap.parse_args(argv)
    return serve_lm(args) if args.mode == "lm" else serve_stereo(args)


if __name__ == "__main__":
    raise SystemExit(main())
