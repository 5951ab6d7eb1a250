#!/usr/bin/env python3
"""Frames per second of the port's StereoService against the bare wave, on
one CUDA card.

    python3 service_profile.py [--rounds 3]     # from the repository root

For elas-kitti and elas-tsukuba, 16 different pairs (seeds 0-15) go
through, in turns, each round:

* ``bare``: the wave-shaped stages of ``chip_smoke.py`` phase 5, four waves
  of four one after another in one thread (upload, support, interpolation,
  dense, download);
* ``bare-2threads``: the same 16 frames as two threads of two waves each,
  started together, each on its own CUDA stream -- the service's two
  compute threads without the service;
* ``service``: ``StereoService(batch=4)`` as shipped, the 16 frames
  submitted at once from two streams, after ``warmup()``;
* ``unlocked``: the same with the stage threads' launch lock replaced by a
  no-op, so both threads launch at once;
* ``fresh-streams``: the same, but the stages get new CUDA streams after
  the warm-up, so the caching allocator has no free blocks for them (the
  service before its warm-up ran on the stage streams);
* ``switch``: the service with the interpreter's GIL switch interval at
  0.2 ms (``sys.setswitchinterval``; the default is 5 ms) -- how much of
  its time is threads waiting for the GIL;
* ``one-stream``: the service with both compute stages on one CUDA stream.

Every run starts with ``torch.cuda.empty_cache()`` and a warm-up (the
service's ``warmup()``, one untimed wave for ``bare``).  Each line gives the
median and the spread over the rounds, with the card's name and power
limit.  Imports nothing of JAX and nothing of ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("service_profile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs.elas_stereo import KITTI, TSUKUBA
    from repro_torch.core import pipeline
    from repro_torch.data.stereo import synthetic_stereo_pair
    from repro_torch.serving import StereoService

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {torch.cuda.get_device_name(0)}; {smi}")
    dev = torch.device("cuda", 0)
    batch, streams, per_stream = 4, 2, 8
    n = streams * per_stream

    for cfg, d_max in ((KITTI, 100.0), (TSUKUBA, 48.0)):
        p = cfg.params
        pairs = [synthetic_stereo_pair(height=cfg.height, width=cfg.width, d_max=d_max,
                                       seed=s)[:2] for s in range(n)]
        want = [pipeline.ielas_disparity(il, ir, p).cpu().numpy() for il, ir in pairs]

        def wave(chunk) -> np.ndarray:
            left = torch.from_numpy(np.stack([c[0] for c in chunk])).to(dev)
            right = torch.from_numpy(np.stack([c[1] for c in chunk])).to(dev)
            dl, dr, sup = pipeline.ielas_support_stage_batched(left, right, p)
            full = torch.stack([pipeline.ielas_interpolate_stage(s, p) for s in sup])
            return pipeline.ielas_dense_stage_batched(dl, dr, full, p).cpu().numpy()

        def bare() -> tuple[float, float]:
            torch.cuda.empty_cache()
            wave(pairs[:batch])                 # warm-up, as the service's
            t0 = time.perf_counter()
            for w in range(0, n, batch):
                for i, o in enumerate(wave(pairs[w:w + batch])):
                    if not np.array_equal(o, want[w + i]):
                        raise AssertionError(f"{cfg.name}: bare wave differs from the frame")
            wall = time.perf_counter() - t0
            # All 16 frames are there at t0, so the p95 latency (frame 16 of
            # 16, as stats() counts it) is the last wave's end.
            return n / wall, wall * 1e3

        def bare_threads() -> tuple[float, float]:
            torch.cuda.empty_cache()
            halves = [(w, torch.cuda.Stream(dev)) for w in (0, n // 2)]
            for _, stream in halves:           # warm-up on each thread's stream
                with torch.cuda.stream(stream):
                    wave(pairs[:batch])
            outs, errors = {}, []

            def run(w0, stream):
                try:
                    with torch.cuda.stream(stream):
                        for w in range(w0, w0 + n // 2, batch):
                            outs[w] = wave(pairs[w:w + batch])
                except BaseException as e:     # noqa: BLE001 -- re-raised below
                    errors.append(e)

            threads = [threading.Thread(target=run, args=h) for h in halves]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            wall = time.perf_counter() - t0
            if errors:
                raise errors[0]
            for w, out in outs.items():
                for i, o in enumerate(out):
                    if not np.array_equal(o, want[w + i]):
                        raise AssertionError(f"{cfg.name}: threaded wave differs")
            return n / wall, wall * 1e3

        def service(switch: float | None = None, one_stream: bool = False,
                    fresh_streams: bool = False, unlocked: bool = False):
            torch.cuda.empty_cache()            # no cached blocks from earlier runs
            svc = StereoService(p, batch=batch, device=dev, wave_linger=0.01)
            if unlocked:
                svc._launch_lock = contextlib.nullcontext()
            stage_streams = svc._cache.streams
            if one_stream:
                stage_streams["dense"] = stage_streams["support"]
            svc.warmup([(cfg.height, cfg.width)])
            if fresh_streams:
                for stage in stage_streams:
                    stage_streams[stage] = torch.cuda.Stream(dev)
            before = sys.getswitchinterval()
            if switch is not None:
                sys.setswitchinterval(switch)
            try:
                with svc:
                    t0 = time.perf_counter()
                    for i in range(per_stream):
                        for s in range(streams):
                            svc.submit(i, *pairs[s * per_stream + i], stream_id=s)
                    done = svc.collect(n, timeout=600, strict=True)
                    wall = time.perf_counter() - t0
            finally:
                sys.setswitchinterval(before)
            for c in done:
                if not c.ok or not np.array_equal(
                        c.disparity, want[c.stream_id * per_stream + c.frame_id]):
                    raise AssertionError(f"{cfg.name}: service frame differs")
            return n / wall, svc.stats().latency_p95_ms

        variants = {
            "bare": bare,
            "bare-2threads": bare_threads,
            "service": service,
            "unlocked": lambda: service(unlocked=True),
            "fresh-streams": lambda: service(fresh_streams=True),
            "switch": lambda: service(switch=2e-4),
            "one-stream": lambda: service(one_stream=True),
        }
        for fn in variants.values():      # first use (builds, allocator) off the clock
            fn()
        runs = {name: [] for name in variants}
        for _ in range(args.rounds):
            for name, fn in variants.items():
                runs[name].append(fn())
        for name, rs in runs.items():
            fps = sorted(r[0] for r in rs)
            p95 = sorted(r[1] for r in rs)
            # Rounds in which the shipped service had the higher rate.
            wins = sum(a[0] > b[0] for a, b in zip(runs["service"], rs))
            print(f"{cfg.name} {name}: {fps[len(fps) // 2]:.2f} frames/s (min "
                  f"{fps[0]:.2f}, max {fps[-1]:.2f}), p95 latency {p95[len(p95) // 2]:.3f} ms "
                  f"(min {p95[0]:.3f}, max {p95[-1]:.3f}); the service faster in {wins} of "
                  f"{args.rounds} rounds of {n} frames {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
