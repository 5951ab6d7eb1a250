"""End-to-end demo on the PyTorch/CUDA port (the paper's kind = real-time
stereo inference): serve several concurrent camera streams through the
continuous-batching StereoService and compare against single-frame calls of
``ielas_disparity`` (the port's counterpart of ``examples/stereo_serving.py``).

  PYTHONPATH=src python examples/torch_stereo_serving.py [--streams 4 --frames 6]
  PYTHONPATH=src python examples/torch_stereo_serving.py --device cpu

It runs on the first CUDA card unless ``--device`` names another device;
without a card it raises.
"""
import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.configs.elas_stereo import SYNTH
from repro_torch.core.pipeline import ielas_disparity
from repro_torch.data.stereo import synthetic_stereo_pair
from repro_torch.device import resolve_device
from repro_torch.serving.stereo_service import StereoService


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Serves the streams; returns what it printed, every single-frame output
    (``serial``, keyed by (stream, frame), on the device), the delivered
    frames (``done``) and the service's stats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--frames", type=int, default=6, help="frames per stream")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--height", type=int, default=60)
    ap.add_argument("--width", type=int, default=80)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; raises without one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    p = SYNTH.params
    n_total = args.streams * args.frames
    print(f"serving {args.streams} streams x {args.frames} frames at "
          f"{args.height}x{args.width}, wave batch={args.batch}...")

    stream_frames = [
        [synthetic_stereo_pair(height=args.height, width=args.width,
                               d_max=40, seed=17 * sid + s)[:2]
         for s in range(args.frames)]
        for sid in range(args.streams)
    ]

    # baseline: single-frame calls, frames served back-to-back
    l0 = np.asarray(stream_frames[0][0][0], np.float32)
    r0 = np.asarray(stream_frames[0][0][1], np.float32)
    ielas_disparity(l0, r0, p, device=dev)                # first call: kernel load
    _sync(dev)
    serial = {}
    t0 = time.monotonic()
    for sid in range(args.streams):
        for fid, (l, r) in enumerate(stream_frames[sid]):
            serial[(sid, fid)] = ielas_disparity(np.asarray(l, np.float32),
                                                 np.asarray(r, np.float32), p, device=dev)
            _sync(dev)
    serial_wall = time.monotonic() - t0

    # continuous batching: dynamic waves + program cache + staged pipeline
    svc = StereoService(p, batch=args.batch, depth=2, wave_linger=0.02,
                        device=dev).start()
    svc.warmup([(args.height, args.width)])               # first use of every kernel

    def producer(sid):
        for fid, (l, r) in enumerate(stream_frames[sid]):
            svc.submit(fid, l, r, stream_id=sid)

    t0 = time.monotonic()
    threads = [threading.Thread(target=producer, args=(sid,))
               for sid in range(args.streams)]
    for t in threads:
        t.start()
    done = svc.collect(n_total, timeout=600)
    wall = time.monotonic() - t0
    for t in threads:
        t.join()
    svc.stop()

    st = svc.stats()
    single_fps, service_fps = n_total / serial_wall, n_total / wall
    print(f"single-frame: {single_fps:6.1f} fps")
    print(f"service:      {service_fps:6.1f} fps "
          f"({serial_wall/wall:.2f}x, batch={args.batch}, "
          f"occupancy={st.wave_occupancy:.2f})")
    print(f"programs: {st.programs_cached} cached, {st.cache_hits} hits, "
          f"{st.cache_misses} misses after warm-up")
    print(f"latency: p50={st.latency_p50_ms:.0f}ms p95={st.latency_p95_ms:.0f}ms  "
          f"backpressure={st.backpressure_seconds*1e3:.1f}ms")
    d = done[0].disparity
    print(f"output: disparity {d.shape} float32, "
          f"range [{d[d>=0].min():.0f}, {d.max():.0f}]")
    return {"serial": serial, "done": done, "stats": st,
            "single_fps": single_fps, "service_fps": service_fps}


if __name__ == "__main__":
    main()
