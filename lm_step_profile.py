#!/usr/bin/env python3
"""A decode step's time and device operations for the port's LM models at
full width on one CUDA card, for one source tree.

    python3 lm_step_profile.py [--src DIR] [--archs gemma2-27b,xlstm-350m,musicgen-large]
                               [--steps 16] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this tree's ``src``), so that
two trees are compared by running the script once for each, in turns, in
one call on one card: e.g. the parent unpacked by ``git archive`` into
``build/parent`` and run as ``--src build/parent/src``, then this tree, this
tree again, the parent again.  For each arch: the model at full width with
bfloat16 weights seeded on the card (``LMModel(cfg).init(0)``), the caches
of ``chip_smoke.py``'s LM smoke (batch 4, 33 positions), 2 warm-up steps of
``serving.engine.decode_step`` on seeded token ids, then ``--steps`` steps,
each timed on the host clock up to its synchronisation (the engine waits
for each step's tokens); then one more step under the profiler: its device
operations and the device time they sum to.  Prints a line for each arch
with the card's name and power limit, then one JSON line of the numbers.
Imports nothing of JAX and nothing of ``repro``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BATCH, MAX_LEN, WARMUP = 4, 33, 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"), help="the tree's src directory")
    ap.add_argument("--archs", default="gemma2-27b,xlstm-350m,musicgen-large")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--label", default=None, help="names the tree in the output")
    args = ap.parse_args(argv)
    if WARMUP + args.steps + 1 > MAX_LEN:
        ap.error(f"--steps takes at most {MAX_LEN - WARMUP - 1}: the caches hold {MAX_LEN} "
                 f"positions")

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("lm_step_profile: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.models.model import LMModel
    from repro_torch.serving.engine import decode_step

    card = "[" + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0] + "]"
    label = args.label or args.src
    results = []
    for arch in args.archs.split(","):
        cfg = get_config(arch)
        model = LMModel(cfg).init(0)
        caches = model.init_caches(BATCH, MAX_LEN)
        rng = np.random.default_rng(0)
        tokens = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (BATCH, 1)), device="cuda")
                  for _ in range(WARMUP + args.steps + 1)]
        step_ms = []
        with torch.inference_mode():
            for i, tok in enumerate(tokens[:-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                caches, nxt = decode_step(model, caches, tok)
                nxt.cpu()
                if i >= WARMUP:
                    step_ms.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                caches, nxt = decode_step(model, caches, tokens[-1])
                nxt.cpu()
        rows = [(e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        ops, busy_ms = sum(r[1] for r in rows), sum(r[0] for r in rows) / 1e3
        median = statistics.median(step_ms)
        results.append(dict(arch=arch, median_step_ms=median, min_step_ms=min(step_ms),
                            max_step_ms=max(step_ms), tokens_per_s=BATCH * 1e3 / median,
                            device_operations=ops, device_busy_ms=busy_ms))
        print(f"lm step {label} {arch} (full width, batch {BATCH}, {args.steps} steps after "
              f"{WARMUP}): median {median:.3f} ms (min {min(step_ms):.3f}, max "
              f"{max(step_ms):.3f}), {BATCH * 1e3 / median:.2f} tokens/s; one profiled step "
              f"{ops} device operations, {busy_ms:.3f} ms device {card}", flush=True)
        del model, caches, tokens
        torch.cuda.empty_cache()
    print(json.dumps({"label": label, "card": card, "archs": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
