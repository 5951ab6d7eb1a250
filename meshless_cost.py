#!/usr/bin/env python3
"""The host work that the sharding layer adds to a decode step without a mesh, on the CPU.

    python3 meshless_cost.py --parent DIR

For this tree's ``src`` and another tree's (``DIR``: e.g. a parent commit
unpacked by ``git archive`` into ``build/parent``, given as
``build/parent/src``), each in a process of its own: yi-9b's reduced config
at yi-9b's 48 layers on the CPU, caches for batch 4, one warm-up step of
``serving.engine.decode_step``, then one step counted two ways: its Python
calls (cProfile; the functions whose counts differ between the trees are
listed) and its aten operations (a ``TorchDispatchMode``).  Also the
objects the garbage collector tracks, and the modules loaded, once the
model's modules are imported.  Then, in this tree, the host time of the
hints a step makes without a mesh: ``common.with_logical`` on a plain
tensor as many times as the step calls it, the median of 200
repetitions.  Every number is this machine's CPU's, none a card's.  Imports
nothing of JAX and nothing of ``repro``.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LAYERS, REPS = 48, 200


def count(src: str) -> dict:
    """One decode step's Python calls and aten operations, for the tree at ``src``."""
    import collections
    import cProfile
    import dataclasses
    import gc
    import pstats

    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.configs import get_config
    from repro_torch.models.model import LMModel
    from repro_torch.serving.engine import decode_step

    gc.collect()
    tracked, modules = len(gc.get_objects()), len(sys.modules)
    cfg = dataclasses.replace(get_config("yi-9b", reduced=True), num_layers=LAYERS)
    model = LMModel(cfg, device="cpu").init(0)
    caches = model.init_caches(4, 8)
    tokens = torch.zeros((4, 1), dtype=torch.int64)
    ops = collections.Counter()

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with torch.inference_mode():
        caches, _ = decode_step(model, caches, tokens)
        prof = cProfile.Profile()
        prof.enable()
        caches, _ = decode_step(model, caches, tokens)
        prof.disable()
        with Ops():
            decode_step(model, caches, tokens)
    calls = collections.Counter()
    for (path, _, name), (_, n, *_) in pstats.Stats(prof).stats.items():
        name = re.sub(r" at 0x[0-9a-f]+", "", name)  # a type's address differs by process
        calls[f"{path.split('repro_torch/')[-1].split('site-packages/')[-1]}:{name}"] += n
    return {"calls": calls, "aten_ops": sum(ops.values()), "ops": ops,
            "gc_tracked": tracked, "modules": modules}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, help="the other tree's src directory")
    ap.add_argument("--count", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.count:
        print(json.dumps(count(args.count)))
        return 0

    got = {}
    for label, src in (("parent", args.parent), ("this tree", str(ROOT / "src"))):
        out = subprocess.run([sys.executable, __file__, "--parent", args.parent, "--count", src],
                             capture_output=True, text=True, check=True, timeout=600)
        got[label] = json.loads(out.stdout.strip().splitlines()[-1])
        r = got[label]
        print(f"{label} ({src}): one decode step of yi-9b reduced at {LAYERS} layers on "
              f"the CPU: {sum(r['calls'].values())} Python calls, {r['aten_ops']} aten "
              f"operations; {r['gc_tracked']} objects tracked by the collector and "
              f"{r['modules']} modules after the imports", flush=True)
    parent, this = got["parent"]["calls"], got["this tree"]["calls"]
    for name in sorted(set(parent) | set(this), key=lambda n: this.get(n, 0) - parent.get(n, 0)):
        if parent.get(name, 0) != this.get(name, 0):
            print(f"  calls {parent.get(name, 0):6d} -> {this.get(name, 0):6d}  {name}")
    same = got["parent"]["ops"] == got["this tree"]["ops"]
    print(f"aten operations {'the same, op for op' if same else 'differ'}")

    import statistics
    import time

    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.models.common import with_logical

    hints = this.get("models/common.py:with_logical", 0)
    x = torch.ones(4, 1, 8)
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        for _ in range(hints):
            with_logical(x, "batch", "seq", None)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"this tree's {hints} hints of a step on a plain tensor without a mesh: median "
          f"{statistics.median(times):.4f} ms, min {min(times):.4f} ms ({REPS} "
          f"repetitions, this machine's CPU)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
