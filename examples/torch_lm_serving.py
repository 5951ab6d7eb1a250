"""Serve a small LM with batched requests (wave-batching engine) on the
PyTorch/CUDA port (the port's counterpart of ``examples/lm_serving.py``).

  PYTHONPATH=src python examples/torch_lm_serving.py [--device cpu]

It runs on the first CUDA card unless ``--device`` names another device;
without a card it raises.
"""
import argparse
import time

import numpy as np

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LMModel
from repro_torch.serving.engine import ServeEngine

CFG = ModelConfig(
    name="serve-demo", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=1024,
    q_chunk=32, kv_chunk=32,
)


def serve(model: LMModel) -> dict:
    """The demo's requests through ``ServeEngine`` on ``model`` (CFG's
    shapes, weights already in place): what it printed, the prompts and
    the generated tokens."""
    engine = ServeEngine(model, batch=4, max_len=96)

    rng = np.random.default_rng(0)
    prompts = [
        rng.integers(0, CFG.vocab_size, size=int(rng.integers(4, 24)))
        for _ in range(10)
    ]
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=32)   # each step's tokens reach the host
    dt = time.perf_counter() - t0
    total = sum(len(o) for o in outs)
    print(f"{len(prompts)} requests (len 4..24) -> {total} tokens "
          f"in {dt:.1f}s = {total/dt:.1f} tok/s (batch=4 waves)")
    for i, o in enumerate(outs[:3]):
        print(f"  req{i} ({len(prompts[i])}-token prompt): {o[:10]}...")
    return {"prompts": prompts, "outs": outs,
            "tokens": total, "seconds": dt, "tokens_per_s": total / dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; raises without one)")
    args = ap.parse_args(argv)
    model = LMModel(CFG, device=args.device).init(0)
    return serve(model)


if __name__ == "__main__":
    main()
