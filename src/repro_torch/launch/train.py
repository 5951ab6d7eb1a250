"""Training launcher (counterpart of ``repro/launch/train.py``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --reduced \\
      --steps 50 --batch 8 --seq 128 [--device cpu]

It runs on the first CUDA card unless ``--device`` names another device
(``cpu`` runs the plain PyTorch versions); without a card it raises rather
than train on the host unasked.  Prints the reference's lines: the arch and
its parameter count, one JSON line of metrics per logged step, and the ce
before and after.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.tokens import pipeline_for
from repro_torch.models.model import LMModel, count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.train_loop import DEFAULT_CKPT_DIR, TrainConfig, Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    model = LMModel(cfg, device=args.device)
    devices = torch.cuda.device_count() if model.device.type == "cuda" else 1
    print(f"arch={cfg.name} params={count_params(cfg):,} "
          f"device={model.device} devices={devices}")

    pipeline = pipeline_for(cfg, args.batch, args.seq, seed=args.seed, device=model.device)
    trainer = Trainer(
        model,
        pipeline,
        TrainConfig(
            num_steps=args.steps,
            microbatches=args.microbatches,
            ckpt_every=args.ckpt_every,
            ckpt_dir=args.ckpt_dir,
            log_every=max(1, args.steps // 20),
            seed=args.seed,
        ),
        opt_cfg=AdamWConfig(),
        sched_cfg=ScheduleConfig(
            peak_lr=args.lr, warmup_steps=args.warmup,
            total_steps=args.steps,
        ),
        checkpoint_mgr=CheckpointManager(args.ckpt_dir),
    )
    state = None if args.resume else trainer.init_state()
    result = trainer.train(state=state, start_step=0)
    for m in result["history"]:
        print(json.dumps(m))
    first = result["history"][0]["ce"] if result["history"] else float("nan")
    last = result["history"][-1]["ce"] if result["history"] else float("nan")
    print(f"done: steps={result['step']} ce {first:.4f} -> {last:.4f} "
          f"(failures recovered: {result['failures']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
