"""Train a small LM end-to-end on the PyTorch/CUDA port with the full
production stack: microbatch accumulation, checkpointing, restart
determinism (the port's counterpart of ``examples/train_lm.py``).

  PYTHONPATH=src python examples/torch_train_lm.py                # ~5M, fast
  PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20

(The 100m preset is the "train a ~100M model for a few hundred steps"
configuration; the fast preset demonstrates the identical code path.)  It
runs on the first CUDA card unless ``--device`` names another device;
without a card it raises.
"""
import argparse
import os
import tempfile

from repro_torch.data.tokens import pipeline_for
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LMModel, count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime.train_loop import TrainConfig, Trainer

PRESETS = {
    "fast": ModelConfig(
        name="lm-fast", family="dense", num_layers=4, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=2048,
        q_chunk=64, kv_chunk=64,
    ),
    "100m": ModelConfig(
        name="lm-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32768,
        q_chunk=128, kv_chunk=128,
    ),
}


def main(argv=None) -> dict:
    """Trains; returns what it printed and the run's history."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="fast")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=2)
    # a directory of its own, so that a run of examples/train_lm.py never mixes with it
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_example_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; raises without one)")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    model = LMModel(cfg, device=args.device)
    print(f"model: {cfg.name}, {count_params(cfg):,} params")

    trainer = Trainer(
        model,
        pipeline_for(cfg, args.batch, args.seq, seed=0, device=model.device),
        TrainConfig(
            num_steps=args.steps,
            microbatches=args.microbatches,
            ckpt_every=max(50, args.steps // 4),
            ckpt_dir=args.ckpt_dir,
            log_every=max(1, args.steps // 20),
        ),
        opt_cfg=AdamWConfig(),
        sched_cfg=ScheduleConfig(peak_lr=3e-3, warmup_steps=args.steps // 10,
                                 total_steps=args.steps),
    )
    result = trainer.train(state=trainer.init_state())
    hist = result["history"]
    print(f"\n{'step':>6} {'ce':>8} {'lr':>10} {'s/step':>8}")
    for m in hist:
        print(f"{m['step']:>6} {m['ce']:>8.4f} {m['lr']:>10.2e} "
              f"{m['step_time_s']:>8.2f}")
    print(f"\nce: {hist[0]['ce']:.3f} -> {hist[-1]['ce']:.3f} over "
          f"{result['step']} steps (checkpoints in {args.ckpt_dir})")
    return {"params": count_params(cfg), "history": hist, "step": result["step"]}


if __name__ == "__main__":
    main()
