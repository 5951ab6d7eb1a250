"""Fault-tolerance demo on the PyTorch/CUDA port: train with injected node
failures, recover from checkpoints, and restore the checkpoint for an
elastic reshard (the port's counterpart of
``examples/fault_tolerance_demo.py``).

  PYTHONPATH=src python examples/torch_fault_tolerance_demo.py [--device cpu]

It runs on the first CUDA card unless ``--device`` names another device;
without a card it raises.

The port's train state holds the model's own parameters, updated in place,
so the failure-free run trains a model of its own: on the first model it
would re-initialise and train the very tensors it is compared with.
"""
import argparse
import tempfile

import numpy as np

from repro_torch.data.tokens import pipeline_for
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LMModel
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime.checkpoint import CheckpointManager, flatten
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.runtime.train_loop import SimulatedNodeFailure, TrainConfig, Trainer

CFG = ModelConfig(
    name="ft-demo", family="dense", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=512, q_chunk=32, kv_chunk=32,
)


def _trainer(model, ckdir, failure_injector=None):
    return Trainer(
        model,
        pipeline_for(CFG, batch=4, seq_len=64, seed=0, device=model.device),
        TrainConfig(num_steps=20, ckpt_every=5, ckpt_dir=ckdir, log_every=5),
        sched_cfg=ScheduleConfig(peak_lr=1e-3, warmup_steps=2, total_steps=20),
        failure_injector=failure_injector,
    )


def main(argv=None) -> dict:
    """The demo; returns what it printed and both runs' final parameters
    (the two models' own tensors)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card; raises without one)")
    args = ap.parse_args(argv)
    model = LMModel(CFG, device=args.device)
    ckdir = tempfile.mkdtemp(prefix="ft_demo_")

    # ---- 1. training with two injected failures --------------------------
    crashes = {"steps": [7, 13], "seen": []}

    def injector(step):
        if step in crashes["steps"] and step not in crashes["seen"]:
            crashes["seen"].append(step)
            print(f"  !! injected node failure at step {step}")
            raise SimulatedNodeFailure(f"node lost at step {step}")

    trainer = _trainer(model, ckdir, injector)
    result = trainer.train(state=trainer.init_state())
    print(f"recovered from {result['failures']} failures, "
          f"finished at step {result['step']}")

    # ---- 2. the run is bitwise identical to a failure-free run -----------
    clean = _trainer(LMModel(CFG, device=model.device), tempfile.mkdtemp(prefix="ft_clean_"))
    clean_result = clean.train(state=clean.init_state())
    params, clean_params = result["state"]["params"], clean_result["state"]["params"]
    diffs = [
        float(np.abs(params[name].detach().float().cpu().numpy()
                     - clean_params[name].detach().float().cpu().numpy()).max())
        for name in params
    ]
    print(f"max param diff vs failure-free run: {max(diffs):.2e} "
          f"(data is a pure function of step -> bitwise replay)")

    # ---- 3. straggler detection ------------------------------------------
    t = [0.0]
    mon = HeartbeatMonitor(["host0", "host1", "host2"], timeout=10.0,
                           straggler_factor=2.0, clock=lambda: t[0])
    for step in range(1, 13):
        t[0] = float(step)
        mon.beat("host0", step)
        if step <= 3:
            mon.beat("host1", step)
        if step % 4 == 0:
            mon.beat("host2", step // 4)
    t[0] = 14.0
    print(f"dead hosts: {mon.dead_hosts()}  stragglers: {mon.stragglers()}")

    # ---- 4. elastic reshard of the checkpoint -----------------------------
    # The restore's structure, as Trainer._restore builds it: the model's
    # parameters and the AdamW moments named as they are; nothing is
    # initialised again.
    named = dict(model.named_parameters())
    like = {"params": named, "opt": {"m": named, "v": named, "step": None}}
    mgr = CheckpointManager(ckdir)
    step, restored = mgr.restore(like)
    leaves = len(flatten(restored))
    print(f"restored checkpoint at step {step}; leaves: {leaves} "
          f"(reshardable onto any mesh via runtime.fault_tolerance."
          f"elastic_reshard)")
    return {"failures": result["failures"], "step": result["step"],
            "max_param_diff": max(diffs), "params": params, "clean_params": clean_params,
            "dead_hosts": mon.dead_hosts(), "stragglers": mon.stragglers(),
            "restored_step": step, "restored_leaves": leaves}


if __name__ == "__main__":
    main()
