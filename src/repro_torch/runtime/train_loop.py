"""Training loop: microbatch gradient accumulation, the step function,
checkpoint/restart, failure injection hooks (counterpart of
``repro/runtime/train_loop.py``).

The reference jits a pure step and lets XLA donate its buffers; the port
runs eagerly and updates the parameters and moments in place
(``optim/adamw.py``).  The knobs that change results are kept:
``microbatches`` (the global batch split along its first axis, one forward
and backward each, activations alive for one microbatch) and
``accum_dtype`` (the gradient accumulator's dtype, float32 by default).

Gradients are taken with respect to the parameters' detached aliases
(``requires_grad`` on the alias, not on the module's ``nn.Parameter``), so
a model that serves and trains in one process builds graphs only here.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.models.model import LMModel
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.schedule import ScheduleConfig, learning_rate
from repro_torch.runtime.checkpoint import CheckpointManager

# Checkpoints go under the repository's build directory unless asked otherwise.
DEFAULT_CKPT_DIR = str(Path(__file__).resolve().parents[3] / "build" / "ckpt")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    num_steps: int = 100
    microbatches: int = 1            # grad-accum steps per global batch
    accum_dtype: str = "float32"     # bf16 halves the accumulator
    ckpt_every: int = 50
    ckpt_dir: str = DEFAULT_CKPT_DIR
    log_every: int = 10
    seed: int = 0


def value_and_grad(model: LMModel, params: dict, batch: dict):
    """(loss, metrics, grads): the gradient of ``model.loss`` with respect to
    every tensor of ``params`` (zeros where a parameter does not reach the
    loss, as ``jax.grad`` gives)."""
    leaves = {n: p.detach().requires_grad_(True) for n, p in params.items()}
    with torch.enable_grad():
        loss, metrics = model.loss(leaves, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for (n, p), g in zip(leaves.items(), grads)}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(
    model: LMModel,
    opt_cfg: AdamWConfig,
    sched_cfg: ScheduleConfig,
    microbatches: int = 1,
    accum_dtype: str = "float32",
    presplit: bool = False,
) -> Callable:
    """Returns (params, opt_state, batch) -> (params, opt_state, metrics),
    updating ``params`` and the moments in place.  With ``microbatches`` > 1
    each batch tensor's first axis is split into that many equal parts; the
    gradients are summed in ``accum_dtype`` and divided by ``microbatches``,
    and the loss and metrics are the microbatches' means.

    ``presplit=True``: every batch tensor already carries a leading
    (microbatches, mb, ...) axis and microbatch ``i`` is ``x[i]`` (the
    launcher and the dry run use it): indexing the outer axis keeps a
    DTensor's batch-sharded inner axis where it is, while a slice of a
    sharded axis would make DTensor gather it."""

    @sharding.plain_as_replicated()
    def train_step(params, opt_state, batch):
        def split(x, i):
            if presplit:
                return x[i]
            n = x.shape[0] // microbatches
            return x[i * n:(i + 1) * n]

        if microbatches == 1:
            mb = {k: split(x, 0) for k, x in batch.items()} if presplit else batch
            loss, metrics, grads = value_and_grad(model, params, mb)
        else:
            acc = {n: torch.zeros_like(p, dtype=getattr(torch, accum_dtype))
                   for n, p in params.items()}
            losses, stack = [], []
            for i in range(microbatches):
                mb = {k: split(x, i) for k, x in batch.items()}
                loss_i, metrics_i, g = value_and_grad(model, params, mb)
                for n, gi in g.items():
                    acc[n] += gi.to(acc[n].dtype)
                del g
                losses.append(loss_i)
                stack.append(metrics_i)
            grads = {n: a / microbatches for n, a in acc.items()}
            del acc
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in stack])) for k in stack[0]}

        lr = learning_rate(opt_state["step"], sched_cfg)
        params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg, lr)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["lr"] = lr
        metrics["loss_mean"] = loss
        return params, opt_state, metrics

    return train_step


class Trainer:
    """Host-side orchestration: data, checkpoints, recovery, logging.  The
    train state's parameters are the model's own (``named_parameters``),
    updated in place; a restored state is copied into them."""

    def __init__(
        self,
        model: LMModel,
        pipeline,
        train_cfg: TrainConfig,
        opt_cfg: Optional[AdamWConfig] = None,
        sched_cfg: Optional[ScheduleConfig] = None,
        checkpoint_mgr=None,
        failure_injector: Optional[Callable[[int], None]] = None,
    ):
        self.model = model
        self.pipeline = pipeline
        self.cfg = train_cfg
        self.opt_cfg = opt_cfg or AdamWConfig()
        self.sched_cfg = sched_cfg or ScheduleConfig(total_steps=train_cfg.num_steps)
        self.ckpt = checkpoint_mgr or CheckpointManager(train_cfg.ckpt_dir)
        self.failure_injector = failure_injector
        self.step_fn = make_train_step(
            model, self.opt_cfg, self.sched_cfg,
            train_cfg.microbatches, train_cfg.accum_dtype,
        )
        self.history: list[dict] = []

    def init_state(self, seed: Optional[int] = None) -> dict:
        """The model's weights from ``init(seed)`` (default ``cfg.seed``) and
        fresh moments."""
        self.model.init(self.cfg.seed if seed is None else seed)
        params = dict(self.model.named_parameters())
        return {"params": params, "opt": adamw_init(params, self.opt_cfg)}

    def train(self, state=None, start_step: int = 0) -> dict:
        """Runs to cfg.num_steps with checkpoint/restart recovery."""
        if state is None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                start_step, state = self._restore()
            else:
                state = self.init_state()

        step = start_step
        failures = 0
        while step < self.cfg.num_steps:
            try:
                if self.failure_injector is not None:
                    self.failure_injector(step)
                batch = self.pipeline.batch_at(step)
                t0 = time.monotonic()
                params, opt, metrics = self.step_fn(state["params"], state["opt"], batch)
                state = {"params": params, "opt": opt}
                step += 1
                if step % self.cfg.log_every == 0 or step == self.cfg.num_steps:
                    m = {k: float(sharding.full(v)) for k, v in metrics.items()}
                    m["step"] = step
                    m["step_time_s"] = time.monotonic() - t0
                    self.history.append(m)
                if step % self.cfg.ckpt_every == 0:
                    self.ckpt.save(step, state)
            except _RECOVERABLE:   # simulated node failure and friends
                failures += 1
                if failures > 10:
                    raise
                self.ckpt.wait()
                state = params = opt = None   # drop the moments before loading others
                if self.ckpt.latest_step() is None:
                    state = self.init_state()
                    step = 0
                else:
                    step, state = self._restore()
        self.ckpt.wait()
        if self.ckpt.latest_step() != step:   # the reference writes it again when it was saved
            self.ckpt.save(step, state, blocking=True)
        return {"state": state, "step": step, "failures": failures,
                "history": self.history}

    def _restore(self) -> tuple[int, dict]:
        """The latest checkpoint, its parameters copied into the model's;
        under a mesh the parameters and moments come back laid out by the
        model's specs."""
        params = dict(self.model.named_parameters())
        like = {"params": params, "opt": {"m": params, "v": params, "step": None}}
        shardings = None
        if sharding.on_mesh():
            mesh = sharding.current_mesh()
            named = {n: sharding.named_sharding(mesh, *axes)
                     for n, axes in self.model.param_specs().items()}
            shardings = {"params": named, "opt": {"m": named, "v": named}}
        step, state = self.ckpt.restore(like, device=self.model.device,
                                        sharding_tree=shardings)
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(state["params"][name])
        state["params"] = params
        return step, state


class SimulatedNodeFailure(RuntimeError):
    pass


_RECOVERABLE = (SimulatedNodeFailure,)
