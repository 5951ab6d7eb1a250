"""Learning-rate schedules: linear warmup + cosine/linear/constant decay
(counterpart of ``repro/optim/schedule.py``), in float32."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ScheduleConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    kind: str = "cosine"          # cosine | linear | constant


def learning_rate(step, cfg: ScheduleConfig) -> torch.Tensor:
    """The rate at ``step`` (an int or a 0-dim tensor) as a float32 0-dim
    tensor on the host."""
    step = torch.as_tensor(step).detach().to("cpu", torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    if cfg.kind == "constant":
        decayed = torch.tensor(cfg.peak_lr, dtype=torch.float32)
    else:
        frac = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        if cfg.kind == "cosine":
            mult = 0.5 * (1 + torch.cos(math.pi * frac))
        else:
            mult = 1.0 - frac
        floor = cfg.min_lr_ratio
        decayed = cfg.peak_lr * (floor + (1 - floor) * mult)
    return torch.where(step < cfg.warmup_steps, warm, decayed)
