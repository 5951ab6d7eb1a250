"""AdamW with dtype-configurable moment storage (counterpart of
``repro/optim/adamw.py``).

``m_dtype``/``v_dtype`` let big configs store moments in bf16 (the update
math still runs in float32).  Global-norm clipping is fused into the update.
The state mirrors the parameters: plain dicts of named tensors, ``{"m":
{name: tensor}, "v": {name: tensor}, "step": 0-dim int32}``, where the
reference has pytrees.

Unlike the reference, :func:`adamw_update` writes the new parameters and
moments into the tensors it is given (a functional update would hold two
copies of every parameter and moment at once: ~20 GB more for yi-9b's first
8 layers) and returns the same dicts.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: str = "float32"
    v_dtype: str = "float32"


def adamw_init(params: dict[str, torch.Tensor], cfg: AdamWConfig) -> dict:
    m = {n: torch.zeros_like(p, dtype=getattr(torch, cfg.m_dtype)) for n, p in params.items()}
    v = {n: torch.zeros_like(p, dtype=getattr(torch, cfg.v_dtype)) for n, p in params.items()}
    return {"m": m, "v": v, "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares (on the leaves'
    device)."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(
    params: dict[str, torch.Tensor],
    grads: dict[str, torch.Tensor],
    state: dict,
    cfg: AdamWConfig,
    lr: torch.Tensor,
) -> tuple[dict, dict, dict]:
    """Returns (params, state, metrics): ``params`` and the moments updated
    in place (the same dicts), ``state["step"]`` a new tensor, one more."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    # The bias corrections on the host, as the rate is: a counter restored
    # onto the card would otherwise take the card's pow, whose last bit can
    # differ from the host's, and a replay after recovery would drift from
    # the run it replays.
    step_f = step.to("cpu", torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32), step_f)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32), step_f)
    lr = torch.as_tensor(lr, dtype=torch.float32)

    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g * g
        mhat = m32 / bc1
        vhat = v32 / bc2
        p32 = p.float()
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m32)
        v.copy_(v32)
    metrics = {"grad_norm": gnorm, "clip_scale": scale}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
