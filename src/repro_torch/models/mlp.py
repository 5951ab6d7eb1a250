"""Dense MLP variants: SwiGLU (llama-family), GeGLU (gemma2), plain GELU
(counterpart of ``repro/models/mlp.py``; the same matrices, (in, out))."""
from __future__ import annotations

import torch

from repro_torch.models import common


def mlp_shapes(d_model: int, d_ff: int, act: str) -> dict[str, tuple[int, ...]]:
    if act == "gelu_mlp":                      # plain 2-layer MLP (musicgen)
        return {"w_in": (d_model, d_ff), "w_out": (d_ff, d_model)}
    return {                                   # gated: SwiGLU / GeGLU
        "w_gate": (d_model, d_ff),
        "w_up": (d_model, d_ff),
        "w_down": (d_ff, d_model),
    }


def init_mlp_params(gen: torch.Generator, d_model: int, d_ff: int, act: str,
                    device=None) -> dict[str, torch.Tensor]:
    """float32 weights drawn as the reference's (fan-in truncated normal)."""
    return {name: common.dense_init(gen, shape, device=device)
            for name, shape in mlp_shapes(d_model, d_ff, act).items()}


def mlp_param_specs(act: str) -> dict:
    """Logical axes per parameter (the reference's)."""
    if act == "gelu_mlp":
        return {"w_in": ("fsdp", "ffn"), "w_out": ("ffn", "fsdp")}
    return {
        "w_gate": ("fsdp", "ffn"),
        "w_up": ("fsdp", "ffn"),
        "w_down": ("ffn", "fsdp"),
    }


def mlp_block(params, x: torch.Tensor, act: str) -> torch.Tensor:
    """``params`` maps names to matrices in x's dtype."""
    if act == "gelu_mlp":
        h = common.with_logical(common.gelu(x @ params["w_in"]), "batch", "seq", "ffn")
        return h @ params["w_out"]
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    act_fn = common.silu if act == "silu" else common.gelu
    h = common.with_logical(act_fn(gate) * up, "batch", "seq", "ffn")
    return h @ params["w_down"]
