"""Mixture-of-Experts with static capacity (counterpart of
``repro/models/moe.py``): deepseek-v2's 2 shared + 64 / 160 routed experts,
top-6, and jamba's 16 routed experts, top-2.

The same function as the reference, in another layout.  Each token's router
logits are float32 (float32 router weights against the activations cast up),
softmax, the top-k experts with the lower expert index first among equal
probabilities (``jax.lax.top_k``'s order; a stable descending sort, since
``torch.topk`` promises no order among ties), renormalised.  Each expert has
``_capacity`` slots, numbered choice-major (choice 0 of every token first,
then choice 1, ...); a (token, choice) past its expert's capacity is
dropped.  The reference builds (T, E, C) one-hot dispatch and combine
tensors; here the kept (token, choice) rows are written into an (E, C, D)
buffer, the experts run as batched products over E, and each token gathers
its k rows back, weighted by its gates cast to the model's dtype and summed
in float32.  Every slot of every expert runs, as in the reference, so a
decode step reads every expert's weights.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.distributed import sharding
from repro_torch.models import common
from repro_torch.models.config import MoeConfig
from repro_torch.models.mlp import init_mlp_params, mlp_block, mlp_param_specs

ROUTED = ("w_gate", "w_up", "w_down")       # the routed experts' tensors (E, ., .)


def _capacity(tokens: int, moe: MoeConfig) -> int:
    c = int(tokens * moe.top_k * moe.capacity_factor / moe.num_experts)
    return max(4, (c + 3) // 4 * 4)


def moe_shapes(d_model: int, moe: MoeConfig) -> dict[str, tuple[int, ...]]:
    """The router and the routed experts (the shared experts are an
    ``mlp_shapes(d_model, num_shared * d_expert, "silu")`` MLP)."""
    e, dx = moe.num_experts, moe.d_expert
    return {"router": (d_model, e), "w_gate": (e, d_model, dx), "w_up": (e, d_model, dx),
            "w_down": (e, dx, d_model)}


def moe_param_specs(moe: MoeConfig) -> dict:
    """Logical axes per parameter (the reference's; the same shapes)."""
    specs = {
        "router": ("fsdp", None),
        "w_gate": ("experts", "fsdp", None),
        "w_up": ("experts", "fsdp", None),
        "w_down": ("experts", None, "fsdp"),
    }
    if moe.num_shared > 0:
        specs["shared"] = mlp_param_specs("silu")
    return specs


def draw_moe_params(gen: torch.Generator, d_model: int, moe: MoeConfig, device=None):
    """Yields (name, float32 weights) drawn as the reference's, one tensor at
    a time, so that a caller can copy each into its parameter before the
    next is drawn: the router, ``w_gate``, ``w_up``, ``w_down`` (the experts'
    fan-in is their second axis: d_model, or d_expert for ``w_down``), then
    the ``shared`` experts' MLP as a dict."""
    for name, shape in moe_shapes(d_model, moe).items():
        yield name, common.dense_init(gen, shape, in_axis=0 if name == "router" else 1,
                                      device=device)
    if moe.num_shared > 0:
        yield "shared", init_mlp_params(gen, d_model, moe.num_shared * moe.d_expert, "silu",
                                        device)


def route(logits: torch.Tensor, moe: MoeConfig, cap: int):
    """Float32 router logits (T, E) -> (probs (T, E), the one-hot choices
    (T, k, E), gates (T, k) float32 with the dropped choices 0, experts
    (T, k), slots (T, k), kept (T, k))."""
    t, e, k = logits.shape[0], moe.num_experts, moe.top_k
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    sel = (top_e[..., None] == torch.arange(e, device=logits.device)).long()   # (T, k, E)
    sel_flat = sel.transpose(0, 1).reshape(k * t, e)                          # choice-major
    before = (torch.cumsum(sel_flat, dim=0) - sel_flat).reshape(k, t, e).transpose(0, 1)
    slot = before.gather(-1, top_e[..., None])[..., 0]                       # (T, k)
    kept = slot < cap
    return probs, sel, top_p * kept, top_e, slot, kept


def _dispatch(xt, top_e, slot, kept, e: int, cap: int):
    """(E, cap + 1, D): each kept (token, choice) row in its expert's slot,
    a dropped one in the spare slot ``cap``."""
    t, k = top_e.shape
    buf = xt.new_zeros((e, cap + 1, xt.shape[1]))
    buf[top_e, torch.where(kept, slot, cap)] = xt[:, None, :].expand(t, k, xt.shape[1])
    return buf


def _combine(ex_out, top_e, slot, kept, gate):
    """(T, D) in the experts' dtype: each token's k rows weighted by their
    gates (a dropped one reads slot 0, weight 0)."""
    rows = ex_out[top_e, torch.where(kept, slot, 0)].float()                 # (T, k, D)
    return (gate.to(ex_out.dtype).float()[..., None] * rows).sum(1).to(ex_out.dtype)


def moe_block(params, x: torch.Tensor, moe: MoeConfig) -> tuple[torch.Tensor, dict]:
    """``params`` maps ``router`` (float32), ``w_gate``, ``w_up``, ``w_down``
    and ``shared`` to weights.  Returns (out (B, S, D), aux {aux_loss,
    z_loss, fraction_dropped} as float32 scalars)."""
    b, s, d = x.shape
    t, e, k = b * s, moe.num_experts, moe.top_k
    cap = _capacity(t, moe)
    dtype = x.dtype

    # The tokens' gradient is laid out as the tokens are before the reshape
    # back to (B, S, D) (DTensor leaves it split over "experts" too).
    xt = sharding.keep_grad_layout(x.reshape(t, d))
    logits = xt.float() @ params["router"].float()
    # Under a mesh the routing, the dispatch scatter and the combine gather
    # run whole on every rank (their inputs gathered; explicit
    # redistributes): a token's slot counts the choices of every token before
    # it, and DTensor has no strategy for the scatter (GSPMD replicates such
    # work too).  Only the experts' products run split over "experts".
    whole = (None, None)
    probs, sel, gate, top_e, slot, kept = sharding.on_local_shards(
        lambda lg: route(lg, moe, cap), (whole,),
        (whole, (None,) * 3, whole, whole, whole, whole))(logits)

    # dispatch: kept (token, choice) rows into their expert's slots; the
    # dropped ones go to a spare slot past the capacity, which no expert runs.
    # (The reference's hint on its (T, E, C) one-hot dispatch tensor has no
    # counterpart: the rows are written into the buffer directly.)
    buf = sharding.on_local_shards(functools.partial(_dispatch, e=e, cap=cap),
                                   (whole, whole, whole, whole), (None,) * 3)(xt, top_e, slot, kept)
    ex_in = common.with_logical(buf[:, :cap], "experts", None, None)
    h = common.silu(torch.bmm(ex_in, params["w_gate"])) * torch.bmm(ex_in, params["w_up"])
    ex_out = common.with_logical(torch.bmm(h, params["w_down"]),              # (E, C, D)
                                 "experts", None, None)

    # combine: each token's k rows (a dropped one reads slot 0, weight 0)
    out = sharding.on_local_shards(_combine, ((None,) * 3, whole, whole, whole, whole), whole)(
        ex_out, top_e, slot, kept, gate)
    if moe.num_shared > 0:
        out = out + mlp_block(params["shared"], x, "silu").reshape(t, d)

    me = probs.mean(0)                                                       # (E,)
    ce = sel.sum(1).float().mean(0)
    aux = {
        "aux_loss": moe.aux_loss * e * torch.sum(me * ce) / k,
        "z_loss": moe.router_z_loss * torch.mean(torch.square(torch.logsumexp(logits, -1))),
        "fraction_dropped": 1.0 - kept.float().mean(),
    }
    return out.reshape(b, s, d), aux
