"""Mamba-1 selective state-space mixer, jamba's sequence mixer (counterpart of
``repro/models/mamba.py`` for ``LayerKind.MAMBA``).

Plain PyTorch, as the reference is plain JAX (no Pallas kernel):

- a whole sequence (the forward without a state, and prefill into a fresh
  state): the causal depthwise convolution summed in float32 tap by tap, as
  the reference, then the discretised ``a_bar = exp(dt A)`` and ``bx = dt x
  B`` in float32 and a chunked selective scan.  Within a chunk of
  ``MAMBA_CHUNK`` positions the combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1
  + b2)`` runs in ``jax.lax.associative_scan``'s odd/even recursion (log2 of
  the chunk levels of strided slices), so the float32 products group as the
  reference's do; across chunks a loop carries the state;
- decode (one token with a state): the recurrent step, ``h = a_bar h + bx``.

softplus is ``jax.nn.softplus``'s ``logaddexp(x, 0)`` (``F.softplus`` has a
threshold and rounds otherwise).  The state (the last ``d_conv - 1`` conv
inputs and the SSM state) is float32 whatever the model's dtype, as the
reference's ``init_mamba_state`` default makes it; so are ``conv_w``,
``conv_b``, ``dt_bias``, ``a_log`` and ``d_skip`` (the reference uses them in
float32; A from a bfloat16 ``a_log`` would be another matrix).  The four
projections are held in the model's dtype.

Prefill into a state at a non-zero index raises ``NotImplementedError``: the
reference's convolution ignores the state's conv inputs there, and after a
prefill of fewer than ``d_conv - 1`` tokens it keeps a conv state too short
for the next decode step (ROADMAP.md, "Reference faults the port does not
reproduce").  At index 0 the new conv state is the last ``d_conv - 1`` rows
of the zero-padded inputs: the reference's for three tokens or more.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.models import common
from repro_torch.models.config import ModelConfig

MAMBA_CHUNK = 256
# The mixer's tensors held in float32 whatever the model's dtype.
FLOAT32 = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip")


@dataclasses.dataclass
class MambaState:
    conv: torch.Tensor    # (B, d_conv-1, d_in) float32: the last inputs of the conv
    ssm: torch.Tensor     # (B, d_in, N) float32
    index: int            # positions seen


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, (cfg.d_model + 15) // 16)


def mamba_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    mc = cfg.mamba
    d = cfg.d_model
    d_in = mc.expand * d
    return {"w_in": (d, 2 * d_in), "conv_w": (mc.d_conv, d_in), "conv_b": (d_in,),
            "w_x": (d_in, dt_rank(cfg) + 2 * mc.d_state), "w_dt": (dt_rank(cfg), d_in),
            "dt_bias": (d_in,), "a_log": (d_in, mc.d_state), "d_skip": (d_in,),
            "w_out": (d_in, d)}


def mamba_param_specs(cfg: ModelConfig) -> dict:
    """Logical axes per parameter (the reference's; the same shapes)."""
    return {
        "w_in": ("fsdp", "conv_dim"),
        "conv_w": (None, "conv_dim"),
        "conv_b": ("conv_dim",),
        "w_x": ("conv_dim", None),   # (d_in, dt_rank+2N): odd width, replicate
        "w_dt": (None, "conv_dim"),
        "dt_bias": ("conv_dim",),
        "a_log": ("conv_dim", "state"),
        "d_skip": ("conv_dim",),
        "w_out": ("conv_dim", "fsdp"),
    }


def init_mamba_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """float32 weights drawn as the reference's: fan-in truncated normals for
    the projections, ``0.1 * normal`` conv taps, zero conv bias, the dt bias
    ``log(expm1(0.01))``, A's S4D-real ``log(1 .. N)`` on every channel and a
    unit skip."""
    shapes = mamba_shapes(cfg)
    d_in, n = shapes["a_log"]
    f32 = dict(dtype=torch.float32, device=device)
    a_init = torch.arange(1, n + 1, **f32).expand(d_in, n)
    return {
        "w_in": common.dense_init(gen, shapes["w_in"], device=device),
        "conv_w": 0.1 * torch.randn(shapes["conv_w"], generator=gen, **f32),
        "conv_b": torch.zeros(d_in, **f32),
        "w_x": common.dense_init(gen, shapes["w_x"], device=device),
        "w_dt": common.dense_init(gen, shapes["w_dt"], device=device),
        "dt_bias": torch.log(torch.expm1(torch.full((d_in,), 0.01, **f32))),
        "a_log": torch.log(a_init),
        "d_skip": torch.ones(d_in, **f32),
        "w_out": common.dense_init(gen, shapes["w_out"], device=device),
    }


def _ssm_inputs(params, xc: torch.Tensor, cfg: ModelConfig):
    """xc (B, S, d_in) after the conv, in the model's dtype -> the
    discretised (a_bar, bx) (B, S, d_in, N) and c (B, S, N), float32."""
    n = cfg.mamba.d_state
    # The product sums over the split channels: reduced here, as GSPMD
    # reduces it, before the bias is added (torch 2.11's DTensor cannot add a
    # pending sum to a split bias).
    proj = common.with_logical(xc @ params["w_x"], "batch", "seq", None)
    dt_r, b_mat, c_mat = torch.split(proj, [dt_rank(cfg), n, n], dim=-1)
    dt = (dt_r @ params["w_dt"]).float() + params["dt_bias"]
    dt = torch.logaddexp(dt, dt.new_zeros(()))                 # jax.nn.softplus
    a = -torch.exp(params["a_log"])                            # (d_in, N)
    a_bar = torch.exp(dt[..., None] * a)
    bx = (dt * xc.float())[..., None] * b_mat.float()[:, :, None, :]
    return a_bar, bx, c_mat.float()


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1], *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """The inclusive scan of ``_combine`` along axis 1, in
    ``jax.lax.associative_scan``'s order: combine adjacent pairs, scan those
    (the odd positions), then combine each with the next even element."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _associative_scan(*_combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2],
                                               b[:, 1::2]))
    m = odd_a.shape[1] - (1 if n % 2 == 0 else 0)
    even_a, even_b = _combine(odd_a[:, :m], odd_b[:, :m], a[:, 2::2], b[:, 2::2])
    even_a, even_b = torch.cat([a[:, :1], even_a], 1), torch.cat([b[:, :1], even_b], 1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def _chunk_scan(a_bar: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor):
    """a_bar, bx (B, C, d_in, N), h0 (B, d_in, N) -> (every state, the last)."""
    bx = torch.cat([bx[:, :1] + a_bar[:, :1] * h0[:, None], bx[:, 1:]], 1)    # fold h0 in
    h_all = _associative_scan(a_bar, bx)[1]
    return h_all, h_all[:, -1]


def _selective_scan(a_bar, bx, c_mat, h0, chunk: int):
    """The chunked scan over the whole sequence from the state ``h0`` (or
    zeros where it is None): (y (B, S, d_in), h_last)."""
    s = a_bar.shape[1]
    if h0 is None:
        h0 = a_bar.new_zeros((a_bar.shape[0], *a_bar.shape[2:]))
    ck = min(chunk, s)
    if s % ck:
        raise ValueError(f"mamba: a sequence of {s} is not a multiple of the chunk {ck}")
    h, ys = h0, []
    for lo in range(0, s, ck):
        h_all, h = _chunk_scan(a_bar[:, lo:lo + ck], bx[:, lo:lo + ck], h)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, c_mat[:, lo:lo + ck]))
    return torch.cat(ys, 1), h


def mamba_block(
    params,
    x: torch.Tensor,              # (B, S, D)
    cfg: ModelConfig,
    state: Optional[MambaState] = None,
) -> tuple[torch.Tensor, Optional[MambaState]]:
    """Returns (out (B, S, D) in x's dtype, the new state or None).  The
    state given is not changed."""
    mc = cfg.mamba
    dtype = x.dtype
    b, s, d = x.shape
    d_in = mc.expand * d
    xc, z = torch.chunk(x @ params["w_in"], 2, dim=-1)
    xc = common.with_logical(xc, "batch", "seq", "conv_dim")

    if state is not None and s == 1:
        # decode: the conv over the state's inputs and this one, in float32
        conv_win = torch.cat([state.conv, xc.to(state.conv.dtype)], 1)    # (B, d_conv, d_in)
        xconv = (conv_win * params["conv_w"]).sum(1) + params["conv_b"]
        xconv = common.silu(xconv)[:, None, :].to(dtype)
        a_bar, bx, c_mat = _ssm_inputs(params, xconv, cfg)
        h = a_bar[:, 0] * state.ssm + bx[:, 0]
        y = torch.einsum("bdn,bn->bd", h, c_mat[:, 0])[:, None, :]
        new_state = MambaState(conv=conv_win[:, 1:], ssm=h, index=state.index + 1)
    else:
        if state is not None and state.index != 0:
            raise NotImplementedError(
                f"prefill of {s} tokens into a Mamba state at index {state.index}: the "
                f"reference's conv ignores the state's inputs there (ROADMAP.md)")
        xp = torch.cat([xc.new_zeros((b, mc.d_conv - 1, d_in)), xc], 1)
        xconv = xp[:, :s].float() * params["conv_w"][0]
        for i in range(1, mc.d_conv):
            xconv = xconv + xp[:, i:i + s].float() * params["conv_w"][i]
        xconv = common.silu(xconv + params["conv_b"]).to(dtype)
        a_bar, bx, c_mat = _ssm_inputs(params, xconv, cfg)
        # Local to each batch row and channel: on local shards under a mesh
        # (DTensor has no strategy for the scan's strided writes' backward).
        bd = ("batch", None, "conv_dim")
        scan = sharding.on_local_shards(
            functools.partial(_selective_scan, chunk=MAMBA_CHUNK),
            (bd + (None,), bd + (None,), ("batch", None, None),
             None if state is None else ("batch", "conv_dim", None)),
            (bd, ("batch", "conv_dim", None)))
        y, h_last = scan(a_bar, bx, c_mat, None if state is None else state.ssm.float())
        new_state = None if state is None else MambaState(
            conv=xp[:, s:].to(state.conv.dtype), ssm=h_last, index=s)

    y = y + xconv.float() * params["d_skip"]
    y = y.to(dtype) * common.silu(z)
    return common.with_logical(y @ params["w_out"], "batch", "seq", None), new_state


def init_mamba_state(cfg: ModelConfig, batch: int, device=None) -> MambaState:
    """A fresh float32 state, whatever the model's dtype (the reference's
    ``init_caches`` makes it with ``init_mamba_state``'s float32 default)."""
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return MambaState(conv=torch.zeros((batch, mc.d_conv - 1, d_in), **f32),
                      ssm=torch.zeros((batch, d_in, mc.d_state), **f32), index=0)
