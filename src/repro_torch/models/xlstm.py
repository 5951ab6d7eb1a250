"""xLSTM blocks: mLSTM (matrix memory, chunkwise parallel) and sLSTM (scalar
memory, recurrent), Beck et al., arXiv:2405.04517 (counterpart of
``repro/models/xlstm.py`` for ``LayerKind.MLSTM`` and ``LayerKind.SLSTM``).

Plain PyTorch, as the reference is plain JAX (no Pallas kernel):

- the mLSTM runs a whole sequence in the stabilised chunkwise form (a
  quadratic attention-like term inside a chunk of ``MLSTM_CHUNK`` positions,
  the state carried across chunks with the running max ``m`` as stabiliser),
  one chunk after another in a loop where the reference scans; decode (one
  token with a state) is the same chunk of one position;
- the sLSTM is recurrent (its gates read the previous h through the
  block-diagonal ``r_gates``): a loop over the positions, then the block's
  GeLU-gated FFN.

log-sigmoid is ``jax.nn.log_sigmoid``'s ``-logaddexp(-x, 0)``; the GeLU is
the tanh form (``jax.nn.gelu``'s default) as XLA rounds it (``common.gelu``),
and the sLSTM cell's float32 tanh is XLA's on the CPU (``kernels/ref.py::tanh_f32``);
the conv's silu rounds as ``jax.nn.silu`` (``common.silu``).  The states are
float32 (the reference's ``init_*_state``), except that the mLSTM's conv
tail comes back in x's dtype after a step, as the reference's ``xp[:, s:]``.
The conv taps and bias, the gate biases and ``r_gates`` are held in float32
(the reference uses them in float32); the projections and ``ogate_skip`` in
the model's dtype.  Each block returns a new state and leaves the one it was
given unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.kernels.ref import tanh_f32
from repro_torch.models import common
from repro_torch.models.config import ModelConfig

MLSTM_CHUNK = 64
MLSTM_HEADS = 4
SLSTM_HEADS = 4
CONV_K = 4
# The blocks' tensors held in float32 whatever the model's dtype.
FLOAT32 = ("conv_w", "conv_b", "if_bias", "r_gates", "gate_bias")


@dataclasses.dataclass
class MLSTMState:
    c: torch.Tensor       # (B, H, dk, dv) float32
    n: torch.Tensor       # (B, H, dk) float32
    m: torch.Tensor       # (B, H) float32
    conv: torch.Tensor    # (B, CONV_K - 1, d_inner): float32 fresh, x's dtype after a step
    index: int            # positions seen


@dataclasses.dataclass
class SLSTMState:
    c: torch.Tensor       # (B, H, dh) float32
    n: torch.Tensor       # (B, H, dh)
    h: torch.Tensor       # (B, H, dh)
    m: torch.Tensor       # (B, H, dh)
    index: int


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)`` with softplus
    ``logaddexp(x, 0)`` (``F.logsigmoid`` rounds otherwise)."""
    return -torch.logaddexp(-x, x.new_zeros(()))


# ==========================================================================
# mLSTM
# ==========================================================================
def mlstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    """(d_inner, head width): projection factor 2, ``MLSTM_HEADS`` heads."""
    d_inner = 2 * cfg.d_model
    return d_inner, d_inner // MLSTM_HEADS


def mlstm_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    d = cfg.d_model
    d_inner, _ = mlstm_dims(cfg)
    return {"w_up": (d, 2 * d_inner), "conv_w": (CONV_K, d_inner), "conv_b": (d_inner,),
            "w_q": (d_inner, d_inner), "w_k": (d_inner, d_inner), "w_v": (d_inner, d_inner),
            "w_if": (d_inner, 2 * MLSTM_HEADS), "if_bias": (2 * MLSTM_HEADS,),
            "ogate_skip": (d_inner,), "w_down": (d_inner, d)}


def mlstm_param_specs(cfg: ModelConfig) -> dict:
    """Logical axes per parameter (the reference's; the same shapes)."""
    return {
        "w_up": ("fsdp", "conv_dim"),
        "conv_w": (None, "conv_dim"),
        "conv_b": ("conv_dim",),
        "w_q": ("conv_dim", "fsdp"),
        "w_k": ("conv_dim", "fsdp"),
        "w_v": ("conv_dim", "fsdp"),
        "w_if": ("conv_dim", None),
        "if_bias": (None,),
        "ogate_skip": ("conv_dim",),
        "w_down": ("conv_dim", "fsdp"),
    }


def init_mlstm_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """float32 weights drawn as the reference's, in its order: fan-in
    truncated normals for the projections, ``0.1 * normal`` conv taps, zero
    conv bias and skip, input-gate bias 0 and forget-gate bias 3."""
    shapes = mlstm_shapes(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    out = {"w_up": common.dense_init(gen, shapes["w_up"], device=device),
           "conv_w": 0.1 * torch.randn(shapes["conv_w"], generator=gen, **f32),
           "conv_b": torch.zeros(shapes["conv_b"], **f32)}
    for name in ("w_q", "w_k", "w_v", "w_if"):
        out[name] = common.dense_init(gen, shapes[name], device=device)
    out["if_bias"] = torch.cat([torch.zeros(MLSTM_HEADS, **f32),
                                torch.full((MLSTM_HEADS,), 3.0, **f32)])
    out["ogate_skip"] = torch.zeros(shapes["ogate_skip"], **f32)
    out["w_down"] = common.dense_init(gen, shapes["w_down"], device=device)
    return out


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state_conv: Optional[torch.Tensor] = None):
    """x (B, S, E); depthwise kernel w (K, E), float32, summed tap by tap;
    the state's tail (or zeros) as the padding.  Returns (y in x's dtype,
    the new tail: the last K - 1 inputs, in x's dtype)."""
    b_, s, e = x.shape
    k = w.shape[0]
    pad = (x.new_zeros((b_, k - 1, e)) if state_conv is None else state_conv.to(x.dtype))
    xp = torch.cat([pad, x], 1)
    y = xp[:, :s].float() * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s].float() * w[i]
    return common.silu(y + b).to(x.dtype), xp[:, s:]


def _mlstm_chunk(q, k, v, logf, logi, c0, n0, m0):
    """One chunk of the stabilised chunkwise-parallel mLSTM, float32.

    q/k/v: (B, H, C, dh); logf/logi: (B, H, C); state (c0 (B, H, dk, dv),
    n0 (B, H, dk), m0 (B, H)).  Returns (h (B, H, C, dh), c1, n1, m1)."""
    ck = q.shape[2]
    a = torch.cumsum(logf, dim=-1)                                  # sum_{l<=i} logf
    # intra-chunk log weights: a_i - a_j + logi_j for j <= i
    w_log = a[..., :, None] - a[..., None, :] + logi[..., None, :]
    mask = torch.ones((ck, ck), dtype=torch.bool, device=q.device).tril()
    w_log = w_log.masked_fill(~mask, float("-inf"))
    m_intra = w_log.amax(-1)                                        # (B, H, C)
    m_inter = m0[..., None] + a
    m_i = torch.maximum(m_intra, m_inter)
    w = torch.exp(w_log - m_i[..., None])                           # (B, H, C, C)
    decay = torch.exp(m_inter - m_i)

    scale = 1.0 / q.shape[-1] ** 0.5
    qk = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    qs = q * scale
    num = (torch.einsum("bhij,bhjd->bhid", w * qk, v)
           + decay[..., None] * torch.einsum("bhid,bhde->bhie", qs, c0))
    den_vec = torch.einsum("bhij,bhjd->bhid", w, k) + decay[..., None] * n0[:, :, None, :]
    den = torch.einsum("bhid,bhid->bhi", qs, den_vec).abs()
    h = num / torch.maximum(den, torch.exp(-m_i))[..., None]

    # the chunk's final state (position ck - 1)
    a_last = a[..., -1]
    m1 = torch.maximum(m0 + a_last, m_intra[..., -1])
    w_last = torch.exp(a_last[..., None] - a + logi - m1[..., None])   # (B, H, C)
    carry = torch.exp(m0 + a_last - m1)
    c1 = carry[..., None, None] * c0 + torch.einsum("bhjd,bhje->bhde", w_last[..., None] * k, v)
    n1 = carry[..., None] * n0 + torch.einsum("bhj,bhjd->bhd", w_last, k)
    return h, c1, n1, m1


def _mlstm_run(q, k, v, logf, logi, c, n, m):
    """The mLSTM over a sequence of (B, H, S, dh) in chunks of
    ``min(MLSTM_CHUNK, S)`` from the state (c, n, m), or from zeros where
    ``c`` is None.  Returns (h (B, H, S, dh), c1, n1, m1)."""
    b, hs, s, dh = q.shape
    if c is None:
        f32 = dict(dtype=torch.float32, device=q.device)
        c = torch.zeros((b, hs, dh, dh), **f32)
        n = torch.zeros((b, hs, dh), **f32)
        m = torch.full((b, hs), -1e30, **f32)
    if s == 1:
        return _mlstm_chunk(q, k, v, logf, logi, c, n, m)
    ck = min(MLSTM_CHUNK, s)
    outs = []
    for lo in range(0, s, ck):
        sl = slice(lo, lo + ck)
        h_c, c, n, m = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl], logf[..., sl],
                                    logi[..., sl], c, n, m)
        outs.append(h_c)
    return torch.cat(outs, 2), c, n, m


def mlstm_block(
    params,
    x: torch.Tensor,              # (B, S, D)
    cfg: ModelConfig,
    state: Optional[MLSTMState] = None,
) -> tuple[torch.Tensor, Optional[MLSTMState]]:
    """Returns (out (B, S, D) in x's dtype, the new state or None).  A whole
    sequence runs in chunks of ``min(MLSTM_CHUNK, S)``, which must divide S
    (the reference's check)."""
    dtype = x.dtype
    b, s, _ = x.shape
    d_inner, dh = mlstm_dims(cfg)
    hs = MLSTM_HEADS

    xm, z = torch.chunk(x @ params["w_up"], 2, dim=-1)
    xm = common.with_logical(xm, "batch", "seq", "conv_dim")
    xc, conv_tail = _causal_conv(xm, params["conv_w"], params["conv_b"],
                                 None if state is None else state.conv)
    q, k, v = xc @ params["w_q"], xc @ params["w_k"], xm @ params["w_v"]
    gates = (xc @ params["w_if"]).float() + params["if_bias"]
    logi, logf = gates[..., :hs], log_sigmoid(gates[..., hs:])

    def heads(t):                                       # (B, S, E) -> (B, H, S, dh) float32
        # The merged dimension takes its heads' layout first: DTensor cannot
        # split a dimension whose shards cut through a head.
        t = common.with_logical(t, "batch", "seq", "heads")
        return t.reshape(b, s, hs, dh).transpose(1, 2).float()

    qh, kh, vh = heads(q), heads(k), heads(v)
    logi_t, logf_t = logi.transpose(1, 2), logf.transpose(1, 2)      # (B, H, S)

    if s % min(MLSTM_CHUNK, s):
        raise ValueError(f"mlstm: a sequence of {s} is not a multiple of the chunk "
                         f"{min(MLSTM_CHUNK, s)}")
    # Local to each batch row and head: on local shards under a mesh
    # (DTensor cannot take the reshapes of the einsums' backward there).
    bh = ("batch", "heads", None)
    run = sharding.on_local_shards(
        _mlstm_run, (bh + (None,),) * 3 + (bh, bh) + (
            (None,) * 3 if state is None else (bh + (None,), bh, ("batch", "heads"))),
        (bh + (None,), bh + (None,), bh, ("batch", "heads")))
    h, c1, n1, m1 = run(qh, kh, vh, logf_t, logi_t, *(
        (None,) * 3 if state is None else (state.c, state.n, state.m)))
    new_state = None if state is None else MLSTMState(c=c1, n=n1, m=m1, conv=conv_tail,
                                                      index=state.index + s)

    # Its gradient comes back in the heads' layout, which the backward of
    # the reshape can split (the channels' split cuts through a head).
    h = sharding.keep_grad_layout(h.transpose(1, 2).reshape(b, s, d_inner)).to(dtype)
    h = h + xc * params["ogate_skip"]                   # learnable skip
    h = h * common.silu(z)
    return common.with_logical(h @ params["w_down"], "batch", "seq", None), new_state


# ==========================================================================
# sLSTM
# ==========================================================================
def slstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    """(heads, head width) of the sLSTM's block-diagonal recurrence."""
    return SLSTM_HEADS, cfg.d_model // SLSTM_HEADS


def slstm_d_ff(cfg: ModelConfig) -> int:
    """The block's FFN width: projection factor 4/3, rounded up to 64."""
    return int(cfg.d_model * 4 / 3 / 64 + 1) * 64


def slstm_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    d = cfg.d_model
    hs, dh = slstm_dims(cfg)
    d_ff = slstm_d_ff(cfg)
    return {"w_gates": (d, 4 * d), "r_gates": (hs, dh, 4 * dh), "gate_bias": (4 * d,),
            "w_ff_gate": (d, d_ff), "w_ff_up": (d, d_ff), "w_ff_down": (d_ff, d)}


def slstm_param_specs(cfg: ModelConfig) -> dict:
    """Logical axes per parameter (the reference's; the same shapes)."""
    return {
        "w_gates": ("fsdp", None),
        "r_gates": (None, None, None),
        "gate_bias": (None,),
        "w_ff_gate": ("fsdp", "ffn"),
        "w_ff_up": ("fsdp", "ffn"),
        "w_ff_down": ("ffn", "fsdp"),
    }


def init_slstm_params(gen: torch.Generator, cfg: ModelConfig, device=None) -> dict:
    """float32 weights drawn as the reference's, in its order: fan-in
    truncated normals for the projections, ``0.1 * normal`` recurrent gates,
    the gate bias 0 (i), 3 (f), 0 (z, o)."""
    shapes = slstm_shapes(cfg)
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    out = {"w_gates": common.dense_init(gen, shapes["w_gates"], device=device),
           "r_gates": 0.1 * torch.randn(shapes["r_gates"], generator=gen, **f32),
           "gate_bias": torch.cat([torch.zeros(d, **f32), torch.full((d,), 3.0, **f32),
                                   torch.zeros(2 * d, **f32)])}
    for name in ("w_ff_gate", "w_ff_up", "w_ff_down"):
        out[name] = common.dense_init(gen, shapes[name], device=device)
    return out


def _slstm_step(r_gates: torch.Tensor, carry, gx: torch.Tensor):
    """carry: (c, n, h, m) each (B, H, dh) float32; gx: (B, 4D) the
    x-gates, gate-major (i, f, z, o).  Returns the new carry."""
    c, n, h, m = carry
    b, hs, dh = c.shape
    rec = torch.einsum("bhd,hde->bhe", h, r_gates)                  # (B, H, 4 dh)
    g = gx.reshape(b, 4, hs, dh).transpose(1, 2).reshape(b, hs, 4 * dh) + rec
    gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
    logf = log_sigmoid(gf)
    m_new = torch.maximum(logf + m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(logf + m - m_new)
    c_new = f * c + i * tanh_f32(gz)
    n_new = f * n + i
    h_new = torch.sigmoid(go) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def _slstm_run(r_gates, gx, c, n, h, m):
    """The sLSTM over gx (B, S, 4D) from the carry (c, n, h, m), or from
    zeros (m at -1e30) where ``c`` is None: (every step's h stacked
    (B, S, H, dh), the last carry)."""
    if c is None:
        b, hs, dh = gx.shape[0], r_gates.shape[0], r_gates.shape[1]
        zeros = torch.zeros((b, hs, dh), dtype=torch.float32, device=gx.device)
        c, n, h, m = zeros, zeros, zeros, torch.full_like(zeros, -1e30)
    carry, hseq = (c, n, h, m), []
    for t in range(gx.shape[1]):
        carry = _slstm_step(r_gates, carry, gx[:, t])
        hseq.append(carry[2])
    return (torch.stack(hseq, 1), *carry)


def slstm_block(
    params,
    x: torch.Tensor,              # (B, S, D)
    cfg: ModelConfig,
    state: Optional[SLSTMState] = None,
) -> tuple[torch.Tensor, Optional[SLSTMState]]:
    """Returns (out (B, S, D) in x's dtype, the new state or None)."""
    dtype = x.dtype
    b, s, d = x.shape
    hs, dh = slstm_dims(cfg)
    gx = (x @ params["w_gates"]).float() + params["gate_bias"]
    # The recurrence is local to each batch row: on local shards under a
    # mesh (a step of a few operations on whole DTensors, S times, is slow to
    # dispatch).
    bhd = ("batch", None, None)
    run = sharding.on_local_shards(
        _slstm_run, ((None, None, None), bhd) + ((None,) * 4 if state is None else (bhd,) * 4),
        (("batch", None, None, None),) + (bhd,) * 4)
    hseq, *carry = run(params["r_gates"], gx, *(
        (None,) * 4 if state is None
        else (state.c.float(), state.n.float(), state.h.float(), state.m.float())))
    h = hseq.reshape(b, s, d).to(dtype)
    new_state = None if state is None else SLSTMState(*carry, index=state.index + s)

    # the block's gated FFN (projection factor 4/3, GeLU)
    gate = h @ params["w_ff_gate"]
    up = h @ params["w_ff_up"]
    y = (common.gelu(gate) * up) @ params["w_ff_down"]
    return common.with_logical(y, "batch", "seq", None), new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, device=None) -> MLSTMState:
    d_inner, dh = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(c=torch.zeros((batch, MLSTM_HEADS, dh, dh), **f32),
                      n=torch.zeros((batch, MLSTM_HEADS, dh), **f32),
                      m=torch.full((batch, MLSTM_HEADS), -1e30, **f32),
                      conv=torch.zeros((batch, CONV_K - 1, d_inner), **f32), index=0)


def init_slstm_state(cfg: ModelConfig, batch: int, device=None) -> SLSTMState:
    hs, dh = slstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    zeros = torch.zeros((batch, hs, dh), **f32)
    return SLSTMState(c=zeros, n=zeros.clone(), h=zeros.clone(),
                      m=torch.full((batch, hs, dh), -1e30, **f32), index=0)
