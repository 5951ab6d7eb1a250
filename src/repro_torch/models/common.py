"""Shared model primitives: norms, rotary embeddings, softcap, the
initialisers, and the logical-axis sharding hint (counterpart of
``repro/models/common.py``)."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import logical_constraint
from repro_torch.kernels.ref import fma_f32, tanh_f32, xla_tanh_f32


# --------------------------------------------------------------------------
# logical-axis activation sharding
# --------------------------------------------------------------------------
def with_logical(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """A logical sharding hint, resolved by ``distributed.sharding`` rules:
    under a mesh and rules a DTensor is redistributed to the placements they
    give; otherwise (and on a plain tensor) ``x`` itself, so models run
    unmodified on a single device."""
    return logical_constraint(x, logical_axes)


# --------------------------------------------------------------------------
# norms / activations
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             dtype: torch.dtype | None = None) -> torch.Tensor:
    """RMSNorm in float32, scaled by ``1 + scale``, in ``dtype`` (x's by
    default)."""
    dtype = dtype or x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA evaluates it: ``x * (1 / (1 + exp(-x)))`` with
    each operation rounded to x's dtype.  ``F.silu`` rounds once; in bfloat16
    it differs from the reference's in ~37% of its outputs (by one step)."""
    return x * torch.reciprocal(torch.exp(-x) + 1.0)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh form) as XLA:CPU evaluates it:
    ``x * (0.5 * (1 + tanh(c * (x + k * x^3))))`` with c = sqrt(2 / pi) and k
    = 0.044715 in x's dtype.  In bfloat16 each operation is rounded to the
    dtype; in float32 ``x + k * x^3`` is one FMA and the tanh is XLA's
    (``kernels/ref.py::xla_tanh_f32``).  ``F.gelu`` differs in ~45% of
    bfloat16 outputs.  On the card it is ``F.gelu``'s one kernel, as
    ``kernels/ref.py::tanh_f32`` is ``torch.tanh`` there."""
    if x.device.type != "cpu":
        return F.gelu(x, approximate="tanh")
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype)
    k = torch.tensor(0.044715, dtype=x.dtype)
    x3 = x * x * x
    if x.dtype == torch.float32:
        t = xla_tanh_f32(c * fma_f32(k, x3, x))
    else:
        t = torch.tanh(c * (x + k * x3))
    return x * (0.5 * (1 + t))


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap), as the jitted
    reference computes it in float32: a multiply by the float32 reciprocal
    of cap, and XLA's tanh on the CPU (``kernels/ref.py::tanh_f32``)."""
    if cap <= 0.0:
        return x
    return cap * tanh_f32(x * float(np.float32(1.0 / cap)))


# --------------------------------------------------------------------------
# position embeddings
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) float32 inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(
    x: torch.Tensor,              # (B, S, H, D)
    positions: torch.Tensor,      # (B, S) integer
    theta: float,
) -> torch.Tensor:
    """Rotary embedding on the two halves of the head (not interleaved
    pairs), in float32, in x's dtype."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)          # (D/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) rotated by angles (B, S, D/2), in float32, in x's dtype."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# M-RoPE's (temporal, height, width) sections, in proportions of D/2.
MROPE_SECTIONS = (1, 1, 2)


def apply_mrope(
    x: torch.Tensor,              # (B, S, H, D)
    positions: torch.Tensor,      # (B, S, 3) integer: (temporal, height, width)
    theta: float,
) -> torch.Tensor:
    """qwen2-vl's multimodal RoPE: the D/2 frequencies are split into three
    sections in the proportions ``MROPE_SECTIONS`` (the last takes the
    remainder; 16 / 16 / 32 at D = 128), each rotated by its own position
    stream, as :func:`apply_rope` rotates the two halves."""
    half = x.shape[-1] // 2
    total = sum(MROPE_SECTIONS)
    sizes = [half * s // total for s in MROPE_SECTIONS]
    sizes[-1] = half - sum(sizes[:-1])
    freqs = rope_frequencies(x.shape[-1], theta, x.device)          # (D/2,)
    parts, start = [], 0
    for i, size in enumerate(sizes):
        parts.append(positions[..., i, None].float() * freqs[start:start + size])
        start += size
    return _rotate(x, torch.cat(parts, dim=-1))


def sinusoidal_embedding(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """(B, S) -> (B, S, d_model) float32 transformer sinusoids (musicgen):
    ``[sin, cos]`` of the positions times ``exp(-log(10000) i / half)``."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# initialisers
# --------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape: tuple[int, ...], in_axis: int = 0,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init in float32: std ``1/sqrt(shape[in_axis])``
    (for ``wo`` of shape (H, hd, d) that is H, as in the reference),
    truncated at three standard deviations."""
    std = 1.0 / math.sqrt(shape[in_axis])
    out = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return out.mul_(std)


def embed_init(gen: torch.Generator, shape: tuple[int, ...], device=None) -> torch.Tensor:
    """Unit normal in float32."""
    return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
