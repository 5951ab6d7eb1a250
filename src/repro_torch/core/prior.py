"""Slanted-plane disparity prior from the regular support grid
(counterpart of ``repro/core/prior.py``).

After iELAS interpolation the support points sit on a regular lattice, so
their Delaunay triangulation is static: each lattice cell splits along its
TL-BR diagonal into two triangles, and the prior mu(p) is the plane through
the pixel's triangle -- closed-form and branch-free.
"""
from __future__ import annotations

import torch

from repro_torch.core.params import ElasParams
from repro_torch.core.support import INVALID
from repro_torch.kernels.ref import fma_f32


def plane_prior(support: torch.Tensor, height: int, width: int, p: ElasParams) -> torch.Tensor:
    """Per-pixel prior mu, (height, width) float32.  Pixels outside the node
    hull extrapolate along the nearest cell's planes."""
    gh, gw = support.shape
    step = p.candidate_step
    off = step // 2
    dev = support.device

    # The reference's XLA:CPU lowering divides by the constant ``step`` as a
    # multiply by its float32 reciprocal and fuses ``c + a * b`` into FMAs;
    # both are reproduced here so the prior is bit-exact.
    def axis(n: int, cells: int):
        t = (torch.arange(n, dtype=torch.float32, device=dev) - off) * (1.0 / step)
        i = torch.floor(t).to(torch.int64).clamp(0, cells - 2)
        return i, t - i.to(torch.float32)               # frac may be <0 / >1 at borders

    iy, fy = axis(height, gh)
    jx, fx = axis(width, gw)
    d_tl = support[iy[:, None], jx[None, :]]
    d_tr = support[iy[:, None], jx[None, :] + 1]
    d_bl = support[iy[:, None] + 1, jx[None, :]]
    d_br = support[iy[:, None] + 1, jx[None, :] + 1]
    fyb = fy[:, None]
    fxb = fx[None, :]
    # Upper-right triangle (TL, TR, BR) and lower-left triangle (TL, BR, BL).
    upper = fma_f32(fyb, d_br - d_tr, fma_f32(fxb, d_tr - d_tl, d_tl))
    lower = fma_f32(fxb, d_br - d_bl, fma_f32(fyb, d_bl - d_tl, d_tl))
    return torch.where(fxb >= fyb, upper, lower)


def right_view_support(support_left: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """Re-express support points in right-image coordinates.

    A left node at column u with disparity d lands on right column u - d.
    Each right-view node takes the disparity of the nearest projected left
    node within one grid pitch (the first on ties), else INVALID.
    """
    gw = support_left.shape[1]
    step = p.candidate_step
    us = torch.arange(gw, dtype=torch.float32, device=support_left.device) * step + step // 2
    proj = us[None, :] - support_left                            # right-image columns
    dist = (proj[:, None, :] - us[None, :, None]).abs()          # (GH, GW_right, GW_left)
    dist = torch.where((support_left != INVALID)[:, None, :], dist, 1e9)
    dmin, k = torch.min(dist, dim=-1)
    dval = torch.gather(support_left, 1, k)
    return torch.where(dmin <= step, dval, INVALID)
