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
    """Per-pixel prior mu, ([...,] height, width) float32, for one support
    grid (GH, GW) or a stack of them (..., GH, GW) in one pass.  Pixels
    outside the node hull extrapolate along the nearest cell's planes."""
    gh, gw = support.shape[-2:]
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
    iy, jx = iy[:, None], jx[None, :]
    fyb, fxb = fy[:, None], fx[None, :]
    # The reference evaluates the upper-right triangle (TL, TR, BR),
    #   fma(fy, d_br - d_tr, fma(fx, d_tr - d_tl, d_tl)),
    # and the lower-left one (TL, BL, BR),
    #   fma(fx, d_br - d_bl, fma(fy, d_bl - d_tl, d_tl)),
    # and keeps one per pixel.  Choosing each pixel's operands first gives
    # the same value from one pair of FMAs: the middle vertex is TR or BL,
    # ``along`` the fraction from TL towards it, ``across`` the other one.
    upper = fxb >= fyb
    d_tl = support[..., iy, jx]
    d_br = support[..., iy + 1, jx + 1]
    d_mid = support[..., iy + (~upper).long(), jx + upper.long()]
    along = torch.where(upper, fxb, fyb)
    across = torch.where(upper, fyb, fxb)
    return fma_f32(across, d_br - d_mid, fma_f32(along, d_mid - d_tl, d_tl))


def support_from_disparity(disp: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """Re-grid a dense disparity map ([...,] H, W) onto the support lattice:
    the map sampled at the regular node coordinates (``candidate_step // 2 +
    i * candidate_step``, the lattice :func:`plane_prior` interpolates from),
    a ([...,] GH, GW) grid.  INVALID pixels stay INVALID; callers fill them
    with :func:`~repro_torch.core.interpolation.interpolate_support`, as for
    the support search's output.  This is the warm-start seam: frame t-1's
    delivered disparity becomes frame t's prior.  A strided view, no copy."""
    h, w = disp.shape[-2:]
    gh, gw = p.grid_shape(h, w)
    step = p.candidate_step
    off = step // 2
    return disp[..., off : off + (gh - 1) * step + 1 : step,
                off : off + (gw - 1) * step + 1 : step]


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
