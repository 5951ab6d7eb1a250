"""Dense matching: per-pixel MAP disparity over a static candidate set
(counterpart of the stream route of ``repro/core/dense.py``).

For every pixel p the energy

    E(d) = beta * SAD(f_src(p), f_dst(p -/+ d)) - log(gamma + exp(-(d-mu)^2 / 2 sigma^2))

is minimised over the grid-vector candidates of the pixel's cell plus the
band ``|d - round(mu)| <= plane_radius``.  The grid vectors become per-cell
disparity bitmasks here; the scan over d that folds them is the dense
kernel (:func:`repro_torch.kernels.dense_match.dense_match_stream`), one
launch for both views of the frame.
"""
from __future__ import annotations

import torch

from repro_torch.core.params import ElasParams
from repro_torch.kernels.dense_match import dense_match_stream


def candidate_bitmask_rows(grid_vec: torch.Tensor, p: ElasParams, height: int) -> torch.Tensor:
    """(H, CW, D) bool: the grid-vector candidate set as a per-cell bitmask.

    ``out[v, cx, i]`` is True iff ``d = disp_min + i`` is one of the rounded,
    clipped grid-vector candidates of the cell at (the cell row of pixel
    row ``v``, ``cx``).  Rows are at pixel resolution, columns at cell
    resolution (the kernel maps a pixel column to its cell).
    """
    ch = grid_vec.shape[0]
    vals = torch.round(grid_vec).clamp(p.disp_min, p.disp_max).to(torch.int32)
    d = torch.arange(p.num_disp, dtype=torch.int32, device=grid_vec.device) + p.disp_min
    cells = (vals[..., None] == d).any(dim=-2)                   # (CH, CW, D)
    # Pixel row v reads cell row min(v // grid_size, CH - 1).
    cy = (torch.arange(height, device=grid_vec.device) // p.grid_size).clamp_(max=ch - 1)
    return cells[cy]


def dense_both_views(
    desc_l: torch.Tensor,       # (H, W, 16) int8
    desc_r: torch.Tensor,       # (H, W, 16) int8
    mu_l: torch.Tensor,         # (H, W) float32 left-view prior
    mu_r: torch.Tensor,         # (H, W) float32 right-view prior
    grid_vec_l: torch.Tensor,   # (CH, CW, K)
    grid_vec_r: torch.Tensor,   # (CH, CW, K)
    p: ElasParams,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(disp_l, disp_r), each (H, W) float32 with INVALID sentinels, from one
    sweep over the descriptors."""
    h = desc_l.shape[0]
    return dense_match_stream(
        desc_l, desc_r, mu_l, mu_r,
        candidate_bitmask_rows(grid_vec_l, p, h),
        candidate_bitmask_rows(grid_vec_r, p, h),
        num_disp=p.num_disp,
        disp_min=p.disp_min,
        plane_radius=p.plane_radius,
        cell_px=p.grid_size,
        beta=p.beta,
        gamma=p.gamma,
        sigma=p.sigma,
        match_texture=p.match_texture,
    )
