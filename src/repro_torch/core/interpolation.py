"""iELAS support-point interpolation (Sec. II-B), the paper's technique
(counterpart of ``repro/core/interpolation.py``).

Fills every vacant node of the support grid:

1. **Horizontal**: nearest valid nodes (P_L, P_R) within ``s_delta`` on both
   sides; ``|D_L - D_R| <= epsilon`` -> mean, else ``min(D_L, D_R)``.
2. **Vertical**: the same rule along columns if no horizontal pair exists.
3. **Constant**: ``const_fill`` if neither direction yields a pair.

Where the trailing (right / bottom) half of the window is cut by the grid
boundary, the leading value alone is used (the causal single-sided rule of
the paper's Fig. 2, the reference's default ``border_extend=True``).
Nearest-valid indices come from ``torch.cummax``, values from
``torch.gather``.
"""
from __future__ import annotations

import torch

from repro_torch.core.params import ElasParams
from repro_torch.core.support import INVALID

_NO_NEIGHBOUR = 1 << 30   # "no valid neighbour" distance: exceeds any s_delta


def nearest_valid_lr(x: torch.Tensor):
    """Nearest valid value/distance to the left and right along the last
    axis: (val_l, dist_l, val_r, dist_r), dist = 2^30 where none exists."""
    w = x.shape[-1]
    col = torch.arange(w, device=x.device).expand_as(x)

    def leftwards(g):
        idx = torch.cummax(torch.where(g != INVALID, col, -1), dim=-1).values
        val = torch.gather(g, -1, idx.clamp(min=0))
        dist = torch.where(idx >= 0, col - idx, _NO_NEIGHBOUR)
        return val, dist.to(torch.int32)

    val_l, dist_l = leftwards(x)
    val_r, dist_r = leftwards(torch.flip(x, dims=(-1,)))
    return val_l, dist_l, torch.flip(val_r, dims=(-1,)), torch.flip(dist_r, dims=(-1,))


def _axis_interpolation(grid: torch.Tensor, p: ElasParams) -> tuple[torch.Tensor, torch.Tensor]:
    """One-axis (horizontal) interpolation: returns (value, found_mask)."""
    gw = grid.shape[1]
    col = torch.arange(gw, device=grid.device)[None, :]
    val_l, dist_l, val_r, dist_r = nearest_valid_lr(grid)
    has_l = dist_l <= p.s_delta
    has_r = dist_r <= p.s_delta
    pair = torch.where(
        (val_l - val_r).abs() <= p.epsilon, 0.5 * (val_l + val_r), torch.minimum(val_l, val_r)
    )
    found = has_l & has_r
    value = torch.where(found, pair, INVALID)
    # Trailing window truncated by the boundary -> the leading value extends.
    ext = has_l & ((col + p.s_delta) >= gw) & ~found
    return torch.where(ext, val_l, value), found | ext


def interpolate_support(grid: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """Fill every vacant node; valid nodes pass through.  No INVALID remains."""
    h_val, h_found = _axis_interpolation(grid, p)
    v_val, v_found = (t.T for t in _axis_interpolation(grid.T, p))
    filled = torch.where(h_found, h_val, torch.where(v_found, v_val, p.const_fill))
    return torch.where(grid != INVALID, grid, filled)
