"""Support-point filtering (counterpart of ``repro/core/filtering.py``).

* **implausible**: a node needs ``incon_min_support`` valid neighbours in a
  ``(2*incon_window+1)^2`` window within ``incon_threshold`` of it.
* **redundant**: a node whose row OR column neighbours within
  ``redun_max_dist`` on BOTH sides hold (near-)identical disparity is removed.
"""
from __future__ import annotations

import torch

from repro_torch.core.params import ElasParams
from repro_torch.core.support import INVALID


def _shift2d(x: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """Shift a 2-D tensor by (dy, dx): ``out[i, j] = x[i - dy, j - dx]``,
    ``fill`` where that falls outside."""
    gh, gw = x.shape
    out = torch.full_like(x, fill)
    out[max(dy, 0) : gh + min(dy, 0), max(dx, 0) : gw + min(dx, 0)] = \
        x[max(-dy, 0) : gh + min(-dy, 0), max(-dx, 0) : gw + min(-dx, 0)]
    return out


def remove_inconsistent(grid: torch.Tensor, p: ElasParams) -> torch.Tensor:
    valid = grid != INVALID
    count = torch.zeros(grid.shape, dtype=torch.int32, device=grid.device)
    for dy in range(-p.incon_window, p.incon_window + 1):
        for dx in range(-p.incon_window, p.incon_window + 1):
            if dy == 0 and dx == 0:
                continue
            nb = _shift2d(grid, dy, dx, INVALID)
            count += ((nb != INVALID) & ((nb - grid).abs() <= p.incon_threshold)).to(torch.int32)
    keep = valid & (count >= p.incon_min_support)
    return torch.where(keep, grid, INVALID)


def _redundant_axis(grid: torch.Tensor, p: ElasParams, axis: int) -> torch.Tensor:
    """True where a node has near-identical valid neighbours on both sides
    along ``axis`` within ``redun_max_dist``."""
    before = torch.zeros(grid.shape, dtype=torch.bool, device=grid.device)
    after = torch.zeros_like(before)
    for k in range(1, p.redun_max_dist + 1):
        dy, dx = (k, 0) if axis == 0 else (0, k)
        nb_b = _shift2d(grid, dy, dx, INVALID)      # neighbour from before (above/left)
        nb_a = _shift2d(grid, -dy, -dx, INVALID)    # neighbour from after (below/right)
        before |= (nb_b != INVALID) & ((nb_b - grid).abs() <= p.redun_threshold)
        after |= (nb_a != INVALID) & ((nb_a - grid).abs() <= p.redun_threshold)
    return before & after


def remove_redundant(grid: torch.Tensor, p: ElasParams) -> torch.Tensor:
    valid = grid != INVALID
    redundant = _redundant_axis(grid, p, axis=0) | _redundant_axis(grid, p, axis=1)
    return torch.where(valid & ~redundant, grid, INVALID)


def filter_support(grid: torch.Tensor, p: ElasParams) -> torch.Tensor:
    return remove_redundant(remove_inconsistent(grid, p), p)
