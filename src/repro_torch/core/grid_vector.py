"""Grid vector: per-cell candidate disparity sets (Sec. II-A / III-C)
(counterpart of ``repro/core/grid_vector.py``).

For every ``grid_size``-pixel cell, pool the support disparities of the cell
and its 8 neighbours and keep K = ``grid_vector_k`` evenly spaced order
statistics -- a static-size candidate set.
"""
from __future__ import annotations

import torch

from repro_torch.core.params import ElasParams
from repro_torch.core.support import INVALID


def build_grid_vector(support: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """(CH, CW, K) float32 candidate disparities per cell; cells with no
    valid support fall back to ``const_fill``."""
    gh, gw = support.shape
    step = p.candidate_step
    if p.grid_size % step:
        raise ValueError("grid_size must be a multiple of candidate_step")
    npc = p.grid_size // step                       # nodes per cell per axis
    ch, cw = gh // npc, gw // npc
    k = p.grid_vector_k
    win = 3 * npc                                   # cell +/- 1 cell
    padded = torch.full((ch * npc + 2 * npc, cw * npc + 2 * npc), INVALID,
                        dtype=support.dtype, device=support.device)
    padded[npc : npc + ch * npc, npc : npc + cw * npc] = support[: ch * npc, : cw * npc]
    pool = torch.stack(
        [padded[dy : dy + ch * npc : npc, dx : dx + cw * npc : npc]
         for dy in range(win) for dx in range(win)],
        dim=-1,
    )                                               # (CH, CW, win*win)
    valid = pool != INVALID
    sorted_pool = torch.sort(torch.where(valid, pool, 1e9), dim=-1).values
    n_valid = valid.sum(dim=-1)                     # (CH, CW)
    ranks = torch.arange(k, dtype=torch.float32, device=support.device)[None, None, :]
    scale = (n_valid - 1).clamp(min=0).to(torch.float32)[..., None]
    idx = torch.round(ranks * scale / max(k - 1, 1)).to(torch.int64)
    idx = torch.where(n_valid[..., None] > 0, idx, 0)
    reps = torch.gather(sorted_pool, -1, idx)
    return torch.where(n_valid[..., None] > 0, reps, p.const_fill)


def cell_index(
    height: int, width: int, p: ElasParams, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Map every pixel row and column to its grid-vector cell (clipped at
    the borders): (cy (H,), cx (W,)) int64."""
    npc_px = p.grid_size
    ch = height // npc_px
    cw = width // npc_px
    cy = (torch.arange(height, device=device) // npc_px).clamp(0, ch - 1)
    cx = (torch.arange(width, device=device) // npc_px).clamp(0, cw - 1)
    return cy, cx
