"""Dense matching: per-pixel MAP disparity over a static candidate set
(counterpart of ``repro/core/dense.py``).

For every pixel p the energy

    E(d) = beta * SAD(f_src(p), f_dst(p -/+ d)) - log(gamma + exp(-(d-mu)^2 / 2 sigma^2))

is minimised over K = grid_vector_k candidates from the pixel's grid cell
plus the ``2 * plane_radius + 1`` candidates around the plane prior mu(p)
(paper: 20 + 5).  Two routes compute it, bitwise equal, and the ``tile``
argument picks one (:func:`repro_torch.core.tiling.dense_route`):

* the stream route (``tile=None``, the default, or ``gather="stream"``):
  the grid vectors become per-cell disparity bitmasks
  (:func:`candidate_bitmask_rows`) and the scan over d folds them with the
  prior band (:func:`repro_torch.kernels.dense_match.dense_match_stream`);
* the candidate route (:data:`~repro_torch.core.tiling.UNTILED` or a
  windowed ``gather``): per-pixel candidate tensors (:func:`candidate_set`)
  and the candidate-window kernel
  (:func:`repro_torch.kernels.dense_match.dense_match_candidates`).

Either way one kernel launch covers both views of a frame, or of a wave;
:func:`dense_disparity` is the single-view wrapper over it.

:func:`dense_warm_both_views` is the warm-start variant (counterpart of
``dense_match_warm_xla``): the band around a previous frame's disparity
only, with a rational prior energy (:func:`repro_torch.kernels.dense_match
.dense_match_warm`).
"""
from __future__ import annotations

import torch

from repro_torch.core.grid_vector import cell_index
from repro_torch.core.params import ElasParams
from repro_torch.core.tiling import STREAM, TileArg, dense_route
from repro_torch.kernels.dense_match import (
    dense_match_candidates,
    dense_match_stream,
    dense_match_warm,
)


def candidate_set(mu: torch.Tensor, grid_vec: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """([B,] H, W, K + 2R + 1) int32 candidate disparities per pixel.

    ``mu`` is ([B,] H, W), ``grid_vec`` ([B,] CH, CW, K).  The grid vector
    and the rounded prior neighbourhood (round half to even, as
    ``jnp.round``) are clipped to the search range.
    """
    h, w = mu.shape[-2:]
    cy, cx = cell_index(h, w, p, mu.device)
    cell_cands = grid_vec[..., cy[:, None], cx[None, :], :]      # ([B,] H, W, K)
    radius = torch.arange(-p.plane_radius, p.plane_radius + 1, dtype=torch.float32,
                          device=mu.device)
    prior_cands = torch.round(mu)[..., None] + radius            # ([B,] H, W, 2R+1)
    cands = torch.cat([torch.round(cell_cands), prior_cands], dim=-1)
    return cands.clamp(p.disp_min, p.disp_max).to(torch.int32)


def candidate_bitmask_rows(grid_vec: torch.Tensor, p: ElasParams, height: int) -> torch.Tensor:
    """([B,] H, CW, D) bool: the grid-vector candidate set as a per-cell bitmask.

    ``out[..., v, cx, i]`` is True iff ``d = disp_min + i`` is one of the
    rounded, clipped grid-vector candidates of the cell at (the cell row of
    pixel row ``v``, ``cx``).  Rows are at pixel resolution, columns at cell
    resolution (the kernel maps a pixel column to its cell).
    """
    ch = grid_vec.shape[-3]
    vals = torch.round(grid_vec).clamp(p.disp_min, p.disp_max).to(torch.int32)
    d = torch.arange(p.num_disp, dtype=torch.int32, device=grid_vec.device) + p.disp_min
    cells = (vals[..., None] == d).any(dim=-2)                   # ([B,] CH, CW, D)
    # Pixel row v reads cell row min(v // grid_size, CH - 1).
    cy = (torch.arange(height, device=grid_vec.device) // p.grid_size).clamp_(max=ch - 1)
    return cells[..., cy, :, :]


def _dense(desc_l, desc_r, mu_l, mu_r, grid_vec_l, grid_vec_r, p, tile):
    kw = dict(num_disp=p.num_disp, disp_min=p.disp_min, beta=p.beta, gamma=p.gamma,
              sigma=p.sigma, match_texture=p.match_texture)
    if dense_route(tile) == STREAM:
        h = desc_l.shape[-3]
        return dense_match_stream(
            desc_l, desc_r, mu_l, mu_r,
            candidate_bitmask_rows(grid_vec_l, p, h),
            candidate_bitmask_rows(grid_vec_r, p, h),
            plane_radius=p.plane_radius, cell_px=p.grid_size, **kw,
        )
    return dense_match_candidates(
        desc_l, desc_r, mu_l, mu_r,
        candidate_set(mu_l, grid_vec_l, p), candidate_set(mu_r, grid_vec_r, p), **kw,
    )


def dense_both_views(
    desc_l: torch.Tensor,       # (H, W, 16) int8
    desc_r: torch.Tensor,       # (H, W, 16) int8
    mu_l: torch.Tensor,         # (H, W) float32 left-view prior
    mu_r: torch.Tensor,         # (H, W) float32 right-view prior
    grid_vec_l: torch.Tensor,   # (CH, CW, K)
    grid_vec_r: torch.Tensor,   # (CH, CW, K)
    p: ElasParams,
    tile: TileArg = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(disp_l, disp_r), each (H, W) float32 with INVALID sentinels, from one
    kernel launch over both views; ``tile`` picks the route."""
    if desc_l.dim() != 3:
        raise ValueError(f"descriptors must be (H, W, 16), got {tuple(desc_l.shape)}")
    return _dense(desc_l, desc_r, mu_l, mu_r, grid_vec_l, grid_vec_r, p, tile)


def dense_disparity(
    desc_src: torch.Tensor,     # (H, W, 16) int8, the view whose map is returned
    desc_dst: torch.Tensor,     # (H, W, 16) int8, the other view
    mu: torch.Tensor,           # (H, W) float32 prior of the source view
    grid_vec: torch.Tensor,     # (CH, CW, K)
    p: ElasParams,
    direction: int = -1,
    tile: TileArg = None,
) -> torch.Tensor:
    """Single-view compatibility wrapper over :func:`dense_both_views`.

    direction=-1: the arguments are left-view (src=left); returns the left map.
    direction=+1: the arguments are right-view (src=right); returns the right map.
    """
    if direction == -1:
        return dense_both_views(desc_src, desc_dst, mu, mu, grid_vec, grid_vec, p, tile=tile)[0]
    return dense_both_views(desc_dst, desc_src, mu, mu, grid_vec, grid_vec, p, tile=tile)[1]


def dense_both_views_batched(
    desc_l: torch.Tensor,       # (B, H, W, 16) int8
    desc_r: torch.Tensor,       # (B, H, W, 16) int8
    mu_l: torch.Tensor,         # (B, H, W) float32
    mu_r: torch.Tensor,         # (B, H, W) float32
    grid_vec_l: torch.Tensor,   # (B, CH, CW, K)
    grid_vec_r: torch.Tensor,   # (B, CH, CW, K)
    p: ElasParams,
    tile: TileArg = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Wave-shaped dense matching: (disp_l, disp_r), each (B, H, W), from one
    kernel launch over every frame and both views.  Each slot equals
    :func:`dense_both_views` on that frame."""
    if desc_l.dim() != 4:
        raise ValueError(f"descriptors must be (B, H, W, 16), got {tuple(desc_l.shape)}")
    return _dense(desc_l, desc_r, mu_l, mu_r, grid_vec_l, grid_vec_r, p, tile)


def dense_warm_both_views(
    desc_l: torch.Tensor,       # ([B,] H, W, 16) int8
    desc_r: torch.Tensor,       # ([B,] H, W, 16) int8
    mu_l: torch.Tensor,         # ([B,] H, W) float32 warm prior
    mu_r: torch.Tensor,         # ([B,] H, W) float32
    p: ElasParams,
    warm_band: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Warm-start dense matching: (disp_l, disp_r), each ([B,] H, W), from
    one kernel launch over every frame and both views.  The candidates are
    the band ``round(mu) -/+ warm_band`` only (no grid vectors); the
    reference's tile heights and precision are invisible in its output."""
    if desc_l.dim() not in (3, 4):
        raise ValueError(f"descriptors must be ([B,] H, W, 16), got {tuple(desc_l.shape)}")
    return dense_match_warm(
        desc_l, desc_r, mu_l, mu_r, num_disp=p.num_disp, disp_min=p.disp_min,
        warm_band=warm_band, beta=p.beta, sigma=p.sigma, match_texture=p.match_texture,
    )
