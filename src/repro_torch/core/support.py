"""Support-point extraction over a regular candidate grid
(counterpart of ``repro/core/support.py``).

SAD matching of the 16-dim int8 descriptors at candidate pixels of pitch
``candidate_step`` over the full disparity range, with texture, uniqueness
and left/right tests.  The result is a DENSE (GH, GW) float32 grid with
INVALID = -1 sentinels.  The search itself is the support kernel
(:func:`repro_torch.kernels.support_match.support_match`), one launch over
all candidate rows of the frame.
"""
from __future__ import annotations

import torch

from repro_torch.core import descriptor as desc_mod
from repro_torch.core.params import ElasParams
from repro_torch.kernels.support_match import support_match

INVALID = -1.0


def candidate_coords(
    height: int, width: int, step: int, device=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel coordinates (v, u) of the support-candidate grid nodes,
    ``(i*step + step//2, j*step + step//2)``; shapes (H//step,), (W//step,)."""
    gh, gw = height // step, width // step
    vs = torch.arange(gh, device=device) * step + step // 2
    us = torch.arange(gw, device=device) * step + step // 2
    return vs, us


def extract_support_grid(
    desc_left: torch.Tensor,    # (H, W, 16) int8
    desc_right: torch.Tensor,   # (H, W, 16) int8
    p: ElasParams,
) -> torch.Tensor:
    """Dense support grid (GH, GW) float32, INVALID where no confident match."""
    h, w = desc_left.shape[:2]
    vs, _ = candidate_coords(h, w, p.candidate_step, desc_left.device)
    return support_match(
        desc_left[vs], desc_right[vs],
        num_disp=p.num_disp,
        step=p.candidate_step,
        offset=p.candidate_step // 2,
        support_texture=p.support_texture,
        support_ratio=p.support_ratio,
        lr_threshold=p.lr_threshold,
        disp_min=p.disp_min,
    )


def extract_support_grid_batched(
    desc_left: torch.Tensor,    # (B, H, W, 16) int8
    desc_right: torch.Tensor,   # (B, H, W, 16) int8
    p: ElasParams,
) -> torch.Tensor:
    """Wave-shaped support grids (B, GH, GW) from one kernel launch; each
    slot equals :func:`extract_support_grid` on that frame."""
    if desc_left.dim() != 4:
        raise ValueError(f"descriptors must be (B, H, W, 16), got {tuple(desc_left.shape)}")
    h, w = desc_left.shape[1:3]
    vs, _ = candidate_coords(h, w, p.candidate_step, desc_left.device)
    return support_match(
        desc_left[:, vs], desc_right[:, vs],
        num_disp=p.num_disp,
        step=p.candidate_step,
        offset=p.candidate_step // 2,
        support_texture=p.support_texture,
        support_ratio=p.support_ratio,
        lr_threshold=p.lr_threshold,
        disp_min=p.disp_min,
    )


def descriptors_and_support(
    img_left: torch.Tensor, img_right: torch.Tensor, p: ElasParams
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Descriptors for both views + the (unfiltered) support grid."""
    dl, dr = desc_mod.extract_views(img_left, img_right)
    return dl, dr, extract_support_grid(dl, dr, p)
