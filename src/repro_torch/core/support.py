"""Support-point extraction over a regular candidate grid
(counterpart of ``repro/core/support.py``).

SAD matching of the 16-dim int8 descriptors at candidate pixels of pitch
``candidate_step`` over the full disparity range, with texture, uniqueness
and left/right tests.  The result is a DENSE (GH, GW) float32 grid with
INVALID = -1 sentinels.  The search itself is the support kernel
(:func:`repro_torch.kernels.support_match.support_match`), one launch over
all candidate rows of the frame, which it reads through a strided view of
the descriptors (no gather).
"""
from __future__ import annotations

import torch

from repro_torch.core import descriptor as desc_mod
from repro_torch.core.params import ElasParams
from repro_torch.kernels.support_match import support_match

INVALID = -1.0


def candidate_rows(desc: torch.Tensor, step: int) -> torch.Tensor:
    """The candidate rows ``i * step + step // 2`` of ([B,] H, W, 16)
    descriptors: a strided view, no copy."""
    gh = desc.shape[-3] // step
    return desc[..., step // 2 : step // 2 + gh * step : step, :, :]


def _support_kwargs(p: ElasParams) -> dict:
    return dict(
        num_disp=p.num_disp,
        step=p.candidate_step,
        offset=p.candidate_step // 2,
        support_texture=p.support_texture,
        support_ratio=p.support_ratio,
        lr_threshold=p.lr_threshold,
        disp_min=p.disp_min,
    )


def extract_support_grid(
    desc_left: torch.Tensor,    # (H, W, 16) int8
    desc_right: torch.Tensor,   # (H, W, 16) int8
    p: ElasParams,
) -> torch.Tensor:
    """Dense support grid (GH, GW) float32, INVALID where no confident match."""
    step = p.candidate_step
    return support_match(candidate_rows(desc_left, step), candidate_rows(desc_right, step),
                         **_support_kwargs(p))


def extract_support_grid_batched(
    desc_left: torch.Tensor,    # (B, H, W, 16) int8
    desc_right: torch.Tensor,   # (B, H, W, 16) int8
    p: ElasParams,
) -> torch.Tensor:
    """Wave-shaped support grids (B, GH, GW) from one kernel launch; each
    slot equals :func:`extract_support_grid` on that frame."""
    if desc_left.dim() != 4:
        raise ValueError(f"descriptors must be (B, H, W, 16), got {tuple(desc_left.shape)}")
    step = p.candidate_step
    return support_match(candidate_rows(desc_left, step), candidate_rows(desc_right, step),
                         **_support_kwargs(p))


def descriptors_and_support(
    img_left: torch.Tensor, img_right: torch.Tensor, p: ElasParams
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Descriptors for both views + the (unfiltered) support grid."""
    dl, dr = desc_mod.extract_views(img_left, img_right)
    return dl, dr, extract_support_grid(dl, dr, p)


def support_from_images(
    img_left: torch.Tensor, img_right: torch.Tensor, p: ElasParams
) -> torch.Tensor:
    """The (unfiltered) support grid (GH, GW) of a stereo pair."""
    return descriptors_and_support(img_left, img_right, p)[2]
