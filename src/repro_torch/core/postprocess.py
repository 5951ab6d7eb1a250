"""Post-processing: left/right consistency, gap interpolation, median filter
(counterpart of ``repro/core/postprocess.py``).

Every function takes one map (H, W) or a wave of them (B, H, W); the
median is the median kernel (:func:`repro_torch.kernels.median.median3x3`,
one launch for the whole stack).
"""
from __future__ import annotations

import torch

from repro_torch.core.interpolation import nearest_valid_lr
from repro_torch.core.params import ElasParams
from repro_torch.kernels.median import median3x3
from repro_torch.kernels.ref import fma_f32

INVALID = -1.0


def lr_consistency(
    disp_left: torch.Tensor, disp_right: torch.Tensor, p: ElasParams
) -> torch.Tensor:
    """Invalidate pixels whose right-image counterpart disagrees."""
    w = disp_left.shape[-1]
    u = torch.arange(w, dtype=torch.float32, device=disp_left.device)
    ur = (u - disp_left).clamp(0, w - 1).to(torch.int64)
    d_r = torch.gather(disp_right, -1, ur)
    ok = (
        (disp_left != INVALID)
        & (d_r != INVALID)
        & ((disp_left - d_r).abs() <= p.lr_check_threshold)
    )
    return torch.where(ok, disp_left, INVALID)


def gap_interpolation(disp: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """Fill horizontal invalid runs of length <= ipol_gap_width: smooth gaps
    (end difference <= 5) linearly, discontinuities with the min."""
    val_l, dist_l, val_r, dist_r = nearest_valid_lr(disp)
    w = disp.shape[-1]
    fillable = (
        (disp == INVALID)
        & (dist_l < w + 1)
        & (dist_r < w + 1)
        & (dist_l + dist_r - 1 <= p.ipol_gap_width)
    )
    t = dist_l.to(torch.float32) / (dist_l + dist_r).clamp(min=1).to(torch.float32)
    linear = fma_f32(t, val_r - val_l, val_l)       # the reference's XLA:CPU FMA
    fill = torch.where((val_l - val_r).abs() <= 5.0, linear, torch.minimum(val_l, val_r))
    return torch.where(fillable, fill, disp)


def postprocess(disp_left: torch.Tensor, disp_right: torch.Tensor, p: ElasParams) -> torch.Tensor:
    d = lr_consistency(disp_left, disp_right, p)
    d = gap_interpolation(d, p)
    return median3x3(d)
