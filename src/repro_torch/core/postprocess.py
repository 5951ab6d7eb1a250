"""Post-processing: left/right consistency, gap interpolation, median filter
(counterpart of ``repro/core/postprocess.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.descriptor import edge_pad
from repro_torch.core.interpolation import nearest_valid_lr
from repro_torch.core.params import ElasParams
from repro_torch.kernels.ref import fma_f32, median9

INVALID = -1.0


def lr_consistency(
    disp_left: torch.Tensor, disp_right: torch.Tensor, p: ElasParams
) -> torch.Tensor:
    """Invalidate pixels whose right-image counterpart disagrees."""
    w = disp_left.shape[1]
    u = torch.arange(w, dtype=torch.float32, device=disp_left.device)[None, :]
    ur = (u - disp_left).clamp(0, w - 1).to(torch.int64)
    d_r = torch.gather(disp_right, 1, ur)
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
    w = disp.shape[1]
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


def median3x3(disp: torch.Tensor) -> torch.Tensor:
    """3x3 median over valid pixels (invalid neighbours take the centre
    value); invalid pixels stay invalid.  Paeth's 19-op network."""
    h, w = disp.shape
    padded = edge_pad(disp, 1)
    wins = []
    for dy in range(3):
        for dx in range(3):
            win = padded[dy : dy + h, dx : dx + w]
            wins.append(torch.where(win == INVALID, disp, win))
    return torch.where(disp == INVALID, INVALID, median9(wins))


def postprocess(disp_left: torch.Tensor, disp_right: torch.Tensor, p: ElasParams) -> torch.Tensor:
    d = lr_consistency(disp_left, disp_right, p)
    d = gap_interpolation(d, p)
    return median3x3(d)
