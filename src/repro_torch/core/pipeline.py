"""End-to-end iELAS frame path and its stages
(counterpart of ``repro/core/pipeline.py``).

:func:`ielas_disparity` runs the paper's fully-on-accelerator pipeline in
three stages, split where the FPGA splits its support-point subsystem from
the dense-matching datapath (paper Fig. 3):

* :func:`ielas_support_stage` -- descriptors + sparse filtered support
  (the support kernel);
* :func:`ielas_interpolate_stage` -- the paper's regular interpolation
  completing the support grid;
* :func:`ielas_dense_stage` -- plane priors, grid-vector bitmasks, dense
  matching for both views (the dense kernel), post-processing.

Stages run on the device of the tensors they are given.  The entry point
runs on CUDA unless the caller passes another device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.dense import dense_both_views
from repro_torch.core.filtering import filter_support
from repro_torch.core.grid_vector import build_grid_vector
from repro_torch.core.interpolation import interpolate_support
from repro_torch.core.params import ElasParams
from repro_torch.core.postprocess import postprocess
from repro_torch.core.prior import plane_prior, right_view_support
from repro_torch.core.support import descriptors_and_support


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0``; raises when no CUDA device is present rather
    than running on the host unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host"
            )
        return torch.device("cuda", 0)
    return torch.device(device)


def _dense_priors(
    support_left: torch.Tensor, h: int, w: int, p: ElasParams
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-frame dense-stage inputs: (mu_l, mu_r, gv_l, gv_r)."""
    mu_l = plane_prior(support_left, h, w, p)
    gv_l = build_grid_vector(support_left, p)
    sup_r = interpolate_support(right_view_support(support_left, p), p)
    mu_r = plane_prior(sup_r, h, w, p)
    gv_r = build_grid_vector(sup_r, p)
    return mu_l, mu_r, gv_l, gv_r


def _narrow_band(p: ElasParams, band_radius: Optional[int]) -> ElasParams:
    """Override the plane-prior band half-width (``plane_radius``); ``None``
    leaves ``p`` untouched."""
    if band_radius is None:
        return p
    if band_radius < 0:
        raise ValueError(f"band_radius must be >= 0, got {band_radius}")
    return dataclasses.replace(p, plane_radius=int(band_radius))


def ielas_support_stage(
    img_left: torch.Tensor, img_right: torch.Tensor, p: ElasParams
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Descriptors (H, W, 16) int8 for both views + the filtered sparse
    support grid (GH, GW) float32."""
    dl, dr, support = descriptors_and_support(img_left, img_right, p)
    return dl, dr, filter_support(support, p)


def ielas_interpolate_stage(support: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """THE iELAS step: regular interpolation completing the support grid."""
    return interpolate_support(support, p)


def ielas_dense_stage(
    dl: torch.Tensor,
    dr: torch.Tensor,
    support_left: torch.Tensor,   # complete (interpolated) left-view support grid
    p: ElasParams,
    band_radius: Optional[int] = None,
) -> torch.Tensor:
    """Dense disparity for both views + post-processing -> final left map."""
    p = _narrow_band(p, band_radius)
    h, w = dl.shape[:2]
    mu_l, mu_r, gv_l, gv_r = _dense_priors(support_left, h, w, p)
    disp_l, disp_r = dense_both_views(dl, dr, mu_l, mu_r, gv_l, gv_r, p)
    return postprocess(disp_l, disp_r, p)


def ielas_disparity(img_left, img_right, p: ElasParams, device=None) -> torch.Tensor:
    """iELAS on one stereo pair: (H, W) float32 left disparity, -1 where invalid.

    ``img_left`` / ``img_right`` are (H, W) arrays or tensors of grey
    levels; they are moved to ``device`` (default ``cuda:0``; raises if no
    card is present).
    """
    dev = resolve_device(device)
    il = torch.as_tensor(img_left, device=dev)
    ir = torch.as_tensor(img_right, device=dev)
    dl, dr, support = ielas_support_stage(il, ir, p)
    support = ielas_interpolate_stage(support, p)
    return ielas_dense_stage(dl, dr, support, p)


def disparity_error(
    disp: torch.Tensor, ground_truth: torch.Tensor, invalid: float = -1.0
) -> torch.Tensor:
    """Paper Eq. (1): Error = (1/N) * sum |D - D*| / D*, over valid pixels."""
    ok = (disp != invalid) & (ground_truth > 0)
    rel = torch.where(ok, (disp - ground_truth).abs() / ground_truth.clamp(min=1e-6), 0.0)
    return rel.sum() / ok.sum().clamp(min=1)


def bad_pixel_rate(
    disp: torch.Tensor, ground_truth: torch.Tensor, tau: float = 3.0, invalid: float = -1.0
) -> torch.Tensor:
    """KITTI-style matching error: fraction of pixels off by more than tau
    (invalid estimates count as errors, as in the paper's Table III)."""
    gt_ok = ground_truth > 0
    wrong = (disp == invalid) | ((disp - ground_truth).abs() > tau)
    return (wrong & gt_ok).sum() / gt_ok.sum().clamp(min=1)
