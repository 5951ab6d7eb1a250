"""End-to-end iELAS frame path and its stages
(counterpart of ``repro/core/pipeline.py``).

:func:`ielas_disparity` runs the paper's fully-on-accelerator pipeline in
three stages, split where the FPGA splits its support-point subsystem from
the dense-matching datapath (paper Fig. 3):

* :func:`ielas_support_stage` -- descriptors + sparse filtered support
  (the support kernel);
* :func:`ielas_interpolate_stage` -- the paper's regular interpolation
  completing the support grid;
* :func:`ielas_dense_stage` -- plane priors, grid vectors, dense matching
  for both views (a dense kernel), post-processing (the median kernel).

The warm-start stages serve video: :func:`ielas_descriptor_stage_batched`
(descriptors only, the warm wave's whole support stage) and
:func:`ielas_warm_dense_stage` / :func:`ielas_warm_dense_stage_batched`,
whose priors come from the previous frame's disparity (:func:`_warm_priors`)
and whose dense kernel scans only a band around them.

:func:`elas_baseline_disparity` is the original-ELAS hybrid the paper
compares against: the same support stage, then the support grid pulled to
the host for a scipy Delaunay prior of each view, pushed back for the dense
half.

The ``*_batched`` stages are the wave-shaped forms the serving engine
runs: a leading batch axis of B frames, one launch of each kernel per
wave, and every slot equal to the single-frame stage on that frame, bit
for bit.  The per-frame preparation around the kernels (filtering,
interpolation, grid vectors) runs frame by frame.

``tile`` picks the dense route (:mod:`repro_torch.core.tiling`): ``None``
or ``gather="stream"`` the gather-free scan, :data:`UNTILED` or a windowed
gather the candidate-window kernel -- bitwise equal.  The reference's
tile heights and precision are invisible in the output and ignored here.

Stages run on the device of the tensors they are given.  The entry point
runs on CUDA unless the caller passes another device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import descriptor as desc_mod
from repro_torch.core import triangulation
from repro_torch.core.dense import (
    dense_both_views,
    dense_both_views_batched,
    dense_warm_both_views,
)
from repro_torch.core.filtering import filter_support
from repro_torch.core.grid_vector import build_grid_vector
from repro_torch.core.interpolation import interpolate_support
from repro_torch.core.params import ElasParams
from repro_torch.core.postprocess import postprocess
from repro_torch.core.prior import plane_prior, right_view_support, support_from_disparity
from repro_torch.core.support import (
    INVALID,
    descriptors_and_support,
    extract_support_grid_batched,
)
from repro_torch.core.tiling import TileArg, dense_route
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import xla_sum_f32


def _dense_priors(
    support_left: torch.Tensor, h: int, w: int, p: ElasParams
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense-stage inputs (mu_l, mu_r, gv_l, gv_r) of one frame (GH, GW) or
    a wave (B, GH, GW), with the same leading axis.  The right view's
    support and the grid vectors are built frame by frame; the priors of
    both views of every frame come from one :func:`plane_prior` call."""
    lead = support_left.shape[:-2]
    frames = support_left.reshape(-1, *support_left.shape[-2:])
    sup_r = torch.stack([interpolate_support(right_view_support(s, p), p) for s in frames])
    mu_l, mu_r = plane_prior(torch.stack([frames, sup_r]), h, w, p).reshape(2, *lead, h, w)
    gv_l, gv_r = (torch.stack([build_grid_vector(s, p) for s in view]) for view in (frames, sup_r))
    return mu_l, mu_r, gv_l.reshape(*lead, *gv_l.shape[1:]), gv_r.reshape(*lead, *gv_r.shape[1:])


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


def ielas_support_stage_batched(
    img_left: torch.Tensor,     # (B, H, W)
    img_right: torch.Tensor,
    p: ElasParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Wave-shaped support stage: (dl, dr, filtered support) with a leading
    B, from one Sobel launch over both views of the wave and one support
    launch; filtering runs frame by frame."""
    if img_left.dim() != 3:
        raise ValueError(f"images must be (B, H, W), got {tuple(img_left.shape)}")
    dl, dr = desc_mod.extract_views(img_left, img_right)
    support = extract_support_grid_batched(dl, dr, p)
    return dl, dr, torch.stack([filter_support(s, p) for s in support])


def ielas_interpolate_stage(support: torch.Tensor, p: ElasParams) -> torch.Tensor:
    """THE iELAS step: regular interpolation completing the support grid."""
    return interpolate_support(support, p)


def ielas_dense_stage(
    dl: torch.Tensor,
    dr: torch.Tensor,
    support_left: torch.Tensor,   # complete (interpolated) left-view support grid
    p: ElasParams,
    band_radius: Optional[int] = None,
    tile: TileArg = None,
) -> torch.Tensor:
    """Dense disparity for both views + post-processing -> final left map.
    ``band_radius`` narrows the plane-prior band; ``tile`` picks the route."""
    p = _narrow_band(p, band_radius)
    h, w = dl.shape[:2]
    mu_l, mu_r, gv_l, gv_r = _dense_priors(support_left, h, w, p)
    disp_l, disp_r = dense_both_views(dl, dr, mu_l, mu_r, gv_l, gv_r, p, tile=tile)
    return postprocess(disp_l, disp_r, p)


def ielas_dense_stage_batched(
    dl: torch.Tensor,             # (B, H, W, 16)
    dr: torch.Tensor,
    support_left: torch.Tensor,   # (B, GH, GW) complete support grids
    p: ElasParams,
    band_radius: Optional[int] = None,
    tile: TileArg = None,
) -> torch.Tensor:
    """Wave-shaped dense stage: (B, H, W) final left maps.  The right-view
    support and the grid vectors are built frame by frame, the priors of the
    whole wave in one pass; dense matching is one kernel launch for the wave
    and the median one more."""
    p = _narrow_band(p, band_radius)
    h, w = dl.shape[1:3]
    mu_l, mu_r, gv_l, gv_r = _dense_priors(support_left, h, w, p)
    disp_l, disp_r = dense_both_views_batched(dl, dr, mu_l, mu_r, gv_l, gv_r, p, tile=tile)
    return postprocess(disp_l, disp_r, p)


def _warm_priors(
    prev_disp: torch.Tensor, h: int, w: int, p: ElasParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """Warm-start dense priors (mu_l, mu_r) from a previous disparity map
    (H, W), or a wave of them (B, H, W), with the same leading axis.

    The previous frame's disparity is re-gridded onto the support lattice
    (:func:`~repro_torch.core.prior.support_from_disparity`), interpolated
    with the paper's rule and planed into a smooth prior; the left view
    keeps the previous value wherever it was valid (the plane fills the
    holes), and the right view re-projects the re-gridded support as the
    cold path re-projects the searched one.  Grids are built frame by frame;
    the planes of both views of every frame come from one
    :func:`plane_prior` call."""
    lead = prev_disp.shape[:-2]
    frames = prev_disp.reshape(-1, h, w)
    grids = torch.stack([interpolate_support(support_from_disparity(f, p), p) for f in frames])
    sup_r = torch.stack([interpolate_support(right_view_support(g, p), p) for g in grids])
    mu_smooth, mu_r = plane_prior(torch.stack([grids, sup_r]), h, w, p)
    mu_l = torch.where(frames != INVALID, frames, mu_smooth)
    return mu_l.reshape(*lead, h, w), mu_r.reshape(*lead, h, w)


def _warm_band(warm_band: int, band_radius: Optional[int]) -> int:
    """The effective band: ``band_radius`` (degraded mode) narrows the warm
    band by intersection, ``min(warm_band, band_radius)``."""
    eff = warm_band if band_radius is None else min(warm_band, int(band_radius))
    if eff < 0:
        raise ValueError(f"warm band must be >= 0, got {eff}")
    return eff


def ielas_warm_dense_stage(
    dl: torch.Tensor,             # (H, W, 16)
    dr: torch.Tensor,
    prev_disp: torch.Tensor,      # (H, W) the previous frame's disparity (the seed)
    p: ElasParams,
    warm_band: int = 8,
    band_radius: Optional[int] = None,
) -> torch.Tensor:
    """Warm-start dense stage: the previous frame seeds the priors
    (:func:`_warm_priors`) and the candidates are only the ``+-band`` band
    around them, ``band = min(warm_band, band_radius)``; then
    post-processing.  Not bitwise equal to the cold stage by design (the
    serving engine's post-hoc check bounds the difference).  Also takes a
    wave, as :func:`ielas_warm_dense_stage_batched`."""
    band = _warm_band(warm_band, band_radius)
    h, w = dl.shape[-3:-1]
    mu_l, mu_r = _warm_priors(prev_disp, h, w, p)
    disp_l, disp_r = dense_warm_both_views(dl, dr, mu_l, mu_r, p, band)
    return postprocess(disp_l, disp_r, p)


def ielas_warm_dense_stage_batched(
    dl: torch.Tensor,             # (B, H, W, 16)
    dr: torch.Tensor,
    prev_disp: torch.Tensor,      # (B, H, W)
    p: ElasParams,
    warm_band: int = 8,
    band_radius: Optional[int] = None,
) -> torch.Tensor:
    """Wave-shaped warm dense stage: (B, H, W) final left maps, one warm
    kernel launch and one median launch for the wave; each slot equals
    :func:`ielas_warm_dense_stage` on that frame."""
    if dl.dim() != 4:
        raise ValueError(f"descriptors must be (B, H, W, 16), got {tuple(dl.shape)}")
    return ielas_warm_dense_stage(dl, dr, prev_disp, p, warm_band, band_radius)


def ielas_descriptor_stage_batched(
    img_left: torch.Tensor,       # (B, H, W)
    img_right: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Descriptors only, (B, H, W, 16) for each view from one Sobel launch:
    a warm wave's whole support stage (its prior comes from the previous
    frame, so it runs no support search and no interpolation)."""
    if img_left.dim() != 3:
        raise ValueError(f"images must be (B, H, W), got {tuple(img_left.shape)}")
    return desc_mod.extract_views(img_left, img_right)


def ielas_disparity(
    img_left, img_right, p: ElasParams, device=None, tile: TileArg = None
) -> torch.Tensor:
    """iELAS on one stereo pair: (H, W) float32 left disparity, -1 where invalid.

    ``img_left`` / ``img_right`` are (H, W) arrays or tensors of grey
    levels; they are moved to ``device`` (default ``cuda:0``; raises if no
    card is present).  ``tile`` picks the dense route; the output is the
    same for every route.
    """
    dev = resolve_device(device)
    il = torch.as_tensor(img_left, device=dev)
    ir = torch.as_tensor(img_right, device=dev)
    dense_route(tile)     # a bad tile fails before any work
    dl, dr, support = ielas_support_stage(il, ir, p)
    support = ielas_interpolate_stage(support, p)
    return ielas_dense_stage(dl, dr, support, p, tile=tile)


def _baseline_back_half(
    dl: torch.Tensor,
    dr: torch.Tensor,
    support_sparse: torch.Tensor,   # (GH, GW) filtered support, not interpolated
    mu_l: torch.Tensor,             # (H, W) float32 Delaunay priors
    mu_r: torch.Tensor,
    p: ElasParams,
) -> torch.Tensor:
    """The baseline's dense half: grid vectors of the sparse support of both
    views, dense matching on the Delaunay priors (the stream kernel),
    post-processing."""
    gv_l = build_grid_vector(support_sparse, p)
    sup_r = right_view_support(support_sparse, p)
    gv_r = build_grid_vector(sup_r, p)
    disp_l, disp_r = dense_both_views(dl, dr, mu_l, mu_r, gv_l, gv_r, p)
    return postprocess(disp_l, disp_r, p)


def _delaunay_priors(
    support: torch.Tensor, h: int, w: int, p: ElasParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """The baseline's host part: the left support grid and its right-view
    re-projection are pulled to the host, each view's prior is a scipy
    Delaunay rasterisation, and both are pushed back to ``support``'s device.
    This round trip is the baseline's cost: do not move it to the device."""
    mu_l = triangulation.delaunay_prior(support.cpu().numpy(), h, w, p)
    sup_r = right_view_support(support, p)
    mu_r = triangulation.delaunay_prior(sup_r.cpu().numpy(), h, w, p)
    return (torch.as_tensor(mu_l, device=support.device),
            torch.as_tensor(mu_r, device=support.device))


def elas_baseline_disparity(img_left, img_right, p: ElasParams, device=None) -> torch.Tensor:
    """Original-ELAS baseline with host-side Delaunay (the [6]-style hybrid):
    (H, W) float32 left disparity, -1 where invalid.

    Not one device program by construction: the support grid is pulled to
    the host, triangulated irregularly, and the rasterised priors are pushed
    back (:func:`_delaunay_priors`).  The images are moved to ``device``
    (default ``cuda:0``; raises if no card is present).
    """
    dev = resolve_device(device)
    il = torch.as_tensor(img_left, device=dev)
    ir = torch.as_tensor(img_right, device=dev)
    h, w = il.shape[:2]
    dl, dr, support = ielas_support_stage(il, ir, p)
    mu_l, mu_r = _delaunay_priors(support, h, w, p)
    return _baseline_back_half(dl, dr, support, mu_l, mu_r, p)


def disparity_error(
    disp: torch.Tensor, ground_truth: torch.Tensor, invalid: float = -1.0
) -> torch.Tensor:
    """Paper Eq. (1): Error = (1/N) * sum |D - D*| / D*, over valid pixels.

    The float32 sum of the 2-D map is taken in XLA:CPU's order (on the
    host), so the result equals the reference's bit for bit."""
    ok = (disp != invalid) & (ground_truth > 0)
    rel = torch.where(ok, (disp - ground_truth).abs() / ground_truth.clamp(min=1e-6), 0.0)
    return xla_sum_f32(rel) / ok.sum().clamp(min=1)


def bad_pixel_rate(
    disp: torch.Tensor, ground_truth: torch.Tensor, tau: float = 3.0, invalid: float = -1.0
) -> torch.Tensor:
    """KITTI-style matching error: fraction of pixels off by more than tau
    (invalid estimates count as errors, as in the paper's Table III)."""
    gt_ok = ground_truth > 0
    wrong = (disp == invalid) | ((disp - ground_truth).abs() > tau)
    return (wrong & gt_ok).sum() / gt_ok.sum().clamp(min=1)
