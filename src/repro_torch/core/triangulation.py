"""Baseline: irregular Delaunay triangulation of the sparse support points
(copy of ``repro/core/triangulation.py``, numpy and scipy as there).

This is the *original ELAS* path that iELAS replaces.  Like the FPGA+ARM
system [6] the paper compares against, triangulation here runs on the HOST
(numpy/scipy) because its data-dependent control flow does not map onto the
accelerator -- which is exactly the overhead the paper's interpolation
removes.  It is kept as (a) the accuracy reference and (b) the performance
baseline for the Table IV comparison
(:func:`repro_torch.core.pipeline.elas_baseline_disparity`).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay

from repro_torch.core.params import ElasParams

INVALID = -1.0


def support_points_from_grid(grid: np.ndarray, p: ElasParams) -> np.ndarray:
    """(N, 3) array of (u, v, d) pixel-coordinate support points."""
    gh, gw = grid.shape
    step = p.candidate_step
    off = step // 2
    ii, jj = np.nonzero(grid != INVALID)
    u = jj * step + off
    v = ii * step + off
    d = grid[ii, jj]
    return np.stack([u, v, d], axis=1).astype(np.float64)


def add_corner_support(pts: np.ndarray, height: int, width: int) -> np.ndarray:
    """libelas' addCornerSupportPoints: anchor the four image corners with
    the disparity of the nearest support point so the mesh covers the image."""
    if len(pts) == 0:
        return pts
    corners = np.array(
        [[0.0, 0.0], [width - 1.0, 0.0], [0.0, height - 1.0], [width - 1.0, height - 1.0]]
    )
    out = [pts]
    for c in corners:
        k = np.argmin((pts[:, 0] - c[0]) ** 2 + (pts[:, 1] - c[1]) ** 2)
        out.append(np.array([[c[0], c[1], pts[k, 2]]]))
    return np.concatenate(out, axis=0)


def delaunay_prior(
    grid: np.ndarray, height: int, width: int, p: ElasParams
) -> np.ndarray:
    """Per-pixel plane prior mu (height, width) via true Delaunay rasterisation.

    Host-side; data-dependent triangle count and per-triangle scanline fill --
    the irregular computation the paper's interpolation eliminates.
    """
    pts = support_points_from_grid(grid, p)
    if len(pts) < 3:
        return np.full((height, width), p.const_fill, np.float32)
    pts = add_corner_support(pts, height, width)

    tri = Delaunay(pts[:, :2])
    mu = np.full((height, width), p.const_fill, np.float32)

    for simplex in tri.simplices:
        p0, p1, p2 = pts[simplex]
        # Plane d = a*u + b*v + c through the three support points.
        a_mat = np.array(
            [[p0[0], p0[1], 1.0], [p1[0], p1[1], 1.0], [p2[0], p2[1], 1.0]]
        )
        try:
            coef = np.linalg.solve(a_mat, np.array([p0[2], p1[2], p2[2]]))
        except np.linalg.LinAlgError:
            continue
        # Rasterise the triangle's bounding box with a barycentric inside test.
        umin = max(int(np.floor(min(p0[0], p1[0], p2[0]))), 0)
        umax = min(int(np.ceil(max(p0[0], p1[0], p2[0]))), width - 1)
        vmin = max(int(np.floor(min(p0[1], p1[1], p2[1]))), 0)
        vmax = min(int(np.ceil(max(p0[1], p1[1], p2[1]))), height - 1)
        if umax < umin or vmax < vmin:
            continue
        uu, vv = np.meshgrid(
            np.arange(umin, umax + 1), np.arange(vmin, vmax + 1)
        )
        det = (p1[1] - p2[1]) * (p0[0] - p2[0]) + (p2[0] - p1[0]) * (p0[1] - p2[1])
        if abs(det) < 1e-12:
            continue
        l0 = ((p1[1] - p2[1]) * (uu - p2[0]) + (p2[0] - p1[0]) * (vv - p2[1])) / det
        l1 = ((p2[1] - p0[1]) * (uu - p2[0]) + (p0[0] - p2[0]) * (vv - p2[1])) / det
        l2 = 1.0 - l0 - l1
        inside = (l0 >= -1e-9) & (l1 >= -1e-9) & (l2 >= -1e-9)
        vals = coef[0] * uu + coef[1] * vv + coef[2]
        sub = mu[vmin : vmax + 1, umin : umax + 1]
        mu[vmin : vmax + 1, umin : umax + 1] = np.where(inside, vals, sub)
    return mu.astype(np.float32)
