"""Plain PyTorch versions of the kernels on the frame path, and the shared math
(counterpart of ``repro/kernels/ref.py``).

These functions define what the CUDA kernels compute: the CPU path runs
them, and the card's kernels are held against them bit for bit.  A scan
over the disparity axis is a Python loop here and a loop inside the kernel
on the card.

The cost row at disparity ``d`` is

    CV[d, u] = sum_k | desc_L[u, k] - desc_R[u - d, k] |        (int32)

and the right view's row is its diagonal, ``CV_R[d, u] = CV[d, u + d]``, so
one sweep of ``d`` serves both views.
"""
from __future__ import annotations

import torch

from repro_torch.core.descriptor import descriptor_texture

BIG = 1 << 28
BIGF = 1e9
INVALID = -1.0


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for float32 tensors, rounded once as a fused multiply-add.

    The reference's XLA:CPU lowering contracts ``c + a * b`` into an FMA; the
    port reproduces that rounding to stay bit-exact.  The product of two
    float32 values is exact in float64, and the float64 sum is exact whenever
    the operands' bits span at most 53 places (always so at the magnitudes of
    disparities and sub-pixel fractions), so rounding it to float32 gives the
    FMA's result on every device.
    """
    return (a.double() * b.double() + c.double()).float()


def _sad_rows(desc_l: torch.Tensor, desc_r: torch.Tensor):
    """SAD-row helpers for the disparity sweeps.

    ``sad_row(d)`` is the (bh, W) int32 SAD row ``|dl[u] - dr[u - d]|``
    (zero where ``u < d``; callers mask it), and ``shift_left(row, d, fill)``
    its right-view diagonal ``row[u + d]`` (``fill`` past the right edge).
    """
    w = desc_l.shape[1]
    dl = desc_l.to(torch.int32)
    dr = desc_r.to(torch.int32)

    def sad_row(d: int) -> torch.Tensor:
        out = torch.zeros(dl.shape[:2], dtype=torch.int32, device=dl.device)
        if d < w:
            out[:, d:] = (dl[:, d:] - dr[:, : w - d]).abs().sum(dim=-1, dtype=torch.int32)
        return out

    def shift_left(row: torch.Tensor, d: int, fill: int) -> torch.Tensor:
        out = torch.full_like(row, fill)
        if d < w:
            out[:, : w - d] = row[:, d:]
        return out

    return sad_row, shift_left


# --------------------------------------------------------------------------
# streaming disparity scan: running-best registers over d
# --------------------------------------------------------------------------
# Four registers reproduce (argmin, min, second-min outside +-1 of argmin)
# exactly: the +-1 exclusion zone holds at most 3 entries, so the smallest
# kept cost outside the zone is the true excluded second minimum.  Strict-<
# insertion keeps ties at the smallest d, matching argmin.

def _insert4(vals: list, idxs: list, v: torch.Tensor, d: int) -> tuple[list, list]:
    """Insert cost ``v`` at disparity ``d`` into sorted 4-deep registers."""
    v1, v2, v3, v4 = vals
    i1, i2, i3, i4 = idxs
    dt = torch.full_like(i1, d)
    b1, b2, b3, b4 = v < v1, v < v2, v < v3, v < v4
    n_v1 = torch.where(b1, v, v1)
    n_i1 = torch.where(b1, dt, i1)
    n_v2 = torch.where(b1, v1, torch.where(b2, v, v2))
    n_i2 = torch.where(b1, i1, torch.where(b2, dt, i2))
    n_v3 = torch.where(b2, v2, torch.where(b3, v, v3))
    n_i3 = torch.where(b2, i2, torch.where(b3, dt, i3))
    n_v4 = torch.where(b3, v3, torch.where(b4, v, v4))
    n_i4 = torch.where(b3, i3, torch.where(b4, dt, i4))
    return [n_v1, n_v2, n_v3, n_v4], [n_i1, n_i2, n_i3, n_i4]


def _init4(shape: tuple, device) -> tuple[list, list]:
    """BIG-valued, index-0 registers: matches argmin==0 on all-BIG columns."""
    vals = [torch.full(shape, BIG, dtype=torch.int32, device=device) for _ in range(4)]
    idxs = [torch.zeros(shape, dtype=torch.int32, device=device) for _ in range(4)]
    return vals, idxs


def _finalize4(vals: list, idxs: list) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best, min1, min2) from 4-deep registers; min2 excludes |d - best| <= 1."""
    best, min1 = idxs[0], vals[0]
    min2 = torch.full_like(min1, BIG)
    for k in (1, 2, 3):
        min2 = torch.minimum(min2, torch.where((idxs[k] - best).abs() > 1, vals[k], BIG))
    return best, min1, min2


# --------------------------------------------------------------------------
# support search
# --------------------------------------------------------------------------
def _support_decision(
    best_l: torch.Tensor,       # (bh, GW) int32 -- left argmin at candidates
    min1_l: torch.Tensor,
    min2_l: torch.Tensor,
    best_r: torch.Tensor,       # (bh, W) int32 -- right argmin everywhere
    min1_r: torch.Tensor,
    min2_r: torch.Tensor,
    desc_l: torch.Tensor,       # (bh, W, 16) int8
    desc_r: torch.Tensor,
    *,
    step: int,
    offset: int,
    support_texture: int,
    support_ratio: float,
    lr_threshold: int,
    disp_min: int,
) -> torch.Tensor:
    """Texture / uniqueness / L-R tests shared by both support formulations.

    The ratio test is float32 (``float(min1) < float32(ratio) * float(min2)``)
    as in the reference; the cross check reads the right view's result at
    ``clip(u - best_l, 0, W - 1)``.
    """
    w = desc_l.shape[1]
    gw = best_l.shape[-1]
    us = torch.arange(gw, device=desc_l.device) * step + offset
    tex_l = descriptor_texture(desc_l)[:, offset : offset + (gw - 1) * step + 1 : step]
    ok_l = (
        (min1_l.float() < support_ratio * min2_l.float())
        & (tex_l >= support_texture)
        & (min1_l < BIG)
    )
    ok_r = (
        (min1_r.float() < support_ratio * min2_r.float())
        & (descriptor_texture(desc_r) >= support_texture)
        & (min1_r < BIG)
    )
    ur = (us[None, :] - best_l).clamp(0, w - 1).long()
    d_r_at = torch.gather(best_r, 1, ur)
    ok_r_at = torch.gather(ok_r, 1, ur)
    consistent = (best_l - d_r_at).abs() <= lr_threshold
    margin_ok = us >= disp_min + 2
    valid = ok_l & ok_r_at & consistent & margin_ok[None, :]
    return torch.where(valid, best_l.float(), INVALID)


def _cost_row(sad_row, d: int) -> torch.Tensor:
    """Support cost row at ``d``: the SAD row with BIG where ``u - d < 0``."""
    row = sad_row(d)
    row[:, :d] = BIG
    return row


def support_match_rows_ref(
    desc_l: torch.Tensor,       # (bh, W, 16) int8 -- candidate rows of left image
    desc_r: torch.Tensor,       # (bh, W, 16) int8
    *,
    num_disp: int,
    step: int,
    offset: int,
    support_texture: int,
    support_ratio: float,
    lr_threshold: int,
    disp_min: int,
) -> torch.Tensor:
    """MATERIALISED support oracle: stacks the (bh, D, W) volumes and reduces
    them with argmin / min.  Ground truth for the streaming scan in tests;
    not used on the frame path."""
    w = desc_l.shape[1]
    gw = w // step
    sad_row, shift_left = _sad_rows(desc_l, desc_r)
    rows = [_cost_row(sad_row, d) for d in range(num_disp)]
    cv = torch.stack(rows, dim=1)                                    # (bh, D, W)
    cv_r = torch.stack([shift_left(r, d, BIG) for d, r in enumerate(rows)], dim=1)

    def best_two(cost):
        best = torch.argmin(cost, dim=1).to(torch.int32)
        min1 = cost.amin(dim=1)
        d_idx = torch.arange(cost.shape[1], device=cost.device)[None, :, None]
        near = (d_idx - best[:, None, :]).abs() <= 1
        min2 = torch.where(near, BIG, cost).amin(dim=1)
        return best, min1, min2

    best_l, min1_l, min2_l = best_two(cv[:, :, offset : offset + (gw - 1) * step + 1 : step])
    best_r, min1_r, min2_r = best_two(cv_r)
    return _support_decision(
        best_l, min1_l, min2_l, best_r, min1_r, min2_r, desc_l, desc_r,
        step=step, offset=offset, support_texture=support_texture,
        support_ratio=support_ratio, lr_threshold=lr_threshold, disp_min=disp_min,
    )


def support_match_rows_streaming(
    desc_l: torch.Tensor,       # (bh, W, 16) int8 -- candidate rows of left image
    desc_r: torch.Tensor,       # (bh, W, 16) int8
    *,
    num_disp: int,
    step: int,
    offset: int,
    support_texture: int,
    support_ratio: float,
    lr_threshold: int,
    disp_min: int,
) -> torch.Tensor:
    """Streaming support search: one loop over ``d`` in ``[0, num_disp)``.

    Returns (bh, W // step) float32: disparity or INVALID.  Each step folds
    one cost row into 4-deep (value, d) registers for the left view at the
    candidate columns ``offset + j * step`` and, through the diagonal
    ``CV_R[d, u] = CV[d, u + d]``, for the right view at every column.  As
    in the reference, the sweep starts at 0 whatever ``disp_min`` is;
    ``disp_min`` only enters the margin test ``u >= disp_min + 2``.
    """
    bh, w, _ = desc_l.shape
    gw = w // step
    sad_row, shift_left = _sad_rows(desc_l, desc_r)
    left = _init4((bh, gw), desc_l.device)
    right = _init4((bh, w), desc_l.device)
    for d in range(num_disp):
        cost = _cost_row(sad_row, d)
        cand = cost[:, offset : offset + (gw - 1) * step + 1 : step]
        left = _insert4(*left, cand, d)
        right = _insert4(*right, shift_left(cost, d, BIG), d)
    best_l, min1_l, min2_l = _finalize4(*left)
    best_r, min1_r, min2_r = _finalize4(*right)
    return _support_decision(
        best_l, min1_l, min2_l, best_r, min1_r, min2_r, desc_l, desc_r,
        step=step, offset=offset, support_texture=support_texture,
        support_ratio=support_ratio, lr_threshold=lr_threshold, disp_min=disp_min,
    )


# --------------------------------------------------------------------------
# streaming dense matching: scan-over-d candidate folding (gather-free)
# --------------------------------------------------------------------------
def upsample_cells(cells: torch.Tensor, w: int, cell_px: int) -> torch.Tensor:
    """(bh, CW) per-grid-cell values -> (bh, W) per-pixel columns.

    Pixel column ``u`` reads cell ``min(u // cell_px, CW - 1)``: each cell
    covers ``cell_px`` columns and the tail extends the last cell.
    """
    cols = (torch.arange(w, device=cells.device) // cell_px).clamp_(max=cells.shape[1] - 1)
    return cells[:, cols]


def dense_match_rows_stream_ref(
    desc_l: torch.Tensor,       # (bh, W, 16) int8
    desc_r: torch.Tensor,       # (bh, W, 16) int8
    mu_l: torch.Tensor,         # (bh, W) float32 plane prior
    mu_r: torch.Tensor,         # (bh, W) float32
    gmask_l: torch.Tensor,      # (bh, CW, D) bool grid-vector bitmask rows
    gmask_r: torch.Tensor,      # (bh, CW, D) bool
    *,
    num_disp: int,
    disp_min: int,
    plane_radius: int,
    cell_px: int,
    beta: float,
    gamma: float,
    sigma: float,
    match_texture: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming dense matching for both views: one loop over
    ``d`` in ``[disp_min, disp_min + num_disp)``.

    At each ``d`` a pixel's candidate mask is its cell's bitmask bit OR the
    band ``clip(round(mu) - R) <= d <= clip(round(mu) + R)``; where the mask
    holds and the matching column is inside the image, the energy

        beta * SAD - log(gamma + exp(-(d - mu)^2 / (2 sigma^2)))

    (float32, each operation rounded on its own) is folded into running
    (best energy, best d) registers with a strict ``<``.  ``exp`` and
    ``log`` are evaluated in float64 and rounded to float32: that makes them
    correctly rounded on every device (float32 libraries, XLA's among them,
    are not, and differ from each other in the last bit), so the CPU, the
    card's plain version and the CUDA kernel agree bit for bit.  Returns
    (disp_l, disp_r), each (bh, W) float32 with INVALID where no candidate
    was valid or the texture is below ``match_texture``.
    """
    bh, w, _ = desc_l.shape
    dev = desc_l.device
    sad_row, shift_left = _sad_rows(desc_l, desc_r)
    u = torch.arange(w, device=dev)[None, :]
    lo_d = float(disp_min)
    hi_d = float(disp_min + num_disp - 1)
    # A device tensor, so the division is a true division on every device
    # (a Python scalar divisor becomes a reciprocal multiply on CUDA).
    two_s2 = torch.tensor(2.0 * sigma * sigma, dtype=torch.float32, device=dev)

    def prior_band(mu):
        r = torch.round(mu)
        return (r - plane_radius).clamp(lo_d, hi_d), (r + plane_radius).clamp(lo_d, hi_d)

    band_l = prior_band(mu_l)
    band_r = prior_band(mu_r)

    def update(state, sad, valid, mu, band, gcells, d):
        best_e, best_d = state
        df = float(d)
        mask = upsample_cells(gcells, w, cell_px) | ((band[0] <= df) & (band[1] >= df))
        diff = df - mu
        x = (-(diff * diff) / two_s2).double()
        prior = -torch.log((gamma + torch.exp(x).float()).double()).float()
        e = beta * sad.float() + prior
        e = torch.where(mask & valid, e, BIGF)
        better = e < best_e
        return torch.where(better, e, best_e), torch.where(better, d, best_d)

    def init():
        return (torch.full((bh, w), BIGF, dtype=torch.float32, device=dev),
                torch.zeros((bh, w), dtype=torch.int32, device=dev))

    left, right = init(), init()
    for i in range(num_disp):
        d = disp_min + i
        sad = sad_row(d)
        left = update(left, sad, u >= d, mu_l, band_l, gmask_l[:, :, i], d)
        right = update(right, shift_left(sad, d, 0), u + d < w, mu_r, band_r,
                       gmask_r[:, :, i], d)

    def finish(state, desc):
        emin, best = state
        valid = (emin < BIGF) & (descriptor_texture(desc) >= match_texture)
        return torch.where(valid, best.float(), INVALID)

    return finish(left, desc_l), finish(right, desc_r)


# --------------------------------------------------------------------------
# median
# --------------------------------------------------------------------------
def median9(vals: list) -> torch.Tensor:
    """Median of 9 elementwise tensors via Paeth's 19-op min/max network
    (value-identical to ``sort(...)[..., 4]``)."""
    if len(vals) != 9:
        raise ValueError(f"median9 needs 9 tensors, got {len(vals)}")
    v = list(vals)
    # Paeth, "Median Finding on a 3x3 Grid" (Graphics Gems).
    pairs = (
        (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7),
        (1, 2), (4, 5), (7, 8), (0, 3), (5, 8), (4, 7),
        (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4),
        (4, 2),
    )
    for i, j in pairs:
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[4]
