"""Synthetic stereo scene generator with ground-truth disparity
(numpy copy of ``repro/data/stereo.py``: single pairs and coherent video
sequences).

Neither New Tsukuba nor KITTI ships with this repository, so frames are
procedurally generated: piecewise-planar geometry (slanted planes, the
scene model ELAS' prior assumes) with band-limited texture, warped to the
left view through the ground-truth disparity.  Lighting conditions are
gain/bias/gamma/noise perturbations applied asymmetrically to the views.
The same seed gives the same bytes as the reference generator.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Lighting:
    name: str
    gain: float          # right-view brightness gain
    bias: float          # right-view brightness offset
    gamma: float         # right-view gamma
    noise_std: float     # additive gaussian noise (both views)


LIGHTING_CONDITIONS: dict[str, Lighting] = {
    "daylight": Lighting("daylight", 1.00, 0.0, 1.00, 1.0),
    "flashlight": Lighting("flashlight", 1.10, 8.0, 0.95, 2.0),
    "fluorescent": Lighting("fluorescent", 0.92, -5.0, 1.05, 3.0),
    "lamps": Lighting("lamps", 0.80, -15.0, 1.15, 5.0),
}


def _smooth_noise(rng: np.random.Generator, h: int, w: int, scale: int) -> np.ndarray:
    """Band-limited texture: upsampled white noise."""
    coarse = rng.standard_normal((h // scale + 2, w // scale + 2))
    ys = np.linspace(0, coarse.shape[0] - 1.001, h)
    xs = np.linspace(0, coarse.shape[1] - 1.001, w)
    y0 = ys.astype(int)
    x0 = xs.astype(int)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    tl = coarse[y0][:, x0]
    tr = coarse[y0][:, x0 + 1]
    bl = coarse[y0 + 1][:, x0]
    br = coarse[y0 + 1][:, x0 + 1]
    return (1 - fy) * ((1 - fx) * tl + fx * tr) + fy * ((1 - fx) * bl + fx * br)


def _plane_disparity(
    rng: np.random.Generator, h: int, w: int, d_min: float, d_max: float, n_objects: int
) -> np.ndarray:
    """Piecewise-planar ground-truth disparity (background + slanted boxes)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    # Slanted background plane (floor-like: disparity grows towards the bottom).
    d0 = d_min + 2.0
    disp = d0 + (d_max * 0.35 - d0) * (yy / h) + rng.uniform(-0.5, 0.5)
    for _ in range(n_objects):
        ow = int(rng.uniform(0.12, 0.35) * w)
        oh = int(rng.uniform(0.12, 0.35) * h)
        ox = int(rng.uniform(0, w - ow))
        oy = int(rng.uniform(0, h - oh))
        base = rng.uniform(d_max * 0.4, d_max * 0.9)
        gx = rng.uniform(-0.03, 0.03)
        gy = rng.uniform(-0.03, 0.03)
        plane = base + gx * (xx[oy : oy + oh, ox : ox + ow] - ox) + gy * (
            yy[oy : oy + oh, ox : ox + ow] - oy
        )
        region = disp[oy : oy + oh, ox : ox + ow]
        # Objects occlude: nearer surface (larger disparity) wins.
        disp[oy : oy + oh, ox : ox + ow] = np.maximum(region, plane)
    return np.clip(disp, d_min + 1.0, d_max - 1.0)


def _render_window(
    tex: np.ndarray,          # (H, margin + wide_w + 2) right-view texture
    disp_wide: np.ndarray,    # (H, wide_w) ground-truth disparity
    x0: int,                  # window offset into the wide scene
    width: int,
    margin: int,              # left texture margin (>= d_max, so x - D
                              # never falls off the texture)
    light: Lighting,
    noise_rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Render one (left, right, gt) frame as a ``width``-wide window into a
    wide static scene -- the sliding window IS the camera pan, so the
    ground truth of consecutive windows overlaps exactly."""
    height = disp_wide.shape[0]
    disp = disp_wide[:, x0 : x0 + width]
    img_r = tex[:, margin + x0 : margin + x0 + width].copy()

    # I_L(y, x) = texture(y, x0 + x - D): the margin keeps x - D on-texture.
    xs = margin + x0 + np.arange(width)[None, :] - disp
    x0i = xs.astype(int)
    fx = xs - x0i
    rows = np.arange(height)[:, None] + np.zeros((1, width), int)
    img_l = (1 - fx) * tex[rows, x0i] + fx * tex[rows, x0i + 1]

    img_r = np.clip(light.gain * img_r + light.bias, 1.0, 255.0)
    img_r = 255.0 * (img_r / 255.0) ** light.gamma
    img_l = img_l + noise_rng.normal(0, light.noise_std, img_l.shape)
    img_r = img_r + noise_rng.normal(0, light.noise_std, img_r.shape)
    return (
        np.clip(img_l, 0, 255).astype(np.uint8),
        np.clip(img_r, 0, 255).astype(np.uint8),
        disp.astype(np.float32),
    )


def synthetic_stereo_sequence(
    n_frames: int,
    height: int = 120,
    width: int = 160,
    d_max: float = 48.0,
    n_objects: int = 4,
    motion: int = 2,
    cut_at: int | None = None,
    lighting: str = "daylight",
    seed: int = 0,
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """A temporally coherent stereo video: ``n_frames`` of
    ``(img_left uint8, img_right uint8, disparity float32)``.

    Each scene is generated ONCE as a wide static world
    (``width + (n-1) * motion`` columns) and frame *t* is the window at
    ``x0 = t * motion`` -- a rightward camera pan.  Because the frames are
    literal windows into one static ground truth, temporal consistency is
    exact: ``gt[t][:, motion:] == gt[t+1][:, :-motion]`` (no resampling,
    no drift), which is what makes the sequence usable for warm-start
    conformance tests.  Per-frame sensor noise still advances a separate
    rng, so consecutive frames differ the way real video does.

    ``cut_at`` injects a hard scene cut: frames ``>= cut_at`` come from an
    independently seeded second scene (its pan restarting at 0), so a
    scene-change detector must fire between ``cut_at - 1`` and ``cut_at``.
    """
    if n_frames < 1:
        raise ValueError(f"n_frames must be >= 1, got {n_frames}")
    if motion < 0:
        raise ValueError(f"motion must be >= 0, got {motion}")
    if cut_at is not None and not 1 <= cut_at < n_frames:
        raise ValueError(
            f"cut_at must be in [1, n_frames), got {cut_at} of {n_frames}"
        )
    light = LIGHTING_CONDITIONS[lighting]
    margin = int(d_max) + 1
    if cut_at is None:
        segments = [(n_frames, seed)]
    else:
        # A large odd stride keeps the second scene's rng stream disjoint
        # from the first's for any practical seed.
        segments = [(cut_at, seed), (n_frames - cut_at, seed + 7919)]
    noise_rng = np.random.default_rng(seed + 104729)

    frames: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for seg_frames, seg_seed in segments:
        rng = np.random.default_rng(seg_seed)
        wide_w = width + (seg_frames - 1) * motion
        disp_wide = _plane_disparity(rng, height, wide_w, 0.0, d_max, n_objects)
        tex = (
            110.0
            + 55.0 * _smooth_noise(rng, height, margin + wide_w + 2, 6)
            + 25.0 * _smooth_noise(rng, height, margin + wide_w + 2, 2)
        )
        for i in range(seg_frames):
            frames.append(_render_window(
                tex, disp_wide, i * motion, width, margin, light, noise_rng
            ))
    return frames


def synthetic_stereo_pair(
    height: int = 120,
    width: int = 160,
    d_max: float = 48.0,
    n_objects: int = 4,
    lighting: str = "daylight",
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (img_left uint8, img_right uint8, disparity float32).

    Disparity is in LEFT-view coordinates: I_L(y, x) ~ I_R(y, x - D(y, x)).
    """
    rng = np.random.default_rng(seed)
    light = LIGHTING_CONDITIONS[lighting]

    disp = _plane_disparity(rng, height, width, 0.0, d_max, n_objects)

    # Texture lives on the RIGHT view; the left view samples it through D.
    tex = (
        110.0
        + 55.0 * _smooth_noise(rng, height, width + int(d_max) + 2, 6)
        + 25.0 * _smooth_noise(rng, height, width + int(d_max) + 2, 2)
    )
    xx = np.arange(width)[None, :] + np.zeros((height, 1))
    img_r = tex[:, :width].copy()

    # I_L(y, x) = texture(y, x - D): sample with linear interpolation.
    xs = xx - disp
    xs = np.clip(xs, 0, tex.shape[1] - 1.001)
    x0 = xs.astype(int)
    fx = xs - x0
    rows = np.arange(height)[:, None] + np.zeros((1, width), int)
    img_l = (1 - fx) * tex[rows.astype(int), x0] + fx * tex[rows.astype(int), x0 + 1]

    # Lighting perturbation on the right view + sensor noise on both.
    img_r = np.clip(light.gain * img_r + light.bias, 1.0, 255.0)
    img_r = 255.0 * (img_r / 255.0) ** light.gamma
    img_l = img_l + rng.normal(0, light.noise_std, img_l.shape)
    img_r = img_r + rng.normal(0, light.noise_std, img_r.shape)

    return (
        np.clip(img_l, 0, 255).astype(np.uint8),
        np.clip(img_r, 0, 255).astype(np.uint8),
        disp.astype(np.float32),
    )
