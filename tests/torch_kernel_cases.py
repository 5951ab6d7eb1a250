"""Kernel test inputs shared by the CPU tests (held against the JAX
package) and the card tests (which run where JAX is not installed): tiny
sizes, odd widths, crafted ties (periodic and constant descriptors,
half-integer and integer priors), columns whose whole sweep runs off the
image, and ``disp_min > 0``, all made with numpy from fixed seeds.

The dense cases also reach the edges of the CUDA kernels' layouts: the
stream kernel packs the bitmask into 32-bit words per cell (D = 40 and
D = 100 end inside a word) and takes a row in tiles of 128 pixels (widths
below a tile and one past it); the candidate-window kernel stages windows
32 slots at a time (C = 40 takes two passes), keeps a seen-set over
disp_min + [0, 256), and takes the flat pixels of a frame in blocks of 128
(3 x 43 = 129 is one past a block)."""
import numpy as np

SUPPORT_KW = dict(step=5, offset=2, support_texture=10, support_ratio=0.85, lr_threshold=2)


def _desc(rng, shape, kind):
    if kind == "random":
        return rng.integers(-40, 41, shape).astype(np.int8)
    if kind == "ternary":           # low entropy: many equal costs
        return rng.integers(-1, 2, shape).astype(np.int8)
    if kind == "periodic":          # a period-4 row: costs tie at d and d + 4
        base = rng.integers(-30, 31, (shape[0], 4, shape[2])).astype(np.int8)
        return np.tile(base, (1, -(-shape[1] // 4), 1))[:, : shape[1]].copy()
    if kind == "zero":              # every cost 0, no texture
        return np.zeros(shape, np.int8)
    if kind == "runs":              # columns in equal pairs: costs tie at d and d + 1
        base = rng.integers(-40, 41, (shape[0], -(-shape[1] // 2), shape[2])).astype(np.int8)
        return np.repeat(base, 2, axis=1)[:, : shape[1]].copy()
    raise ValueError(kind)


# (id, rows, width, num_disp, disp_min, left kind, right kind, seed).  The
# support kernel takes a row whole in one block when it is narrower than 256
# columns, else (with few rows, as here) in 8 spans of columns, one block
# each (8 spans of 36 at W = 257, one column past 8 spans of 32, the last
# holding 5 columns; the KITTI and Tsukuba rows); right-view columns in
# groups of 4 and d in chunks of 32 (D = 40 and 100 end inside a chunk);
# "runs" descriptors with the right view shifted by 32 tie the least cost at
# d = 31 and 32, on both sides of a chunk boundary.
SUPPORT_CASES = [
    ("random-w37-d16", 3, 37, 16, 0, "random", "random", 0),
    ("ternary-w53-d24", 2, 53, 24, 0, "ternary", "ternary", 1),
    ("periodic-w41-d16", 2, 41, 16, 0, "periodic", "periodic", 2),
    ("zero-w21-d8", 1, 21, 8, 0, "zero", "zero", 3),
    ("dmin4-w47-d20", 3, 47, 20, 4, "random", "random", 4),
    ("sweep-past-edge-w13-d24", 2, 13, 24, 0, "random", "random", 5),
    ("span-plus-one-w257-d40", 2, 257, 40, 0, "random", "random", 6),
    ("chunk-end-w133-d100", 2, 133, 100, 0, "random", "random", 7),
    ("ties-across-chunks-w97-d64", 2, 97, 64, 0, "runs", "shift32", 8),
    ("kitti-2-rows-w1242-d128", 2, 1242, 128, 0, "random", "random", 10),
    ("tsukuba-2-rows-w640-d64", 2, 640, 64, 0, "random", "random", 11),
]

# Support cases for the card only (the plain version takes seconds there):
# 90 rows cover two thirds of an H100's 132 SMs, so the kernel gives a row
# one block, unless its span would not fit shared memory; these widths give
# 2, 4 and 8 blocks a row.
SUPPORT_WIDE_CASES = [
    ("wide-2-blocks-w5800-d32", 90, 5800, 32, 0, "random", "random", 12),
    ("wide-4-blocks-w11600-d32", 90, 11600, 32, 0, "random", "random", 13),
    ("wide-8-blocks-w23200-d32", 90, 23200, 32, 0, "random", "random", 14),
]


def support_inputs(case):
    _, rows, w, nd, dmin, kl, kr, seed = case
    rng = np.random.default_rng(seed)
    dl = _desc(rng, (rows, w, 16), kl)
    if kr == "shift32":
        dr = _desc(rng, (rows, w, 16), "random")
        dr[:, : w - 32] = dl[:, 32:]
    else:
        dr = _desc(rng, (rows, w, 16), kr)
    if kl == "random" and kr == "random":
        # Make the right view a shifted copy of the left, so support points exist.
        shift = rng.integers(1, max(2, min(nd, w) - 1))
        dr[:, : w - shift] = dl[:, shift:]
    return dl, dr, dict(num_disp=nd, disp_min=dmin, **SUPPORT_KW)


# (id, rows, width, num_disp, disp_min, cell_px, mask density, mu kind, desc kind, texture, seed)
DENSE_CASES = [
    ("random-w37-d16", 3, 37, 16, 0, 5, 0.2, "spread", "random", 1, 0),
    ("dmin4-w29-d12", 2, 29, 12, 4, 4, 0.3, "spread", "random", 1, 1),
    ("band-only-w31-d16", 2, 31, 16, 0, 5, 0.0, "spread", "random", 1, 2),
    ("far-prior-w23-d10", 2, 23, 10, 3, 7, 0.0, "far", "random", 1, 3),
    ("tie-half-prior-w19-d12", 2, 19, 12, 0, 5, 0.0, "half", "zero", 0, 4),
    ("texture-gate-w17-d8", 1, 17, 8, 0, 5, 0.5, "spread", "ternary", 40, 5),
    ("all-off-image-w9-d20", 2, 9, 20, 6, 3, 0.4, "spread", "random", 1, 6),
    ("words-d40-dmin4-w57", 2, 57, 40, 4, 6, 0.15, "spread", "random", 1, 7),
    ("words-d100-dmin4-w61", 2, 61, 100, 4, 7, 0.1, "spread", "random", 1, 8),
    ("tile-plus-one-w129-d40", 2, 129, 40, 0, 20, 0.15, "spread", "random", 1, 9),
    ("tie-integer-prior-w43-d24", 2, 43, 24, 0, 5, 0.3, "integer", "zero", 0, 10),
]


def _tie_prior(rng, kind, lo, hi, shape):
    """Priors on which candidates tie on the prior energy: half-integer
    (d = mu -/+ 1/2 tie), or integer (d = mu -/+ k tie, for every k)."""
    if kind == "half":
        return rng.integers(lo, hi, shape) + 0.5
    if kind == "integer":
        return rng.integers(lo, hi + 1, shape).astype(np.float64)
    raise ValueError(kind)


def dense_inputs(case):
    _, h, w, nd, dmin, cell_px, density, mu_kind, dkind, tex, seed = case
    rng = np.random.default_rng(seed)
    dl = _desc(rng, (h, w, 16), dkind)
    dr = _desc(rng, (h, w, 16), dkind)
    lo, hi = dmin, dmin + nd - 1
    if mu_kind == "spread":
        mu = rng.uniform(lo - 3, hi + 3, (2, h, w))
    elif mu_kind == "far":
        mu = np.stack([np.full((h, w), lo - 40.0), np.full((h, w), hi + 40.0)])
    else:
        mu = _tie_prior(rng, mu_kind, lo, hi, (2, h, w))
    cw = max(1, w // cell_px)
    gm = rng.uniform(size=(2, h, cw, nd)) < density
    kw = dict(num_disp=nd, disp_min=dmin, plane_radius=2, cell_px=cell_px, beta=0.02,
              gamma=3.0, sigma=1.0, match_texture=tex)
    return dl, dr, mu.astype(np.float32), gm, kw


# Candidate-window cases: (id, rows, width, num_disp, disp_min, candidates, mu kind,
# desc kind, texture, window kind, seed).  Candidates repeat values, run off the
# image at both edges, and (with "half" or "integer" priors and constant
# descriptors) tie on energy.  Window kinds: "domain" draws values from
# [disp_min, disp_min + D), as candidate_set clips them; "wide" also below
# disp_min (negative ones too) and at or above disp_min + D; "constant" gives
# every slot of a window one value.
WINDOWED_CASES = [
    ("random-w37-d16", 3, 37, 16, 0, 9, "spread", "random", 1, "domain", 10),
    ("dmin4-w29-d12", 2, 29, 12, 4, 9, "spread", "random", 1, "domain", 11),
    ("tie-half-prior-w19-d12", 2, 19, 12, 0, 7, "half", "zero", 0, "domain", 12),
    ("wide-values-d40-dmin4-w57", 2, 57, 40, 4, 25, "spread", "random", 1, "wide", 13),
    ("constant-windows-d100-dmin4-w61", 2, 61, 100, 4, 25, "spread", "random", 1, "constant",
     14),
    ("block-plus-one-3x43-d24", 3, 43, 24, 0, 25, "spread", "random", 1, "domain", 15),
    ("tie-integer-prior-w43-d24", 2, 43, 24, 0, 25, "integer", "zero", 0, "domain", 16),
    ("two-passes-c40-w37-d64", 2, 37, 64, 0, 40, "spread", "random", 1, "domain", 17),
]


def windowed_inputs(case):
    _, h, w, nd, dmin, c, mu_kind, dkind, tex, window, seed = case
    rng = np.random.default_rng(seed)
    dl = _desc(rng, (h, w, 16), dkind)
    dr = _desc(rng, (h, w, 16), dkind)
    lo, hi = dmin, dmin + nd - 1
    if mu_kind == "spread":
        mu = rng.uniform(lo - 3, hi + 3, (2, h, w))
    else:
        mu = _tie_prior(rng, mu_kind, lo, hi, (2, h, w))
    if window == "wide":
        cand = rng.integers(lo - 8, hi + 9, (2, h, w, c))
    else:
        cand = rng.integers(lo, hi + 1, (2, h, w, c))
    if window == "constant":
        cand[...] = cand[..., :1]
    else:
        cand[..., 1] = cand[..., 0]                 # a repeated value in every window
    kw = dict(num_disp=nd, disp_min=dmin, beta=0.02, gamma=3.0, sigma=1.0, match_texture=tex)
    return dl, dr, mu.astype(np.float32), cand.astype(np.int32), kw


# Sobel images: (id, height, width, dtype, least grey level, seed).  Floats
# carry fractions, which the int32 cast truncates toward zero (negative ones
# too); 1-row and 1-column images take every edge clamp.  The kernel reads
# each type as it is, a thread taking 16 columns down 2 rows (widths 1, 15,
# 17, 33, 129 and 200: below, at and past 16 columns, rows ending inside a
# chunk; odd heights: a strip past the last row), rows at any offset.
SOBEL_CASES = [
    ("uint8-17x33", 17, 33, np.uint8, 0, 0),
    ("int32-16x24", 16, 24, np.int32, 0, 1),
    ("float32-5x7", 5, 7, np.float32, 0, 2),
    ("float32-1x9", 1, 9, np.float32, 0, 3),
    ("uint8-8x1", 8, 1, np.uint8, 0, 4),
    ("float32-negative-6x15", 6, 15, np.float32, -256, 5),
    ("uint8-9x17", 9, 17, np.uint8, 0, 6),
    ("int32-negative-12x33", 12, 33, np.int32, -300, 7),
    ("uint8-1x200", 1, 200, np.uint8, 0, 8),
    ("float32-10x129", 10, 129, np.float32, -20, 9),
]


def sobel_image(case):
    _, h, w, dtype, low, seed = case
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.uniform(low, 256, (h, w)).astype(np.float32)
    return rng.integers(low, 256, (h, w)).astype(dtype)


# Median maps: (id, height, width, invalid share, invalid middle row, seed).
# Integral disparities (many equal values), some halves, invalid pixels,
# and a fully invalid middle row.  The kernel takes 4 columns a thread and
# 128 a warp, 2 rows a thread and 8 a block: maps of 1 row or 1 column (every
# edge clamp), widths that end inside a thread's 4 columns and one or two
# past a warp, heights that end inside a block, maps with no invalid pixel
# (every window on the kernel's arithmetic without a -1) and with only
# invalid ones.
MEDIAN_CASES = [
    ("9x9-p20", 9, 9, 0.2, True, 0),
    ("16x31-p20", 16, 31, 0.2, True, 1),
    ("7x50-p50", 7, 50, 0.5, True, 2),
    ("2x3-p0", 2, 3, 0.0, True, 3),
    ("1x1-p0", 1, 1, 0.0, False, 4),
    ("1x1-invalid", 1, 1, 1.0, False, 5),
    ("1x37-p30", 1, 37, 0.3, False, 6),
    ("23x1-p30", 23, 1, 0.3, False, 7),
    ("5x130-no-invalid", 5, 130, 0.0, False, 8),
    ("9x133-all-invalid", 9, 133, 1.0, False, 9),
    ("13x257-p25", 13, 257, 0.25, True, 10),
    ("3x6-p40", 3, 6, 0.4, False, 11),
]


def median_map(case):
    _, h, w, share, middle_row, seed = case
    rng = np.random.default_rng(seed)
    disp = rng.integers(0, 64, (h, w)).astype(np.float32)
    disp[rng.random((h, w)) < 0.5] += 0.5
    disp[rng.random((h, w)) < share] = -1.0
    if middle_row and h > 2:
        disp[h // 2] = -1.0
    return disp


def median_stack(case):
    """Two maps of a case (the second flipped), a stack as a wave gives the
    kernel."""
    disp = median_map(case)
    return np.stack([disp, disp[::-1, ::-1].copy()])


# Warm band cases: (id, rows, width, num_disp, disp_min, warm_band, mu kind,
# desc kind, texture, seed[, frames]).  Bands at either end of the search
# range and beyond it, of width 0 and wider than the range, cut by the image
# on both views, ties on the prior energy (half-integer and integer priors
# with constant descriptors), the texture gate, a NaN prior (an empty band).
# The kernel's paths: a block per row in equal passes of at most 1024
# threads (1025 wide: one past a pass), rows too wide to stage in shared
# memory (7265: read from global memory), a band of 81 candidates, priors
# whose energies overflow the fast reciprocal's range (+-1.5e19: those
# pixels divide, their neighbours do not), a stack of three frames
# (``frames``; the arrays then carry a leading frame axis), and the two
# views' bands fully shared (consistent priors: every right-view candidate's
# SAD is a left-view candidate's too) or not at all (disjoint priors).
WARM_CASES = [
    ("random-w37-d16-b3", 3, 37, 16, 0, 3, "spread", "random", 1, 0),
    ("dmin4-w29-d12-b2", 2, 29, 12, 4, 2, "spread", "random", 1, 1),
    ("band0-w31-d16", 2, 31, 16, 0, 0, "spread", "random", 1, 2),
    ("low-end-w23-d10-b4", 2, 23, 10, 3, 4, "low", "random", 1, 3),
    ("high-end-w41-d24-b4", 2, 41, 24, 2, 4, "high", "random", 1, 4),
    ("far-prior-w23-d10-b3", 2, 23, 10, 3, 3, "far", "random", 1, 5),
    ("band-past-range-w41-d24-b30", 2, 41, 24, 0, 30, "spread", "random", 1, 6),
    ("tie-half-prior-w19-d12-b4", 2, 19, 12, 0, 4, "half", "zero", 0, 7),
    ("tie-integer-prior-w43-d24-b3", 2, 43, 24, 0, 3, "integer", "zero", 0, 8),
    ("texture-gate-w17-d8-b2", 1, 17, 8, 0, 2, "spread", "ternary", 40, 9),
    ("all-off-image-w9-d20-b3", 2, 9, 20, 6, 3, "spread", "random", 1, 10),
    ("nan-prior-w21-d16-b4", 2, 21, 16, 0, 4, "nan", "random", 1, 11),
    ("tile-plus-one-w129-d40-b8", 2, 129, 40, 0, 8, "spread", "random", 1, 12),
    ("consistent-priors-w97-d32-b8", 3, 97, 32, 0, 8, "consistent", "random", 1, 13),
    ("disjoint-priors-w61-d40-b3", 2, 61, 40, 0, 3, "disjoint", "random", 1, 14),
    ("pass-plus-one-w1025-d24-b8", 2, 1025, 24, 0, 8, "spread", "random", 1, 15),
    ("wide-band-w3001-d100-b40", 2, 3001, 100, 0, 40, "spread", "random", 1, 16),
    ("rows-past-shared-memory-w7265-d16-b4", 2, 7265, 16, 0, 4, "spread", "random", 1, 17),
    ("stack-of-3-w45-d20-b5", 2, 45, 20, 2, 5, "spread", "random", 1, 18, 3),
    ("huge-prior-w67-d24-b4", 2, 67, 24, 0, 4, "huge", "random", 1, 19),
]


def warm_inputs(case):
    _, h, w, nd, dmin, band, mu_kind, dkind, tex, seed, *frames = case
    lead = tuple(frames)            # () or (frames,)
    rng = np.random.default_rng(seed)
    dl = _desc(rng, (int(np.prod(lead, dtype=int)) * h, w, 16), dkind).reshape(*lead, h, w, 16)
    dr = _desc(rng, (int(np.prod(lead, dtype=int)) * h, w, 16), dkind).reshape(*lead, h, w, 16)
    shape = (2, *lead, h, w)
    lo, hi = dmin, dmin + nd - 1
    if mu_kind in ("spread", "nan"):
        mu = rng.uniform(lo - 3, hi + 3, shape)
        if mu_kind == "nan":
            mu[rng.random(shape) < 0.3] = np.nan
    elif mu_kind == "low":
        mu = rng.uniform(lo - band - 2, lo + 2, shape)
    elif mu_kind == "high":
        mu = rng.uniform(hi - 2, hi + band + 2, shape)
    elif mu_kind == "far":
        mu = np.stack([np.full((h, w), lo - 40.0), np.full((h, w), hi + 40.0)])
    elif mu_kind == "consistent":
        # Both views round to one integer per row: equal bands, so right
        # pixel u at d and left pixel u + d share every SAD.
        rows = rng.integers(lo, hi + 1, (*lead, h, 1)).astype(np.float64)
        mu = rows + rng.uniform(-0.4, 0.4, shape)
    elif mu_kind == "huge":
        # (d - mu)^2 / 2 near float32's top: q past 2^126 at +-1.5e19 (a
        # division), inside it at +-1e19 and for the rest.
        mu = rng.uniform(lo - 3, hi + 3, shape)
        pick = rng.integers(0, 5, shape)
        mu = np.select([pick == 0, pick == 1, pick == 2, pick == 3],
                       [np.float64(1.5e19), np.float64(-1.5e19), np.float64(1e19),
                        np.float64(-1e19)], mu)
    elif mu_kind == "disjoint":
        # Left bands low in the range, right bands high: no SAD shared.
        mu = np.stack([rng.uniform(lo, lo + 5, shape[1:]), rng.uniform(hi - 9, hi, shape[1:])])
    else:
        mu = _tie_prior(rng, mu_kind, lo, hi, shape)
    kw = dict(num_disp=nd, disp_min=dmin, warm_band=band, beta=0.02, sigma=1.0,
              match_texture=tex)
    return dl, dr, mu.astype(np.float32), kw
