"""ELAS / iELAS algorithm parameters (copy of ``repro/core/params.py``).

Defaults follow libelas (Geiger et al., ACCV 2010) where the paper does not
override them; the iELAS interpolation parameters (s_delta, epsilon,
const_fill) default to the paper's Table III setting in support-grid-node
units (candidate_step=5 px -> 50 px == 10 nodes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class ElasParams:
    # --- disparity search range -------------------------------------------------
    disp_min: int = 0
    disp_max: int = 63                  # inclusive; full range = disp_max+1 values

    # --- support point extraction -----------------------------------------------
    candidate_step: int = 5             # support candidate grid pitch in pixels
    support_texture: int = 10           # min sum|desc| to accept a candidate
    support_ratio: float = 0.85         # uniqueness: best < ratio * second_best
    lr_threshold: int = 2               # max |d_L - d_R| for left/right check

    # --- support filtering (on the candidate grid) -------------------------------
    incon_window: int = 2               # +/- window (grid nodes) for consistency
    incon_threshold: int = 5            # |d - d_neighbor| <= threshold is "consistent"
    incon_min_support: int = 5          # min consistent neighbors to survive
    redun_max_dist: int = 1             # +/- window (grid nodes) for redundancy
    redun_threshold: int = 1            # |d - d_neighbor| <= threshold is "identical"

    # --- iELAS support-point interpolation (the paper's technique) ---------------
    s_delta: int = 10                   # search window (grid nodes); 10 nodes = 50 px
    epsilon: float = 15.0               # mean-vs-min consistency threshold
    const_fill: float = 60.0            # constant C for isolated regions

    # --- dense matching ----------------------------------------------------------
    grid_size: int = 20                 # grid-vector cell size in pixels
    grid_vector_k: int = 20             # disparities stored per cell (paper: 20)
    plane_radius: int = 2               # candidates around the plane prior mu(p)
    beta: float = 0.02                  # data term weight
    gamma: float = 3.0                  # prior mixture weight
    sigma: float = 1.0                  # prior gaussian width
    match_texture: int = 1              # min texture for a dense-matched pixel

    # --- post-processing ----------------------------------------------------------
    lr_check_threshold: float = 1.0     # final dense L/R consistency
    ipol_gap_width: int = 7             # max gap (px) filled by interpolation
    median_radius: int = 1              # 3x3 median
    invalid: float = -1.0               # sentinel for invalid disparity

    @property
    def num_disp(self) -> int:
        return self.disp_max - self.disp_min + 1

    @property
    def num_candidates(self) -> int:
        """Static per-pixel candidate count for dense matching."""
        return self.grid_vector_k + 2 * self.plane_radius + 1

    def grid_shape(self, height: int, width: int) -> Tuple[int, int]:
        """Support-candidate grid shape for an image of (height, width)."""
        return (height // self.candidate_step, width // self.candidate_step)


# Parameters used in the paper's Fig. 2 worked example (grid units).
FIG2_PARAMS = ElasParams(s_delta=5, epsilon=3.0, const_fill=0.0)

# The paper's Table III evaluation setting (s_delta = 50 px = 10 nodes).
PAPER_EVAL_PARAMS = ElasParams(s_delta=10, epsilon=15.0, const_fill=60.0)

# Tuned for the procedurally generated benchmark scenes in repro_torch.data.stereo
# (denser support -> wider interpolation window, mid-range constant fill).
SYNTHETIC_BENCH_PARAMS = ElasParams(
    disp_max=63, s_delta=32, epsilon=15.0, const_fill=16.0
)


def params_from_dict(d: Mapping[str, Any]) -> ElasParams:
    """Build :class:`ElasParams` from ``dataclasses.asdict`` of an equivalent
    object (e.g. the reference package's).  Unknown or missing fields raise."""
    names = {f.name for f in dataclasses.fields(ElasParams)}
    if set(d) != names:
        raise ValueError(
            f"ElasParams fields differ: missing {sorted(names - set(d))}, "
            f"unknown {sorted(set(d) - names)}"
        )
    return ElasParams(**d)
