"""Temporal warm-start state and its self-validation primitives (numpy copy
of ``repro/serving/warmstart.py``).

Video streams are temporally coherent: frame *t* usually looks like frame
*t-1*, so seeding *t*'s dense search from *t-1*'s delivered disparity and
narrowing the scan to a ``+-warm_band`` band around it buys a large
constant-factor win (the streaming scan's cost is linear in band width,
and the warm wave skips the sparse support search entirely).  But a
stateful prior is a robustness hazard first: a stale, corrupt, or
scene-cut prior silently poisons every subsequent frame.  This module
holds the per-stream state record plus the two cheap self-checks the
serving engine (:mod:`repro_torch.serving.stereo_service`) wraps around every
warm transition:

* **Scene-change detection** (:func:`scene_change_score` over
  :func:`frame_thumbnail`): a stride-``THUMB_STRIDE`` block-mean thumbnail
  SAD between consecutive left frames.  Measured calibration on the
  synthetic sequences: normal motion scores ~4 levels/px, scene cuts ~30,
  sensor noise < 1 -- the default threshold 20.0 separates them with wide
  margin (12.0 misclassifies a fast 3 px/frame pan as a cut).

* **Post-hoc prior disagreement** (:func:`prior_disagreement`): after a
  warm frame computes, compare the result against the very prior that
  seeded it.  A healthy warm frame tracks its prior closely; a corrupt or
  stale prior forces the band onto the wrong disparities, the L/R
  consistency check then invalidates most of the frame, and -- because
  INVALID output pixels count as *maximal* disagreement (``num_disp``
  levels; a plain mean-abs-delta could never exceed the band half-width
  by construction) -- the score blows past the engine's rerun bound (a
  fraction of ``num_disp``: healthy warm frames measure <= 3% of the
  range, corrupt-seeded ones >= 33%) and the engine retroactively
  re-runs the frame cold.

Both checks are host-side numpy on downsampled data: microseconds per
frame, no device round-trips beyond the disparity the emit stage already
pulled.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

#: Thumbnail block edge in pixels.  8 px blocks keep the thumbnail ~1.5%
#: of the frame's pixels while still resolving object-scale motion.
THUMB_STRIDE = 8


def frame_thumbnail(img: np.ndarray, stride: int = THUMB_STRIDE) -> np.ndarray:
    """(H//stride, W//stride) float32 block-mean thumbnail of a frame.

    The frame is cropped to whole blocks; a frame smaller than one block
    falls back to its global mean (a 1x1 thumbnail), so tiny test frames
    never divide by zero.
    """
    img = np.asarray(img, np.float32)
    th, tw = img.shape[0] // stride, img.shape[1] // stride
    if th == 0 or tw == 0:
        return img.mean(dtype=np.float32).reshape(1, 1)
    crop = img[: th * stride, : tw * stride]
    return crop.reshape(th, stride, tw, stride).mean(axis=(1, 3), dtype=np.float32)


def scene_change_score(a: np.ndarray, b: np.ndarray) -> float:
    """Mean absolute thumbnail difference; ``inf`` on shape mismatch.

    Shape mismatch means the stream switched resolution buckets -- by
    definition a scene change for warm-start purposes, since the stored
    prior no longer matches the frame geometry.
    """
    if a.shape != b.shape:
        return float("inf")
    return float(np.mean(np.abs(a - b)))


def prior_disagreement(
    disp: np.ndarray,           # (H, W) warm result, INVALID sentinels
    prior: np.ndarray,          # (H, W) the prior that seeded it
    num_disp: int,
    invalid: float = -1.0,
    stride: int = 4,
) -> float:
    """How far a warm result strayed from its own seed, in disparity levels.

    Valid output pixels contribute ``|disp - prior|`` (bounded by the warm
    band by construction -- the scan cannot leave the band); INVALID
    output pixels contribute the maximal ``num_disp``.  That asymmetry is
    the point: a poisoned prior cannot reveal itself through the in-band
    delta, but it wrecks L/R consistency and texture validity, so the
    invalid fraction -- weighted maximally here -- carries the signal.
    Pixels where the PRIOR itself is invalid are skipped (nothing to
    disagree with).  Evaluated on a ``stride``-subsampled lattice: the
    check is a per-frame guard, not a metric, and 1/16 of the pixels
    bound the same failure modes.
    """
    d = np.asarray(disp)[::stride, ::stride]
    m = np.asarray(prior)[::stride, ::stride]
    care = m != invalid
    if not care.any():
        return float(num_disp)
    delta = np.where(d == invalid, float(num_disp), np.abs(d - m))
    return float(delta[care].mean())


def corrupt_disparity(disp: np.ndarray, disp_max: float) -> np.ndarray:
    """Deterministic in-range corruption for fault injection.

    Reflects every valid disparity across the range (``disp_max - d``):
    the values stay plausible (in-range, INVALID preserved), so nothing
    upstream of the post-hoc disagreement check can tell the prior is
    garbage -- exactly the silent-corruption scenario the check exists
    to catch.
    """
    d = np.asarray(disp, np.float32)
    return np.where(d >= 0.0, np.float32(disp_max) - d, d).astype(np.float32)


@dataclasses.dataclass
class WarmState:
    """One stream's warm-start seed: the last successfully delivered frame.

    Written ONLY by a successful in-sequence delivery; any error delivery
    (compute fault after retry, admission shed), any out-of-sequence
    delivery, and any resolution switch resets it -- a poisoned or stale
    frame can never seed its successor.  ``streak`` counts consecutive
    warm-classified frames since the last cold one, driving the
    bounded-drift forced refresh.
    """

    disparity: np.ndarray               # (H, W) float32 delivered disparity
    thumbnail: np.ndarray               # block-mean thumbnail of its LEFT frame
    shape: tuple                        # (H, W) native resolution
    seq: int                            # per-stream submission seq of the seed
    streak: int = 0                     # warm frames since the last cold frame

    @classmethod
    def from_delivery(cls, disparity: np.ndarray, thumbnail: np.ndarray,
                      seq: int, streak: int = 0) -> "WarmState":
        # Copy, not alias: the same array was just handed to the caller in
        # a CompletedFrame, and in-place mutation there (normalisation for
        # display is common) must not silently poison the stored seed.
        return cls(
            disparity=np.array(disparity, np.float32, copy=True),
            thumbnail=thumbnail,
            shape=tuple(disparity.shape),
            seq=seq,
            streak=streak,
        )


def classify(
    state: Optional[WarmState],
    thumbnail: np.ndarray,
    shape: tuple,
    seq: int,
    *,
    threshold: float,
    refresh_interval: int,
) -> tuple[bool, str]:
    """The warm/cold decision for one arriving frame: ``(warm, reason)``.

    Pure function of the stream's state and the frame's identity, so the
    state machine is unit-testable without an engine.  Reasons (the
    engine's counters key off them): ``"no_state"`` (first frame, or
    state was reset), ``"stale_seq"`` (the seed is not this frame's
    immediate predecessor -- a frame between them was lost, shed, or
    reordered), ``"resolution"`` (bucket/shape switch), ``"refresh"``
    (bounded-drift forced cold frame), ``"scene_change"`` (thumbnail SAD
    past ``threshold``), and ``"warm"``.
    """
    if state is None:
        return False, "no_state"
    if state.seq != seq - 1:
        return False, "stale_seq"
    if tuple(shape) != state.shape:
        return False, "resolution"
    if state.streak + 1 >= refresh_interval:
        return False, "refresh"
    if scene_change_score(thumbnail, state.thumbnail) > threshold:
        return False, "scene_change"
    return True, "warm"
