"""The port's error metric against the reference's, bit for bit: the float32
sum in XLA:CPU's order (``kernels/ref.py::xla_sum_f32``) against
``jax.jit(jnp.sum)``, and ``disparity_error`` against the reference's
``disparity_error``.  Tolerance: exact (equal float32 bits)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import pipeline as ref_pipeline
from repro_torch.core import pipeline
from repro_torch.kernels.ref import xla_sum_f32

# The frame shapes the tests and the chip run use (golden frame, QVGA-ish,
# KITTI, Tsukuba), and odd ones: one element, one row or column past a
# window of 32, a single window, padding on both axes, two whole windows.
FRAME_SHAPES = [(57, 83), (120, 160), (240, 320), (375, 1242), (480, 640)]
ODD_SHAPES = [(1, 1), (1, 33), (33, 1), (31, 31), (33, 65), (64, 64)]
# Final (R, C) loops on both sides of each edge of the vector widths LLVM
# picks (kernels/ref.py::_xla_lanes), and R not a multiple of the width.
LANE_SHAPES = [(2, 8), (2, 9), (3, 4), (8, 8), (9, 2), (16, 6), (16, 7), (17, 1), (20, 2),
               (23, 8), (24, 6), (27, 7), (28, 2), (28, 3), (31, 8), (32, 6), (32, 9)]
SEEDS = 20

_jit_sum = jax.jit(jnp.sum)


def _rel_map(shape, seed: int) -> np.ndarray:
    """A float32 map as disparity_error sums it: |d - d*| / d* over valid
    pixels, 0 elsewhere (many exact zeros: invalid estimates, no ground
    truth, and estimates equal to the ground truth)."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.5, 130.0, shape).astype(np.float32)
    gt[rng.random(shape) < 0.1] = 0.0
    disp = (gt + rng.normal(0.0, 3.0, shape)).astype(np.float32)
    disp[rng.random(shape) < 0.2] = -1.0
    exact = rng.random(shape) < 0.2
    disp[exact] = gt[exact]
    ok = (disp != -1.0) & (gt > 0)
    rel = np.abs(disp - gt) / np.maximum(gt, np.float32(1e-6))
    return np.where(ok, rel, np.float32(0.0)).astype(np.float32)


def _bits(x) -> int:
    return int(np.asarray(x, np.float32).view(np.int32))


@pytest.mark.parametrize("shape", FRAME_SHAPES + ODD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_xla_sum_matches_jitted_jax(shape):
    got = [_bits(xla_sum_f32(torch.as_tensor(_rel_map(shape, s)))) for s in range(SEEDS)]
    want = [_bits(_jit_sum(_rel_map(shape, s))) for s in range(SEEDS)]
    assert sum(g != w for g, w in zip(got, want)) == 0


@pytest.mark.parametrize("shape", LANE_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_xla_sum_final_loop_lanes(shape):
    for seed in range(5):
        x = _rel_map(shape, seed)
        assert _bits(xla_sum_f32(torch.as_tensor(x))) == _bits(_jit_sum(x))


def test_xla_sum_order_is_not_torch_sum():
    """The plan matters: torch's own sum differs in the last bits on some of
    these maps, so the test above would catch a plain ``.sum()``."""
    maps = [_rel_map((375, 1242), s) for s in range(SEEDS)]
    assert any(_bits(torch.as_tensor(m).sum()) != _bits(_jit_sum(m)) for m in maps)


@pytest.mark.parametrize("shape", [(57, 83), (120, 160), (375, 1242)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_disparity_error_matches_reference(shape):
    rng = np.random.default_rng(7)
    gt = rng.uniform(0.0, 100.0, shape).astype(np.float32)
    gt[rng.random(shape) < 0.1] = 0.0
    disp = np.rint(gt + rng.normal(0.0, 2.0, shape)).astype(np.float32)
    disp[rng.random(shape) < 0.3] = -1.0
    want = ref_pipeline.disparity_error(jnp.asarray(disp), jnp.asarray(gt))
    got = pipeline.disparity_error(torch.as_tensor(disp), torch.as_tensor(gt))
    assert got.dtype == torch.float32
    assert _bits(got) == _bits(want)


def test_xla_sum_takes_2d_only():
    with pytest.raises(ValueError):
        xla_sum_f32(torch.zeros(4))
    assert _bits(xla_sum_f32(torch.zeros((0, 5)))) == 0
