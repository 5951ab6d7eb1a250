"""The port's hybrid baseline (original ELAS with a host-side Delaunay prior)
on the CPU against the JAX package, bit for bit: ``delaunay_prior`` (a numpy
and scipy copy, so equal arrays), the two single-purpose wrappers
``support_from_images`` and ``dense_disparity``, and
``elas_baseline_disparity`` end to end at two small shapes (the Table I
scene of tests/test_accuracy_oracle.py and the golden frame's pair)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.elas_stereo import SYNTH as REF_SYNTH
from repro.core import descriptor as ref_desc
from repro.core import pipeline as ref_pipeline
from repro.core import triangulation as ref_triangulation
from repro.core.dense import dense_disparity as ref_dense_disparity
from repro.core.params import ElasParams as RefParams
from repro.core.support import support_from_images as ref_support_from_images
from repro.data.stereo import synthetic_stereo_pair
from repro_torch.configs.elas_stereo import SYNTH
from repro_torch.core import descriptor as port_desc
from repro_torch.core import pipeline, triangulation
from repro_torch.core.dense import dense_disparity
from repro_torch.core.params import ElasParams
from repro_torch.core.support import support_from_images
from test_accuracy_oracle import _random_sparse_grid

P = SYNTH.params
RP = REF_SYNTH.params


def _planar_grid() -> np.ndarray:
    """A fully valid, exactly planar support grid (8 x 10 nodes)."""
    step = P.candidate_step
    uu, vv = np.meshgrid(np.arange(10) * step + step // 2, np.arange(8) * step + step // 2)
    return (0.02 * uu + 0.03 * vv + 12.0).astype(np.float32)


def _sparse_grid(points: int) -> np.ndarray:
    grid = np.full((6, 8), -1.0, np.float32)
    grid.flat[[5, 20, 41][:points]] = [17.0, 23.5, 30.0][:points]
    return grid


GRIDS = {
    **{f"random-seed{s}": (lambda s=s: _random_sparse_grid(s)) for s in range(5)},
    "planar-full": _planar_grid,
    "two-points": lambda: _sparse_grid(2),
    "no-points": lambda: _sparse_grid(0),
}


@pytest.mark.parametrize("name", list(GRIDS))
def test_delaunay_prior_matches_reference(name):
    grid = GRIDS[name]()
    gh, gw = grid.shape
    h, w = gh * P.candidate_step, gw * P.candidate_step
    want = ref_triangulation.delaunay_prior(grid, h, w, RP)
    got = triangulation.delaunay_prior(grid, h, w, P)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    if name in ("two-points", "no-points"):       # fewer than 3 points: const_fill
        assert np.all(got == P.const_fill)
    assert np.array_equal(triangulation.support_points_from_grid(grid, P),
                          ref_triangulation.support_points_from_grid(grid, RP))


def test_support_from_images_matches_reference():
    il, ir, _ = synthetic_stereo_pair(height=60, width=80, d_max=24, seed=3)
    want = ref_support_from_images(jnp.asarray(il, jnp.float32), jnp.asarray(ir, jnp.float32), RP)
    got = support_from_images(torch.as_tensor(il), torch.as_tensor(ir), P)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("direction", [-1, 1])
def test_dense_disparity_matches_reference(direction):
    """tests/test_core_stages.py's perfect-shift scene, both directions."""
    rng = np.random.default_rng(5)
    shift = 6
    tex = rng.integers(0, 256, (60, 130)).astype(np.float64)
    img_r = tex[:, :120]
    img_l = np.zeros((60, 120))
    img_l[:, shift:] = tex[:, : 120 - shift]
    img_l[:, :shift] = tex[:, :1]
    rp, p = RefParams(disp_max=31), ElasParams(disp_max=31)
    jl, jr = (ref_desc.extract(jnp.asarray(x, jnp.float32)) for x in (img_l, img_r))
    tl, tr = (port_desc.extract(torch.as_tensor(x, dtype=torch.float32)) for x in (img_l, img_r))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    mu = np.full((60, 120), float(shift), np.float32)
    mu[:, ::7] += 2.5                     # a non-constant prior
    gv = np.full((3, 6, p.grid_vector_k), float(shift), np.float32)
    gv[1, 2, ::3] = -1.0
    src, dst = ((jl, jr), (tl, tr)) if direction == -1 else ((jr, jl), (tr, tl))
    want = ref_dense_disparity(*src, jnp.asarray(mu), jnp.asarray(gv), rp, direction=direction)
    got = dense_disparity(*dst, torch.as_tensor(mu), torch.as_tensor(gv), p,
                          direction=direction)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("height,width,d_max,seed", [(60, 80, 24, 3), (57, 83, 24, 11)],
                         ids=["table1-scene-60x80", "golden-pair-57x83"])
def test_elas_baseline_disparity_matches_reference(height, width, d_max, seed):
    il, ir, gt = synthetic_stereo_pair(height=height, width=width, d_max=d_max, seed=seed)
    want = np.asarray(ref_pipeline.elas_baseline_disparity(
        jnp.asarray(il, jnp.float32), jnp.asarray(ir, jnp.float32), RP))
    got = pipeline.elas_baseline_disparity(il, ir, P, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (height, width)
    assert np.array_equal(got.numpy(), want)
    # The same frame from float32 images, as the reference test feeds them.
    as_float = pipeline.elas_baseline_disparity(torch.as_tensor(il, dtype=torch.float32),
                                                torch.as_tensor(ir, dtype=torch.float32), P,
                                                device="cpu")
    assert torch.equal(as_float, got)
    gt_t = torch.as_tensor(gt)
    assert float(pipeline.bad_pixel_rate(got, gt_t)) == float(
        ref_pipeline.bad_pixel_rate(jnp.asarray(want), jnp.asarray(gt)))


def test_elas_baseline_disparity_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    il, ir, _ = synthetic_stereo_pair(height=40, width=60, d_max=16, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.elas_baseline_disparity(il, ir, P)
