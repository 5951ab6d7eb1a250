"""Each ported stage against its JAX counterpart (``backend="ref"``) on the
same inputs, on two small scenes; the second has ``disp_min=4``, which pins
the support sweep's start at 0.

Tolerance: exact (0 differing elements) for every stage.  The float stages
(plane prior, gap interpolation) reproduce the reference's XLA:CPU
roundings -- a reciprocal multiply for a constant divisor and fused
multiply-adds -- so they are bit-exact too.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.elas_stereo import SYNTH
from repro.core import dense as ref_dense
from repro.core import descriptor as ref_desc
from repro.core import filtering as ref_filter
from repro.core import grid_vector as ref_gv
from repro.core import interpolation as ref_interp
from repro.core import postprocess as ref_post
from repro.core import prior as ref_prior
from repro.core import support as ref_support
from repro.data.stereo import synthetic_stereo_pair
from repro_torch.core import dense as port_dense
from repro_torch.core import descriptor as port_desc
from repro_torch.core import filtering as port_filter
from repro_torch.core import grid_vector as port_gv
from repro_torch.core import interpolation as port_interp
from repro_torch.core import postprocess as port_post
from repro_torch.core import prior as port_prior
from repro_torch.core import support as port_support
from repro_torch.core.params import params_from_dict
from repro_torch.core.tiling import UNTILED

SCENES = {
    # name: (height, width, d_max, lighting, seed, reference params)
    "synth-40x64": (40, 64, 20.0, "daylight", 3, SYNTH.params),
    "dmin4-37x71": (37, 71, 24.0, "lamps", 5,
                    dataclasses.replace(SYNTH.params, disp_min=4, disp_max=40)),
}


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def _exact(ref, got, what):
    ref = np.asarray(ref)
    got = got.numpy()
    assert ref.shape == got.shape and ref.dtype == got.dtype, (what, ref.shape, got.shape)
    diff = int(np.sum(ref != got))
    assert diff == 0, f"{what}: {diff} of {ref.size} elements differ"


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    """The reference's stage outputs on one scene (numpy), computed once."""
    h, w, d_max, lighting, seed, p = SCENES[request.param]
    il, ir, gt = synthetic_stereo_pair(height=h, width=w, d_max=d_max, lighting=lighting, seed=seed)
    s = dict(name=request.param, h=h, w=w, p=p, q=params_from_dict(dataclasses.asdict(p)),
             il=il, ir=ir)
    jl = ref_desc.extract(jnp.asarray(il, jnp.float32))
    jr = ref_desc.extract(jnp.asarray(ir, jnp.float32))
    s["gx"], s["gy"] = ref_desc.sobel3x3(jnp.asarray(il, jnp.float32))
    s["dl"], s["dr"] = jl, jr
    s["support"] = ref_support.extract_support_grid(jl, jr, p, backend="ref")
    s["filtered"] = ref_filter.filter_support(s["support"], p)
    s["full"] = ref_interp.interpolate_support(s["filtered"], p)
    s["mu_l"] = ref_prior.plane_prior(s["full"], h, w, p)
    s["sup_r"] = ref_prior.right_view_support(s["full"], p)
    s["full_r"] = ref_interp.interpolate_support(s["sup_r"], p)
    s["mu_r"] = ref_prior.plane_prior(s["full_r"], h, w, p)
    s["gv_l"] = ref_gv.build_grid_vector(s["full"], p)
    s["gv_r"] = ref_gv.build_grid_vector(s["full_r"], p)
    s["gv_sparse"] = ref_gv.build_grid_vector(s["filtered"], p)
    s["bitmask"] = ref_dense.candidate_bitmask_rows(s["gv_l"], p, h)
    s["cands_l"] = ref_dense.candidate_set(s["mu_l"], s["gv_l"], p)
    s["cands_r"] = ref_dense.candidate_set(s["mu_r"], s["gv_r"], p)
    s["cell_index"] = ref_gv.cell_index(h, w, p)
    s["disp_l"], s["disp_r"] = ref_dense.dense_both_views(
        jl, jr, s["mu_l"], s["mu_r"], s["gv_l"], s["gv_r"], p, backend="ref"
    )
    s["lr"] = ref_post.lr_consistency(s["disp_l"], s["disp_r"], p)
    s["gap"] = ref_post.gap_interpolation(s["lr"], p)
    s["post"] = ref_post.postprocess(s["disp_l"], s["disp_r"], p)
    return {k: (np.asarray(v) if hasattr(v, "shape") else v) for k, v in s.items()}


def test_descriptors(scene):
    gx, gy = port_desc.sobel3x3(torch.as_tensor(scene["il"]))
    _exact(scene["gx"], gx, "sobel gx")
    _exact(scene["gy"], gy, "sobel gy")
    _exact(scene["dl"], port_desc.extract(torch.as_tensor(scene["il"])), "left descriptors")
    _exact(scene["dr"], port_desc.extract(torch.as_tensor(scene["ir"])), "right descriptors")


def test_support_grid(scene):
    got = port_support.extract_support_grid(_t(scene["dl"]), _t(scene["dr"]), scene["q"])
    _exact(scene["support"], got, "support grid")
    assert (got != -1.0).sum() > 0, "scene produced no support points"


def test_filter_support(scene):
    _exact(scene["filtered"], port_filter.filter_support(_t(scene["support"]), scene["q"]),
           "filter_support")


def test_interpolate_support(scene):
    got = port_interp.interpolate_support(_t(scene["filtered"]), scene["q"])
    _exact(scene["full"], got, "interpolate_support (left)")
    _exact(scene["full_r"], port_interp.interpolate_support(_t(scene["sup_r"]), scene["q"]),
           "interpolate_support (right)")


def test_plane_prior(scene):
    h, w, q = scene["h"], scene["w"], scene["q"]
    _exact(scene["mu_l"], port_prior.plane_prior(_t(scene["full"]), h, w, q), "plane_prior (left)")
    _exact(scene["mu_r"], port_prior.plane_prior(_t(scene["full_r"]), h, w, q),
           "plane_prior (right)")


def test_right_view_support(scene):
    _exact(scene["sup_r"], port_prior.right_view_support(_t(scene["full"]), scene["q"]),
           "right_view_support")


def test_build_grid_vector(scene):
    q = scene["q"]
    _exact(scene["gv_l"], port_gv.build_grid_vector(_t(scene["full"]), q), "grid vector (full)")
    _exact(scene["gv_r"], port_gv.build_grid_vector(_t(scene["full_r"]), q), "grid vector (right)")
    _exact(scene["gv_sparse"], port_gv.build_grid_vector(_t(scene["filtered"]), q),
           "grid vector (sparse, with empty cells)")


def test_candidate_bitmask_rows(scene):
    got = port_dense.candidate_bitmask_rows(_t(scene["gv_l"]), scene["q"], scene["h"])
    _exact(scene["bitmask"], got, "candidate_bitmask_rows")


def test_candidate_set(scene):
    q = scene["q"]
    _exact(scene["cands_l"], port_dense.candidate_set(_t(scene["mu_l"]), _t(scene["gv_l"]), q),
           "candidate_set (left)")
    _exact(scene["cands_r"], port_dense.candidate_set(_t(scene["mu_r"]), _t(scene["gv_r"]), q),
           "candidate_set (right)")
    cy, cx = port_gv.cell_index(scene["h"], scene["w"], q)
    assert np.array_equal(cy.numpy(), np.asarray(scene["cell_index"][0]))
    assert np.array_equal(cx.numpy(), np.asarray(scene["cell_index"][1]))


def test_dense_both_views(scene):
    got_l, got_r = port_dense.dense_both_views(
        _t(scene["dl"]), _t(scene["dr"]), _t(scene["mu_l"]), _t(scene["mu_r"]),
        _t(scene["gv_l"]), _t(scene["gv_r"]), scene["q"],
    )
    _exact(scene["disp_l"], got_l, "dense left")
    _exact(scene["disp_r"], got_r, "dense right")
    # The candidate route (per-pixel candidate tensors) gives the same maps.
    got_l, got_r = port_dense.dense_both_views(
        _t(scene["dl"]), _t(scene["dr"]), _t(scene["mu_l"]), _t(scene["mu_r"]),
        _t(scene["gv_l"]), _t(scene["gv_r"]), scene["q"], tile=UNTILED,
    )
    _exact(scene["disp_l"], got_l, "dense left, candidate route")
    _exact(scene["disp_r"], got_r, "dense right, candidate route")


def test_postprocess(scene):
    q = scene["q"]
    dl, dr = _t(scene["disp_l"]), _t(scene["disp_r"])
    _exact(scene["lr"], port_post.lr_consistency(dl, dr, q), "lr_consistency")
    _exact(scene["gap"], port_post.gap_interpolation(_t(scene["lr"]), q), "gap_interpolation")
    _exact(scene["post"], port_post.postprocess(dl, dr, q), "postprocess")
