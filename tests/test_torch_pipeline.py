"""The port's frame path end to end on the CPU: the pinned golden digest of
the reference (tests/test_golden_frame.py) on every dense route, single
frame and wave, the wave-shaped stages against the reference's, a second
scene against the reference's ``ielas_disparity``, the error metrics, and
the rule that the entry point never falls back to the host unasked."""
import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.elas_stereo import KITTI as REF_KITTI
from repro.configs.elas_stereo import SYNTH as REF_SYNTH
from repro.core import pipeline as ref_pipeline
from repro.core import tiling as ref_tiling
from repro.data.stereo import synthetic_stereo_pair
from repro_torch.configs.elas_stereo import KITTI, SYNTH
from repro_torch.core import pipeline
from repro_torch.core.params import params_from_dict
from repro_torch.core.tiling import (
    GATHER_IMPLS,
    STREAM,
    UNTILED,
    WINDOWED,
    WINDOWED_GATHERS,
    TileSpec,
    dense_route,
)

GOLDEN_SHA256 = "91e3ce9df8a9d01f9b9905bd2aabe4f0791dd06329e1c6f015557054988c018b"


@pytest.fixture(scope="module")
def golden():
    il, ir, gt = synthetic_stereo_pair(height=57, width=83, d_max=24, seed=11)
    return il, ir, gt, pipeline.ielas_disparity(il, ir, SYNTH.params, device="cpu")


def test_golden_frame_digest(golden):
    out = golden[3].numpy()
    assert out.shape == (57, 83) and out.dtype == np.float32
    assert hashlib.sha256(np.ascontiguousarray(out).tobytes()).hexdigest() == GOLDEN_SHA256


def test_stages_compose_to_entry_point(golden):
    il, ir, _, out = golden
    p = SYNTH.params
    dl, dr, sup = pipeline.ielas_support_stage(torch.as_tensor(il), torch.as_tensor(ir), p)
    sup = pipeline.ielas_interpolate_stage(sup, p)
    assert torch.equal(pipeline.ielas_dense_stage(dl, dr, sup, p), out)
    # band_radius narrows the plane-prior band; None is the default band.
    assert torch.equal(pipeline.ielas_dense_stage(dl, dr, sup, p, band_radius=p.plane_radius), out)
    assert not torch.equal(pipeline.ielas_dense_stage(dl, dr, sup, p, band_radius=0), out)
    with pytest.raises(ValueError):
        pipeline.ielas_dense_stage(dl, dr, sup, p, band_radius=-1)


def test_kitti_params_scene_matches_reference():
    """KITTI's parameters (D = 128, disp_min moved to 4) on a small lamp-lit frame."""
    ref_p = dataclasses.replace(REF_KITTI.params, disp_min=4)
    il, ir, _ = synthetic_stereo_pair(height=44, width=150, d_max=60, lighting="lamps", seed=2)
    want = np.asarray(ref_pipeline.ielas_disparity(
        jnp.asarray(il, jnp.float32), jnp.asarray(ir, jnp.float32), ref_p, backend="ref",
        tile=ref_tiling.UNTILED,
    ))
    got = pipeline.ielas_disparity(il, ir, params_from_dict(dataclasses.asdict(ref_p)),
                                   device="cpu").numpy()
    assert np.array_equal(got, want), f"{int(np.sum(got != want))} pixels differ"
    assert KITTI.params == params_from_dict(dataclasses.asdict(REF_KITTI.params))


def test_error_metrics_match_reference(golden):
    _, _, gt, out = golden
    ref_bad = float(ref_pipeline.bad_pixel_rate(jnp.asarray(out.numpy()), jnp.asarray(gt)))
    ref_err = float(ref_pipeline.disparity_error(jnp.asarray(out.numpy()), jnp.asarray(gt)))
    gt_t = torch.as_tensor(gt)
    assert float(pipeline.bad_pixel_rate(out, gt_t)) == ref_bad
    # The float32 sum is taken in XLA:CPU's order (kernels/ref.py::xla_sum_f32).
    assert float(pipeline.disparity_error(out, gt_t)) == ref_err


def test_entry_point_raises_without_cuda(monkeypatch, golden):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    il, ir = golden[0], golden[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.ielas_disparity(il, ir, SYNTH.params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.resolve_device(None)
    assert pipeline.resolve_device("cpu") == torch.device("cpu")


# ------------------------------------------------------------ dense routes
TILES = [("default", None), ("untiled", UNTILED)] + [
    (f"gather-{g}", TileSpec(rows=16, support_rows=3, gather=g)) for g in GATHER_IMPLS
]


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(np.ascontiguousarray(t.numpy()).tobytes()).hexdigest()


def test_dense_route_reads_gather_only():
    assert dense_route(None) == STREAM
    assert dense_route(UNTILED) == WINDOWED
    assert dense_route(TileSpec(gather="stream", precision="int8", rows=3)) == STREAM
    for g in WINDOWED_GATHERS:
        assert dense_route(TileSpec(gather=g)) == WINDOWED
    with pytest.raises(ValueError):
        dense_route("tiled")
    for bad in (dict(rows=0), dict(support_rows=0), dict(gather="gather"),
                dict(precision="bf16")):
        with pytest.raises(ValueError):
            TileSpec(**bad)
        with pytest.raises(ValueError):
            ref_tiling.TileSpec(**bad)
    assert GATHER_IMPLS == ref_tiling.GATHER_IMPLS and UNTILED == ref_tiling.UNTILED


@pytest.mark.parametrize("tile_id,tile", TILES, ids=[t[0] for t in TILES])
def test_golden_frame_on_every_route(golden, tile_id, tile):
    """The pinned digest from the single-frame entry point and from the
    wave-shaped stages (two slots), on every dense route."""
    il, ir, _, _ = golden
    p = SYNTH.params
    out = pipeline.ielas_disparity(il, ir, p, device="cpu", tile=tile)
    assert _digest(out) == GOLDEN_SHA256, f"single frame, tile={tile_id}"
    left = torch.stack([torch.as_tensor(il)] * 2)
    right = torch.stack([torch.as_tensor(ir)] * 2)
    dl, dr, sup = pipeline.ielas_support_stage_batched(left, right, p)
    sup = torch.stack([pipeline.ielas_interpolate_stage(s, p) for s in sup])
    wave = pipeline.ielas_dense_stage_batched(dl, dr, sup, p, tile=tile)
    assert wave.shape == (2, 57, 83)
    for slot in range(2):
        assert _digest(wave[slot]) == GOLDEN_SHA256, f"wave slot {slot}, tile={tile_id}"


@pytest.fixture(scope="module")
def wave_scenes():
    """Two different scenes (57 x 83, seeds 11 and 12) as one wave."""
    pairs = [synthetic_stereo_pair(height=57, width=83, d_max=24, seed=s)[:2] for s in (11, 12)]
    left = np.stack([pr[0] for pr in pairs]).astype(np.float32)
    right = np.stack([pr[1] for pr in pairs]).astype(np.float32)
    return left, right


def test_wave_stages_match_reference(wave_scenes):
    """Support, interpolation and dense stages of a wave of two different
    scenes against the reference's batched stages, slot by slot and stage by
    stage, on both dense routes; and each slot against the port's
    single-frame stages."""
    left, right = wave_scenes
    rp, p = REF_SYNTH.params, SYNTH.params
    r_dl, r_dr, r_sup = ref_pipeline.ielas_support_stage_batched(
        jnp.asarray(left), jnp.asarray(right), rp, backend="ref")
    r_full = jax.vmap(lambda s: ref_pipeline.ielas_interpolate_stage(s, rp))(r_sup)
    r_out = np.asarray(ref_pipeline.ielas_dense_stage_batched(
        r_dl, r_dr, r_full, rp, backend="ref"))

    dl, dr, sup = pipeline.ielas_support_stage_batched(
        torch.as_tensor(left), torch.as_tensor(right), p)
    full = torch.stack([pipeline.ielas_interpolate_stage(s, p) for s in sup])
    for name, got, want in (("dl", dl, r_dl), ("dr", dr, r_dr), ("support", sup, r_sup),
                            ("interpolated", full, r_full)):
        assert np.array_equal(got.numpy(), np.asarray(want)), name
    for tile in (None, UNTILED):
        out = pipeline.ielas_dense_stage_batched(dl, dr, full, p, tile=tile)
        assert int(np.sum(out.numpy() != r_out)) == 0, f"dense stage, tile={tile}"
    assert not np.array_equal(r_out[0], r_out[1]), "the two scenes must differ"
    for slot in range(2):
        one = pipeline.ielas_support_stage(
            torch.as_tensor(left[slot]), torch.as_tensor(right[slot]), p)
        assert all(torch.equal(a, b[slot]) for a, b in zip(one, (dl, dr, sup)))
        assert torch.equal(pipeline.ielas_dense_stage(dl[slot], dr[slot], full[slot], p),
                           out[slot])
    narrow = pipeline.ielas_dense_stage_batched(dl, dr, full, p, band_radius=0)
    assert torch.equal(narrow[1], pipeline.ielas_dense_stage(dl[1], dr[1], full[1], p,
                                                             band_radius=0))
    with pytest.raises(ValueError):
        pipeline.ielas_support_stage_batched(torch.as_tensor(left[0]),
                                             torch.as_tensor(right[0]), p)
