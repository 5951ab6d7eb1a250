"""The port's warm-start datapath on the CPU against the JAX package, bit for
bit: the coherent sequence generator, ``support_from_disparity``, the warm
priors, the band-only scan (the warm kernel's plain version) and its
energy, both warm dense stages, the descriptor-only stage, and the
host-side primitives of ``serving/warmstart.py``.  Warm frames are compared
with the reference's warm frames (``==``); warm against cold is the
service tests' business (tests/test_torch_warm_service.py)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.elas_stereo import SYNTH as REF_SYNTH
from repro.core import pipeline as ref_pipeline
from repro.core.prior import support_from_disparity as ref_support_from_disparity
from repro.data.stereo import synthetic_stereo_sequence as ref_sequence
from repro.kernels import ref as jref
from repro.serving import warmstart as ref_warmstart
from repro_torch.configs.elas_stereo import SYNTH
from repro_torch.core import pipeline
from repro_torch.core.prior import support_from_disparity
from repro_torch.data.stereo import synthetic_stereo_sequence
from repro_torch.kernels import dense_match as dense_kernel
from repro_torch.kernels import ref
from repro_torch.serving import warmstart
from torch_kernel_cases import WARM_CASES, warm_inputs

P = SYNTH.params
RP = REF_SYNTH.params
H, W = 60, 80


@functools.cache
def _frames():
    """Three frames of a 60x80 pan and the reference's cold output of the
    first two: the warm stages' inputs."""
    frames = synthetic_stereo_sequence(3, height=H, width=W, d_max=24.0, motion=2, seed=1)
    prevs = [np.asarray(ref_pipeline.ielas_disparity(jnp.asarray(l, jnp.float32),
                                                     jnp.asarray(r, jnp.float32), RP))
             for l, r, _ in frames[:2]]
    left = np.stack([f[0] for f in frames[1:]]).astype(np.float32)
    right = np.stack([f[1] for f in frames[1:]]).astype(np.float32)
    return frames, np.stack(prevs), left, right


@functools.cache
def _descriptors():
    _, _, left, right = _frames()
    jdl, jdr = ref_pipeline.ielas_descriptor_stage_batched(jnp.asarray(left), jnp.asarray(right))
    return np.array(jdl), np.array(jdr)


# ---------------------------------------------------------------- sequences
@pytest.mark.parametrize("kw", [
    dict(n_frames=4, height=40, width=64, d_max=24.0, motion=2, seed=1),
    dict(n_frames=5, height=33, width=47, d_max=30.0, motion=3, cut_at=2, seed=7),
    dict(n_frames=3, height=24, width=40, d_max=16.0, motion=0, lighting="lamps", seed=2),
], ids=["pan", "cut", "static-lamps"])
def test_sequence_matches_reference(kw):
    got = synthetic_stereo_sequence(**kw)
    want = ref_sequence(**kw)
    assert len(got) == len(want) == kw["n_frames"]
    for g, x in zip(got, want):
        for a, b in zip(g, x):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(n_frames=0), dict(n_frames=3, motion=-1),
                                dict(n_frames=3, cut_at=3), dict(n_frames=3, cut_at=0)])
def test_sequence_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        ref_sequence(**kw, height=24, width=40)
    with pytest.raises(ValueError):
        synthetic_stereo_sequence(**kw, height=24, width=40)


# ---------------------------------------------------------------- priors
@pytest.mark.parametrize("shape", [(40, 64), (57, 83), (60, 80), (23, 21)])
def test_support_from_disparity_matches_reference(shape):
    disp = np.random.default_rng(sum(shape)).uniform(-1, 24, shape).astype(np.float32)
    disp[::7] = -1.0
    want = np.asarray(ref_support_from_disparity(jnp.asarray(disp), RP))
    got = support_from_disparity(torch.as_tensor(disp), P)
    assert np.array_equal(got.numpy(), want)
    stacked = support_from_disparity(torch.as_tensor(np.stack([disp, disp + 1])), P)
    assert np.array_equal(stacked[1].numpy(), want + np.float32(1))


def test_warm_priors_match_reference():
    _, prevs, _, _ = _frames()
    prev = prevs.copy()
    prev[1, :20] = -1.0                     # a hole the plane must fill
    ref_priors = jax.jit(ref_pipeline._warm_priors, static_argnums=(1, 2, 3))
    got_l, got_r = pipeline._warm_priors(torch.as_tensor(prev), H, W, P)
    for i in range(2):
        want_l, want_r = ref_priors(jnp.asarray(prev[i]), H, W, RP)
        assert np.array_equal(got_l[i].numpy(), np.asarray(want_l))
        assert np.array_equal(got_r[i].numpy(), np.asarray(want_r))
    one_l, one_r = pipeline._warm_priors(torch.as_tensor(prev[1]), H, W, P)
    assert torch.equal(one_l, got_l[1]) and torch.equal(one_r, got_r[1])


def test_warm_priors_from_an_all_invalid_map_match_reference():
    prev = np.full((H, W), -1.0, np.float32)
    ref_priors = jax.jit(ref_pipeline._warm_priors, static_argnums=(1, 2, 3))
    want = ref_priors(jnp.asarray(prev), H, W, RP)
    got = pipeline._warm_priors(torch.as_tensor(prev), H, W, P)
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))


# ---------------------------------------------------------------- the band-only scan
@pytest.mark.parametrize("precision", ["int8", "f32"])
@pytest.mark.parametrize("case", WARM_CASES, ids=[c[0] for c in WARM_CASES])
def test_warm_ref_scan_matches_oracle(case, precision):
    dl, dr, mu, kw = warm_inputs(case)
    w = dl.shape[-2]           # a stack of frames is scanned as its rows
    rows = [dl.reshape(-1, w, 16), dr.reshape(-1, w, 16), mu[0].reshape(-1, w),
            mu[1].reshape(-1, w)]
    oracle = jax.jit(functools.partial(jref.dense_match_rows_warm_ref, **kw, precision=precision))
    want = oracle(*rows)
    got = ref.dense_match_rows_warm_ref(*(torch.as_tensor(a) for a in rows), **kw)
    for g, x in zip(got, want):
        assert g.dtype == torch.float32
        assert np.array_equal(g.numpy(), np.asarray(x))


@pytest.mark.parametrize("case", WARM_CASES, ids=[c[0] for c in WARM_CASES])
def test_warm_band_counts_match_a_direct_count(case):
    """ref.warm_band_counts (the warm kernel's bound and shared share) against
    a count pixel by pixel: each view's in-image band candidates, and the
    right-view ones (u, d) whose left pixel u + d holds d in its band."""
    _, _, mu, kw = warm_inputs(case)
    w = mu.shape[-1]
    got = ref.warm_band_counts(torch.as_tensor(mu[0]), torch.as_tensor(mu[1]),
                               num_disp=kw["num_disp"], disp_min=kw["disp_min"],
                               warm_band=kw["warm_band"])
    lo_d, hi_d = kw["disp_min"], kw["disp_min"] + kw["num_disp"] - 1

    def band(m):
        if np.isnan(m):
            return range(0)
        r = np.round(m)
        return range(int(np.clip(r - kw["warm_band"], lo_d, hi_d)),
                     int(np.clip(r + kw["warm_band"], lo_d, hi_d)) + 1)

    left = right = shared = 0
    for row_l, row_r in zip(mu[0].reshape(-1, w), mu[1].reshape(-1, w)):
        bands_l = [band(m) for m in row_l]
        for x in range(w):
            left += sum(d <= x for d in bands_l[x])
            for d in band(row_r[x]):
                if x + d < w:
                    right += 1
                    shared += d in bands_l[x + d]
    assert got == (left, right, shared)
    if case[6] == "consistent":
        assert shared == right > 0
    if case[6] == "disjoint":
        assert shared == 0 < right


@pytest.mark.parametrize("sigma", [1.0, 1.5, 0.7, 3.0])
def test_warm_energy_matches_jitted_reference_expression(sigma):
    """ref.warm_energy against jax.jit of the reference's expression
    (src/repro/kernels/ref.py, dense_match_rows_warm_ref's ``update``):
    inv_2s2 a Python float meeting float32, ``1 + diff * diff * inv_2s2`` and
    ``beta * sad + prior`` contracted to FMAs by XLA:CPU, a true division."""
    inv_2s2 = 1.0 / (2.0 * sigma * sigma)
    beta = 0.02

    def expr(sad, df, mu):
        diff = df - mu
        prior = -1.0 / (1.0 + diff * diff * inv_2s2)
        return beta * sad.astype(jnp.float32) + prior

    rng = np.random.default_rng(int(sigma * 10))
    n = 1 << 16
    sad = rng.integers(0, 4081, n).astype(np.int32)
    df = rng.integers(0, 256, n).astype(np.float32)
    mu = (df + rng.normal(0, 6, n)).astype(np.float32)
    mu[:64] = df[:64] + 0.5
    want = np.asarray(jax.jit(expr)(sad, df, mu))
    got = ref.warm_energy(torch.as_tensor(sad), torch.as_tensor(df), torch.as_tensor(mu),
                          beta=beta, inv_2s2=inv_2s2).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # Each operation rounded on its own gives other bits: the FMAs matter.
    diff = df - mu
    unfused = (np.float32(beta) * sad.astype(np.float32)
               + np.float32(-1.0) / (np.float32(1.0) + diff * diff * np.float32(inv_2s2)))
    assert not np.array_equal(unfused.view(np.int32), want.view(np.int32))


def test_warm_wrapper_takes_plain_version_on_cpu_without_counting():
    dl, dr, mu, kw = warm_inputs(WARM_CASES[0])
    args = [torch.as_tensor(a) for a in (dl, dr, mu[0], mu[1])]
    before = dense_kernel.warm_launches
    got = dense_kernel.dense_match_warm(*args, **kw)
    want = ref.dense_match_rows_warm_ref(*args, **kw)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    batched = dense_kernel.dense_match_warm(*(torch.stack([a, a]) for a in args), **kw)
    assert all(torch.equal(b[1], x) for b, x in zip(batched, want))
    assert dense_kernel.warm_launches == before


def test_warm_wrapper_rejects_bad_inputs():
    dl, dr, mu, kw = warm_inputs(WARM_CASES[0])
    args = [torch.as_tensor(a) for a in (dl, dr, mu[0], mu[1])]
    with pytest.raises(ValueError):
        dense_kernel.dense_match_warm(*args, **{**kw, "warm_band": -1})
    with pytest.raises(ValueError):
        dense_kernel.dense_match_warm(*args, **{**kw, "num_disp": dense_kernel.WARM_MAX_DISP + 1})
    with pytest.raises(TypeError):
        dense_kernel.dense_match_warm(args[0].int(), *args[1:], **kw)
    with pytest.raises(ValueError):
        dense_kernel.dense_match_warm(*args[:2], args[2][:1], args[3], **kw)


# ---------------------------------------------------------------- the stages
def test_descriptor_stage_batched_matches_reference():
    _, _, left, right = _frames()
    jdl, jdr = _descriptors()
    dl, dr = pipeline.ielas_descriptor_stage_batched(torch.as_tensor(left),
                                                     torch.as_tensor(right))
    assert np.array_equal(dl.numpy(), jdl) and np.array_equal(dr.numpy(), jdr)
    with pytest.raises(ValueError):
        pipeline.ielas_descriptor_stage_batched(torch.as_tensor(left[0]),
                                                torch.as_tensor(right[0]))


@pytest.mark.parametrize("warm_band,band_radius", [(8, None), (8, 2), (0, None), (3, 5)])
def test_warm_dense_stage_matches_reference(warm_band, band_radius):
    _, prevs, _, _ = _frames()
    jdl, jdr = _descriptors()
    kw = dict(warm_band=warm_band, band_radius=band_radius)
    want = np.asarray(ref_pipeline.ielas_warm_dense_stage(
        jnp.asarray(jdl[0]), jnp.asarray(jdr[0]), jnp.asarray(prevs[0]), RP, **kw))
    got = pipeline.ielas_warm_dense_stage(torch.as_tensor(jdl[0]), torch.as_tensor(jdr[0]),
                                          torch.as_tensor(prevs[0]), P, **kw)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("warm_band,band_radius", [(8, None), (8, 2)])
def test_warm_dense_stage_batched_matches_reference(warm_band, band_radius):
    _, prevs, _, _ = _frames()
    jdl, jdr = _descriptors()
    kw = dict(warm_band=warm_band, band_radius=band_radius)
    want = np.asarray(ref_pipeline.ielas_warm_dense_stage_batched(
        jnp.asarray(jdl), jnp.asarray(jdr), jnp.asarray(prevs), RP, **kw))
    got = pipeline.ielas_warm_dense_stage_batched(torch.as_tensor(jdl), torch.as_tensor(jdr),
                                                  torch.as_tensor(prevs), P, **kw)
    assert np.array_equal(got.numpy(), want)
    for i in range(2):
        one = pipeline.ielas_warm_dense_stage(torch.as_tensor(jdl[i]), torch.as_tensor(jdr[i]),
                                              torch.as_tensor(prevs[i]), P, **kw)
        assert torch.equal(got[i], one)


def test_warm_band_must_not_be_negative():
    _, prevs, _, _ = _frames()
    jdl, jdr = _descriptors()
    args = (torch.as_tensor(jdl[0]), torch.as_tensor(jdr[0]), torch.as_tensor(prevs[0]), P)
    with pytest.raises(ValueError):
        pipeline.ielas_warm_dense_stage(*args, warm_band=-1)
    with pytest.raises(ValueError):
        pipeline.ielas_warm_dense_stage(*args, warm_band=4, band_radius=-1)


# ---------------------------------------------------------------- warmstart.py
def test_thumbnails_and_scene_scores_match_reference():
    frames, _, _, _ = _frames()
    rng = np.random.default_rng(3)
    imgs = [frames[0][0], frames[1][0], rng.uniform(0, 255, (5, 7)).astype(np.float32),
            rng.uniform(0, 255, (17, 9))]
    for img in imgs:
        for stride in (8, 4):
            a = warmstart.frame_thumbnail(img, stride)
            b = ref_warmstart.frame_thumbnail(img, stride)
            assert a.dtype == b.dtype and np.array_equal(a, b)
    ta, tb = (warmstart.frame_thumbnail(f[0]) for f in frames[:2])
    assert warmstart.scene_change_score(ta, tb) == ref_warmstart.scene_change_score(ta, tb)
    assert warmstart.scene_change_score(ta, ta[:1]) == float("inf")


@pytest.mark.parametrize("seed", range(3))
def test_prior_disagreement_and_corruption_match_reference(seed):
    rng = np.random.default_rng(seed)
    disp = rng.integers(0, 40, (H, W)).astype(np.float32)
    prior = disp + rng.integers(-3, 4, (H, W)).astype(np.float32)
    disp[rng.random((H, W)) < 0.2] = -1.0
    prior[rng.random((H, W)) < 0.1] = -1.0
    for stride in (4, 1):
        assert (warmstart.prior_disagreement(disp, prior, 64, stride=stride)
                == ref_warmstart.prior_disagreement(disp, prior, 64, stride=stride))
    empty = np.full((H, W), -1.0, np.float32)
    assert warmstart.prior_disagreement(disp, empty, 64) == 64.0
    a = warmstart.corrupt_disparity(disp, 63.0)
    b = ref_warmstart.corrupt_disparity(disp, 63.0)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_warm_state_and_classify_match_reference():
    thumb = np.ones((2, 2), np.float32)
    disp = np.zeros((H, W), np.float32)
    cases = []
    for mod in (warmstart, ref_warmstart):
        state = mod.WarmState.from_delivery(disp, thumb, seq=4, streak=2)
        disp[0, 0] = 9.0                    # the state holds a copy
        assert state.disparity[0, 0] == 0.0 and state.shape == (H, W)
        disp[0, 0] = 0.0
        kw = dict(threshold=20.0, refresh_interval=30)
        cases.append([
            mod.classify(None, thumb, (H, W), 5, **kw),
            mod.classify(state, thumb, (H, W), 6, **kw),
            mod.classify(state, thumb, (H, W + 1), 5, **kw),
            mod.classify(state, thumb, (H, W), 5, threshold=20.0, refresh_interval=3),
            mod.classify(state, thumb + 50, (H, W), 5, **kw),
            mod.classify(state, thumb + 1, (H, W), 5, **kw),
        ])
    assert cases[0] == cases[1]
    assert [c[1] for c in cases[0]] == ["no_state", "stale_seq", "resolution", "refresh",
                                        "scene_change", "warm"]
