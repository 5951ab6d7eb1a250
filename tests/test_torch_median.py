"""The port's 3x3 median against the JAX package, and the facts its CUDA
kernel (csrc/median.cu) relies on, proved on the plain side.

* ``median3x3`` (the plain version on the CPU) equals the reference's
  ``postprocess.median3x3`` and ``median3x3_pallas(interpret=True)`` on
  seeded maps -- invalid pixels, ties, thin maps, stacks -- and on random
  maps (hypothesis); tolerance ``==``.
* The kernel assembles each output's 9 neighbours from its register rows,
  replaces an invalid one by the centre, and runs Paeth's network
  (``ref.median9``), the plain version's: the network returns the sorted
  middle value of any 9 floats without NaN (hypothesis, bit for bit).
* min/max choose freely between -0.0 and +0.0: the maps the path hands the
  median hold no -0.0 and no NaN (pinned on the post-processing chain).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st
from repro.core.postprocess import median3x3 as ref_median3x3
from repro.kernels.median import median3x3_pallas
from repro_torch.configs.elas_stereo import SYNTH
from repro_torch.core.postprocess import gap_interpolation, lr_consistency
from repro_torch.kernels import median as median_kernel
from repro_torch.kernels import ref
from torch_kernel_cases import MEDIAN_CASES, median_map, median_stack

P = SYNTH.params


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("case", MEDIAN_CASES, ids=[c[0] for c in MEDIAN_CASES])
def test_median_matches_reference_postprocess(case):
    disp = median_map(case)
    got = median_kernel.median3x3(torch.as_tensor(disp))
    want = np.asarray(ref_median3x3(jnp.asarray(disp)))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", MEDIAN_CASES, ids=[c[0] for c in MEDIAN_CASES])
def test_median_stack_matches_pallas_per_map(case):
    stack = median_stack(case)
    got = median_kernel.median3x3(torch.as_tensor(stack))
    for i in range(2):
        want = np.asarray(median3x3_pallas(jnp.asarray(stack[i]), interpret=True))
        assert np.array_equal(got[i].numpy(), want)


@settings(max_examples=80, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), levels=st.integers(1, 9),
       special=st.sampled_from([None, float("inf"), -float("inf"), -1.0, 1e30]))
def test_median9_is_the_sorted_middle(seed, levels, special):
    """Paeth's 19 min/max pairs give the 5th smallest of 9 values, bit for
    bit, whatever their order, ties and infinities."""
    rng = np.random.default_rng(seed)
    vals = (rng.integers(-3, levels, (9, 64)) * 0.5).astype(np.float32)
    vals[vals == 0] = 0.0                               # no -0.0
    if special is not None:
        vals[rng.random((9, 64)) < 0.3] = special
    t = torch.as_tensor(vals)
    got = ref.median9(list(t))
    want = torch.sort(t, dim=0).values[4]
    assert np.array_equal(_bits(got), _bits(want))


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), h=st.integers(1, 12), w=st.integers(1, 14),
       invalid=st.sampled_from([0.0, 0.2, 0.5, 1.0]))
def test_median_matches_reference_on_random_maps(seed, h, w, invalid):
    rng = np.random.default_rng(seed)
    disp = (rng.integers(0, 8, (h, w)) * 0.5).astype(np.float32)
    disp[rng.random((h, w)) < invalid] = -1.0
    got = median_kernel.median3x3(torch.as_tensor(disp))
    assert np.array_equal(got.numpy(), np.asarray(ref_median3x3(jnp.asarray(disp))))


@pytest.mark.parametrize("seed", range(6))
def test_path_maps_hold_no_negative_zero_or_nan(seed):
    """The median's input on the path -- lr_consistency then
    gap_interpolation of two dense maps -- holds no -0.0 and no NaN, even
    with many zero disparities and gaps between zero and nonzero ends."""
    rng = np.random.default_rng(seed)
    h, w = 12, 40
    dl = rng.integers(0, 4, (h, w)).astype(np.float32)
    dl[rng.random((h, w)) < 0.4] = -1.0
    dr = np.where(rng.random((h, w)) < 0.8, dl, rng.integers(0, 4, (h, w))).astype(np.float32)
    out = gap_interpolation(lr_consistency(torch.as_tensor(dl), torch.as_tensor(dr), P), P)
    assert not bool(torch.isnan(out).any())
    assert not bool(((out == 0) & torch.signbit(out)).any())
    assert bool((out == 0).any()), "the case must reach zero disparities"


def test_median_of_stack_equals_per_map_calls_at_any_offset():
    """A stack whose first map starts 4, 8 or 12 bytes past a 16-byte
    boundary (as a wave's slices lie) gives each map's own median."""
    stack = torch.as_tensor(median_stack(MEDIAN_CASES[10]))
    for offset in (0, 1, 2, 3):
        raw = torch.zeros(stack.numel() + offset)
        view = raw[offset:].view(stack.shape)
        view.copy_(stack)
        got = median_kernel.median3x3(view)
        for i in range(2):
            assert torch.equal(got[i], median_kernel.median3x3(stack[i].clone()))


def test_median_wrapper_limits_hold_on_cpu():
    before = median_kernel.launches
    with pytest.raises(ValueError):
        median_kernel.median3x3(torch.zeros((median_kernel.MEDIAN_MAX_HEIGHT + 1, 1)))
    with pytest.raises(ValueError):
        median_kernel.median3x3(torch.zeros((0, 4)))
    assert median_kernel.launches == before
