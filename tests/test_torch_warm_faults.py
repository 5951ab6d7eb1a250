"""Fault-injected warm-start transitions of the port's StereoService on the
CPU, the warm cases of tests/test_warm_start.py and
tests/test_serving_faults.py: an injected scene cut, a corrupt in-flight
prior and a poisoned stored seed (both caught by the post-hoc check and
re-run cold), a transient dense fault on a warm wave (retried warm), a
quarantined and a shed seed (neither warms its successor), and the
degraded warm program's band.  The main fault run is held against the JAX
service frame by frame and counter by counter; every re-run or fallback
frame equals the cold path bit for bit.
"""
import functools
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.elas_stereo import SYNTH
from repro_torch.core.pipeline import ielas_warm_dense_stage_batched
from repro_torch.data.stereo import synthetic_stereo_sequence
from repro_torch.serving import StereoService
from repro_torch.serving.stereo_service import FrameProgramCache
from torch_serving_cases import (
    WARM_COUNTERS,
    drive,
    expected_output,
    port_warm_run,
    reference_warm_run,
)

pytestmark = pytest.mark.faults

P = SYNTH.params
N_FRAMES = 8
# rid 1's wave fails its dense stage once (retried on the batch-1 warm
# program); rid 2's pinned prior is corrupted in flight; rid 4 is forced to
# a scene cut; rid 6's stored seed is poisoned before it is classified.
FAULTS = (
    dict(stage="dense", wave=1, times=1),
    dict(stage="warm", kind="corrupt_prior", request_id=2),
    dict(stage="warm", kind="scene_cut", request_id=4),
    dict(stage="warm", kind="stale_state", request_id=6),
)


@functools.cache
def _frames(n=N_FRAMES, h=60, w=80):
    return synthetic_stereo_sequence(n, height=h, width=w, d_max=24.0, motion=2, seed=5)


@functools.cache
def _runs():
    kw = dict(batch=1, depth=2, warm_start=True)
    return (reference_warm_run(_frames(), FAULTS, **kw),
            port_warm_run(_frames(), FAULTS, **kw))


@pytest.mark.parametrize("t", range(N_FRAMES))
def test_fault_run_frame_equals_reference_service(t):
    (ref_outs, _), (outs, _) = _runs()
    assert outs[t].ok and ref_outs[t].ok, (outs[t].error, ref_outs[t].error)
    assert int(np.sum(outs[t].disparity != ref_outs[t].disparity)) == 0


@pytest.mark.parametrize("counter", WARM_COUNTERS)
def test_fault_run_counter_equals_reference_service(counter):
    (_, ref_counts), (_, counts) = _runs()
    assert counts[counter] == ref_counts[counter]


def test_fault_run_counters_tell_the_story():
    _, (_, counts) = _runs()
    assert counts["retried"] == 1                       # rid 1, recovered warm
    assert counts["scene_changes"] == 1                 # rid 4
    assert counts["warm_reruns"] == 2                   # rids 2 and 6
    assert counts["cold_frames"] == 2 and counts["warm_frames"] == N_FRAMES - 2
    assert counts["warm_resets"] == 0 and counts["failed_frames"] == 0


@pytest.mark.parametrize("t", [0, 2, 4, 6])
def test_fallback_and_rerun_frames_equal_the_cold_path(t):
    """The first frame, the injected cut and both post-hoc re-runs."""
    _, (outs, _) = _runs()
    assert np.array_equal(outs[t].disparity, expected_output(*_frames()[t][:2]))


def test_retried_warm_frame_is_warm():
    _, (outs, _) = _runs()
    assert not np.array_equal(outs[1].disparity, expected_output(*_frames()[1][:2]))


def test_quarantined_seed_never_warms_its_successor():
    frames = _frames(4, 40, 64)
    specs = (dict(stage="dense", request_id=1, times=None),)
    ref_outs, ref_counts = reference_warm_run(frames, specs, batch=1, warm_start=True)
    outs, counts = port_warm_run(frames, specs, batch=1, warm_start=True)
    assert counts == ref_counts
    assert outs[1].error is not None and ref_outs[1].error is not None
    assert np.array_equal(outs[2].disparity, expected_output(*frames[2][:2]))
    assert counts["warm_resets"] >= 1 and counts["failed_frames"] == 1
    for t in (0, 2, 3):
        assert np.array_equal(outs[t].disparity, ref_outs[t].disparity)


def test_shed_seed_never_warms_its_successor():
    frames = _frames(3, 40, 64)
    with StereoService(P, batch=1, warm_start=True, device="cpu") as svc:
        outs = drive(svc, frames, deadlines={1: time.monotonic() - 1.0})
        st = svc.stats()
    assert outs[1].error is not None and st.shed == 1
    assert np.array_equal(outs[2].disparity, expected_output(*frames[2][:2]))
    assert st.warm_resets >= 1 and st.warm_frames == 0


def test_support_fault_on_a_warm_wave_recovers_warm():
    """A warm wave whose support stage fails once is retried on the batch-1
    warm programs with its slice of the pinned prior, and delivers the frame
    the fault-free run delivers.  (The reference's retry drops the prior
    here and quarantines the frame; the port does not reproduce that.)"""
    frames = _frames(3, 40, 64)
    clean, _ = port_warm_run(frames, batch=1, warm_start=True)
    outs, counts = port_warm_run(frames, (dict(stage="support", wave=2, times=1),),
                                 batch=1, warm_start=True)
    assert counts["retried"] == 1 and counts["warm_frames"] == 2
    assert all(c.ok for c in outs)
    assert np.array_equal(outs[2].disparity, clean[2].disparity)


def test_degraded_warm_program_uses_band_intersection():
    frames = _frames(2, 40, 64)
    prev = torch.as_tensor(np.array(expected_output(*frames[0][:2])))[None]
    cache = FrameProgramCache(P, batch=1, device="cpu", degraded_radius=2, warm_band=8)
    prog = cache.get(40, 64, batch=1)
    left = torch.as_tensor(frames[1][0], dtype=torch.float32)[None]
    right = torch.as_tensor(frames[1][1], dtype=torch.float32)[None]
    dl, dr = prog.support_warm(left, right)
    degraded = prog.dense_warm_degraded(dl, dr, prev)
    assert torch.equal(degraded, ielas_warm_dense_stage_batched(dl, dr, prev, P, warm_band=2))
    assert not torch.equal(degraded, prog.dense_warm(dl, dr, prev))
