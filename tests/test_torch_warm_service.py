"""The port's warm-start StereoService on the CPU against the JAX service:
an 8-frame 60x80 pan with a scene cut at frame 4, driven one frame at a
time through both services.  Every delivered frame, warm frames included,
equals the reference service's bit for bit, and so do the warm counters.
The cold frames of the warm stream (the first, the cut) equal the cold
path; the warm frames track the scene as well as the cold path does, within
the reference's margin.  Also the reference's other service cases of
tests/test_warm_start.py: the forced refresh, interleaved streams, warm
start off, and the constructor's checks.  The fault cases are in
tests/test_torch_warm_faults.py.
"""
import functools

import numpy as np
import pytest

from repro_torch.configs.elas_stereo import SYNTH
from repro_torch.data.stereo import synthetic_stereo_sequence
from repro_torch.serving import StereoService
from torch_serving_cases import (
    WARM_COUNTERS,
    drive,
    expected_output,
    port_warm_run,
    reference_warm_run,
)

P = SYNTH.params
N_FRAMES, CUT = 8, 4
# Warm frames trade a little accuracy for the narrowed search; the
# reference's tests hold their bad-pixel rate within +0.10 of the cold path.
BAD_PX_MARGIN = 0.10


@functools.cache
def _frames(n=N_FRAMES, cut_at=CUT, h=60, w=80, seed=3):
    return synthetic_stereo_sequence(n, height=h, width=w, d_max=24.0, motion=2,
                                     cut_at=cut_at, seed=seed)


@functools.cache
def _runs():
    frames = _frames()
    kw = dict(batch=1, depth=2, warm_start=True, warm_band=8)
    return reference_warm_run(frames, **kw), port_warm_run(frames, **kw)


def _bad_px(disp, gt, tol=3.0):
    valid = disp >= 0
    assert valid.any()
    return float((np.abs(disp - gt) > tol)[valid].mean())


@pytest.mark.parametrize("t", range(N_FRAMES))
def test_frame_equals_reference_service(t):
    (ref_outs, _), (outs, _) = _runs()
    want, got = ref_outs[t], outs[t]
    assert got.ok and want.ok, (got.error, want.error)
    assert got.frame_id == want.frame_id == t
    assert got.disparity.dtype == np.float32 and got.disparity.shape == want.disparity.shape
    assert int(np.sum(got.disparity != want.disparity)) == 0


@pytest.mark.parametrize("counter", WARM_COUNTERS)
def test_counter_equals_reference_service(counter):
    (_, ref_counts), (_, counts) = _runs()
    assert counts[counter] == ref_counts[counter]


def test_sequence_shape_in_the_counters():
    """Frame 0 has no state, frame 4 is the cut: two cold frames, six warm."""
    _, (_, counts) = _runs()
    assert counts["cold_frames"] == 2 and counts["warm_frames"] == N_FRAMES - 2
    assert counts["scene_changes"] == 1
    assert counts["warm_refreshes"] == counts["warm_reruns"] == counts["warm_resets"] == 0


@pytest.mark.parametrize("t", [0, CUT])
def test_cold_frames_equal_the_cold_path(t):
    _, (outs, _) = _runs()
    left, right, _ = _frames()[t]
    assert np.array_equal(outs[t].disparity, expected_output(left, right))


@pytest.mark.parametrize("t", [1, 2, 3, 5, 6, 7])
def test_warm_frames_track_cold_quality(t):
    _, (outs, _) = _runs()
    left, right, gt = _frames()[t]
    cold = expected_output(left, right)
    assert _bad_px(outs[t].disparity, gt) <= _bad_px(cold, gt) + BAD_PX_MARGIN
    assert not np.array_equal(outs[t].disparity, cold), "a warm frame is another solution"


def test_refresh_frame_is_cold_and_counted():
    frames = _frames(5, None, 40, 64, 1)
    (ref_outs, ref_counts) = reference_warm_run(frames, batch=1, warm_start=True,
                                                refresh_interval=3)
    outs, counts = port_warm_run(frames, batch=1, warm_start=True, refresh_interval=3)
    assert counts == ref_counts
    assert counts["warm_refreshes"] == 1 and counts["cold_frames"] == 2
    for got, want in zip(outs, ref_outs):
        assert np.array_equal(got.disparity, want.disparity)
    assert np.array_equal(outs[3].disparity, expected_output(*frames[3][:2]))


def test_interleaved_streams_keep_independent_state():
    frames_a = _frames(3, None, 40, 64, 1)
    frames_b = _frames(3, None, 40, 64, 9)
    with StereoService(P, batch=1, warm_start=True, device="cpu") as svc:
        outs = []
        for t in range(3):
            outs += drive(svc, [frames_a[t]], stream_id=0)
            outs += drive(svc, [frames_b[t]], stream_id=1)
        st = svc.stats()
    assert all(c.ok for c in outs)
    assert st.cold_frames == 2 and st.warm_frames == 4       # each stream's first frame
    for c in outs[:2]:
        frames = frames_a if c.stream_id == 0 else frames_b
        assert np.array_equal(c.disparity, expected_output(*frames[0][:2]))


def test_warm_start_off_is_the_default_and_untouched():
    frames = _frames(2, None, 40, 64, 1)
    with StereoService(P, batch=1, device="cpu") as svc:
        outs = drive(svc, frames)
        st = svc.stats()
    assert st.warm_frames == st.cold_frames == st.warm_reruns == st.warm_resets == 0
    for c, (left, right, _) in zip(outs, frames):
        assert np.array_equal(c.disparity, expected_output(left, right))


@pytest.mark.parametrize("bad", [dict(warm_band=-1), dict(refresh_interval=0),
                                 dict(rerun_threshold=0.0), dict(rerun_threshold=1.5)])
def test_constructor_validation(bad):
    with pytest.raises(ValueError):
        StereoService(P, warm_start=True, device="cpu", **bad)
    StereoService(P, warm_start=False, device="cpu", **bad)     # checked only when warm
