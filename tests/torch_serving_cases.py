"""Shared helpers of the port's service tests: frames from the reference's
synthetic scenes, and the JAX reference's output for a pair as the
reference service delivers it."""
import math

import jax.numpy as jnp
import numpy as np

from repro.configs.elas_stereo import SYNTH as REF_SYNTH
from repro.core.pipeline import ielas_disparity as ref_ielas_disparity
from repro.data.stereo import synthetic_stereo_pair

_EXPECTED: dict = {}


def scene_pairs(n, h=60, w=80, seed0=0):
    return [
        synthetic_stereo_pair(height=h, width=w, d_max=24, seed=seed0 + s)[:2]
        for s in range(n)
    ]


def expected_output(left, right, bucket=1):
    """The JAX reference's output for one pair as the reference service
    delivers it: with ``bucket > 1`` the pair is edge-padded up to the
    bucket multiple and the result cropped."""
    h, w = left.shape
    bh, bw = math.ceil(h / bucket) * bucket, math.ceil(w / bucket) * bucket
    key = (left.tobytes(), right.tobytes(), bh, bw)
    if key not in _EXPECTED:
        pad = ((0, bh - h), (0, bw - w))
        il = np.pad(np.asarray(left, np.float32), pad, mode="edge")
        ir = np.pad(np.asarray(right, np.float32), pad, mode="edge")
        out = ref_ielas_disparity(jnp.asarray(il), jnp.asarray(ir), REF_SYNTH.params)
        _EXPECTED[key] = np.asarray(out)[:h, :w]
    return _EXPECTED[key]


def assert_bitwise(done, pairs, bucket=1):
    """Every delivered frame equals the reference's output of its pair;
    ``pairs`` maps (stream_id, frame_id) to the pair submitted."""
    for c in done:
        assert c.ok, c.error
        want = expected_output(*pairs[(c.stream_id, c.frame_id)], bucket=bucket)
        assert c.disparity.shape == want.shape and c.disparity.dtype == np.float32
        diff = int(np.sum(c.disparity != want))
        assert diff == 0, f"frame {c.frame_id} of stream {c.stream_id}: {diff} pixels differ"


WARM_COUNTERS = ("warm_frames", "cold_frames", "scene_changes", "warm_refreshes",
                 "warm_reruns", "warm_resets", "retried", "failed_frames", "shed")


def drive(svc, frames, stream_id=0, deadlines=None):
    """Live-camera pacing: frame t+1 is submitted only after frame t was
    delivered (the warm chain needs each seed delivered before its
    successor is classified).  ``deadlines`` maps a frame index to a
    ``deadline`` for submit."""
    outs = []
    for t, (left, right, *_) in enumerate(frames):
        svc.submit(t, left, right, stream_id=stream_id,
                   deadline=(deadlines or {}).get(t))
        got = svc.collect(1, timeout=300)
        assert len(got) == 1, f"frame {t} never delivered"
        outs.extend(got)
    return outs


def reference_warm_run(frames, fault_specs=(), **kw):
    """The JAX StereoService's deliveries and warm counters for ``frames``
    driven one at a time, with a FaultPlan of ``fault_specs`` (a list of
    FaultSpec keyword dicts) and the service keywords ``kw``."""
    from repro.serving import FaultPlan, FaultSpec, StereoService

    plan = FaultPlan([FaultSpec(**s) for s in fault_specs]) if fault_specs else None
    with StereoService(REF_SYNTH.params, fault_plan=plan, **kw) as svc:
        outs = drive(svc, frames)
        st = svc.stats()
    return outs, {k: getattr(st, k) for k in WARM_COUNTERS}


def port_warm_run(frames, fault_specs=(), **kw):
    """The same run through the port's StereoService on the CPU."""
    from repro_torch.configs.elas_stereo import SYNTH
    from repro_torch.serving import FaultPlan, FaultSpec, StereoService

    plan = FaultPlan([FaultSpec(**s) for s in fault_specs]) if fault_specs else None
    with StereoService(SYNTH.params, fault_plan=plan, device="cpu", **kw) as svc:
        outs = drive(svc, frames)
        st = svc.stats()
    return outs, {k: getattr(st, k) for k in WARM_COUNTERS}
