"""Fault containment, admission control and liveness of the port's
StereoService on the CPU: the cold cases of tests/test_serving_faults.py
(its warm-start cases are in tests/test_torch_warm_faults.py).  Frames that
recover are held against the JAX ``ielas_disparity`` of their pair bit for
bit.  Also: an emit-stage fault fails only its wave, and the copied
harness, admission controller and heartbeat monitor behave as the
reference's on the same inputs.
"""
import time

import pytest

from repro.runtime.fault_tolerance import HeartbeatMonitor as RefHeartbeatMonitor
from repro.serving import AdmissionController as RefAdmissionController
from repro.serving import FaultInjected as RefFaultInjected
from repro.serving import FaultPlan as RefFaultPlan
from repro.serving import FaultSpec as RefFaultSpec
from repro_torch.configs.elas_stereo import SYNTH
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.serving import (
    AdmissionController,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    StereoService,
)
from torch_serving_cases import assert_bitwise, scene_pairs

pytestmark = pytest.mark.faults

P = SYNTH.params


def _frames(n):
    return scene_pairs(n, h=40, w=64)


def _service(**kw):
    svc = StereoService(P, device="cpu", **kw)
    svc.warmup([(40, 64)])
    return svc


# ---------------------------------------------------------------------------
# harness units (no service)
# ---------------------------------------------------------------------------
class TestFaultPlan:
    @pytest.mark.parametrize("impl", ["port", "reference"])
    def test_spec_validation(self, impl):
        spec = FaultSpec if impl == "port" else RefFaultSpec
        for bad in (dict(stage="nope"), dict(stage="dense", kind="explode"),
                    dict(stage="dense", times=0), dict(stage="warm", kind="raise")):
            with pytest.raises(ValueError):
                spec(**bad)
        assert spec(stage="warm", kind="scene_cut").kind == "scene_cut"

    def test_matching_is_an_and_of_conditions(self):
        for plan, exc in ((FaultPlan([FaultSpec(stage="dense", wave=3, request_id=7,
                                                times=None)]), FaultInjected),
                          (RefFaultPlan([RefFaultSpec(stage="dense", wave=3, request_id=7,
                                                      times=None)]), RefFaultInjected)):
            plan.check("support", 3, (7,))       # wrong stage: no fire
            plan.check("dense", 2, (7,))         # wrong wave: no fire
            plan.check("dense", 3, (5, 6))       # request not riding: no fire
            assert plan.fired(0) == 0
            with pytest.raises(exc):
                plan.check("dense", 3, (6, 7))
            assert plan.fired(0) == 1

    def test_times_bounds_firings(self):
        plan = FaultPlan([FaultSpec(stage="support", times=2)])
        for _ in range(2):
            with pytest.raises(FaultInjected):
                plan.check("support", 0, (0,))
        plan.check("support", 0, (0,))       # spec exhausted: quiet now
        assert plan.fired(0) == 2

    def test_delay_kind_sleeps_instead_of_raising(self):
        plan = FaultPlan([FaultSpec(stage="dense", kind="delay", delay_s=0.05, times=1)])
        t0 = time.monotonic()
        plan.check("dense", 0, (0,))         # no raise
        assert time.monotonic() - t0 >= 0.05
        t0 = time.monotonic()
        plan.check("dense", 1, (1,))         # exhausted: no sleep either
        assert time.monotonic() - t0 < 0.05

    def test_warm_kinds_are_kept_but_not_checked(self):
        plan = FaultPlan([FaultSpec(stage="warm", kind="stale_state", request_id=3)])
        plan.check("warm", 0, (3,))          # warm specs never fire in check()
        assert plan.warm_kind(2) is None
        assert plan.warm_kind(3) == "stale_state"
        assert plan.warm_kind(3) is None     # times=1: consumed


class _R:
    """Minimal request stand-in for AdmissionController tests."""

    def __init__(self, rid, sid, deadline=None):
        self.request_id = rid
        self.stream_id = sid
        self.deadline = deadline


class TestAdmissionController:
    def test_watermark_validation(self):
        with pytest.raises(ValueError):
            AdmissionController(degrade_watermark=0)
        with pytest.raises(ValueError):
            AdmissionController(degrade_watermark=4, clear_watermark=4)

    def test_expired_work_is_shed(self):
        ctl = AdmissionController()
        reqs = [_R(0, 0, deadline=5.0), _R(1, 0), _R(2, 0, deadline=20.0)]
        admitted, dead = ctl.select(reqs, width=4, now=10.0)
        assert [r.request_id for r in dead] == [0]
        assert [r.request_id for r in admitted] == [1, 2]
        c = ctl.counters()
        assert c["shed"] == c["expired"] == 1
        assert c["shed_by_stream"] == ((0, 1),)

    def test_round_robin_matches_reference(self):
        """One slot per stream before a stream gets a second, rotation
        resuming after the last stream served: the same picks as the
        reference's controller over a sequence of waves."""
        port, refc = AdmissionController(), RefAdmissionController()
        waves = [([_R(i, 0) for i in range(4)] + [_R(10, 1), _R(11, 2)], 3),
                 ([_R(20, 0), _R(21, 1)], 2),
                 ([_R(30, 0), _R(31, 1), _R(32, 2)], 1),
                 ([_R(40, 2), _R(41, 2), _R(42, 0, deadline=1.0)], 2)]
        for reqs, width in waves:
            got = port.select(reqs, width, now=5.0)
            want = refc.select(reqs, width, now=5.0)
            assert [[r.request_id for r in x] for x in got] == \
                [[r.request_id for r in x] for x in want]
        assert port.counters() == refc.counters()

    def test_degraded_hysteresis(self):
        ctl = AdmissionController(degrade_watermark=8, clear_watermark=2)
        assert ctl.update_pressure(7) is False
        assert ctl.update_pressure(8) is True          # engage at watermark
        assert ctl.update_pressure(5) is True          # hysteresis: hold
        assert ctl.update_pressure(2) is False         # clear at low mark
        assert ctl.counters()["degraded_transitions"] == 1

    def test_disabled_without_watermark(self):
        assert AdmissionController().update_pressure(10_000) is False


class TestHeartbeatMonitor:
    def test_liveness_with_fake_clock(self):
        t = [0.0]
        mon = HeartbeatMonitor(["support", "dense"], timeout=10.0, clock=lambda: t[0])
        assert mon.is_alive("support")       # registration counts as a beat
        t[0] = 5.0
        mon.beat("support", 1)
        t[0] = 12.0
        assert mon.is_alive("support")       # beaten at t=5, within 10
        assert not mon.is_alive("dense")     # silent since t=0
        assert mon.dead_hosts() == ["dense"]
        assert mon.healthy_hosts() == ["support"]
        assert not mon.is_alive("never-registered")

    def test_beat_auto_registers_unknown_host(self):
        mon = HeartbeatMonitor([], timeout=10.0, clock=lambda: 0.0)
        mon.beat("late-stage", 0)
        assert mon.is_alive("late-stage")

    def test_stragglers_match_reference(self):
        """The same beats give the same stragglers as the reference's
        monitor (mean time per step against the median)."""
        t = [0.0]
        mons = [cls(["a", "b", "c"], timeout=1e9, clock=lambda: t[0])
                for cls in (HeartbeatMonitor, RefHeartbeatMonitor)]
        for host, dt in (("a", 1.0), ("b", 1.0), ("c", 10.0)):
            for step, at in ((0, 100.0), (1, 100.0 + dt), (3, 100.0 + 3 * dt)):
                t[0] = at
                for mon in mons:
                    mon.beat(host, step)
        assert mons[0].stragglers() == mons[1].stragglers() == ["c"]


# ---------------------------------------------------------------------------
# containment in the live engine
# ---------------------------------------------------------------------------
class TestContainment:
    def test_transient_fault_retries_and_recovers_bitwise(self):
        """Wave 0's support attempt fails once; the single-frame retries
        recover every slot bit for bit, and nothing fails."""
        frames = _frames(4)
        plan = FaultPlan([FaultSpec(stage="support", wave=0, times=1)])
        svc = _service(batch=2, wave_linger=0.05, fault_plan=plan)
        with svc:
            for i, (l, r) in enumerate(frames):
                svc.submit(i, l, r)
            done = svc.collect(4, timeout=300)
        st = svc.stats()
        assert len(done) == 4 and all(c.ok for c in done)
        assert plan.fired(0) == 1
        assert st.retried == 2               # both slots of the failed wave
        assert st.failed_frames == 0
        assert st.completed == 4 and st.pending == 0
        assert_bitwise(done, {(0, i): f for i, f in enumerate(frames)})

    def test_persistent_wave_fault_is_isolated(self):
        """A fault pinned to wave 0 (batched attempt AND retries) fails only
        wave 0's frames; the next wave is untouched."""
        frames = _frames(4)
        plan = FaultPlan([FaultSpec(stage="dense", wave=0, times=None)])
        svc = _service(batch=2, wave_linger=0.05, fault_plan=plan)
        with svc:
            for i, (l, r) in enumerate(frames):
                svc.submit(i, l, r)
            done = svc.collect(4, timeout=300)
        st = svc.stats()
        assert len(done) == 4
        failed = [c for c in done if not c.ok]
        assert len(failed) == 2, "exactly one wave's frames should fail"
        for c in failed:
            assert c.disparity is None
            assert "dense stage failed after retry" in c.error
        assert st.failed_frames == 2 and st.completed == 2 and st.pending == 0
        assert_bitwise([c for c in done if c.ok], {(0, i): f for i, f in enumerate(frames)})

    def test_poison_frame_quarantined_wave_mates_recover(self):
        """A request-pinned fault re-fires on the frame's retry: that frame
        fails terminally while its wave-mate recovers bit for bit."""
        frames = _frames(2)
        plan = FaultPlan([FaultSpec(stage="dense", request_id=1, times=None)])
        svc = _service(batch=2, wave_linger=0.05, fault_plan=plan)
        with svc:
            for i, (l, r) in enumerate(frames):
                svc.submit(i, l, r)
            done = svc.collect(2, timeout=300)
        st = svc.stats()
        by_id = {c.frame_id: c for c in done}
        assert not by_id[1].ok and by_id[1].disparity is None
        assert_bitwise([by_id[0]], {(0, 0): frames[0]})
        assert st.failed_frames == 1 and st.completed == 1
        assert st.retried == 2               # both slots were retried

    def test_retry_programs_do_not_evict_hot_path(self):
        """The batch-1 program the retry makes lives beside the batch-2
        one: traffic after the fault makes no new program."""
        frames = _frames(6)
        plan = FaultPlan([FaultSpec(stage="support", wave=0, times=1)])
        svc = _service(batch=2, wave_linger=0.05, fault_plan=plan)
        with svc:
            for i, (l, r) in enumerate(frames[:2]):
                svc.submit(i, l, r)
            svc.collect(2, timeout=300)
            misses_after_fault = svc.stats().cache_misses
            for i, (l, r) in enumerate(frames[2:], start=2):
                svc.submit(i, l, r)
            done = svc.collect(4, timeout=300)
        st = svc.stats()
        assert len(done) == 4 and all(c.ok for c in done)
        assert misses_after_fault == 1, "the retry makes exactly one batch-1 program"
        assert st.cache_misses == misses_after_fault
        assert st.programs_cached == 2       # batch-2 hot + batch-1 fallback

    def test_systemic_failure_aborts_engine(self):
        """Every attempt failing is systemic: after max_wave_failures
        consecutive dead waves the engine aborts, stop() re-raises, and
        submit() refuses."""
        frames = _frames(6)
        plan = FaultPlan([FaultSpec(stage="support", times=None)])
        svc = _service(batch=2, wave_linger=0.05, fault_plan=plan, max_wave_failures=2)
        svc.start()
        for i, (l, r) in enumerate(frames):
            try:
                svc.submit(i, l, r)
            except RuntimeError:
                break           # engine already aborted mid-submission: fine
        with pytest.raises(RuntimeError, match="worker failed"):
            svc.stop(drain=True, timeout=60)
        assert isinstance(svc._error, RuntimeError)
        assert "systemic" in str(svc._error)
        with pytest.raises(RuntimeError):
            svc.submit(99, *frames[0])

    def test_isolated_failures_never_count_as_systemic(self):
        """Waves that fail but recover by retry reset the consecutive count."""
        frames = _frames(6)
        plan = FaultPlan([FaultSpec(stage="support", wave=w, times=1) for w in range(3)])
        svc = _service(batch=2, wave_linger=0.05, fault_plan=plan, max_wave_failures=2)
        with svc:
            for i, (l, r) in enumerate(frames):
                svc.submit(i, l, r)
            done = svc.collect(6, timeout=300)
        assert len(done) == 6 and all(c.ok for c in done)
        assert svc.stats().retried == 6

    def test_in_order_failed_frame_does_not_block_stream(self):
        """With in_order=True a quarantined frame delivers its sequence slot
        as an error frame, so later frames still come out, in order."""
        frames = _frames(4)
        plan = FaultPlan([FaultSpec(stage="dense", request_id=1, times=None)])
        svc = _service(batch=2, wave_linger=0.05, in_order=True, fault_plan=plan)
        with svc:
            for i, (l, r) in enumerate(frames):
                svc.submit(i, l, r)
            done = svc.collect(4, timeout=300)
        assert [c.frame_id for c in done] == [0, 1, 2, 3]
        assert [c.ok for c in done] == [True, False, True, True]

    def test_emit_fault_fails_only_its_wave(self):
        """A fault at emit has no retry (the wave's results are gone): its
        frames fail terminally, the next wave is delivered, the engine
        stays up; max_wave_failures consecutive emit faults abort it."""
        frames = _frames(4)
        plan = FaultPlan([FaultSpec(stage="emit", wave=0, times=1)])
        svc = _service(batch=2, wave_linger=0.05, fault_plan=plan)
        with svc:
            for i, (l, r) in enumerate(frames):
                svc.submit(i, l, r)
            done = svc.collect(4, timeout=300)
        st = svc.stats()
        failed = [c for c in done if not c.ok]
        assert len(done) == 4 and len(failed) == 2
        assert all("emit stage failed" in c.error and c.disparity is None for c in failed)
        assert st.failed_frames == 2 and st.completed == 2 and st.retried == 0
        assert_bitwise([c for c in done if c.ok], {(0, i): f for i, f in enumerate(frames)})

        plan = FaultPlan([FaultSpec(stage="emit", times=None)])
        svc = _service(batch=2, wave_linger=0.05, fault_plan=plan, max_wave_failures=1)
        svc.start()
        svc.submit(0, *frames[0])
        with pytest.raises(RuntimeError, match="worker failed"):
            svc.stop(drain=True, timeout=60)
        assert "consecutive waves failed at emit" in str(svc._error)


# ---------------------------------------------------------------------------
# admission control in the live engine
# ---------------------------------------------------------------------------
class TestAdmissionInEngine:
    def test_expired_requests_shed_without_compute(self):
        frames = _frames(4)
        svc = _service(batch=2, wave_linger=0.05)
        with svc:
            past = time.monotonic() - 1.0
            for i, (l, r) in enumerate(frames):
                svc.submit(i, l, r, deadline=past if i % 2 else None)
            done = svc.collect(4, timeout=300)
        st = svc.stats()
        assert len(done) == 4
        assert sorted(c.frame_id for c in done if not c.ok) == [1, 3]
        assert all("shed by admission control" in c.error for c in done if not c.ok)
        assert st.shed == 2 and st.expired == 2
        assert st.failed_frames == 0         # shed is not a compute failure
        assert st.completed == 2 and st.pending == 0

    def test_degraded_mode_engages_and_clears(self):
        """Backlog past the watermark switches waves to the narrowed-band
        dense stage; once pressure drains, the mode clears."""
        frames = _frames(2)
        plan = FaultPlan([FaultSpec(stage="dense", kind="delay", delay_s=0.1, times=None)])
        svc = _service(batch=1, fault_plan=plan, degrade_watermark=3, clear_watermark=1)
        with svc:
            for i in range(10):
                svc.submit(i, *frames[i % 2])
            done = svc.collect(10, timeout=300)
        st = svc.stats()
        assert len(done) == 10 and all(c.ok for c in done)
        assert st.degraded_waves > 0, "pressure should engage degraded mode"
        assert st.degraded_waves < st.waves, "early waves ran full quality"
        assert st.degraded is False, "mode must clear once pressure drains"

    def test_non_degraded_path_stays_bitwise_exact(self):
        """A watermark-enabled service that never overloads runs zero
        degraded waves and delivers the reference's bits."""
        frames = _frames(3)
        svc = _service(batch=1, degrade_watermark=50)
        with svc:
            for i, (l, r) in enumerate(frames):
                svc.submit(i, l, r)
                svc.collect(0, timeout=0.05)     # keep the backlog at ~1
            done = svc.collect(3, timeout=300)
        st = svc.stats()
        assert len(done) == 3
        assert st.degraded_waves == 0
        assert_bitwise(done, {(0, i): f for i, f in enumerate(frames)})


# ---------------------------------------------------------------------------
# fail-fast lifecycle + liveness
# ---------------------------------------------------------------------------
class TestFailFast:
    def test_stop_drain_detects_dead_pipeline_promptly(self):
        """stop(drain=True, timeout=120) on an aborted engine raises within
        seconds, not at its timeout."""
        frames = _frames(2)
        plan = FaultPlan([FaultSpec(stage="support", times=None)])
        svc = _service(batch=2, wave_linger=0.05, fault_plan=plan, max_wave_failures=1)
        svc.start()
        for i, (l, r) in enumerate(frames):
            svc.submit(i, l, r)
        deadline = time.monotonic() + 30.0   # wait for the abort to land
        while svc._error is None and time.monotonic() < deadline:
            time.sleep(0.05)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="worker failed"):
            svc.stop(drain=True, timeout=120.0)
        assert time.monotonic() - t0 < 10.0

    def test_collect_total_deadline_and_strict(self):
        """collect()'s timeout is a total deadline; strict=True raises a
        TimeoutError naming the outstanding frame ids with the partial
        results attached."""
        frames = _frames(1)
        svc = _service(batch=1)
        with svc:
            svc.submit(7, *frames[0])
            assert len(svc.collect(1, timeout=300)) == 1
            t0 = time.monotonic()
            assert svc.collect(5, timeout=0.3) == []      # nothing else coming
            assert time.monotonic() - t0 < 5.0, "timeout must be total"
            svc.submit(8, *frames[0])
            with pytest.raises(TimeoutError) as ei:
                svc.collect(3, timeout=2.0, strict=True)
        assert "outstanding frame ids" in str(ei.value)
        assert len(ei.value.partial) <= 2

    def test_stage_liveness_reported_while_running(self):
        svc = _service(batch=1)
        with svc:
            svc.submit(0, *_frames(1)[0])
            svc.collect(1, timeout=300)
            st = svc.stats()
        assert dict(st.stage_liveness) == {
            "assemble": True, "support": True, "dense": True, "emit": True,
        }

    def test_stats_before_start_has_no_liveness(self):
        st = StereoService(P, batch=1, device="cpu").stats()
        assert st.stage_liveness == () and st.stage_stragglers == ()
