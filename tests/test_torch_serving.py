"""The port's StereoService on the CPU against the reference: the cold cases
of tests/test_stereo_serving.py at the reference's frame sizes and
``SYNTH`` parameters.  Every delivered frame is held against the JAX
``ielas_disparity`` of its pair bit for bit; with ``bucket > 1`` against
that of the edge-padded pair, cropped -- what the reference service
delivers.  (``TestBackendRegistry`` has no counterpart: the port has no
kernel registry.)  Mixed buckets and auto-batching are in
tests/test_torch_serving_buckets.py; faults, admission and liveness in
tests/test_torch_serving_faults.py.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.configs.elas_stereo import SYNTH
from repro_torch.serving import FaultPlan, FaultSpec
from repro_torch.serving.stereo_service import FrameProgramCache, StereoService
from torch_serving_cases import assert_bitwise, scene_pairs

P = SYNTH.params


class TestWaveBatching:
    def test_partial_wave_masking_matches_single_frame(self):
        """3 requests into a batch-4 wave: the padded slot is invisible."""
        frames = scene_pairs(3)
        svc = StereoService(P, batch=4, depth=2, wave_linger=0.05, device="cpu").start()
        try:
            svc.warmup([(60, 80)])
            for i, (l, r) in enumerate(frames):
                svc.submit(i, l, r)
            done = svc.collect(3, timeout=300)
        finally:
            svc.stop()
        assert len(done) == 3
        st = svc.stats()
        assert st.waves == 1 and st.padded_slots == 1
        assert_bitwise(done, {(0, i): f for i, f in enumerate(frames)})

    def test_multi_stream_order_preserved(self):
        """Interleaved submissions from 3 streams come back, per stream, in
        submission order."""
        per_stream = 3
        streams = 3
        frames = scene_pairs(per_stream)        # shared frames, distinct ids
        svc = StereoService(P, batch=streams, depth=2, wave_linger=0.05,
                            device="cpu").start()
        try:
            svc.warmup([(60, 80)])
            for fid in range(per_stream):
                for sid in range(streams):
                    svc.submit(fid, *frames[fid], stream_id=sid)
            done = svc.collect(per_stream * streams, timeout=300)
        finally:
            svc.stop()
        assert len(done) == per_stream * streams
        for sid in range(streams):
            got = [c.frame_id for c in done if c.stream_id == sid]
            assert got == sorted(got) == list(range(per_stream))
        assert_bitwise(done, {(s, i): frames[i] for s in range(streams)
                               for i in range(per_stream)})

    def test_stats_accounting(self):
        frames = scene_pairs(5, h=40, w=64)
        svc = StereoService(P, batch=2, depth=2, wave_linger=0.05, device="cpu").start()
        try:
            svc.warmup([(40, 64)])
            for i, (l, r) in enumerate(frames):
                svc.submit(i, l, r)
            done = svc.collect(5, timeout=300)
        finally:
            svc.stop()
        st = svc.stats()
        assert len(done) == 5
        assert st.submitted == st.completed == 5
        assert st.dropped == 0 and st.pending == 0
        assert st.waves * 2 == st.completed + st.padded_slots
        assert st.latency_p50_ms > 0 and st.latency_max_ms >= st.latency_p50_ms
        assert st.throughput_fps > 0
        assert st.backend == "cpu" and st.tile is None
        assert all(c.latency_s > 0 for c in done)
        assert_bitwise(done, {(0, i): f for i, f in enumerate(frames)})


class TestProgramCache:
    def test_warmup_then_zero_misses(self):
        """Repeated resolutions after warm-up: every wave is a cache hit."""
        svc = StereoService(P, batch=2, depth=2, wave_linger=0.05, device="cpu").start()
        frames = scene_pairs(6, h=40, w=64)
        try:
            svc.warmup([(40, 64)])
            assert svc.stats().cache_misses == 0
            for i, (l, r) in enumerate(frames):
                svc.submit(i, l, r)
            done = svc.collect(6, timeout=300)
        finally:
            svc.stop()
        st = svc.stats()
        assert len(done) == 6
        assert st.cache_misses == 0, "a new program on the hot path after warm-up"
        assert st.cache_hits == st.waves > 0
        assert st.programs_cached == 1
        assert_bitwise(done, {(0, i): f for i, f in enumerate(frames)})

    def test_mixed_resolutions_miss_then_hit(self):
        svc = StereoService(P, batch=1, depth=2, device="cpu").start()
        a = scene_pairs(2, h=40, w=64)
        b = scene_pairs(2, h=45, w=70, seed0=7)
        try:
            for i, (l, r) in enumerate(a + b):
                svc.submit(i, l, r)
            done = svc.collect(4, timeout=300)
        finally:
            svc.stop()
        st = svc.stats()
        assert len(done) == 4
        assert st.programs_cached == 2
        assert st.cache_misses == 2          # one new program per resolution
        assert st.cache_hits == 2            # second frame of each reuses it
        assert_bitwise(done, {(0, i): f for i, f in enumerate(a + b)})

    def test_resolution_bucketing_shares_programs(self):
        """bucket=16: (40,64) and (45,60) collapse onto one (48,64)
        program; outputs keep their native shapes and equal the reference
        on the edge-padded pair, cropped."""
        svc = StereoService(P, batch=2, depth=2, bucket=16, wave_linger=0.05,
                            device="cpu").start()
        a = scene_pairs(1, h=40, w=64)[0]
        b = scene_pairs(1, h=45, w=60, seed0=7)[0]
        try:
            svc.submit(0, *a)
            svc.submit(1, *b)
            done = svc.collect(2, timeout=300)
        finally:
            svc.stop()
        st = svc.stats()
        assert len(done) == 2
        assert st.programs_cached == 1, "bucketing should share one program"
        shapes = {c.frame_id: c.disparity.shape for c in done}
        assert shapes == {0: (40, 64), 1: (45, 60)}
        assert_bitwise(done, {(0, 0): a, (0, 1): b}, bucket=16)

    def test_cache_key_includes_bucketing(self):
        cache = FrameProgramCache(P, batch=2, device="cpu", bucket=32)
        assert cache.bucket_shape(40, 64) == (64, 64)
        assert cache.bucket_shape(64, 64) == (64, 64)
        assert cache.bucket_shape(65, 64) == (96, 64)
        exact = FrameProgramCache(P, batch=2, device="cpu")
        assert exact.bucket_shape(41, 63) == (41, 63)
        with pytest.raises(ValueError):
            FrameProgramCache(P, batch=2, device="cpu", tile="tiled")


class TestLifecycle:
    def test_clean_shutdown_with_nonempty_queue(self):
        """stop(drain=False) with queued work discards it, accounts for it,
        and returns promptly."""
        svc = StereoService(P, batch=1, depth=2, max_pending=64, device="cpu").start()
        svc.warmup([(40, 64)])
        for i, (l, r) in enumerate(scene_pairs(12, h=40, w=64)):
            svc.submit(i, l, r)
        t0 = time.monotonic()
        svc.stop(drain=False)
        assert time.monotonic() - t0 < 30.0
        st = svc.stats()
        assert st.submitted == 12
        assert st.completed + st.dropped == 12
        assert not svc._threads

    def test_drain_completes_all_queued_work(self):
        svc = StereoService(P, batch=2, depth=2, wave_linger=0.05, device="cpu").start()
        svc.warmup([(40, 64)])
        frames = scene_pairs(5, h=40, w=64)
        for i, (l, r) in enumerate(frames):
            svc.submit(i, l, r)
        svc.stop(drain=True)                 # no collect() before stop
        st = svc.stats()
        assert st.completed == 5 and st.dropped == 0
        done = svc.collect(5, timeout=5)
        assert {c.frame_id for c in done} == set(range(5))
        assert_bitwise(done, {(0, i): f for i, f in enumerate(frames)})

    def test_context_manager(self):
        frames = scene_pairs(2, h=40, w=64)
        with StereoService(P, batch=2, wave_linger=0.05, device="cpu") as svc:
            for i, (l, r) in enumerate(frames):
                svc.submit(i, l, r)
            done = svc.collect(2, timeout=300)
        assert {c.frame_id for c in done} == {0, 1}
        assert_bitwise(done, {(0, i): f for i, f in enumerate(frames)})

    def test_submit_rejects_mismatched_shapes(self):
        svc = StereoService(P, device="cpu")
        with pytest.raises(ValueError):
            svc.submit(0, np.zeros((4, 8), np.float32), np.zeros((4, 9), np.float32))
        with pytest.raises(ValueError, match="too small"):
            svc.submit(0, np.zeros((8, 8), np.float32), np.zeros((8, 8), np.float32))

    def test_no_device_raises_without_a_card(self, monkeypatch):
        """``device=None`` is ``cuda:0``: without a card the service refuses
        to start rather than run on the host unasked."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StereoService(P)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FrameProgramCache(P, batch=1)


@pytest.mark.faults
class TestOverload:
    def test_two_stream_overload_fairness_and_shedding(self):
        """A flooding stream with tight deadlines and a quiet stream: the
        flood's expired work is shed (counted, delivered as error frames),
        the quiet stream is never starved or shed, and per-stream in-order
        delivery holds with the shed frames in their sequence slots."""
        plan = FaultPlan([FaultSpec(stage="dense", kind="delay", delay_s=0.2, times=None)])
        svc = StereoService(P, batch=2, depth=1, wave_linger=0.01, in_order=True,
                            fault_plan=plan, max_pending=64, device="cpu")
        svc.warmup([(40, 64)])
        frames = scene_pairs(2, h=40, w=64)
        n_flood, n_quiet = 40, 3
        with svc:
            deadline = time.monotonic() + 0.8
            for i in range(n_flood):
                svc.submit(i, *frames[i % 2], stream_id=0, deadline=deadline)
            for i in range(n_quiet):
                svc.submit(i, *frames[i % 2], stream_id=1)
            done = svc.collect(n_flood + n_quiet, timeout=300)
        st = svc.stats()
        assert len(done) == n_flood + n_quiet
        assert st.shed > 0 and st.expired == st.shed
        assert st.completed + st.shed == n_flood + n_quiet
        flood_shed = [c for c in done if c.stream_id == 0 and not c.ok]
        assert len(flood_shed) == st.shed
        assert all("shed by admission control" in c.error for c in flood_shed)
        shed_by = dict(st.shed_by_stream)
        assert shed_by.get(0) == st.shed and 1 not in shed_by
        quiet = [c for c in done if c.stream_id == 1]
        assert len(quiet) == n_quiet and all(c.ok for c in quiet)
        admitted = dict(st.admitted_by_stream)
        assert admitted.get(1) == n_quiet
        assert admitted.get(0, 0) >= 1
        for sid in (0, 1):
            got = [c.frame_id for c in done if c.stream_id == sid]
            assert got == sorted(got), f"stream {sid} out of order: {got}"
        assert_bitwise([c for c in done if c.ok],
                        {(s, i): frames[i % 2] for s in (0, 1) for i in range(n_flood)})
