"""The port's StereoService on the CPU against the reference, continued
from tests/test_torch_serving.py: mixed-resolution buckets, ``in_order``
across buckets, and the auto-batch calibration cases of
tests/test_dense_tiling.py's ``TestServiceAutoBatch``.  Every delivered
frame is held against the JAX ``ielas_disparity`` of its pair bit for bit
(with ``bucket > 1``: of the edge-padded pair, cropped).
"""
from repro.data.stereo import synthetic_stereo_pair
from repro_torch.configs.elas_stereo import SYNTH
from repro_torch.core.tiling import TileSpec
from repro_torch.serving.stereo_service import StereoService, _default_batch_candidates
from torch_serving_cases import assert_bitwise, scene_pairs

P = SYNTH.params


class TestMixedBuckets:
    """Mixed-resolution traffic: the calibrated hot path never makes a new
    program; completion order across buckets is out of order by default
    and in order with ``in_order=True``."""

    def test_autobatch_mixed_buckets_zero_misses(self):
        svc = StereoService(P, batch=4, bucket=16, autobatch=True, wave_linger=0.05,
                            device="cpu").start()
        a = scene_pairs(4, h=40, w=64)
        b = scene_pairs(4, h=56, w=80, seed0=9)
        try:
            svc.warmup([(40, 64), (56, 80)])     # -> (48,64) and (64,80)
            warm = svc.stats()
            assert warm.calibrations == 2, "one calibration pass per bucket"
            assert warm.cache_misses == 0
            assert {bk for bk, _ in warm.batch_by_bucket} == {(48, 64), (64, 80)}
            assert all(1 <= width <= 4 for _, width in warm.batch_by_bucket)
            for i in range(4):                   # interleave the two buckets
                svc.submit(i, *a[i], stream_id=0)
                svc.submit(i, *b[i], stream_id=1)
            done = svc.collect(8, timeout=300)
        finally:
            svc.stop()
        st = svc.stats()
        assert len(done) == 8
        assert st.cache_misses == 0, "a new program on the hot path after warm-up"
        assert st.calibrations == 2, "live traffic must not re-calibrate"
        for sid in (0, 1):                       # per-stream order holds
            got = [c.frame_id for c in done if c.stream_id == sid]
            assert got == sorted(got) == list(range(4))
        shapes = {c.stream_id: c.disparity.shape for c in done}
        assert shapes == {0: (40, 64), 1: (56, 80)}, "native shapes restored"
        pairs = {(0, i): a[i] for i in range(4)} | {(1, i): b[i] for i in range(4)}
        assert_bitwise(done, pairs, bucket=16)

    def test_out_of_order_completion_across_buckets(self):
        """A0, B1, A2 with a batch-2 service completes as A0, A2, B1: the
        second A request fills A's wave and jumps the earlier B one."""
        svc = StereoService(P, batch=2, wave_linger=1.5, device="cpu").start()
        a = scene_pairs(2, h=40, w=64)
        b = scene_pairs(1, h=56, w=80, seed0=9)
        try:
            svc.warmup([(40, 64), (56, 80)])
            svc.submit(0, *a[0])                 # bucket A, opens the wave
            svc.submit(1, *b[0])                 # bucket B, must wait
            svc.submit(2, *a[1])                 # bucket A, fills the wave
            done = svc.collect(3, timeout=300)
        finally:
            svc.stop()
        order = [c.frame_id for c in done]
        assert order == [0, 2, 1], order
        st = svc.stats()
        assert st.waves == 2 and st.cache_misses == 0
        assert_bitwise(done, {(0, 0): a[0], (0, 1): b[0], (0, 2): a[1]})

    def test_in_order_restores_submission_order_across_buckets(self):
        """The same schedule with in_order=True: A2 is held until B1
        delivers, so the stream observes 0, 1, 2."""
        svc = StereoService(P, batch=2, wave_linger=1.5, in_order=True,
                            device="cpu").start()
        a = scene_pairs(2, h=40, w=64)
        b = scene_pairs(1, h=56, w=80, seed0=9)
        try:
            svc.warmup([(40, 64), (56, 80)])
            svc.submit(0, *a[0])
            svc.submit(1, *b[0])
            svc.submit(2, *a[1])
            done = svc.collect(3, timeout=300)
        finally:
            svc.stop()
        assert [c.frame_id for c in done] == [0, 1, 2]
        st = svc.stats()
        assert st.waves == 2 and st.cache_misses == 0
        assert st.completed == 3 and st.dropped == 0
        assert all(c.latency_s > 0 for c in done)
        assert_bitwise(done, {(0, 0): a[0], (0, 1): b[0], (0, 2): a[1]})

    def test_in_order_restart_delivers_ingest_survivors(self):
        """stop(drain=False) strands late requests in the ingest queue;
        start() keeps their seqs live and marks the aborted ones lost, so
        the survivors are delivered, in order."""
        svc = StereoService(P, batch=1, depth=2, in_order=True, max_pending=64,
                            device="cpu").start()
        svc.warmup([(40, 64)])
        frames = scene_pairs(10, h=40, w=64)
        for i, (l, r) in enumerate(frames):
            svc.submit(i, l, r)
        svc.stop(drain=False)                # strands the tail in ingest
        svc.start()
        svc.stop(drain=True)                 # serve every survivor
        st = svc.stats()
        assert st.submitted == 10
        assert st.completed + st.dropped == 10
        done = svc.collect(st.completed, timeout=30)
        assert len(done) == st.completed
        seqs = [c.frame_id for c in done]
        assert seqs == sorted(seqs), "per-stream order must survive restart"
        assert 9 in set(seqs)
        assert_bitwise(done, {(0, i): f for i, f in enumerate(frames)})

    def test_in_order_multi_stream_independent(self):
        """Reordering is per stream: stream 1 is never held behind stream 0."""
        svc = StereoService(P, batch=2, wave_linger=0.05, in_order=True,
                            device="cpu").start()
        frames = scene_pairs(4, h=40, w=64)
        try:
            svc.warmup([(40, 64)])
            for i in range(4):
                svc.submit(i, *frames[i], stream_id=i % 2)
            done = svc.collect(4, timeout=300)
        finally:
            svc.stop()
        assert len(done) == 4
        for sid in (0, 1):
            got = [c.frame_id for c in done if c.stream_id == sid]
            assert got == sorted(got)
        assert_bitwise(done, {(i % 2, i): frames[i] for i in range(4)})


class TestServiceAutoBatch:
    def test_default_candidates(self):
        assert _default_batch_candidates(1) == (1,)
        assert _default_batch_candidates(4) == (1, 2, 4)
        assert _default_batch_candidates(6) == (1, 2, 4, 6)

    def test_calibrated_service_stays_bitwise_and_warm(self):
        """TileSpec(rows=16) takes the candidate-window route (its gather
        is "take"); the calibrated service stays warm and bit-exact."""
        frames = [synthetic_stereo_pair(height=48, width=64, d_max=24, seed=s)[:2]
                  for s in range(5)]
        svc = StereoService(P, batch=4, depth=2, wave_linger=0.05, tile=TileSpec(rows=16),
                            autobatch=True, device="cpu").start()
        try:
            svc.warmup([(48, 64)])
            st_warm = svc.stats()
            assert st_warm.calibrations == 1
            assert st_warm.cache_misses == 0
            ((bucket, width),) = st_warm.batch_by_bucket
            assert bucket == (48, 64) and 1 <= width <= 4
            for i, (l, r) in enumerate(frames):
                svc.submit(i, l, r)
            done = svc.collect(5, timeout=300)
        finally:
            svc.stop()
        st = svc.stats()
        assert len(done) == 5
        assert st.cache_misses == 0, "a new program on the hot path after warm-up"
        assert st.tile == TileSpec(rows=16)
        assert_bitwise(done, {(0, i): f for i, f in enumerate(frames)})

    def test_calibration_is_per_bucket_and_idempotent(self):
        svc = StereoService(P, batch=2, bucket=16, autobatch=True, device="cpu")
        svc.warmup([(40, 64), (45, 60)])     # same (48, 64) bucket
        assert svc.stats().calibrations == 1
        svc.warmup([(40, 64)])               # idempotent
        assert svc.stats().calibrations == 1

    def test_uncalibrated_service_uses_fixed_batch(self):
        svc = StereoService(P, batch=3, device="cpu")
        svc.warmup([(40, 64)])
        st = svc.stats()
        assert st.calibrations == 0 and st.batch_by_bucket == ()
        assert svc._cache.batch_for(40, 64) == 3
