"""Continuous-batching stereo serving engine (counterpart of
``repro/serving/stereo_service.py``).

The FPGA design overlaps frame i's compute with frame i+1's arrival via
ping-pong BRAMs (paper Fig. 7).  This module is the service-level form of
that idea for many concurrent streams, as in the reference:

* **Dynamic wave assembly** -- requests from any number of streams are
  grouped into *waves* of up to ``batch`` frames.  A partial wave is padded
  (slots replicate a real frame) and masked at emit time rather than
  stalled.  Within a resolution bucket, wave order is submission order;
  with ``in_order=True`` a per-stream reordering buffer extends that
  guarantee across buckets (delivery deferred, wave assembly untouched).

* **Frame-program cache** -- a wave "program" is the pair of stage
  callables for one ((H, W) bucket, wave width) on the service's device:
  :func:`~repro_torch.core.pipeline.ielas_support_stage_batched` followed
  by :func:`~repro_torch.core.pipeline.ielas_interpolate_stage` per slot,
  then :func:`~repro_torch.core.pipeline.ielas_dense_stage_batched`.
  PyTorch runs eagerly, so nothing is traced; ``misses`` still counts new
  (shape, width) entries, so "zero misses after ``warmup()``" keeps its
  meaning, and ``warmup()`` runs a dummy wave so the first-use kernel build
  and the CUDA context cost fall there and not on the first request.  With
  ``bucket > 1`` resolutions are rounded up to bucket multiples (inputs
  edge-padded, outputs cropped).

* **Per-bucket auto-batching** -- with ``autobatch=True``, ``warmup()``
  times candidate wave widths per bucket on dummy frames and keeps the
  per-frame-fastest.

* **Staged pipeline** -- assembly, the support stage, the dense stage and
  emit each run on their own thread, joined by bounded queues of depth
  ``depth``.  On a card the support and dense threads each launch on their
  own CUDA stream, so wave i+1's support work overlaps wave i's dense work;
  each stage synchronises its own stream before it hands a wave on, which
  makes the hand-off safe and surfaces a failure in the stage that owns
  the retry.  The two threads take turns issuing their work (a launch
  lock): a wave is ~2,400 small PyTorch launches, PyTorch releases the GIL
  inside each, and two threads launching at once pass the GIL back and
  forth at every launch and together run at half the rate of one thread
  (``service_profile.py``).

* **Accounting** -- per-request latency, wave occupancy, backpressure time,
  cache counters, admission / containment counters and per-stage liveness,
  snapshotted by :meth:`StereoService.stats`.

Every delivered frame equals the single-frame
:func:`~repro_torch.core.pipeline.ielas_disparity` of its pair bit for bit
(with ``bucket > 1``: of the edge-padded pair, cropped), which is what the
reference service delivers.

Failure model (as the reference's; proved by
``tests/test_torch_serving_faults.py`` with :mod:`repro_torch.serving.faults`):

* an exception while executing a wave's support or dense stage fails only
  that wave's frames: each slot is retried once as a single-frame wave, so
  a transient fault recovers completely and a *poison frame* is
  quarantined alone; failed frames are delivered as :class:`CompletedFrame`
  with ``error`` set; requests whose ``deadline`` passed before assembly
  are shed without device time;
* only ``max_wave_failures`` consecutive waves failing completely abort
  the engine; the error is stored and re-raised by ``submit`` / ``stop``;
* with ``degrade_watermark`` set, a backlog past the watermark switches new
  waves to a dense stage whose plane-prior band is narrowed to
  ``degraded_band``, until the backlog falls below ``clear_watermark``;
* every stage thread beats a
  :class:`~repro_torch.runtime.fault_tolerance.HeartbeatMonitor`.

Temporal warm start (``warm_start=True``), as the reference's (proved by
``tests/test_torch_warm_service.py`` against the JAX service, frame by frame
and counter by counter):

* each stream's last successfully delivered frame (its disparity and a
  block-mean thumbnail of its left image,
  :class:`~repro_torch.serving.warmstart.WarmState`) seeds the next frame:
  a warm frame's support stage is descriptor extraction only
  (:func:`~repro_torch.core.pipeline.ielas_descriptor_stage_batched`) and
  its dense stage scans only ``+-warm_band`` around the previous disparity
  (:func:`~repro_torch.core.pipeline.ielas_warm_dense_stage_batched`, the
  warm band kernel);
* classification happens once, as the frame enters assembly, and pins its
  prior: a frame is cold without state, when its seed is not its immediate
  predecessor, on a resolution change, when the warm streak reaches
  ``refresh_interval``, or when the thumbnail SAD against the previous frame
  exceeds ``scene_change_threshold``; every cold reason but "no state"
  resets the stream's state, and cold frames run the cold stages unchanged;
* warm and cold frames never share a wave;
* at emit, a warm frame whose result disagrees with its own seed by more
  than ``rerun_threshold * num_disp`` (INVALID pixels counting as
  ``num_disp``) is re-run cold on the batch-1 cold stages before delivery;
* state is written only by a successful in-sequence delivery; an error,
  a shed or an out-of-sequence delivery resets it.  A warm slot retries on
  the batch-1 warm stages with its slice of the wave's pinned prior, and a
  degraded warm wave runs band ``min(warm_band, degraded_band)``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
import queue
import threading
import time
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.params import ElasParams
from repro_torch.core.pipeline import (
    ielas_dense_stage_batched,
    ielas_descriptor_stage_batched,
    ielas_interpolate_stage,
    ielas_support_stage_batched,
    ielas_warm_dense_stage_batched,
    resolve_device,
)
from repro_torch.core.tiling import TileArg, TileSpec, dense_route
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving import warmstart as _warmstart
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.warmstart import WarmState, frame_thumbnail, prior_disagreement

_EOS = object()          # end-of-stream sentinel flowing through the stages

_STAGES = ("assemble", "support", "dense", "emit")


# ---------------------------------------------------------------------------
# public result / stats types
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CompletedFrame:
    """One finished request, as delivered by :meth:`StereoService.collect`.

    ``error`` is the terminal failure state: ``None`` for a successful
    frame (``disparity`` is the (H, W) float32 map), else a message
    describing why the frame failed (compute fault after retry, or shed
    for a passed deadline) with ``disparity=None``.
    """

    request_id: int
    stream_id: int
    frame_id: int
    disparity: Optional[np.ndarray]    # (H, W) float32, native resolution
    latency_s: float                   # submit() -> emitted
    error: Optional[str] = None        # terminal failure reason, if any

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclasses.dataclass(frozen=True)
class ServiceStats:
    """Point-in-time snapshot of the engine's accounting."""

    submitted: int
    completed: int
    dropped: int                   # discarded by stop(drain=False)
    pending: int                   # submitted - completed - dropped - failed - shed
    waves: int
    padded_slots: int              # batch slots filled by padding, not work
    wave_occupancy: float          # real frames / total wave slots
    cache_hits: int
    cache_misses: int              # == new (shape, width) program entries
    programs_cached: int
    backpressure_seconds: float    # total time submit() spent blocked
    latency_avg_ms: float
    latency_p50_ms: float
    latency_p95_ms: float
    latency_max_ms: float
    throughput_fps: float          # completed / (last emit - first submit)
    calibrations: int = 0          # auto-batch calibration passes run
    batch_by_bucket: tuple = ()    # ((H, W), wave width) per calibrated bucket
    backend: str = ""              # the device the waves run on, e.g. "cuda:0"
    tile: Optional[TileSpec] = None  # the TileSpec passed; None == the
                                     # default (stream) route or UNTILED
    # ---- fault containment / admission control ----
    shed: int = 0                  # requests shed pre-compute by admission
    expired: int = 0               # subset of shed: deadline already passed
    retried: int = 0               # single-frame retry attempts run
    failed_frames: int = 0         # frames delivered with a compute error
    degraded_waves: int = 0        # waves run with the narrowed prior band
    degraded: bool = False         # current degraded-mode state
    admitted_by_stream: tuple = () # ((stream_id, admitted), ...) fairness view
    shed_by_stream: tuple = ()     # ((stream_id, shed), ...)
    stage_liveness: tuple = ()     # ((stage, alive), ...) from the heartbeat
    stage_stragglers: tuple = ()   # stage names slower than the median
    # ---- temporal warm start (all zero with warm_start=False) ----
    warm_frames: int = 0           # frames classified warm (band-only scan)
    cold_frames: int = 0           # warm-start frames classified cold
    scene_changes: int = 0         # cold because the thumbnail SAD tripped
    warm_refreshes: int = 0        # cold because the streak hit refresh_interval
    warm_reruns: int = 0           # warm frames re-run cold by the post-hoc check
    warm_resets: int = 0           # state dropped (error/shed/out-of-seq/stale)


# ---------------------------------------------------------------------------
# frame-program cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WavePrograms:
    """The two stage callables of one wave-shaped frame program."""

    key: tuple                     # (H, W) bucketed
    batch: int                     # wave width
    support: object                # (B,H,W)x2 -> (dl, dr, interpolated support)
    dense: object                  # (dl, dr, support) -> (B,H,W) disparity
    dense_degraded: object = None  # same, with the narrowed prior band
                                   # (present only when the cache was built
                                   # with degraded_radius)
    # warm-start variants (present only when the cache was built with
    # warm_band; a warm wave runs exactly this pair):
    support_warm: object = None    # (B,H,W)x2 -> (dl, dr): descriptors only
    dense_warm: object = None      # (dl, dr, prior) -> (B,H,W) disparity,
                                   # band-only scan around the prior
    dense_warm_degraded: object = None   # band = min(warm_band, degraded)


class FrameProgramCache:
    """Wave programs keyed on ``(H, W, batch)`` under fixed ``(device,
    params, tile)``, with optional resolution bucketing and a per-bucket
    wave width.

    With ``bucket > 1`` a request's resolution is rounded up to the next
    bucket multiple, so nearby resolutions share one program.
    ``hits``/``misses`` count :meth:`get` resolutions; a miss is one new
    (shape, width) entry.  ``batch`` is the maximum wave width;
    :meth:`calibrate` times candidate widths for one bucket on dummy
    frames and records the fastest per-frame width, which :meth:`batch_for`
    reports to wave assembly.  Programs are cached per ``(shape, width)``
    so the batch-1 programs the retry path uses never evict a bucket's
    calibrated one.  ``tile`` goes to the dense stage only (it picks the
    dense route); with ``degraded_radius`` set every program also carries a
    ``dense_degraded`` variant whose plane-prior band is that radius.  With
    ``warm_band`` set every program also carries the warm-start pair
    (``support_warm``: descriptors only; ``dense_warm``: the band-only scan
    seeded by a previous disparity), and with both set a
    ``dense_warm_degraded`` whose band is ``min(warm_band,
    degraded_radius)``.

    On a card each stage has its own CUDA stream (``streams``), and the
    dummy waves of :meth:`warm` and :meth:`calibrate` run each stage on its
    stream, as the service's stage threads do: PyTorch's caching allocator
    keeps its free blocks per stream, so a warm-up on another stream would
    leave the hot path's first waves to allocate from the driver.
    """

    def __init__(self, params: ElasParams, batch: int, device=None, bucket: int = 1,
                 tile: TileArg = None, degraded_radius: Optional[int] = None,
                 warm_band: Optional[int] = None):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if bucket < 1:
            raise ValueError(f"bucket must be >= 1, got {bucket}")
        if degraded_radius is not None and degraded_radius < 0:
            raise ValueError(
                f"degraded_radius must be >= 0 or None, got {degraded_radius}"
            )
        if warm_band is not None and warm_band < 0:
            raise ValueError(f"warm_band must be >= 0 or None, got {warm_band}")
        dense_route(tile)              # a bad tile fails here, not in a wave
        self.params = params
        self.batch = batch
        self.device = resolve_device(device)
        self.tile = tile
        self.bucket = bucket
        self.degraded_radius = degraded_radius
        self.warm_band = warm_band
        self.hits = 0
        self.misses = 0
        self.calibrations = 0
        self._lock = threading.Lock()
        self._programs: dict[tuple, WavePrograms] = {}   # (key, batch) ->
        self._batch_choice: dict[tuple, int] = {}
        self.streams = {
            stage: (torch.cuda.Stream(self.device) if self.device.type == "cuda" else None)
            for stage in ("support", "dense")
        }

    def on_stream(self, stage: str):
        """The stage's CUDA stream as the current one (no-op on the CPU)."""
        s = self.streams[stage]
        return torch.cuda.stream(s) if s is not None else contextlib.nullcontext()

    def synchronize(self, stage: str) -> None:
        """Wait for the stage's work on the card: a fault shows here, and the
        next stage may read the results from its own stream."""
        s = self.streams[stage]
        if s is not None:
            s.synchronize()

    def bucket_shape(self, h: int, w: int) -> tuple[int, int]:
        b = self.bucket
        return (math.ceil(h / b) * b, math.ceil(w / b) * b)

    def batch_for(self, h: int, w: int) -> int:
        """Wave width for a *bucketed* shape (calibrated, or the default)."""
        return self._batch_choice.get((h, w), self.batch)

    def batch_choices(self) -> tuple:
        with self._lock:
            return tuple(sorted(self._batch_choice.items()))

    def __len__(self) -> int:
        return len(self._programs)

    def get(self, h: int, w: int, batch: Optional[int] = None) -> WavePrograms:
        """The wave program for a *bucketed* shape at the wave width the
        caller assembled (each width has its own entry)."""
        key = (h, w)
        want = batch if batch is not None else self.batch_for(*key)
        with self._lock:
            prog = self._programs.get((key, want))
            if prog is not None:
                self.hits += 1
                return prog
            self.misses += 1
            prog = self._build(key, want)
            self._programs[(key, want)] = prog
            return prog

    def warm(self, h: int, w: int) -> WavePrograms:
        """Make the program for (h, w) without touching hit/miss counters,
        and run a dummy wave through it on the device."""
        key = self.bucket_shape(h, w)
        want = self.batch_for(*key)
        with self._lock:
            prog = self._programs.get((key, want))
            if prog is None:
                prog = self._build(key, want)
                self._programs[(key, want)] = prog
        self._run_dummy(prog)
        return prog

    def calibrate(self, h: int, w: int,
                  candidates: Optional[Sequence[int]] = None,
                  reps: int = 2) -> int:
        """Time candidate wave widths for (h, w)'s bucket on dummy frames;
        record and return the per-frame-fastest width.

        The winner's program is kept, so a calibrated warm-up leaves the
        bucket hot (``misses == 0`` afterwards).  Idempotent per bucket.
        """
        key = self.bucket_shape(h, w)
        with self._lock:
            if key in self._batch_choice:
                return self._batch_choice[key]
        if candidates is None:
            candidates = _default_batch_candidates(self.batch)
        best_b, best_t, best_prog = self.batch, float("inf"), None
        for b in candidates:
            b = max(1, min(int(b), self.batch))
            prog = self._build(key, b)
            self._run_dummy(prog)              # first use outside the timing
            t = float("inf")
            for _ in range(max(1, reps)):
                t0 = time.perf_counter()
                self._run_dummy(prog)
                t = min(t, (time.perf_counter() - t0) / b)
            if t < best_t:
                best_b, best_t, best_prog = b, t, prog
        with self._lock:
            self._batch_choice[key] = best_b
            self._programs[(key, best_b)] = best_prog
            self.calibrations += 1
        return best_b

    def _run_dummy(self, prog: WavePrograms) -> None:
        with self.on_stream("support"):
            zeros = torch.zeros((prog.batch, *prog.key), dtype=torch.float32,
                                device=self.device)
            mid = prog.support(zeros, zeros)
        self.synchronize("support")
        with self.on_stream("dense"):
            prog.dense(*mid)
            if prog.dense_degraded is not None:
                prog.dense_degraded(*mid)
        self.synchronize("dense")
        if prog.dense_warm is not None:
            with self.on_stream("support"):
                warm_mid = prog.support_warm(zeros, zeros)
            self.synchronize("support")
            with self.on_stream("dense"):
                prior = torch.zeros_like(zeros)
                prog.dense_warm(*warm_mid, prior)
                if prog.dense_warm_degraded is not None:
                    prog.dense_warm_degraded(*warm_mid, prior)
            self.synchronize("dense")

    def _build(self, key: tuple, batch: int) -> WavePrograms:
        p, tile = self.params, self.tile

        def support_wave(left, right):
            dl, dr, sup = ielas_support_stage_batched(left, right, p)
            return dl, dr, torch.stack([ielas_interpolate_stage(s, p) for s in sup])

        def dense_wave(dl, dr, sup):
            return ielas_dense_stage_batched(dl, dr, sup, p, tile=tile)

        dense_degraded = None
        if self.degraded_radius is not None:
            radius = self.degraded_radius

            def dense_degraded(dl, dr, sup):
                return ielas_dense_stage_batched(dl, dr, sup, p, band_radius=radius,
                                                 tile=tile)

        support_warm = dense_warm = dense_warm_degraded = None
        if self.warm_band is not None:
            band = self.warm_band
            support_warm = ielas_descriptor_stage_batched

            def dense_warm(dl, dr, prior):
                return ielas_warm_dense_stage_batched(dl, dr, prior, p, warm_band=band)

            if self.degraded_radius is not None:
                dradius = self.degraded_radius

                def dense_warm_degraded(dl, dr, prior):
                    return ielas_warm_dense_stage_batched(dl, dr, prior, p, warm_band=band,
                                                          band_radius=dradius)

        return WavePrograms(key=key, batch=batch, support=support_wave, dense=dense_wave,
                            dense_degraded=dense_degraded, support_warm=support_warm,
                            dense_warm=dense_warm, dense_warm_degraded=dense_warm_degraded)


def _default_batch_candidates(batch: int) -> tuple:
    """1, 2, 4, ... up to and including ``batch``."""
    cands = []
    b = 1
    while b < batch:
        cands.append(b)
        b *= 2
    cands.append(batch)
    return tuple(cands)


# ---------------------------------------------------------------------------
# internal request / wave records
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Request:
    request_id: int
    stream_id: int
    frame_id: int
    left: np.ndarray
    right: np.ndarray
    h: int
    w: int
    t_submit: float
    seq: int = 0               # per-stream submission sequence (in_order
                               # reordering and warm-start chain identity)
    deadline: Optional[float] = None   # absolute time.monotonic() budget
    # warm-start classification, pinned at assembly:
    warm: bool = False                 # ride a warm (band-only) wave
    prior: Optional[np.ndarray] = None  # (h, w) seed disparity (warm only)
    thumb: Optional[np.ndarray] = None  # left-frame thumbnail (warm_start only)


@dataclasses.dataclass
class _Wave:
    key: tuple                     # bucketed (H, W)
    requests: list                 # valid slots, in submission order
    left: object                   # (B, H, W) tensor on the device
    right: object
    index: int = 0                 # global wave-assembly index (fault keys)
    degraded: bool = False         # run the narrowed-band dense program
    warm: bool = False             # run the warm (band-only) programs
    prior: object = None           # (B, H, W) prior on the device (warm waves only)
    programs: Optional[WavePrograms] = None
    mid: Optional[tuple] = None    # (dl, dr, support) between stages
    disp: object = None


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class StereoService:
    """Continuous-batching stereo disparity service.

    Parameters
    ----------
    params:      algorithm parameters.
    batch:       wave width -- max frames in one wave.
    depth:       bound of each inter-stage queue (2 == ping-pong).
    device:      where the waves run; ``None`` is ``cuda:0`` and raises
                 when no card is present.  ``"cpu"`` runs the plain
                 PyTorch versions of the kernels.
    bucket:      resolution bucketing multiple (1 == exact shapes only).
    tile:        the dense route (:mod:`repro_torch.core.tiling`): None or
                 a ``TileSpec(gather="stream")`` the streaming scan, a
                 windowed ``TileSpec`` or ``UNTILED`` the candidate window
                 (bitwise equal).
    autobatch:   time candidate wave widths per resolution bucket at
                 warmup() and use the per-frame-fastest width for that
                 bucket's waves (``batch`` remains the upper bound).
    in_order:    per-stream in-order completion, also across buckets (a
                 per-stream reordering buffer defers delivery; failed and
                 shed frames deliver their sequence slot like any other).
    wave_linger: how long assembly waits to fill a partial wave before
                 dispatching it padded (seconds).
    max_pending: ingest queue bound; submit() blocks beyond this.
    fault_plan:  a :class:`~repro_torch.serving.faults.FaultPlan` for
                 deterministic fault injection in the stage loops.
    max_wave_failures: consecutive fully-failed waves that count as
                 systemic failure and abort the engine.
    degrade_watermark: assembly backlog depth that engages degraded mode
                 (None disables it); see ``degraded_band``.
    clear_watermark: backlog depth that clears degraded mode (default:
                 half the degrade watermark; hysteresis).
    degraded_band: plane-prior band half-width for degraded waves.
    warm_start:  temporal warm start for video streams (module docstring):
                 each stream's last delivered frame seeds the next frame's
                 dense search, guarded by the scene-change detector, the
                 forced refresh and the post-hoc disagreement re-run.  Cold
                 frames run the cold stages unchanged.
    warm_band:   disparity band half-width of warm frames (``prior +-
                 warm_band``); with degraded mode the two bands compose by
                 ``min``.
    scene_change_threshold: thumbnail-SAD score past which a frame counts
                 as a scene cut and runs cold with a state reset.
    refresh_interval: force a cold frame after this many consecutive warm
                 frames.
    rerun_threshold: post-hoc disagreement bound as a fraction of
                 ``num_disp``: a warm result whose
                 :func:`~repro_torch.serving.warmstart.prior_disagreement`
                 with its own seed exceeds ``rerun_threshold * num_disp`` is
                 re-run cold.
    heartbeat_timeout: stage heartbeat staleness (seconds) after which a
                 stage thread reports dead in :meth:`stats`.
    clock:       monotonic clock for the heartbeat monitor.
    """

    def __init__(self, params: ElasParams, batch: int = 1, depth: int = 2,
                 device=None, bucket: int = 1,
                 tile: TileArg = None, autobatch: bool = False,
                 in_order: bool = False, wave_linger: float = 0.002,
                 max_pending: int = 64,
                 fault_plan: Optional[FaultPlan] = None,
                 max_wave_failures: int = 3,
                 degrade_watermark: Optional[int] = None,
                 clear_watermark: Optional[int] = None,
                 degraded_band: int = 1,
                 warm_start: bool = False,
                 warm_band: int = 8,
                 scene_change_threshold: float = 20.0,
                 refresh_interval: int = 30,
                 rerun_threshold: float = 0.15,
                 heartbeat_timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if max_wave_failures < 1:
            raise ValueError(
                f"max_wave_failures must be >= 1, got {max_wave_failures}"
            )
        if warm_start:
            if warm_band < 0:
                raise ValueError(f"warm_band must be >= 0, got {warm_band}")
            if refresh_interval < 1:
                raise ValueError(f"refresh_interval must be >= 1, got {refresh_interval}")
            if not 0.0 < rerun_threshold <= 1.0:
                raise ValueError(
                    f"rerun_threshold is a fraction of the disparity range "
                    f"in (0, 1], got {rerun_threshold}"
                )
        self.params = params
        self.batch = batch
        self.depth = depth
        self.autobatch = autobatch
        self.in_order = in_order
        self.wave_linger = wave_linger
        self.fault_plan = fault_plan
        self.max_wave_failures = max_wave_failures
        self.warm_start = warm_start
        self.warm_band = warm_band
        self.scene_change_threshold = float(scene_change_threshold)
        self.refresh_interval = refresh_interval
        self.rerun_threshold = float(rerun_threshold)
        self.heartbeat_timeout = heartbeat_timeout
        self._clock = clock
        self._admission = AdmissionController(
            degrade_watermark=degrade_watermark,
            clear_watermark=clear_watermark,
        )
        self._cache = FrameProgramCache(
            params, batch, device, bucket=bucket, tile=tile,
            degraded_radius=(degraded_band
                             if degrade_watermark is not None else None),
            warm_band=(warm_band if warm_start else None),
        )
        self.device = self._cache.device
        self.tile = tile
        # Held while a stage issues its work, not while it waits for its
        # stream (see "Staged pipeline" in the module docstring).
        self._launch_lock = threading.Lock()

        self._ingest: queue.Queue = queue.Queue(maxsize=max_pending)
        self._waves: queue.Queue = queue.Queue(maxsize=depth)
        self._mid: queue.Queue = queue.Queue(maxsize=depth)
        self._ready: queue.Queue = queue.Queue(maxsize=depth)
        self._out: queue.Queue = queue.Queue()

        self._drain = threading.Event()    # finish queued work, then stop
        self._abort = threading.Event()    # stop now, discard queued work
        self._done = threading.Event()     # emitter saw EOS
        self._threads: list[threading.Thread] = []
        self._error: Optional[BaseException] = None
        self._monitor = HeartbeatMonitor(
            hosts=list(_STAGES), timeout=heartbeat_timeout, clock=clock
        )
        self._stage_steps: dict = {s: 0 for s in _STAGES}

        # Warm-start lock: guards the per-stream WarmState map and the warm
        # counters (assembly classifies, emit counts re-runs, delivery moves
        # the state).  A leaf lock: nothing takes _slock or _olock under it.
        self._wlock = threading.Lock()
        self._warm_state: dict = {}    # stream_id -> WarmState
        self._warm_frames = 0
        self._cold_frames = 0
        self._scene_changes = 0
        self._warm_refreshes = 0
        self._warm_reruns = 0
        self._warm_resets = 0

        self._slock = threading.Lock()
        # Ordering lock: guards the in_order reordering state, touched by
        # BOTH the emit loop and the assembly loop (shed frames deliver
        # their sequence slot directly from assembly).  _deliver takes
        # _slock inside _olock, and nothing takes _olock under _slock while
        # threads run.
        self._olock = threading.Lock()
        self._next_request_id = 0
        self._stream_seq: dict = collections.defaultdict(int)   # next seq to assign
        self._reorder: dict = {}       # stream_id -> {seq: (req, disp, err, shed)}
        self._next_emit: dict = collections.defaultdict(int)    # next seq to deliver
        self._lost_seqs: dict = collections.defaultdict(set)    # never deliverable
        self._inflight: dict = {}      # request_id -> (stream_id, frame_id)
        self._submitted = 0
        self._completed = 0
        self._dropped = 0
        self._failed = 0               # frames delivered with a compute error
        self._shed = 0                 # frames shed pre-compute by admission
        self._retried = 0              # single-frame retry attempts
        self._degraded_waves = 0
        self._consec_wave_failures = 0
        self._waves_built = 0
        self._wave_slots = 0
        self._padded_slots = 0
        self._backpressure_s = 0.0
        self._latencies: collections.deque = collections.deque(maxlen=4096)
        self._lat_sum = 0.0
        self._lat_max = 0.0
        self._t_first_submit: Optional[float] = None
        self._t_last_emit: Optional[float] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "StereoService":
        if self._threads:
            raise RuntimeError("service already started")
        # Restart after stop(): requests still in the ingest queue are
        # served now; waves stranded in the stage queues by an aborted stop
        # lost their host frames already and stay dropped.
        self._drain.clear()
        self._abort.clear()
        self._done.clear()
        self._error = None
        self._consec_wave_failures = 0
        self._monitor = HeartbeatMonitor(
            hosts=list(_STAGES), timeout=self.heartbeat_timeout,
            clock=self._clock,
        )
        self._stage_steps = {s: 0 for s in _STAGES}
        for q in (self._waves, self._mid, self._ready):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        with self._olock:
            # Frames stranded in the reordering buffer by an aborted stop
            # lost their results and can never be delivered.
            self._reorder.clear()
        with self._slock:
            # Every assigned seq that is neither delivered nor still in the
            # ingest queue is dead: mark it so the in-order flush skips it.
            with self._ingest.mutex:
                surviving = {
                    (r.stream_id, r.seq) for r in list(self._ingest.queue)
                }
            for sid, assigned in self._stream_seq.items():
                for seq in range(self._next_emit[sid], assigned):
                    if (sid, seq) not in surviving:
                        self._lost_seqs[sid].add(seq)
            # Compact quiescent streams, so churning stream ids do not grow
            # per-stream state forever (threads are stopped here).
            live = {sid for sid, _ in surviving}
            for sid in list(self._stream_seq):
                quiescent = (
                    sid not in live
                    and self._next_emit[sid] + len(self._lost_seqs[sid])
                    >= self._stream_seq[sid]
                )
                if quiescent:
                    self._stream_seq.pop(sid, None)
                    self._next_emit.pop(sid, None)
                    self._lost_seqs.pop(sid, None)
            self._dropped = max(
                0, self._submitted - self._completed - self._failed
                - self._shed - self._ingest.qsize()
            )
        stages = [
            ("stereo-assemble", self._assemble_loop),
            ("stereo-support", self._support_loop),
            ("stereo-dense", self._dense_loop),
            ("stereo-emit", self._emit_loop),
        ]
        for name, target in stages:
            t = threading.Thread(target=self._guard(target), name=name,
                                 daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self, drain: bool = True, timeout: float = 120.0) -> None:
        """Shut down.  ``drain=True`` finishes all queued work first;
        ``drain=False`` discards queued work (counted as ``dropped``) and
        returns as soon as the stage threads exit.  An abort or a stored
        worker error ends the drain wait promptly (the error is re-raised).
        """
        if not self._threads:
            return
        if drain and self._error is None:
            self._drain.set()
            t_end = time.monotonic() + timeout
            while not self._done.is_set() and time.monotonic() < t_end:
                if self._abort.is_set() or self._error is not None:
                    break           # pipeline died mid-drain: stop waiting
                self._done.wait(0.1)
        self._abort.set()
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads = []
        with self._slock:
            self._dropped = max(
                0, self._submitted - self._completed - self._failed
                - self._shed
            )
        if self._error is not None:
            raise RuntimeError("stereo service worker failed") from self._error

    def __enter__(self) -> "StereoService":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            self.stop(drain=exc_type is None)
        except RuntimeError:
            if exc_type is None:    # don't mask the exception already in flight
                raise

    def _guard(self, target):
        def run():
            try:
                target()
            except BaseException as e:            # noqa: BLE001
                self._error = e
                self._abort.set()
                self._done.set()
        return run

    # ------------------------------------------------------------------ api
    def warmup(self, shapes: Sequence[tuple[int, int]],
               calibrate: Optional[bool] = None) -> None:
        """Make the wave programs for the given (H, W) resolutions and run a
        dummy wave through each on the device (the first-use kernel build
        and CUDA context set-up happen here).

        With ``calibrate`` (default: the service's ``autobatch`` setting)
        and ``batch > 1``, each resolution bucket first times candidate
        wave widths on dummy frames; the winner becomes that bucket's wave
        width and its program is kept (zero misses afterwards).
        """
        if calibrate is None:
            calibrate = self.autobatch
        for h, w in shapes:
            if calibrate and self.batch > 1:
                before = self._cache.calibrations
                self._cache.calibrate(h, w)
                if self._cache.calibrations != before:
                    continue    # the pass built and exercised the winner
            self._cache.warm(h, w)

    def submit(self, frame_id: int, left: np.ndarray, right: np.ndarray,
               stream_id: int = 0,
               deadline: Optional[float] = None) -> int:
        """Enqueue one stereo pair; returns the request id.

        ``deadline`` is an absolute ``time.monotonic()`` timestamp: a
        request whose deadline passes before its wave is assembled is shed
        without spending device time and delivered as an error frame.
        Blocks only when ``max_pending`` requests are already queued (the
        backpressure point, accounted in :meth:`stats`)."""
        if self._error is not None:
            raise RuntimeError("stereo service worker failed") from self._error
        left = np.asarray(left, np.float32)
        right = np.asarray(right, np.float32)
        if left.shape != right.shape or left.ndim != 2:
            raise ValueError(
                f"expected matching (H, W) pairs, got {left.shape} vs {right.shape}"
            )
        min_dim = max(self.params.grid_size, self.params.candidate_step)
        if left.shape[0] < min_dim or left.shape[1] < min_dim:
            raise ValueError(
                f"frame {left.shape} too small: needs at least one "
                f"{min_dim}x{min_dim} grid cell (grid_size={self.params.grid_size})"
            )
        if deadline is not None:
            deadline = float(deadline)
        now = time.monotonic()
        with self._slock:
            rid = self._next_request_id
            self._next_request_id += 1
            # Sequence numbers exist for the in_order reordering buffer and
            # for the warm chain's identity (a frame's seed must be its
            # immediate predecessor).
            seq = 0
            if self.in_order or self.warm_start:
                seq = self._stream_seq[stream_id]
                self._stream_seq[stream_id] = seq + 1
            if self._t_first_submit is None:
                self._t_first_submit = now
            self._inflight[rid] = (stream_id, frame_id)
        req = _Request(
            request_id=rid, stream_id=stream_id, frame_id=frame_id,
            left=left, right=right, h=left.shape[0], w=left.shape[1],
            t_submit=now, seq=seq, deadline=deadline,
        )
        t0 = time.monotonic()
        while True:     # abort-aware put: never deadlock on a dead service
            if self._error is not None:
                raise RuntimeError(
                    "stereo service worker failed") from self._error
            try:
                self._ingest.put(req, timeout=0.05)
                break
            except queue.Full:
                if not self._threads:
                    raise RuntimeError(
                        "ingest queue full and service not running"
                    ) from None
        waited = time.monotonic() - t0
        with self._slock:
            self._submitted += 1
            self._backpressure_s += waited
        return rid

    def collect(self, n: int, timeout: float = 60.0,
                strict: bool = False) -> list[CompletedFrame]:
        """Up to ``n`` completed frames (successes AND terminal failures),
        waiting at most ``timeout`` seconds in total.

        With ``strict=True``, fewer than ``n`` frames inside the deadline
        raises :class:`TimeoutError` naming the outstanding frame ids; the
        partial results are attached as ``err.partial``.
        """
        out: list[CompletedFrame] = []
        deadline = time.monotonic() + timeout
        while len(out) < n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                out.append(self._out.get(timeout=min(0.05, remaining)))
                continue
            except queue.Empty:
                pass
            # only surface a worker failure once finished frames are drained
            if self._error is not None:
                raise RuntimeError("stereo service worker failed") from self._error
        if strict and len(out) < n:
            with self._slock:
                missing = sorted(
                    fid for _, fid in self._inflight.values()
                )
            err = TimeoutError(
                f"collect() got {len(out)}/{n} frames within {timeout:.3f}s; "
                f"outstanding frame ids: {missing[:32]}"
                + (" ..." if len(missing) > 32 else "")
            )
            err.partial = out
            raise err
        return out

    def results(self, n: int, timeout: float = 60.0) -> list[tuple[int, np.ndarray]]:
        """``(frame_id, disparity)`` tuples (disparity is None for frames
        that failed or were shed)."""
        return [(c.frame_id, c.disparity) for c in self.collect(n, timeout)]

    def run_stream(
        self, frames: Iterator[tuple[np.ndarray, np.ndarray]], n_frames: int,
        timeout: float = 600.0,
    ) -> tuple[list, float]:
        """Process a single stream; returns ``((frame_id, disp) list, wall_s)``,
        with whatever completed within ``timeout``."""
        t0 = time.monotonic()
        deadline = t0 + timeout
        submitted = 0
        results: list = []
        it = iter(frames)
        while len(results) < n_frames and time.monotonic() < deadline:
            if submitted < n_frames:
                try:
                    left, right = next(it)
                    self.submit(submitted, left, right)
                    submitted += 1
                except StopIteration:
                    submitted = n_frames
            results.extend(self.results(
                1, timeout=0.01 if submitted < n_frames
                else max(0.0, min(1.0, deadline - time.monotonic()))
            ))
        return results, time.monotonic() - t0

    def stats(self) -> ServiceStats:
        adm = self._admission.counters()
        with self._wlock:
            warm = (self._warm_frames, self._cold_frames, self._scene_changes,
                    self._warm_refreshes, self._warm_reruns, self._warm_resets)
        dead = set(self._monitor.dead_hosts()) if self._threads else set()
        liveness = tuple(
            (s, s not in dead) for s in _STAGES
        ) if self._threads else ()
        stragglers = tuple(self._monitor.stragglers()) if self._threads else ()
        with self._slock:
            lats = sorted(self._latencies)
            n = len(lats)
            avg = (self._lat_sum / self._completed) if self._completed else 0.0
            p50 = lats[n // 2] if n else 0.0
            p95 = lats[min(n - 1, int(n * 0.95))] if n else 0.0
            span = (
                (self._t_last_emit - self._t_first_submit)
                if self._t_last_emit is not None and self._t_first_submit is not None
                else 0.0
            )
            return ServiceStats(
                submitted=self._submitted,
                completed=self._completed,
                dropped=self._dropped,
                pending=(self._submitted - self._completed - self._dropped
                         - self._failed - self._shed),
                waves=self._waves_built,
                padded_slots=self._padded_slots,
                wave_occupancy=(
                    1.0 - self._padded_slots / self._wave_slots
                    if self._wave_slots else 0.0
                ),
                cache_hits=self._cache.hits,
                cache_misses=self._cache.misses,
                programs_cached=len(self._cache),
                backpressure_seconds=self._backpressure_s,
                latency_avg_ms=avg * 1e3,
                latency_p50_ms=p50 * 1e3,
                latency_p95_ms=p95 * 1e3,
                latency_max_ms=self._lat_max * 1e3,
                throughput_fps=(self._completed / span) if span > 0 else 0.0,
                calibrations=self._cache.calibrations,
                batch_by_bucket=self._cache.batch_choices(),
                backend=str(self.device),
                tile=self.tile if isinstance(self.tile, TileSpec) else None,
                shed=self._shed,
                expired=adm["expired"],
                retried=self._retried,
                failed_frames=self._failed,
                degraded_waves=self._degraded_waves,
                degraded=adm["degraded"],
                admitted_by_stream=adm["admitted_by_stream"],
                shed_by_stream=adm["shed_by_stream"],
                stage_liveness=liveness,
                stage_stragglers=stragglers,
                warm_frames=warm[0],
                cold_frames=warm[1],
                scene_changes=warm[2],
                warm_refreshes=warm[3],
                warm_reruns=warm[4],
                warm_resets=warm[5],
            )

    # ------------------------------------------------------- stage plumbing
    def _beat(self, stage: str) -> None:
        self._monitor.beat(stage, self._stage_steps[stage])

    def _step(self, stage: str) -> None:
        self._stage_steps[stage] += 1
        self._monitor.beat(stage, self._stage_steps[stage])

    def _put(self, q: queue.Queue, item, stage: str) -> bool:
        while not self._abort.is_set():
            self._beat(stage)
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _get(self, q: queue.Queue, stage: str):
        while not self._abort.is_set():
            self._beat(stage)
            try:
                return q.get(timeout=0.05)
            except queue.Empty:
                continue
        return None

    # --------------------------------------------------- stage 0: assembly
    def _assemble_loop(self) -> None:
        pending: collections.deque = collections.deque()
        while not self._abort.is_set():
            self._beat("assemble")
            draining = self._drain.is_set()
            try:
                req = self._ingest.get(timeout=0.02)
                self._classify_warm(req)
                pending.append(req)
            except queue.Empty:
                if draining and not pending:
                    self._put(self._waves, _EOS, "assemble")
                    return
                if not pending:
                    continue

            # Shed work that expired while queued -- in every bucket.
            now = time.monotonic()
            if any(r.deadline is not None and r.deadline < now
                   for r in pending):
                _, dead = self._admission.select(list(pending), 0, now)
                dead_ids = {r.request_id for r in dead}
                pending = collections.deque(
                    r for r in pending if r.request_id not in dead_ids
                )
                for r in dead:
                    self._shed_request(r)
                if not pending:
                    continue

            # Fill the head-of-line wave: linger briefly for same-bucket
            # requests, then dispatch padded rather than stall.  Warm and
            # cold frames never share a wave, so the classification joins
            # the grouping key.
            key = self._cache.bucket_shape(pending[0].h, pending[0].w)
            warm = pending[0].warm
            width = self._cache.batch_for(*key)
            deadline = time.monotonic() + self.wave_linger
            while (not draining
                   and sum(self._cache.bucket_shape(r.h, r.w) == key and r.warm == warm
                           for r in pending) < width):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    req = self._ingest.get(timeout=remaining)
                    self._classify_warm(req)
                    pending.append(req)
                except queue.Empty:
                    break

            # Admission: deadline shedding + per-stream round-robin slots
            # over the head bucket's candidates.
            candidates = [
                r for r in pending
                if self._cache.bucket_shape(r.h, r.w) == key and r.warm == warm
            ]
            admitted, dead = self._admission.select(
                candidates, width, time.monotonic()
            )
            taken = {r.request_id for r in admitted}
            taken |= {r.request_id for r in dead}
            pending = collections.deque(
                r for r in pending if r.request_id not in taken
            )
            for r in dead:
                self._shed_request(r)
            if not admitted:
                continue
            backlog = self._ingest.qsize() + len(pending) + len(admitted)
            degraded = self._admission.update_pressure(backlog)
            wave = self._build_wave(key, admitted, width, degraded, warm)
            if not self._put(self._waves, wave, "assemble"):
                return
            self._step("assemble")

    def _classify_warm(self, req: _Request) -> None:
        """The warm/cold decision for one frame, pinned as it enters
        assembly: stamps ``req.warm`` / ``req.prior`` / ``req.thumb`` and
        advances the warm counters.  A no-op with ``warm_start=False``."""
        if not self.warm_start:
            return
        if req.deadline is not None and req.deadline < time.monotonic():
            # Admission sheds it this same pass: a doomed frame touches no
            # state and no streak (its shed delivery still resets the state).
            return
        fault = (self.fault_plan.warm_kind(req.request_id)
                 if self.fault_plan is not None else None)
        req.thumb = frame_thumbnail(req.left)
        with self._wlock:
            state = self._warm_state.get(req.stream_id)
            if fault == "stale_state" and state is not None:
                # Poison the stored seed: the thumbnail still matches, so the
                # frame classifies warm on a corrupt prior, which only the
                # post-hoc check can catch.
                state.disparity = _warmstart.corrupt_disparity(
                    state.disparity, self.params.disp_max
                )
            if fault == "scene_cut":
                warm, reason = False, "scene_change"
            else:
                warm, reason = _warmstart.classify(
                    state, req.thumb, (req.h, req.w), req.seq,
                    threshold=self.scene_change_threshold,
                    refresh_interval=self.refresh_interval,
                )
            if warm:
                req.warm = True
                # Pinned now: a later state reset cannot change an assembled
                # wave.
                req.prior = state.disparity.copy()
                if fault == "corrupt_prior":
                    req.prior = _warmstart.corrupt_disparity(
                        req.prior, self.params.disp_max
                    )
                state.streak += 1
                self._warm_frames += 1
            else:
                self._cold_frames += 1
                if reason == "scene_change":
                    self._scene_changes += 1
                elif reason == "refresh":
                    self._warm_refreshes += 1
                elif reason in ("stale_seq", "resolution"):
                    self._warm_resets += 1
                # Every cold reason but "no state" resets the chain, so this
                # frame's own delivery re-seeds it.
                if state is not None:
                    self._warm_state.pop(req.stream_id, None)

    def _shed_request(self, req: _Request) -> None:
        self._finish(req, None, error=(
            f"shed by admission control: deadline expired before compute "
            f"(frame {req.frame_id}, stream {req.stream_id})"
        ), shed=True)

    def _build_wave(self, key: tuple, reqs: list, width: int,
                    degraded: bool = False, warm: bool = False) -> _Wave:
        bh, bw = key
        pad = width - len(reqs)

        def fit(img: np.ndarray) -> np.ndarray:
            h, w = img.shape
            if (h, w) == (bh, bw):
                return img
            return np.pad(img, ((0, bh - h), (0, bw - w)), mode="edge")

        lefts = [fit(r.left) for r in reqs]
        rights = [fit(r.right) for r in reqs]
        if pad:                     # replicate a real frame into padded slots
            lefts += [lefts[0]] * pad
            rights += [rights[0]] * pad
        prior = None
        if warm:
            # The pinned priors, padded like the frames.  Warm requests keep
            # their host frames and priors: emit needs them for the post-hoc
            # check and its cold re-run.
            priors = [fit(r.prior) for r in reqs]
            priors += [priors[0]] * pad
            prior = torch.from_numpy(np.stack(priors)).to(self.device)
        else:
            for r in reqs:          # emit only needs ids/shape/timing: release
                r.left = r.right = None  # host frames while waves are queued
        with self._slock:
            index = self._waves_built
            self._waves_built += 1
            self._wave_slots += width
            self._padded_slots += pad
            if degraded:
                self._degraded_waves += 1
        return _Wave(
            key=key, requests=reqs, index=index, degraded=degraded, warm=warm, prior=prior,
            left=torch.from_numpy(np.stack(lefts)).to(self.device),
            right=torch.from_numpy(np.stack(rights)).to(self.device),
        )

    # ------------------------------------------- stages 1+2: contained exec
    def _check_faults(self, stage: str, wave: _Wave) -> None:
        if self.fault_plan is not None:
            self.fault_plan.check(
                stage, wave.index,
                tuple(r.request_id for r in wave.requests),
            )

    def _support_of(self, prog: WavePrograms, warm: bool):
        return prog.support_warm if warm else prog.support

    def _dense_of(self, prog: WavePrograms, degraded: bool, warm: bool = False):
        if warm:
            return (prog.dense_warm_degraded
                    if degraded and prog.dense_warm_degraded is not None else prog.dense_warm)
        return (prog.dense_degraded
                if degraded and prog.dense_degraded is not None else prog.dense)

    def _exec_stage(self, wave: _Wave, stage: str) -> None:
        """Run one stage over one wave and wait for it, so failures surface
        HERE -- in the stage that owns the retry -- not at emit."""
        self._check_faults(stage, wave)
        with self._launch_lock, self._cache.on_stream(stage):
            if stage == "support":
                wave.programs = self._cache.get(
                    *wave.key, batch=int(wave.left.shape[0])
                )
                wave.mid = self._support_of(wave.programs, wave.warm)(wave.left, wave.right)
            else:
                dense = self._dense_of(wave.programs, wave.degraded, wave.warm)
                extra = (wave.prior,) if wave.warm else ()
                wave.disp = dense(*wave.mid, *extra)
        self._cache.synchronize(stage)
        if stage == "support":
            wave.left = wave.right = None
        else:
            wave.mid = wave.prior = None

    def _retry_slot(self, wave: _Wave, stage: str, slot: int) -> _Wave:
        """The bounded retry: re-run ONE slot of a failed wave as a
        single-frame wave (batch-1 program).  A warm slot retries on the
        batch-1 warm programs with its slice of the wave's pinned prior."""
        req = wave.requests[slot]
        with self._slock:
            self._retried += 1
        prog = self._cache.get(*wave.key, batch=1)
        sub = _Wave(key=wave.key, requests=[req], left=None, right=None,
                    index=wave.index, degraded=wave.degraded, warm=wave.warm,
                    programs=prog)
        if self.fault_plan is not None:
            self.fault_plan.check(stage, wave.index, (req.request_id,))
        with self._launch_lock, self._cache.on_stream(stage):
            if stage == "support":
                sub.mid = self._support_of(prog, wave.warm)(wave.left[slot:slot + 1],
                                                            wave.right[slot:slot + 1])
                if wave.warm:
                    sub.prior = wave.prior[slot:slot + 1]
            else:
                mid = tuple(m[slot:slot + 1] for m in wave.mid)
                extra = (wave.prior[slot:slot + 1],) if wave.warm else ()
                sub.disp = self._dense_of(prog, wave.degraded, wave.warm)(*mid, *extra)
        self._cache.synchronize(stage)
        return sub

    def _contain(self, wave: _Wave, stage: str, exc: Exception,
                 downstream: queue.Queue) -> bool:
        """Wave-scoped error containment: the failed wave is split into
        single-frame waves and retried once per slot.  Slots that recover
        continue downstream; slots that fail again are quarantined
        (delivered as error frames).  Only ``max_wave_failures`` consecutive
        waves with no surviving slot abort the engine.  Returns False only
        when aborting mid-push."""
        survivors: list[_Wave] = []
        failures: list[tuple[_Request, Exception]] = []
        for slot, req in enumerate(wave.requests):
            try:
                survivors.append(self._retry_slot(wave, stage, slot))
            except Exception as retry_exc:     # noqa: BLE001 -- quarantine
                failures.append((req, retry_exc))
        for req, retry_exc in failures:
            self._finish(req, None, error=(
                f"{stage} stage failed after retry: {retry_exc!r} "
                f"(wave {wave.index}, first failure: {exc!r})"
            ))
        systemic = False
        with self._slock:
            if failures and not survivors:
                self._consec_wave_failures += 1
                systemic = (self._consec_wave_failures
                            >= self.max_wave_failures)
            else:
                self._consec_wave_failures = 0
        if systemic:
            raise RuntimeError(
                f"systemic failure: {self.max_wave_failures} consecutive "
                f"waves failed completely in the {stage} stage"
            ) from exc
        for sub in survivors:
            if not self._put(downstream, sub, stage):
                return False
        return True

    def _stage_loop(self, stage: str, upstream: queue.Queue,
                    downstream: queue.Queue) -> None:
        while True:
            wave = self._get(upstream, stage)
            if wave is None:
                return
            if wave is _EOS:
                self._put(downstream, _EOS, stage)
                return
            try:
                self._exec_stage(wave, stage)
            except Exception as e:             # noqa: BLE001 -- contained
                if not self._contain(wave, stage, e, downstream):
                    return
            else:
                with self._slock:
                    self._consec_wave_failures = 0
                if not self._put(downstream, wave, stage):
                    return
            self._step(stage)

    def _support_loop(self) -> None:
        self._stage_loop("support", self._waves, self._mid)

    def _dense_loop(self) -> None:
        self._stage_loop("dense", self._mid, self._ready)

    # ------------------------------------------------------- stage 3: emit
    def _emit_loop(self) -> None:
        while True:
            wave = self._get(self._ready, "emit")
            if wave is None:
                return
            if wave is _EOS:
                self._done.set()
                return
            try:
                self._check_faults("emit", wave)
                disp = wave.disp.cpu().numpy()   # device -> host
            except Exception as e:             # noqa: BLE001 -- contain: the
                # wave's device results are gone, so there is no retry here;
                # its frames fail terminally but the engine stays up.
                for req in wave.requests:
                    self._finish(req, None, error=(
                        f"emit stage failed: {e!r} (wave {wave.index})"
                    ))
                with self._slock:
                    self._consec_wave_failures += 1
                    systemic = (self._consec_wave_failures
                                >= self.max_wave_failures)
                if systemic:
                    raise RuntimeError(
                        f"systemic failure: {self.max_wave_failures} "
                        f"consecutive waves failed at emit"
                    ) from e
                self._step("emit")
                continue
            with self._slock:
                self._consec_wave_failures = 0
            for slot, req in enumerate(wave.requests):
                out = np.array(disp[slot, : req.h, : req.w])
                error = None
                if wave.warm:
                    out, error = self._posthoc_check(req, out, wave.key)
                    req.left = req.right = req.prior = None
                self._finish(req, out, error=error)
            wave.disp = None
            self._step("emit")

    def _posthoc_check(self, req: _Request, out: np.ndarray, key: tuple) -> tuple:
        """The warm self-check at emit: the result scored against the prior
        that seeded it; past ``rerun_threshold * num_disp`` the frame is
        re-run cold on the batch-1 cold stages.  Returns ``(out, error)``."""
        score = prior_disagreement(out, req.prior, self.params.num_disp)
        limit = self.rerun_threshold * self.params.num_disp
        if score <= limit:
            return out, None
        with self._wlock:
            self._warm_reruns += 1
        try:
            return self._run_cold_single(req, key), None
        except Exception as e:             # noqa: BLE001 -- contained: the
            # re-run failing fails only this frame, like any compute fault
            return None, (
                f"warm post-hoc cold re-run failed: {e!r} "
                f"(disagreement {score:.1f} levels, limit {limit:.1f})"
            )

    def _run_cold_single(self, req: _Request, key: tuple) -> np.ndarray:
        """One frame through the batch-1 cold stages, from its host frames
        (warm requests keep them until emit for this), each stage on its own
        stream under the launch lock, as the stage threads run them."""
        bh, bw = key
        pad = ((0, bh - req.h), (0, bw - req.w))
        prog = self._cache.get(*key, batch=1)
        left, right = (torch.from_numpy(np.pad(img, pad, mode="edge")[None]).to(self.device)
                       for img in (req.left, req.right))
        with self._launch_lock, self._cache.on_stream("support"):
            mid = prog.support(left, right)
        self._cache.synchronize("support")
        with self._launch_lock, self._cache.on_stream("dense"):
            disp = prog.dense(*mid)
        self._cache.synchronize("dense")
        return np.array(disp[0, : req.h, : req.w].cpu().numpy())

    # ------------------------------------------------------------ delivery
    def _finish(self, req: _Request, out: Optional[np.ndarray],
                error: Optional[str] = None, shed: bool = False) -> None:
        """Terminal delivery for one request -- success, compute failure,
        or admission shed.  Honors the in_order reordering buffer: every
        terminal state advances the stream's sequence, so a failed or shed
        frame never blocks the frames behind it."""
        if not self.in_order:
            self._deliver(req, out, error, shed)
            return
        with self._olock:
            # Hold this frame until every earlier submission of the same
            # stream has been delivered, then flush the consecutive run.
            # Latency is measured at delivery, so it includes hold time.
            sid = req.stream_id
            self._reorder.setdefault(sid, {})[req.seq] = (req, out, error, shed)
            pending = self._reorder[sid]
            while True:
                nxt = self._next_emit[sid]
                if nxt in self._lost_seqs[sid]:
                    # known-dead seq (dropped by an aborted stop): skip it
                    self._lost_seqs[sid].discard(nxt)
                    self._next_emit[sid] = nxt + 1
                elif nxt in pending:
                    r, o, err, sh = pending.pop(nxt)
                    self._next_emit[sid] = nxt + 1
                    self._deliver(r, o, err, sh)
                else:
                    break

    def _deliver(self, req: _Request, out: Optional[np.ndarray],
                 error: Optional[str] = None, shed: bool = False) -> None:
        now = time.monotonic()
        lat = now - req.t_submit
        if self.warm_start:
            # Delivery is the only writer of a stream's state: a frame seeds
            # its successor only once it was delivered intact and in sequence.
            with self._wlock:
                state = self._warm_state.get(req.stream_id)
                if error is not None:
                    # A quarantined or shed frame: the state is suspect.
                    if state is not None:
                        self._warm_state.pop(req.stream_id, None)
                        self._warm_resets += 1
                elif state is None or req.seq == state.seq + 1:
                    self._warm_state[req.stream_id] = WarmState.from_delivery(
                        out, req.thumb, req.seq,
                        streak=state.streak if state is not None else 0,
                    )
                else:
                    # Out of sequence: the chain is broken; reset rather than
                    # store a gapped seed.
                    self._warm_state.pop(req.stream_id, None)
                    self._warm_resets += 1
        with self._slock:
            self._inflight.pop(req.request_id, None)
            if error is None:
                self._completed += 1
                self._latencies.append(lat)
                self._lat_sum += lat
                self._lat_max = max(self._lat_max, lat)
            elif shed:
                self._shed += 1
            else:
                self._failed += 1
            self._t_last_emit = now
        self._out.put(CompletedFrame(
            request_id=req.request_id, stream_id=req.stream_id,
            frame_id=req.frame_id, disparity=out, latency_s=lat,
            error=error,
        ))
