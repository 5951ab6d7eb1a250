"""Deadline-aware admission control for the stereo serving engine (copy of
``repro/serving/admission.py``; standard library only).

The paper's target consumers (robot navigation, autonomous vehicles) are
hard-real-time: a disparity frame that arrives after its deadline is not
late, it is *worthless* -- and computing it anyway steals device time from
frames that could still make theirs.  Under overload, plain FIFO wave
assembly also starves quiet streams behind a single hot one.  The
:class:`AdmissionController` fixes both at the wave-assembly seam:

* **Deadline shedding** -- requests whose ``deadline`` (absolute
  ``time.monotonic()`` timestamp) has already passed are shed *before*
  compute and delivered immediately as error frames, so device time is
  only ever spent on frames that can still be useful.  ``shed`` /
  ``expired`` counters (total and per stream) make the policy auditable.

* **Per-stream round-robin fairness** -- wave slots are granted one per
  stream in rotating order (resuming after the last stream served) rather
  than strictly FIFO, so a stream flooding the queue cannot starve the
  others; each stream's own requests still leave in submission order, so
  per-stream delivery order is untouched.

* **Degraded mode with hysteresis** -- when the assembly backlog crosses
  ``degrade_watermark``, the controller reports pressure and the service
  narrows the dense scan's plane-prior band (the streaming scan's cost is
  linear in band width, so this trades a little disparity quality for
  real latency); full quality is restored once the backlog falls back
  under ``clear_watermark``.  The two watermarks give hysteresis so the
  mode does not flap at the boundary.

The controller is engine-agnostic on purpose: it sees only objects with
``stream_id`` / ``deadline`` / ``request_id`` attributes, so the future
sharded / LM serving engines can reuse it unchanged.
"""
from __future__ import annotations

import collections
import threading
from typing import Optional, Sequence


class AdmissionController:
    """Wave-assembly admission policy: shed expired work, grant slots
    round-robin across streams, and track overload pressure.

    Parameters
    ----------
    degrade_watermark: backlog depth at which degraded mode engages, or
        None to disable degraded mode entirely (shedding and fairness
        still apply).
    clear_watermark: backlog depth at which degraded mode clears
        (default: half the degrade watermark).  Must be strictly below
        ``degrade_watermark``.
    """

    def __init__(self, degrade_watermark: Optional[int] = None,
                 clear_watermark: Optional[int] = None):
        if degrade_watermark is not None and degrade_watermark < 1:
            raise ValueError(
                f"degrade_watermark must be >= 1 or None, got {degrade_watermark}"
            )
        self.degrade_watermark = degrade_watermark
        if clear_watermark is None:
            clear_watermark = (degrade_watermark // 2
                               if degrade_watermark is not None else None)
        if degrade_watermark is not None and clear_watermark >= degrade_watermark:
            raise ValueError(
                f"clear_watermark ({clear_watermark}) must be below "
                f"degrade_watermark ({degrade_watermark})"
            )
        self.clear_watermark = clear_watermark

        self._lock = threading.Lock()
        self._degraded = False
        self._last_stream: Optional[int] = None
        self.shed = 0                    # total requests shed pre-compute
        self.expired = 0                 # subset shed for a passed deadline
        self.degraded_transitions = 0    # times degraded mode engaged
        self.admitted_by_stream: collections.Counter = collections.Counter()
        self.shed_by_stream: collections.Counter = collections.Counter()

    # ------------------------------------------------------------ admission
    def select(self, candidates: Sequence, width: int,
               now: float) -> tuple[list, list]:
        """Pick up to ``width`` requests for one wave.

        Returns ``(admitted, shed)``: requests whose ``deadline`` already
        passed are shed (never computed); the remainder are granted slots
        one per stream in rotating round-robin order, preserving each
        stream's own submission order.  Both lists keep request identity;
        the caller delivers shed requests as error frames.
        """
        live: list = []
        dead: list = []
        for r in candidates:
            if r.deadline is not None and r.deadline < now:
                dead.append(r)
            else:
                live.append(r)

        by_stream: dict = {}
        for r in live:
            by_stream.setdefault(r.stream_id, collections.deque()).append(r)
        order = sorted(by_stream)
        with self._lock:
            last = self._last_stream
        if last is not None and order:
            # resume the rotation after the last stream served
            start = 0
            for i, sid in enumerate(order):
                if sid > last:
                    start = i
                    break
            order = order[start:] + order[:start]

        admitted: list = []
        while len(admitted) < width and order:
            nxt = []
            for sid in order:
                if len(admitted) >= width:
                    break
                q = by_stream[sid]
                admitted.append(q.popleft())
                if q:
                    nxt.append(sid)
            order = nxt

        with self._lock:
            if admitted:
                self._last_stream = admitted[-1].stream_id
            for r in admitted:
                self.admitted_by_stream[r.stream_id] += 1
            self.shed += len(dead)
            self.expired += len(dead)
            for r in dead:
                self.shed_by_stream[r.stream_id] += 1
        return admitted, dead

    # ------------------------------------------------------------- pressure
    def update_pressure(self, backlog: int) -> bool:
        """Fold one backlog observation into the degraded-mode hysteresis;
        returns the mode the *next* wave should run in."""
        if self.degrade_watermark is None:
            return False
        with self._lock:
            if self._degraded:
                if backlog <= self.clear_watermark:
                    self._degraded = False
            elif backlog >= self.degrade_watermark:
                self._degraded = True
                self.degraded_transitions += 1
            return self._degraded

    @property
    def degraded(self) -> bool:
        return self._degraded

    def counters(self) -> dict:
        """Point-in-time snapshot of the admission counters."""
        with self._lock:
            return {
                "shed": self.shed,
                "expired": self.expired,
                "degraded": self._degraded,
                "degraded_transitions": self.degraded_transitions,
                "admitted_by_stream": tuple(sorted(
                    self.admitted_by_stream.items())),
                "shed_by_stream": tuple(sorted(self.shed_by_stream.items())),
            }
