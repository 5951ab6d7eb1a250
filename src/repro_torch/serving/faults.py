"""Deterministic fault injection for the stereo serving engine (copy of
``repro/serving/faults.py``; standard library only).

Robustness claims about a threaded pipeline are worthless unless every
failure mode can be reproduced on demand.  A :class:`FaultPlan` is a list
of :class:`FaultSpec` triggers handed to ``StereoService(fault_plan=...)``;
the stage loops call :meth:`FaultPlan.check` immediately before executing a
wave's program, and the plan deterministically raises (or delays) for the
chosen stage / wave index / request id.  ``tests/test_torch_serving_faults.py``
uses this to prove the engine's containment properties: a wave-level fault
fails only its own frames, one bounded retry recovers transients, a poison
frame is quarantined without killing its wave-mates, and repeated systemic
failure aborts the engine cleanly.

Trigger matching (all conditions AND together):

* ``stage``       -- which stage loop fires ("support" | "dense" | "emit").
* ``wave``        -- global wave-assembly index, or None for every wave.
* ``request_id``  -- fire only when this request rides the wave (a *poison
  frame*: it re-fires on the single-frame retry wave, so the frame fails
  terminally while its wave-mates recover).
* ``times``       -- total number of firings, or None for unlimited.
  ``times=1`` models a *transient* fault: the batched attempt fails, the
  retry passes.

``kind="delay"`` sleeps ``delay_s`` instead of raising -- used to build
queue pressure for admission-control / degraded-mode tests without any
frame actually failing.

Warm-start injection: specs with ``stage="warm"`` fire at warm
CLASSIFICATION time (no wave exists yet, so only ``request_id`` /
``times`` match) and carry one of the :data:`WARM_KINDS` instead of
raising:

* ``"scene_cut"``    -- force the scene-change detector's score to
  infinity for the matched frame, proving the detector-fallback path
  (the frame must come out bitwise-cold and reset the stream's state).
* ``"corrupt_prior"``-- corrupt the frame's pinned prior AFTER a warm
  classification (the in-flight copy only; stream state is untouched),
  proving the post-hoc disagreement check triggers a cold re-run.
* ``"stale_state"``  -- corrupt the stream's STORED state before
  classification (the thumbnail still matches, so the frame classifies
  warm on a poisoned seed), proving silent state corruption is caught
  by the same post-hoc check.

The engine polls these via :meth:`FaultPlan.warm_kind`.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence


#: Fault kinds valid for ``stage="warm"`` specs (see module docstring).
WARM_KINDS = ("scene_cut", "corrupt_prior", "stale_state")


class FaultInjected(RuntimeError):
    """Raised by :meth:`FaultPlan.check` when a ``raise``-kind spec fires."""


@dataclasses.dataclass
class FaultSpec:
    """One deterministic trigger inside a :class:`FaultPlan`."""

    stage: str                          # "support" | "dense" | "emit"
    wave: Optional[int] = None          # global wave index; None == any wave
    request_id: Optional[int] = None    # poison frame; None == any request
    kind: str = "raise"                 # "raise" | "delay"
    times: Optional[int] = 1            # firings before the spec goes quiet;
                                        # None == unlimited (persistent fault)
    delay_s: float = 0.0                # sleep length for kind="delay"
    message: str = "injected fault"

    def __post_init__(self) -> None:
        if self.stage not in ("support", "dense", "emit", "warm"):
            raise ValueError(f"unknown stage {self.stage!r}")
        if self.stage == "warm":
            if self.kind not in WARM_KINDS:
                raise ValueError(
                    f"warm-stage specs need a kind in {WARM_KINDS}, "
                    f"got {self.kind!r}"
                )
        elif self.kind not in ("raise", "delay"):
            raise ValueError(f"unknown kind {self.kind!r}")
        if self.times is not None and self.times < 1:
            raise ValueError(f"times must be >= 1 or None, got {self.times}")


class FaultPlan:
    """A deterministic set of :class:`FaultSpec` triggers (thread-safe)."""

    def __init__(self, specs: Sequence[FaultSpec]):
        self.specs = list(specs)
        self._fired = [0] * len(self.specs)
        self._lock = threading.Lock()

    def fired(self, index: int) -> int:
        """How many times spec ``index`` has fired so far."""
        with self._lock:
            return self._fired[index]

    def check(self, stage: str, wave_index: int,
              request_ids: Sequence[int]) -> None:
        """Fire every matching spec; raises on the first ``raise`` match.

        Called by the stage loops with the wave's global assembly index and
        the request ids riding it (a single-frame retry wave passes just
        the one id, which is what lets ``request_id`` specs poison a frame
        through its retry while wave-mates recover).
        """
        rids = set(request_ids)
        for i, spec in enumerate(self.specs):
            if spec.stage != stage:
                continue
            if spec.stage == "warm":
                continue            # warm specs fire via warm_kind(), not here
            if spec.wave is not None and spec.wave != wave_index:
                continue
            if spec.request_id is not None and spec.request_id not in rids:
                continue
            with self._lock:
                if spec.times is not None and self._fired[i] >= spec.times:
                    continue
                self._fired[i] += 1
            if spec.kind == "delay":
                time.sleep(spec.delay_s)
                continue
            raise FaultInjected(
                f"{spec.message} (stage={stage}, wave={wave_index}, "
                f"requests={sorted(rids)})"
            )

    def warm_kind(self, request_id: int) -> Optional[str]:
        """The first matching warm-stage spec's kind for one frame, or None.

        Called by the serving engine once per frame at warm classification
        time; a match consumes one firing (``times`` semantics as in
        :meth:`check`).  Only ``request_id`` filters apply -- no wave
        exists yet when a frame is classified.
        """
        for i, spec in enumerate(self.specs):
            if spec.stage != "warm":
                continue
            if spec.request_id is not None and spec.request_id != request_id:
                continue
            with self._lock:
                if spec.times is not None and self._fired[i] >= spec.times:
                    continue
                self._fired[i] += 1
            return spec.kind
        return None
