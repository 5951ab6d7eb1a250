"""Stage heartbeats (copy of ``HostStatus`` and ``HeartbeatMonitor`` from
``repro/runtime/fault_tolerance.py``; the reference module's checkpoint
recovery and resharding need JAX and are not ported).

Each stage thread of :class:`repro_torch.serving.stereo_service.StereoService`
beats once per poll with its wave count as the step, so a wedged stage
shows up as dead (no beat within ``timeout``) and a slow one as a
straggler (mean time per step above ``straggler_factor`` x the median) in
``StereoService.stats()``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class HostStatus:
    last_beat: float
    last_step: int
    step_times: list


class HeartbeatMonitor:
    def __init__(
        self,
        hosts: list[str],
        timeout: float = 60.0,
        straggler_factor: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.timeout = timeout
        self.straggler_factor = straggler_factor
        self.clock = clock
        self.hosts = {
            h: HostStatus(last_beat=clock(), last_step=-1, step_times=[])
            for h in hosts
        }

    def beat(self, host: str, step: int) -> None:
        st = self.hosts.get(host)
        if st is None:      # late registration (e.g. a restarted stage thread)
            st = self.hosts[host] = HostStatus(
                last_beat=self.clock(), last_step=-1, step_times=[]
            )
        now = self.clock()
        if st.last_step >= 0 and step > st.last_step:
            st.step_times.append((now - st.last_beat) / (step - st.last_step))
            st.step_times = st.step_times[-20:]
        st.last_beat = now
        st.last_step = step

    def dead_hosts(self) -> list[str]:
        now = self.clock()
        return [
            h for h, st in self.hosts.items() if now - st.last_beat > self.timeout
        ]

    def stragglers(self) -> list[str]:
        times = {
            h: sum(st.step_times) / len(st.step_times)
            for h, st in self.hosts.items()
            if st.step_times
        }
        if len(times) < 2:
            return []
        ordered = sorted(times.values())
        median = ordered[len(ordered) // 2]
        return [
            h for h, t in times.items() if t > self.straggler_factor * median
        ]

    def is_alive(self, host: str) -> bool:
        """Whether ``host``'s last beat is within ``timeout`` (unknown
        hosts report dead -- they have never beaten)."""
        st = self.hosts.get(host)
        return st is not None and self.clock() - st.last_beat <= self.timeout

    def healthy_hosts(self) -> list[str]:
        bad = set(self.dead_hosts())
        return [h for h in self.hosts if h not in bad]
