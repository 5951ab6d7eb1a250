"""Stage heartbeats, checkpoint-replay recovery and elastic re-scale
(counterpart of ``repro/runtime/fault_tolerance.py``: ``HostStatus``,
``HeartbeatMonitor``, ``run_with_recovery``, ``elastic_reshard``).

Each stage thread of :class:`repro_torch.serving.stereo_service.StereoService`
beats once per poll with its wave count as the step, so a wedged stage
shows up as dead (no beat within ``timeout``) and a slow one as a
straggler (mean time per step above ``straggler_factor`` x the median) in
``StereoService.stats()``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed.sharding import (NamedSharding, ShardingRules, logical_to_spec,
                                              spec_to_placements)


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


# --------------------------------------------------------------------------
# checkpoint-replay recovery
# --------------------------------------------------------------------------
def run_with_recovery(
    step_fn: Callable[[int, Any], Any],
    state: Any,
    start_step: int,
    num_steps: int,
    checkpoint_mgr,
    save_every: int,
    restore_fn: Callable[[], tuple[int, Any]],
    max_failures: int = 10,
) -> tuple[Any, int, int]:
    """Drive step_fn with checkpointing; on exception restore and replay.

    Returns (final_state, final_step, failures_recovered).
    """
    failures = 0
    step = start_step
    while step < start_step + num_steps:
        try:
            state = step_fn(step, state)
            step += 1
            if step % save_every == 0:
                checkpoint_mgr.save(step, state)
        except Exception:
            failures += 1
            if failures > max_failures:
                raise
            checkpoint_mgr.wait()
            step, state = restore_fn()
    checkpoint_mgr.wait()
    return state, step, failures


# --------------------------------------------------------------------------
# elastic re-scale
# --------------------------------------------------------------------------
def elastic_reshard(
    tree: Any,
    spec_tree: Any,
    new_mesh: DeviceMesh,
    rules: ShardingRules,
) -> Any:
    """Re-lay-out a tree of tensors (plain, or DTensors on any mesh) onto
    ``new_mesh``: nested dicts and lists of them, with ``spec_tree`` in the
    same structure holding each leaf's logical-axis tuple (the model's
    ``param_specs``).  The specs are re-resolved against the NEW mesh, so
    e.g. fsdp=("pod","data") simply drops the pod axis when the new mesh has
    none."""
    if isinstance(tree, dict):
        return {k: elastic_reshard(v, spec_tree[k], new_mesh, rules) for k, v in tree.items()}
    if isinstance(tree, list):
        return [elastic_reshard(v, s, new_mesh, rules) for v, s in zip(tree, spec_tree)]
    spec = logical_to_spec(spec_tree, rules, new_mesh)
    return NamedSharding(new_mesh, spec, spec_to_placements(spec, new_mesh)).place(tree)
