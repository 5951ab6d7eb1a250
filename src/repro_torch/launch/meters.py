"""The dry run's meters (counterpart of ``collective_bytes`` and
``peak_memory_bytes`` in ``repro/launch/dryrun.py``, and of XLA's
``cost_analysis`` flops).

The reference reads its numbers off the compiled, partitioned HLO, one
device's program.  The port traces one step eagerly on DTensors over a fake
process group, under ``FakeTensorMode``, and counts what each rank's local
operations do:

- :class:`CollectiveCounter` sums the RESULT bytes of every collective that
  DTensor issues on the local shards (the reference sums result shapes), by
  the reference's five kinds plus ``count``.  On a ``cpu`` mesh DTensor turns
  a shard-to-shard all-to-all into an all-gather and a chunk, so only a
  ``cuda`` run gives the card's inventory.
- :class:`DeviceFlopCounter` is ``FlopCounterMode`` counting the local
  operations under DTensor (``FlopCounterMode`` alone counts a DTensor
  operation at its global shape), so both the matmuls and the flash ops,
  which run on local shards inside ``local_map``, count per device.

- :class:`StepMemTracker` is ``torch.distributed._tools.mem_tracker.MemTracker``
  over a step that calls the model once a microbatch.

All three return ``NotImplemented`` on DTensor arguments, so that DTensor
dispatches first and the meter sees the local operations it runs; and they
skip the operations that DTensor's sharding propagation runs on fake
tensors of the GLOBAL shapes to learn an output's metadata: under
:func:`propagation_marked` (which flags those calls), or under another fake
mode than the one active when the meter was entered.  They stack in any
order above the ``FakeTensorMode``.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import threading

import torch
from torch._guards import active_fake_mode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, _FlopCounterMode

#: The reference's collective kinds (HLO op names), in its order.
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


# Functional collectives (``torch.ops._c10d_functional``) by the reference's
# kinds; the ops a torch build lacks are left out.
_FUNCTIONAL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "isend": "collective-permute",
    "irecv": "collective-permute",
    "batch_p2p_ops": "collective-permute",
    # what ``distribute_tensor`` issues: a whole tensor handed out from one
    # rank (the reference's inputs arrive laid out, so a step that counts one
    # of these made a tensor whole somewhere)
    "broadcast": "other",
    "broadcast_": "other",
}


def _kind_table() -> dict:
    table = {}
    for namespace, names in ((torch.ops._c10d_functional, _FUNCTIONAL_KINDS),
                             (torch.ops.c10d, {"broadcast_": "other", "scatter_": "other"}),
                             # DTensor's Shard(i) -> Shard(j) on a cuda mesh
                             (getattr(torch.ops, "_dtensor", None),
                              {"shard_dim_alltoall": "all-to-all"})):
        for name, kind in names.items():
            op = getattr(namespace, name, None) if namespace is not None else None
            if op is not None:
                table[op] = kind
    return table


_state = threading.local()


def _propagating() -> bool:
    return getattr(_state, "propagating", 0) > 0


@contextlib.contextmanager
def propagation_marked():
    """Within: DTensor's output-metadata propagation (which runs an operation
    on fake tensors of the global shapes, under the active fake mode when
    there is one) is flagged, and the meters leave what it runs out."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    original = ShardingPropagator._propagate_tensor_meta_non_cached

    @functools.wraps(original)
    def flagged(*args, **kwargs):
        _state.propagating = getattr(_state, "propagating", 0) + 1
        try:
            return original(*args, **kwargs)
        finally:
            _state.propagating -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = flagged
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = original


def _result_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_result_bytes(o) for o in out)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Bytes of every collective's result, by kind, and their ``count``
    (the reference's ``collective_bytes`` dict; ``other`` holds broadcasts
    and scatters, which the reference's kinds lack)."""

    def __init__(self):
        super().__init__()
        self._kinds = _kind_table()
        self.totals = {k: 0 for k in KINDS}
        self.totals["other"] = 0
        self.totals["count"] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        kind = self._kinds.get(getattr(func, "_overloadpacket", None))
        if kind is not None:
            self.totals[kind] += _result_bytes(out)
            self.totals["count"] += 1
        return out


class _DeviceFlopMode(_FlopCounterMode):
    def __init__(self, counter):
        super().__init__(counter)
        self.entry_fake_mode = active_fake_mode()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if _propagating() or active_fake_mode() is not self.entry_fake_mode:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)


class DeviceFlopCounter(FlopCounterMode):
    """``FlopCounterMode`` over the local operations that DTensor runs: one
    rank's flops (``get_total_flops``), and the calls of each operation with
    a flop formula (``calls``).  On plain tensors it is ``FlopCounterMode``."""

    def __init__(self):
        super().__init__(display=False)
        self.calls = collections.Counter()

    def _count_flops(self, func_packet, out, args, kwargs):
        if func_packet in self.flop_registry:
            self.calls[func_packet] += 1
        return super()._count_flops(func_packet, out, args, kwargs)

    def __enter__(self):
        # FlopCounterMode.__enter__ with the inner dispatch mode swapped for
        # one that lets DTensor go first.
        self.flop_counts.clear()
        self.calls.clear()
        self.mod_tracker.__enter__()
        self.mode = _DeviceFlopMode(self)
        self.mode.__enter__()
        return self


class StepMemTracker(MemTracker):
    """``MemTracker`` over a step that calls the model once a microbatch:
    each new forward of a module with no other parent starts that module's
    statistics afresh (``MemTracker`` refuses a second iteration), while the
    device totals and their peak run on over the whole step.  Operations of
    DTensor's sharding propagation are run untracked."""

    def __enter__(self):
        if self._depth == 0:
            self._entry_fake_mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if _propagating() or active_fake_mode() is not self._entry_fake_mode:
            return func(*args, **(kwargs or {}))
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _pre_fw_hook(self, module, inputs):
        if module in self.memory_tracking and not self._mod_tracker.is_bw:
            name = self._mod_tracker.get_known_fqn(module)
            if set(self._mod_tracker.parents) - {name} == {"Global"}:
                del self.memory_tracking[module]
        super()._pre_fw_hook(module, inputs)
