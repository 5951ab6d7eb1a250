"""Logical-axis sharding: one rules table maps model-level axis names onto
the axes of a ``torch.distributed`` DeviceMesh (counterpart of
``repro/distributed/sharding.py``).

Models annotate activations and parameters with LOGICAL axes ("batch",
"heads", "ffn", "vocab", "experts", ...).  The rules decide the physical
mapping:

  single-pod mesh (16, 16) = (data, model)
  multi-pod mesh (2, 16, 16) = (pod, data, model)

Parallelism styles expressed purely through rules:
  * DP/FSDP: batch -> (pod, data); fsdp param axis -> (pod, data)
  * TP:      heads/ffn/vocab/experts -> model
  * SP:      seq_kv -> (data,)/(model,) for long-context decode

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
tensor dimension, each None (replicated), a mesh axis name, or a tuple of
names (one dimension split over several mesh axes, the first the major).
DTensor writes the same layout the other way round, one placement per mesh
dimension (:func:`spec_to_placements`): ``Shard(d)`` on every mesh axis
that tensor dimension ``d`` names, ``Replicate()`` on the rest.  DTensor
splits a dimension over its mesh dimensions in the mesh's order, so a tuple
must name its axes in that order (the rules' ``("pod", "data")`` does).

The reference's ambient mesh is JAX's ``with mesh:``; here it is
:class:`use_mesh`, thread-local as the rules are.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication, local_map

Spec = Tuple[Optional[object], ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> physical mesh axis (or tuple, or None=replicated)."""
    batch: tuple[str, ...] | str | None = ("pod", "data")
    seq: tuple[str, ...] | str | None = None          # activation seq axis
    seq_kv: tuple[str, ...] | str | None = None       # KV-cache seq axis (SP)
    d_model: tuple[str, ...] | str | None = None
    heads: tuple[str, ...] | str | None = "model"
    kv_heads: tuple[str, ...] | str | None = "model"
    head_dim: tuple[str, ...] | str | None = None
    ffn: tuple[str, ...] | str | None = "model"
    vocab: tuple[str, ...] | str | None = "model"
    experts: tuple[str, ...] | str | None = "model"
    expert_capacity: tuple[str, ...] | str | None = None
    conv_dim: tuple[str, ...] | str | None = "model"  # mamba inner dim
    state: tuple[str, ...] | str | None = None        # ssm/xlstm state dims
    fsdp: tuple[str, ...] | str | None = ("pod", "data")  # param FSDP axis
    layers: tuple[str, ...] | str | None = None       # stacked-unit axis

    def lookup(self, logical: Optional[str]) -> tuple[str, ...] | str | None:
        if logical is None:
            return None
        try:
            return getattr(self, logical)
        except AttributeError as e:
            raise KeyError(f"unknown logical axis {logical!r}") from e


# Default rules (single-device / test): everything replicated.
REPLICATED_RULES = ShardingRules(
    batch=None, heads=None, kv_heads=None, ffn=None, vocab=None,
    experts=None, conv_dim=None, fsdp=None,
)

_state = threading.local()


def set_rules(rules: Optional[ShardingRules]) -> None:
    _state.rules = rules


def current_rules() -> Optional[ShardingRules]:
    return getattr(_state, "rules", None)


class use_rules:
    """Context manager scoping the active sharding rules."""

    def __init__(self, rules: Optional[ShardingRules]):
        self.rules = rules

    def __enter__(self):
        self.prev = current_rules()
        set_rules(self.rules)
        return self.rules

    def __exit__(self, *exc):
        set_rules(self.prev)
        return False


def current_mesh() -> Optional[DeviceMesh]:
    return getattr(_state, "mesh", None)


class use_mesh:
    """Context manager scoping the ambient mesh (JAX's ``with mesh:``)."""

    def __init__(self, mesh: Optional[DeviceMesh]):
        self.mesh = mesh

    def __enter__(self):
        self.prev = current_mesh()
        _state.mesh = self.mesh
        return self.mesh

    def __exit__(self, *exc):
        _state.mesh = self.prev
        return False


def logical_to_spec(
    logical_axes: Tuple[Optional[str], ...],
    rules: Optional[ShardingRules] = None,
    mesh: Optional[DeviceMesh] = None,
) -> Spec:
    """Resolve logical axis names to a spec under the rules.

    Physical axes absent from the mesh are dropped (so the same rules work
    on single-pod (data, model) and multi-pod (pod, data, model) meshes).
    """
    rules = rules or current_rules() or REPLICATED_RULES
    mesh = mesh or current_mesh()
    avail = set(mesh.mesh_dim_names) if mesh is not None else None

    spec = []
    for ax in logical_axes:
        phys = rules.lookup(ax)
        if phys is None:
            spec.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        if avail is not None:
            phys = tuple(a for a in phys if a in avail)
        if len(phys) == 0:
            spec.append(None)
        elif len(phys) == 1:
            spec.append(phys[0])
        else:
            spec.append(phys)
    return tuple(spec)


def spec_to_placements(spec: Spec, mesh: DeviceMesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dimension:
    ``Shard(d)`` where tensor dimension ``d`` names that mesh axis, else
    ``Replicate()``.  Raises for an axis the mesh lacks, an axis named
    twice, or a tuple out of the mesh's order (DTensor would give a rank
    another shard than JAX)."""
    names = tuple(mesh.mesh_dim_names)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"spec {spec} names mesh axes {missing} not in {names}")
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec {spec} splits dimension {d} over {axes}, out of the "
                             f"mesh's order {names}")
        for i in dims:
            if placements[i] != Replicate():
                raise ValueError(f"spec {spec} names mesh axis {names[i]!r} twice")
            placements[i] = Shard(d)
    return tuple(placements)


def logical_placements(logical_axes: Tuple[Optional[str], ...],
                       rules: Optional[ShardingRules] = None,
                       mesh: Optional[DeviceMesh] = None) -> tuple:
    """The placements of ``logical_axes`` under the rules on the mesh (the
    ambient ones by default)."""
    mesh = mesh or current_mesh()
    return spec_to_placements(logical_to_spec(logical_axes, rules, mesh), mesh)


def on_mesh() -> bool:
    """Whether both a mesh and rules are in scope (else the hints below are
    no-ops, as the reference's are without them)."""
    return current_rules() is not None and current_mesh() is not None


def logical_constraint(x: torch.Tensor, logical_axes: Tuple[Optional[str], ...]) -> torch.Tensor:
    """The counterpart of ``with_sharding_constraint`` by logical names: a
    DTensor is redistributed to the placements the rules give on the
    ambient mesh; a no-op without mesh or rules, and on a plain tensor."""
    if not isinstance(x, DTensor) or not on_mesh():
        return x
    placements = logical_placements(logical_axes)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def on_local_shards(fn, in_axes: tuple, out_axes: tuple):
    """``fn`` run on each rank's local shards, for a computation that is
    local along the dimensions the rules split (attention over one batch
    row and head, a recurrent chunk): under a mesh, with DTensor arguments,
    each tensor argument is redistributed to the layout of its logical axes
    (``in_axes``, one tuple per argument, None for a non-tensor or an absent
    one; explicit redistributes, no-ops where the layouts agree) and the
    outputs are DTensors laid out by ``out_axes`` (one tuple per output; a
    single tuple of names for one output).  This is the layout GSPMD would
    give such a computation; DTensor may have no strategy for some of its
    operations, or for the reshapes of their backward.  Without a mesh, or
    on plain tensors, ``fn`` itself."""
    single = all(a is None or isinstance(a, str) for a in out_axes)

    def wrapped(*args):
        if not on_mesh() or not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        mesh = current_mesh()
        in_placements, laid = [], []
        for a, axes in zip(args, in_axes):
            if axes is None or a is None:
                in_placements.append(None)
                laid.append(a)
                continue
            if not isinstance(a, DTensor):
                raise TypeError("on_local_shards: every tensor argument with axes must be a "
                                "DTensor under a mesh")
            placements = logical_placements(axes, mesh=mesh)
            in_placements.append(placements)
            laid.append(a if tuple(a.placements) == placements
                        else a.redistribute(mesh, placements))
        # local_map reads a list as one output's placements, a tuple as one
        # entry per output.
        out_placements = (list(logical_placements(out_axes, mesh=mesh)) if single else
                          tuple(list(logical_placements(axes, mesh=mesh)) for axes in out_axes))
        local = local_map(fn, out_placements=out_placements, in_placements=tuple(in_placements),
                          device_mesh=mesh)
        return local(*laid)

    return wrapped


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor redistributed to whole on every rank (a pending sum or mean
    reduced, shards gathered); anything else unchanged."""
    if not isinstance(x, DTensor) or all(p.is_replicate() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def placements_split(x: torch.Tensor, dim: int) -> Optional[tuple]:
    """For a DTensor split along ``dim``: its placements with that split
    replicated; None for a plain tensor or one whole along ``dim``."""
    if not isinstance(x, DTensor) or not any(p.is_shard(dim) for p in x.placements):
        return None
    return tuple(Replicate() if p.is_shard(dim) else p for p in x.placements)


class _GradLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        # A pending sum's gradient is the same on every rank: replicated.
        ctx.mesh = x.device_mesh
        ctx.placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(ctx.mesh, ctx.placements)
        return grad


def keep_grad_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, whose gradient is laid out as ``x`` is before it flows
    on (GSPMD reshards a gradient to its value's layout; DTensor may leave it
    split where a later backward view cannot take it).  A no-op on a plain
    tensor or without a mesh."""
    if not isinstance(x, DTensor) or not on_mesh() or not torch.is_grad_enabled():
        return x
    return _GradLayout.apply(x)


def distribute(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """A plain tensor laid out on the ambient mesh by logical names (the
    reference's ``in_shardings`` for an input); unchanged without mesh or
    rules, or when it is already a DTensor."""
    if isinstance(x, DTensor) or not on_mesh():
        return x
    mesh = current_mesh()
    return distribute_tensor(x, mesh, logical_placements(logical_axes, mesh=mesh))


def full(x):
    """A DTensor gathered into one plain tensor on every rank (what
    ``np.asarray`` of a sharded array gives); anything else unchanged."""
    return x.full_tensor() if isinstance(x, DTensor) else x


@contextlib.contextmanager
def plain_as_replicated():
    """Under a mesh, a context in which plain tensors meeting DTensors count
    as replicated: the positions, masks, frequencies and constants that the
    models make on every rank alike.  A null context otherwise.  Nests
    (``implicit_replication`` itself switches off at the first exit); as a
    decorator it decides at each call."""
    if not on_mesh() or getattr(_state, "replicating", False):
        yield
        return
    _state.replicating = True
    try:
        with implicit_replication():
            yield
    finally:
        _state.replicating = False


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a layout on it (the reference's ``jax.sharding.NamedSharding``):
    the spec and its DTensor placements."""
    mesh: DeviceMesh
    spec: Spec
    placements: tuple

    def place(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (plain, or a DTensor on any mesh) laid out by this sharding."""
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return distribute_tensor(x, self.mesh, self.placements)


def named_sharding(mesh: DeviceMesh, *logical_axes: Optional[str]) -> NamedSharding:
    spec = logical_to_spec(tuple(logical_axes), mesh=mesh)
    return NamedSharding(mesh, spec, spec_to_placements(spec, mesh))
