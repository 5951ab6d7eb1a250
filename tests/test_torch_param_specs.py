"""Every parameter's and cache tensor's logical axes (``LMModel.param_specs``,
``models/model.py::cache_specs``) against the reference's
(``repro/models/model.py``: ``param_specs``, ``cache_specs``), for all ten
architectures at full width, and each tensor's local shard shape on both
production meshes against ``jax.sharding.NamedSharding(AbstractMesh(...),
spec).shard_shape``; all on ``meta`` tensors, allocating nothing.

The port's layout differs in two ways, which the mapping below undoes: its
layers are unstacked (the reference's leading "layers" axis on ``units``
goes), and its attention projections are matrices (the reference's ``wq``
(D, H, hd) with ("fsdp", "heads", None) is the port's (D, H*hd) with
("fsdp", "heads"): heads major in the merged dimension, so its shard is the
reshape of the reference's, element for element).  The shard shapes are
rank 0's, on a fake process group of 512 ranks (every split divides).
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_config as ref_get_config
from repro.distributed.sharding import logical_to_spec as ref_logical_to_spec
from repro.launch.mesh import make_rules as ref_make_rules
from repro.models.model import LMModel as RefModel
from repro.models.model import cache_specs as ref_cache_specs
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_production_mesh, make_rules
from repro_torch.models.model import LMModel, cache_specs

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def meshes():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        yield {"multi_pod": make_production_mesh(multi_pod=True, device_type="cpu"),
               "single_pod": DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                                        mesh_dim_names=("data", "model"))}
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference_abstract():
    """arch -> the reference's full-width parameter shapes (``jax.eval_shape``
    of its init: the costly part), each computed once in the module."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = RefModel(ref_get_config(arch)).abstract_params()
        return cache[arch]

    return get


def _is_spec(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _walk(specs, shapes, path, out):
    """(path, reference spec, reference shape) of each leaf of two pytrees
    of one structure (dicts, lists, cache dataclasses)."""
    if _is_spec(specs):
        out.append((path, specs, tuple(shapes.shape)))
    elif isinstance(specs, dict):
        for key in specs:
            _walk(specs[key], shapes[key], path + (key,), out)
    elif isinstance(specs, list):
        for i, (s, a) in enumerate(zip(specs, shapes)):
            _walk(s, a, path + (i,), out)
    else:                                       # a cache dataclass
        for f in dataclasses.fields(specs):
            _walk(getattr(specs, f.name), getattr(shapes, f.name), path + (f.name,), out)
    return out


def port_leaves(cfg, ref_specs, ref_shapes):
    """{port name: (reference spec, reference shape, whether stacked)}: the
    reference's ``prefix`` layer i is the port's layer i, its ``units``
    position p of unit u the port's layer len(prefix) + u * len(unit) + p."""
    out = {}
    for path, spec, shape in _walk(ref_specs, ref_shapes, (), []):
        top, rest = path[0], ".".join(map(str, path[2:]))
        if top == "prefix":
            out[f"layers.{path[1]}.{rest}"] = (spec, shape, False)
        elif top == "units":
            first, n = len(cfg.prefix) + path[1], len(cfg.pattern_unit)
            for u in range(cfg.num_units):
                out[f"layers.{first + u * n}.{rest}"] = (spec, shape, True)
        else:
            out[".".join(map(str, path))] = (spec, shape, False)
    return out


def groups(ref_shape, port_shape):
    """The reference's dimensions merged into each of the port's (in order)."""
    out, i = [], 0
    for size in port_shape:
        group = [i]
        prod = ref_shape[i]
        i += 1
        while prod < size:
            prod *= ref_shape[i]
            group.append(i)
            i += 1
        assert prod == size, (ref_shape, port_shape)
        out.append(group)
    assert i == len(ref_shape), (ref_shape, port_shape)
    return out


def merge(values, grouping, combine):
    return tuple(combine([values[i] for i in g]) for g in grouping)


def major(entries):
    """A merged dimension's spec: its major part's, the minor parts unsplit."""
    assert all(e is None for e in entries[1:]), entries
    return entries[0]


def check_leaves(cfg, leaves, port_specs, port_shapes, mesh, rules, ref_rules, stub):
    """Each leaf's logical spec and rank 0's shard shape, port against
    reference; returns the number of leaves checked."""
    assert leaves.keys() == port_specs.keys() == port_shapes.keys()
    mesh_shape, axes = MESHES[stub.name]
    for name, (ref_spec, ref_shape, stacked) in leaves.items():
        if stacked:
            assert ref_spec[0] == "layers", name
            ref_spec, ref_shape = ref_spec[1:], ref_shape[1:]
            full_spec, full_shape = ("layers", *ref_spec), (cfg.num_units, *ref_shape)
        else:
            full_spec, full_shape = ref_spec, ref_shape
        port_shape = tuple(port_shapes[name])
        grouping = groups(ref_shape, port_shape)
        assert port_specs[name] == merge(ref_spec, grouping, major), name
        # rank 0's shard: the reference's resolved on an abstract mesh
        jax_spec = ref_logical_to_spec(full_spec, ref_rules, stub)
        want = NamedSharding(AbstractMesh(mesh_shape, axes), jax_spec).shard_shape(full_shape)
        if stacked:
            assert want[0] == cfg.num_units, name       # the "layers" axis is not split
            want = want[1:]
        want = merge(want, grouping, lambda v: int(np.prod(v)))
        placements = sharding.spec_to_placements(
            sharding.logical_to_spec(port_specs[name], rules, mesh), mesh)
        got, _ = _compute_local_shape_and_global_offset(port_shape, mesh_shape,
                                                        [0] * len(mesh_shape), placements)
        assert tuple(got) == tuple(want), (name, port_specs[name], placements)
    return len(leaves)


def stub_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(name=name, axis_names=axes, devices=np.empty(shape, np.int8))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_shards_equal_the_references(meshes, reference_abstract, arch,
                                                     mesh_name):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    model = LMModel(cfg, device="meta")
    abstract = model.abstract_params()
    assert all(t.device.type == "meta" for t in abstract.values())
    assert abstract.keys() == dict(model.state_dict()).keys()
    leaves = port_leaves(cfg, RefModel(ref_cfg).param_specs(), reference_abstract(arch))
    stub, mesh = stub_mesh(mesh_name), meshes[mesh_name]
    for shape, optimized in (("train_4k", False), ("decode_32k", True)):
        batch = SHAPES[shape].global_batch
        n = check_leaves(cfg, leaves, model.param_specs(),
                         {k: t.shape for k, t in abstract.items()}, mesh,
                         make_rules(cfg, mesh, batch, shape, optimized),
                         ref_make_rules(ref_cfg, stub, batch, shape, optimized), stub)
        assert n == len(abstract)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_and_shards_equal_the_references(meshes, arch, mesh_name):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    model, ref = LMModel(cfg, device="meta"), RefModel(ref_cfg)
    stub, mesh = stub_mesh(mesh_name), meshes[mesh_name]
    for shape in ("decode_32k", "long_500k") if cfg.sub_quadratic else ("decode_32k",):
        b, n = SHAPES[shape].global_batch, SHAPES[shape].seq_len
        caches = model.init_caches(b, n)
        port_specs, port_shapes = {}, {}
        for i, (cache, spec) in enumerate(zip(caches, cache_specs(cfg))):
            for f in dataclasses.fields(cache):
                if f.name != "index":
                    t = getattr(cache, f.name)
                    assert t.device.type == "meta"
                    port_specs[f"layers.{i}.{f.name}"] = getattr(spec, f.name)
                    port_shapes[f"layers.{i}.{f.name}"] = t.shape
        leaves = port_leaves(cfg, ref_cache_specs(ref_cfg),
                             jax.eval_shape(lambda: ref.init_caches(b, n)))
        indices = {k for k in leaves if k.endswith(".index")}
        assert all(leaves[k][0] in ((), ("layers",)) for k in indices)
        leaves = {k: v for k, v in leaves.items() if k not in indices}
        check_leaves(cfg, leaves, port_specs, port_shapes, mesh,
                     make_rules(cfg, mesh, b, shape),
                     ref_make_rules(ref_cfg, stub, b, shape), stub)
