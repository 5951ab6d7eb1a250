"""The port's sharding layer on the CPU (``repro_torch.distributed.sharding``,
``launch/mesh.py``, ``configs/shapes.py``, ``analysis/roofline._cache_bytes``)
against the JAX package, on a fake process group of 512 ranks
(``torch.testing._internal.distributed.fake_pg``: rank 0 of a world that
runs no collective), which holds both production meshes: (2, 16, 16)
("pod", "data", "model") from ``make_production_mesh(multi_pod=True)`` and
(16, 16) ("data", "model") over its first 256 ranks.

The reference's ``make_rules`` and ``logical_to_spec`` read only
``mesh.axis_names`` and ``mesh.devices.shape``, so a stub with those two
attributes stands in for a JAX mesh of 256 or 512 devices.  Its
``count_params`` (``make_rules(optimized=True)``'s serving budget) traces a
full-width init each call; the module memoises it.
"""
import dataclasses
import functools
import threading
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import _compute_local_shape_and_global_offset
from torch.testing._internal.distributed.fake_pg import FakeStore

import repro.models.model as ref_model_mod
from repro.analysis.roofline import _cache_bytes as ref_cache_bytes
from repro.configs import get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import input_specs as ref_input_specs
from repro.configs.shapes import shape_applicable as ref_shape_applicable
from repro.distributed import sharding as ref_sharding
from repro.launch.mesh import make_rules as ref_make_rules
from repro_torch.analysis.roofline import _cache_bytes
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.shapes import SHAPES, input_specs, shape_applicable
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import make_production_mesh, make_rules

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(arch, shape) for arch in ARCH_IDS for shape in SHAPES
         if shape_applicable(get_config(arch), shape)]


@pytest.fixture(scope="module")
def meshes():
    """The two production meshes on a fake group of 512 ranks, destroyed at
    the module's end (other files run after it on the same worker)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
    try:
        yield {"multi_pod": make_production_mesh(multi_pod=True, device_type="cpu"),
               "single_pod": DeviceMesh("cpu", torch.arange(256).reshape(16, 16),
                                        mesh_dim_names=("data", "model"))}
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def memoised_reference_count_params():
    original = ref_model_mod.count_params
    ref_model_mod.count_params = functools.cache(original)
    yield
    ref_model_mod.count_params = original


def ref_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape, np.int8))


# ---------------------------------------------------------------- the rules
def test_rules_fields_and_defaults_are_the_references():
    assert ([f.name for f in dataclasses.fields(sharding.ShardingRules)]
            == [f.name for f in dataclasses.fields(ref_sharding.ShardingRules)])
    assert (dataclasses.asdict(sharding.ShardingRules())
            == dataclasses.asdict(ref_sharding.ShardingRules()))
    assert (dataclasses.asdict(sharding.REPLICATED_RULES)
            == dataclasses.asdict(ref_sharding.REPLICATED_RULES))


def test_lookup_raises_key_error_for_an_unknown_axis():
    rules = sharding.ShardingRules()
    assert rules.lookup(None) is None and rules.lookup("batch") == ("pod", "data")
    with pytest.raises(KeyError, match="unknown logical axis 'nope'"):
        rules.lookup("nope")


def test_use_rules_nests_and_is_thread_local():
    assert sharding.current_rules() is None
    inner = sharding.ShardingRules(batch=None)
    seen = []
    with sharding.use_rules(sharding.REPLICATED_RULES):
        assert sharding.current_rules() is sharding.REPLICATED_RULES
        with sharding.use_rules(inner):
            assert sharding.current_rules() is inner
            worker = threading.Thread(target=lambda: seen.append(sharding.current_rules()))
            worker.start()
            worker.join(timeout=10)
            assert not worker.is_alive()
        assert sharding.current_rules() is sharding.REPLICATED_RULES
    assert sharding.current_rules() is None
    assert seen == [None]


def test_set_rules():
    sharding.set_rules(sharding.REPLICATED_RULES)
    try:
        assert sharding.current_rules() is sharding.REPLICATED_RULES
    finally:
        sharding.set_rules(None)
    assert sharding.current_rules() is None


def test_replicated_rules_resolve_to_no_split():
    assert sharding.logical_to_spec(("batch", "heads"), sharding.REPLICATED_RULES) == (None, None)
    assert (ref_sharding.logical_to_spec(("batch", "heads"), ref_sharding.REPLICATED_RULES, None)
            == P(None, None))


def test_use_mesh_scopes_the_ambient_mesh(meshes):
    assert sharding.current_mesh() is None and not sharding.on_mesh()
    with sharding.use_mesh(meshes["single_pod"]):
        assert sharding.current_mesh() is meshes["single_pod"]
        assert not sharding.on_mesh()                 # no rules
        with sharding.use_rules(sharding.ShardingRules()):
            assert sharding.on_mesh()
            # pod is not in the mesh: dropped, data remains
            assert sharding.logical_to_spec(("batch", "seq", None)) == ("data", None, None)
    assert sharding.current_mesh() is None


@pytest.mark.parametrize("mesh_name", MESHES)
def test_logical_to_spec_equals_the_reference(meshes, mesh_name):
    """Every logical name, in one tuple, under every cell's rules."""
    names = tuple(f.name for f in dataclasses.fields(sharding.ShardingRules)) + (None,)
    mesh, stub = meshes[mesh_name], ref_mesh(mesh_name)
    for arch, shape in CELLS:
        for optimized in (False, True):
            rules = make_rules(get_config(arch), mesh, SHAPES[shape].global_batch, shape,
                               optimized)
            ref_rules = ref_make_rules(ref_get_config(arch), stub,
                                       REF_SHAPES[shape].global_batch, shape, optimized)
            got = sharding.logical_to_spec(names, rules, mesh)
            want = ref_sharding.logical_to_spec(names, ref_rules, stub)
            assert got == tuple(want), (arch, shape, optimized)


SPLITS = [("single_pod", ("data", "model")), ("single_pod", ("model", "data")),
          ("single_pod", (("data", "model"), None)), ("single_pod", (None, "model")),
          ("multi_pod", (("pod", "data"), "model")), ("multi_pod", ("model", ("pod", "data"))),
          ("multi_pod", (("pod", "data", "model"), None)), ("multi_pod", ("data", None))]


@pytest.mark.parametrize("mesh_name,spec", SPLITS)
def test_each_rank_holds_the_shard_jax_gives_it(meshes, mesh_name, spec):
    """A tuple such as ("pod", "data") splits one dimension over two mesh
    axes, the first the major: every rank's DTensor shard (offset and shape)
    is the tile that JAX's sharding assigns that device."""
    shape, axes = MESHES[mesh_name]
    global_shape = (1024, 512)
    placements = sharding.spec_to_placements(spec, meshes[mesh_name])
    jax_sharding = NamedSharding(AbstractMesh(shape, axes), P(*spec))
    hlo = jax_sharding._to_xla_hlo_sharding(2)
    tiles = np.asarray(hlo.tile_assignment_devices()).reshape(
        hlo.tile_assignment_dimensions())
    want_shape = jax_sharding.shard_shape(global_shape)
    for device, coord in enumerate(np.ndindex(*shape)):
        local, offset = _compute_local_shape_and_global_offset(global_shape, shape, list(coord),
                                                                placements)
        tile = [int(t[0]) for t in np.nonzero(tiles == device)][:2]
        assert local == want_shape
        assert offset == tuple(t * s for t, s in zip(tile, want_shape)), (coord, spec)


def test_spec_to_placements_refuses_what_dtensor_cannot_lay_out(meshes):
    mesh = meshes["multi_pod"]
    assert sharding.spec_to_placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert sharding.spec_to_placements((None,), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sharding.spec_to_placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="twice"):
        sharding.spec_to_placements(("model", "model"), mesh)
    with pytest.raises(ValueError, match="not in"):
        sharding.spec_to_placements(("nope",), mesh)


def test_named_sharding(meshes):
    mesh = meshes["multi_pod"]
    with sharding.use_rules(sharding.ShardingRules()):
        ns = sharding.named_sharding(mesh, "fsdp", "heads")
    assert ns.mesh is mesh and ns.spec == (("pod", "data"), "model")
    assert ns.placements == (Shard(0), Shard(0), Shard(1))


def test_logical_constraint_leaves_plain_tensors_and_meshless_code_alone(meshes):
    x = torch.ones(4, 4)
    assert sharding.logical_constraint(x, ("batch", None)) is x
    with sharding.use_mesh(meshes["multi_pod"]), sharding.use_rules(sharding.ShardingRules()):
        assert sharding.logical_constraint(x, ("batch", None)) is x


# ---------------------------------------------------------------- the mesh
def test_make_mesh_raises_without_a_process_group(monkeypatch):
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        make_production_mesh(device_type="cpu")


def test_production_mesh_shape(meshes):
    assert meshes["multi_pod"].shape == (2, 16, 16)
    assert meshes["multi_pod"].mesh_dim_names == ("pod", "data", "model")
    assert mesh_mod._axis_size(meshes["single_pod"], "pod") == 1
    assert mesh_mod._axis_size(meshes["single_pod"], "data") == 16


@pytest.mark.parametrize("optimized", [False, True], ids=["plain", "optimized"])
@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_make_rules_equals_the_reference(meshes, arch, shape, mesh_name, optimized):
    got = make_rules(get_config(arch), meshes[mesh_name], SHAPES[shape].global_batch, shape,
                     optimized)
    want = ref_make_rules(ref_get_config(arch), ref_mesh(mesh_name),
                          REF_SHAPES[shape].global_batch, shape, optimized)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_serving_budgets_are_the_references():
    import repro.launch.mesh as ref_mesh_mod

    assert mesh_mod.SERVE_WEIGHT_BUDGET == ref_mesh_mod.SERVE_WEIGHT_BUDGET
    assert mesh_mod.SERVE_CACHE_BUDGET == ref_mesh_mod.SERVE_CACHE_BUDGET


# ---------------------------------------------------------------- shapes
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_and_input_specs_equal_the_references(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    for shape in SHAPES:
        assert shape_applicable(cfg, shape) == ref_shape_applicable(ref_cfg, shape)
        got, want = input_specs(cfg, shape), ref_input_specs(ref_cfg, shape)
        assert got.keys() == want.keys()
        for key, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == want[key].shape, (shape, key)
            assert str(t.dtype).removeprefix("torch.") == str(want[key].dtype), (shape, key)
        seq = SHAPES[shape].seq_len
        assert _cache_bytes(cfg, 128, seq) == ref_cache_bytes(ref_cfg, 128, seq)


def test_jax_stays_on_the_host():
    assert jax.devices()[0].platform == "cpu"
