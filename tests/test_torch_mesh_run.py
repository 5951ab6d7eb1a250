"""The port's models under a DeviceMesh on the CPU: a real world-1 ``gloo``
group and a (1, 1) ("data", "model") mesh (``tests/torch_mesh_cases.py``),
the rules of ``make_rules``, the parameters laid out by ``shard_model``.

For yi-9b (GQA on the flash kernel's plain version, through ``local_map``),
deepseek-v2-lite-16b (MLA, MoE) and jamba-1.5-large-398b (Mamba, MoE), all
reduced and in float32: ``LMModel.apply``'s logits and a ``ServeEngine``
wave under the mesh are bit-equal to the port without it (on a mesh of one
device every local operation sees the whole tensor), and the logits are
within the conformance rule's float32 tolerance (``torch_lm_cases.F32_TOL``)
of the JAX reference run under its own one-device mesh with its rules.  Then
``elastic_reshard`` onto a (1, 1, 1) ("pod", "data", "model") mesh and a
checkpoint restored with ``sharding_tree`` give every tensor back bit for
bit in the placements its rules give; ``Trainer`` under the mesh replays a
failed step from its checkpoint; ``with_logical`` is a no-op without a mesh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_mesh_cases import ARCHS, mesh, reference_mesh  # noqa: F401 (a fixture)
from repro.configs import get_config as ref_get_config
from repro.distributed.sharding import use_rules as ref_use_rules
from repro.launch.mesh import make_rules as ref_make_rules
from repro_torch.configs import get_config
from repro_torch.data.tokens import pipeline_for
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_mesh, make_rules
from repro_torch.models import common
from repro_torch.models.model import LMModel, shard_model
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.fault_tolerance import elastic_reshard
from repro_torch.runtime.train_loop import SimulatedNodeFailure, TrainConfig, Trainer
from repro_torch.serving.engine import ServeEngine


def sharded_copy(port, mesh, rules):
    model = LMModel(port.cfg, device="cpu")
    model.load_state_dict(port.state_dict())
    return shard_model(model, mesh, rules)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_and_serving_under_the_mesh(mesh, arch):
    ref, params, _, port = cases.model_pair(arch, "float32", port_init=True)
    cfg = port.cfg
    toks = cases.tokens(cfg.vocab_size, (2, 16), seed=1)
    rules = make_rules(cfg, mesh, global_batch=2, shape_name="prefill_32k")
    model = sharded_copy(port, mesh, rules)
    assert all(isinstance(p, DTensor) for p in model.parameters())
    with torch.no_grad():
        want, _, _ = port.apply(torch.from_numpy(toks))
    with sharding.use_mesh(mesh), sharding.use_rules(rules), torch.no_grad():
        got, _, _ = model.apply(torch.from_numpy(toks))
        placements = sharding.logical_placements(("batch", "seq", "vocab"))
    assert isinstance(got, DTensor) and tuple(got.placements) == placements
    assert torch.equal(got.full_tensor(), want)

    ref_rules = ref_make_rules(ref_get_config(arch, True), reference_mesh(), 2, "prefill_32k")
    assert dataclasses.asdict(ref_rules) == dataclasses.asdict(rules)
    with reference_mesh(), ref_use_rules(ref_rules):
        ref_logits = jax.jit(lambda p, t: ref.apply(p, t)[0])(params, jnp.asarray(toks))
    np.testing.assert_allclose(got.full_tensor().numpy(), np.asarray(ref_logits),
                               **cases.F32_TOL)

    prompts = cases.prompts(cfg.vocab_size, 2, seed=2)
    want_tokens = ServeEngine(port, batch=2, max_len=16).generate(prompts, 3)
    rules = make_rules(cfg, mesh, global_batch=2, shape_name="decode_32k")
    model = sharded_copy(port, mesh, rules)
    with sharding.use_mesh(mesh), sharding.use_rules(rules):
        assert ServeEngine(model, batch=2, max_len=16).generate(prompts, 3) == want_tokens


def test_elastic_reshard_and_resharded_restore_round_trip(mesh, tmp_path):
    cfg = dataclasses.replace(get_config("yi-9b", True), dtype="float32")
    model = LMModel(cfg, device="cpu").init(0)
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    specs = model.param_specs()
    shard_model(model, mesh, make_rules(cfg, mesh, 4, "train_4k"))
    mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
    rules3 = make_rules(cfg, mesh3, 4, "train_4k")
    assert rules3.fsdp == ("data",) and rules3.batch == ("data",)

    def check(tree):
        assert tree.keys() == want.keys()
        for n, x in tree.items():
            placements = sharding.spec_to_placements(
                sharding.logical_to_spec(specs[n], rules3, mesh3), mesh3)
            assert isinstance(x, DTensor) and x.device_mesh == mesh3, n
            assert tuple(x.placements) == placements, n
            assert torch.equal(x.full_tensor(), want[n]), n

    resharded = elastic_reshard(dict(model.named_parameters()), specs, mesh3, rules3)
    check(resharded)
    check(elastic_reshard(want, specs, mesh3, rules3))           # plain tensors too

    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(3, {"params": resharded, "step": torch.tensor(3)}, blocking=True)
    with sharding.use_rules(rules3):
        named = {n: sharding.named_sharding(mesh3, *axes) for n, axes in specs.items()}
    like = {"params": want, "step": None}
    step, restored = ckpt.restore(like, sharding_tree={"params": named})
    assert step == 3 and int(restored["step"]) == 3
    check(restored["params"])
    step, plain = ckpt.restore(like)                              # and without
    assert all(not isinstance(x, DTensor) and torch.equal(x, want[n])
               for n, x in plain["params"].items())


def test_trainer_under_the_mesh_replays_a_failed_step(mesh, tmp_path):
    """Three steps under the mesh with a checkpoint after each and a failure
    before step 2's batch: the restore (parameters and moments laid out by
    the specs) and the replay give the same state as three steps without
    the mesh or the failure, bit for bit."""
    cfg = dataclasses.replace(get_config("yi-9b", True), dtype="float32")
    sched = ScheduleConfig(peak_lr=1e-3, warmup_steps=0, total_steps=3)

    def run(tag, on_mesh):
        model = LMModel(cfg, device="cpu")
        fired = []

        def injector(step):
            if on_mesh and step == 2 and not fired:
                fired.append(step)
                raise SimulatedNodeFailure("lost")

        trainer = Trainer(model, pipeline_for(cfg, 4, 32, seed=3, device="cpu"),
                          TrainConfig(num_steps=3, microbatches=2, ckpt_every=1,
                                      ckpt_dir=str(tmp_path / tag)),
                          sched_cfg=sched, failure_injector=injector)
        if not on_mesh:
            return trainer.train()
        rules = make_rules(cfg, mesh, 4, "train_4k")
        shard_model(model, mesh, rules)
        with sharding.use_mesh(mesh), sharding.use_rules(rules):
            out = trainer.train()
        assert out["failures"] == 1 and fired == [2]
        return out

    want, got = run("plain", False), run("mesh", True)
    assert got["step"] == want["step"] == 3
    for part in ("params",):
        for n, x in got["state"][part].items():
            assert isinstance(x, DTensor) and torch.equal(x.full_tensor(), want["state"][part][n])
    for moment in ("m", "v"):
        for n, x in got["state"]["opt"][moment].items():
            assert isinstance(x, DTensor), n
            assert torch.equal(x.full_tensor(), want["state"]["opt"][moment][n]), n
    strip = [{k: v for k, v in h.items() if k != "step_time_s"} for h in got["history"]]
    assert strip[-1] == {k: v for k, v in want["history"][-1].items() if k != "step_time_s"}


def test_with_logical_is_a_noop_without_a_mesh(mesh):
    x = torch.ones(2, 3, 4)
    assert common.with_logical(x, "batch", "seq", None) is x
    with sharding.use_rules(sharding.ShardingRules()):              # rules, no mesh
        assert common.with_logical(x, "batch", "seq", None) is x
    with sharding.use_mesh(mesh):                                   # a mesh, no rules
        assert common.with_logical(x, "batch", "seq", None) is x
    with sharding.use_mesh(mesh), sharding.use_rules(sharding.ShardingRules()):
        assert common.with_logical(x, "batch", "seq", None) is x    # a plain tensor
        dx = sharding.distribute(x, "batch", "seq", None)
        assert isinstance(dx, DTensor) and torch.equal(dx.full_tensor(), x)
