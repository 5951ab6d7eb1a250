"""Shared pieces of the port's CPU tests under a DeviceMesh
(tests/test_torch_mesh_*.py): a real world-1 ``gloo`` process group over a
``FileStore`` with a (1, 1) ("data", "model") CPU mesh, created in a module
fixture and destroyed at its end (other files run after it on the same
xdist worker), the reference's one-device mesh with the same axes, and the
training-step check of tests/test_torch_mesh_train*.py.

The reference's mesh is ``jax.make_mesh`` with ``Auto`` axis types: JAX
0.9's default is ``Explicit``, under which ``with_sharding_constraint`` (the
reference's ``logical_constraint``) refuses a spec.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import torch_lm_cases as cases
from repro.data.tokens import pipeline_for as ref_pipeline_for
from repro.distributed.sharding import use_rules as ref_use_rules
from repro.launch.mesh import make_rules as ref_make_rules
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.schedule import ScheduleConfig as RefScheduleConfig
from repro.runtime.train_loop import make_train_step as ref_make_train_step
from repro_torch.data.tokens import pipeline_for
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import make_mesh, make_rules
from repro_torch.models.model import LMModel, params_from_reference, shard_model
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime.train_loop import TrainConfig, Trainer

ARCHS = ("yi-9b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b")


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = tmp_path_factory.mktemp("mesh") / "store"
    dist.init_process_group("gloo", store=dist.FileStore(str(store), 1), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def reference_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


SCHED = dict(peak_lr=1e-4, warmup_steps=0, total_steps=10)
BATCH, SEQ, MICROBATCHES = 4, 32, 2
GRAD_TOL = 1e-5


def check_trainer_step(mesh, arch, tmp_path):
    """One ``Trainer`` step of reduced ``arch`` in float32 under ``mesh``
    against the step without it (bit for bit) and the reference's jitted
    step under its one-device mesh (tests/test_torch_mesh_train.py)."""
    ref, params, _, port = cases.model_pair(arch, "float32", port_init=True)
    cfg = port.cfg

    def step(tag, rules=None):
        model = LMModel(cfg, device="cpu")
        trainer = Trainer(model, pipeline_for(cfg, BATCH, SEQ, seed=9, device="cpu"),
                          TrainConfig(num_steps=1, microbatches=MICROBATCHES,
                                      ckpt_dir=str(tmp_path / tag), log_every=1),
                          sched_cfg=ScheduleConfig(**SCHED))
        if rules is None:
            return trainer.train()       # Trainer.init_state draws init(0): port_init's weights
        shard_model(model, mesh, rules)
        with sharding.use_mesh(mesh), sharding.use_rules(rules):
            return trainer.train()

    want = step("plain")
    rules = make_rules(cfg, mesh, BATCH, "train_4k")
    got = step("mesh", rules)
    metrics = {k: v for k, v in got["history"][0].items() if k != "step_time_s"}
    assert metrics == {k: v for k, v in want["history"][0].items() if k != "step_time_s"}
    state, want_state = got["state"], want["state"]
    for n, x in state["params"].items():
        assert isinstance(x, DTensor) and torch.equal(x.full_tensor(), want_state["params"][n]), n
    for moment in ("m", "v"):
        for n, x in state["opt"][moment].items():
            assert isinstance(x, DTensor), n
            assert torch.equal(x.full_tensor(), want_state["opt"][moment][n]), (moment, n)

    # the reference's step under its one-device mesh
    ref_rules = ref_make_rules(ref.cfg, reference_mesh(), BATCH, "train_4k")
    assert dataclasses.asdict(ref_rules) == dataclasses.asdict(rules)
    ref_step = ref_make_train_step(ref, RefAdamWConfig(), RefScheduleConfig(**SCHED),
                                   microbatches=MICROBATCHES, donate=False)
    batch = ref_pipeline_for(ref.cfg, batch=BATCH, seq_len=SEQ, seed=9).batch_at(0)
    with reference_mesh(), ref_use_rules(ref_rules):
        _, ref_opt, ref_metrics = ref_step(params, ref_adamw_init(params, RefAdamWConfig()),
                                              batch)
    for key in ("ce", "loss_mean", "grad_norm", "lr"):
        np.testing.assert_allclose(metrics[key], float(ref_metrics[key]), rtol=1e-5,
                                   err_msg=key)
    ref_m = params_from_reference(cfg, jax.tree.map(np.asarray, ref_opt["m"]))
    for n, w in ref_m.items():
        top = float(w.abs().max())
        np.testing.assert_allclose(state["opt"]["m"][n].full_tensor().numpy(), w.numpy(),
                                   atol=GRAD_TOL * top, rtol=0, err_msg=n)
