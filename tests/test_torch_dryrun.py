"""The port's dry run on the CPU (``repro_torch.launch.dryrun``,
``launch/meters.py``) and what it stands on: ``make_train_step(presplit=)``,
remat in ``LMModel.apply`` and the flash kernels as ``torch.library`` ops.

- The collective counter on hand-built redistributions over a fake group of
  8 gives the reference parser test's numbers
  (``tests/test_dryrun_mini.py::TestCollectiveParser``), exactly; its count
  agrees with ``CommDebugMode``'s.
- ``DeviceFlopCounter`` counts a DTensor matmul at one rank's local size,
  exactly.
- ``presplit=True`` gives the split step's loss, metrics and parameters bit
  for bit, and the reference's ``make_train_step(presplit=True, jit=False)``
  within ``tests/test_torch_train.py``'s tolerances (ce, loss, gradient norm
  and rate ``rtol = 1e-5``; parameters ``atol = 1e-6``).
- Remat under both policies: the loss and every gradient bit-equal to
  ``remat=False``, and MemTracker's peak activation bytes lower.
- ``torch.library.opcheck`` on both flash ops; under ``FlopCounterMode`` each
  counts its formula exactly (4 B H D per visible pair, 2.5 times that
  backward).
- ``run_cell(device_type="cpu")`` over a (2, 4) fake mesh at cut sizes: a
  record with every key, parameter bytes equal to the local shards' (exact),
  and the flash ops' flops those of the local shapes (exact).
"""
import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.library import opcheck
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils.flop_counter import FlopCounterMode

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.data.tokens import pipeline_for as ref_pipeline_for
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.schedule import ScheduleConfig as RefScheduleConfig
from repro.runtime.train_loop import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.tokens import pipeline_for
from repro_torch.distributed.sharding import logical_to_spec
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, meters
from repro_torch.launch.mesh import make_rules
from repro_torch.models.model import LMModel, opt_state_from_reference, params_from_reference
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime.train_loop import make_train_step, value_and_grad


@pytest.fixture
def fake_group_of_8():
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (8,))
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# the meters
# --------------------------------------------------------------------------
def test_collective_counter_sums_result_bytes(fake_group_of_8):
    mesh = fake_group_of_8
    gathered = distribute_tensor(torch.zeros(8, 128, dtype=torch.bfloat16), mesh, [Shard(0)])
    summed = DTensor.from_local(torch.zeros(256), mesh, [Partial()])
    scattered = DTensor.from_local(torch.zeros(32, 64), mesh, [Partial()])
    with meters.CollectiveCounter() as coll, CommDebugMode() as comm:
        gathered.redistribute(mesh, [Replicate()])
        summed.redistribute(mesh, [Replicate()])
        scattered.redistribute(mesh, [Shard(0)])
    assert coll.totals["all-gather"] == 8 * 128 * 2
    assert coll.totals["all-reduce"] == 256 * 4
    assert coll.totals["reduce-scatter"] == 4 * 64 * 4
    assert coll.totals["count"] == 3 == comm.get_total_counts()
    assert coll.totals["all-to-all"] == coll.totals["collective-permute"] == 0


def test_collective_counter_counts_nothing_for_a_noop_redistribute(fake_group_of_8):
    mesh = fake_group_of_8
    x = distribute_tensor(torch.zeros(8, 128), mesh, [Shard(0)])
    with meters.CollectiveCounter() as coll, CommDebugMode() as comm:
        x.redistribute(mesh, [Shard(0)])
    assert coll.totals["count"] == 0 == comm.get_total_counts()
    assert sum(v for k, v in coll.totals.items()) == 0


def test_device_flop_counter_counts_one_ranks_share(fake_group_of_8):
    mesh = fake_group_of_8
    a = distribute_tensor(torch.zeros(256, 64), mesh, [Shard(0)])
    b = distribute_tensor(torch.zeros(64, 32), mesh, [Replicate()])
    with meters.DeviceFlopCounter() as local:
        a @ b
    with FlopCounterMode(display=False) as whole:
        a @ b
    assert local.get_total_flops() == 2 * (256 // 8) * 64 * 32
    assert whole.get_total_flops() == 2 * 256 * 64 * 32


# --------------------------------------------------------------------------
# make_train_step(presplit=True)
# --------------------------------------------------------------------------
def _presplit(batch: dict, microbatches: int) -> dict:
    return {k: x.reshape(microbatches, x.shape[0] // microbatches, *x.shape[1:])
            for k, x in batch.items()}


def test_presplit_step_equals_the_split_step_bit_for_bit():
    cfg = get_config("yi-9b", reduced=True)
    pipe = pipeline_for(cfg, batch=4, seq_len=32, seed=5, device="cpu")
    runs = []
    for presplit in (False, True):
        model = LMModel(cfg, device="cpu").init(0)
        params = dict(model.named_parameters())
        opt = adamw_init(params, AdamWConfig())
        step = make_train_step(model, AdamWConfig(), ScheduleConfig(warmup_steps=1),
                               microbatches=2, presplit=presplit)
        for i in range(2):
            batch = pipe.batch_at(i)
            params, opt, metrics = step(params, opt, _presplit(batch, 2) if presplit else batch)
        runs.append((params, opt, metrics))
    (p0, o0, m0), (p1, o1, m1) = runs
    assert m0.keys() == m1.keys()
    for key in m0:
        assert torch.equal(torch.as_tensor(m0[key]), torch.as_tensor(m1[key])), key
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
        assert torch.equal(o0["m"][name], o1["m"][name]) and torch.equal(o0["v"][name],
                                                                        o1["v"][name])


def test_presplit_step_matches_the_reference():
    ref, params, _, port = cases.model_pair("yi-9b", "float32", port_init=True)
    cfg = port.cfg
    sched = dict(peak_lr=1e-4, warmup_steps=1, total_steps=10)
    ref_step = ref_make_train_step(ref, RefAdamWConfig(), RefScheduleConfig(**sched),
                                   microbatches=2, donate=False, presplit=True, jit=False)
    ref_state = (params, ref_adamw_init(params, RefAdamWConfig()))
    ref_pipe = ref_pipeline_for(cfg, batch=4, seq_len=32, seed=9)
    port.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, params)))
    port_params = dict(port.named_parameters())
    port_opt = opt_state_from_reference(cfg, jax.tree.map(np.asarray, ref_state[1]))
    step = make_train_step(port, AdamWConfig(), ScheduleConfig(**sched), microbatches=2,
                           presplit=True)
    pipe = pipeline_for(cfg, batch=4, seq_len=32, seed=9, device="cpu")
    for i in (0, 1):
        ref_batch = {k: np.asarray(x).reshape(2, 2, *np.shape(x)[1:])
                     for k, x in ref_pipe.batch_at(i).items()}
        *ref_state, want = ref_step(*ref_state, ref_batch)
        port_params, port_opt, got = step(port_params, port_opt, _presplit(pipe.batch_at(i), 2))
        for key in ("ce", "loss_mean", "grad_norm", "lr"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    want_params = params_from_reference(cfg, jax.tree.map(np.asarray, ref_state[0]))
    for name, w in want_params.items():
        np.testing.assert_allclose(port_params[name].detach().numpy(), w.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------
def _loss_grads_and_peak_activations(cfg, batch):
    model = LMModel(cfg, device="cpu").init(0)
    tracker = MemTracker()
    tracker.track_external(model)
    with tracker:
        loss, _, grads = value_and_grad(model, dict(model.named_parameters()), batch)
    peak = tracker.get_tracker_snapshot("peak")[torch.device("cpu")]
    return loss, grads, peak["Activation"]


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b"])
def test_remat_keeps_the_gradients_and_lowers_the_activations(arch):
    base = get_config(arch, reduced=True)
    # Two units at least: remat keeps one unit's activations at a time (the
    # reduced jamba is one unit of eight layers).
    base = dataclasses.replace(base, num_layers=len(base.prefix) + 2 * len(base.pattern_unit))
    gen = torch.Generator().manual_seed(1)
    batch = {"inputs": torch.randint(0, base.vocab_size, (2, 128), generator=gen),
             "targets": torch.randint(0, base.vocab_size, (2, 128), generator=gen)}
    loss0, grads0, act0 = _loss_grads_and_peak_activations(
        dataclasses.replace(base, remat=False), batch)
    for policy in ("nothing", "names"):
        loss, grads, act = _loss_grads_and_peak_activations(
            dataclasses.replace(base, remat=True, remat_policy=policy), batch)
        assert torch.equal(loss, loss0), policy
        for name in grads0:
            assert torch.equal(grads[name], grads0[name]), (policy, name)
        assert act < act0, (policy, act, act0)


# --------------------------------------------------------------------------
# the flash ops
# --------------------------------------------------------------------------
FLASH_OPTIONS = [(True, 0, 0.0), (True, 5, 0.0), (False, 0, 20.0), (True, 7, 30.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,softcap", FLASH_OPTIONS)
def test_flash_ops_pass_opcheck(dtype, causal, window, softcap):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 12, 16, generator=gen).to(dtype).requires_grad_()
               for _ in range(3))
    opcheck(torch.ops.repro_torch.flash_fwd.default, (q, k, v, causal, window, softcap, True))
    out, lse = torch.ops.repro_torch.flash_fwd(q, k, v, causal, window, softcap, True)
    assert lse.shape == (2, 12) and lse.dtype == torch.float32
    dout = torch.randn(out.shape, generator=gen).to(dtype)
    opcheck(torch.ops.repro_torch.flash_bwd.default,
            (q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(), dout, causal,
             window, softcap))


@pytest.mark.parametrize("causal,window,sq,skv,pairs", [
    (True, 0, 12, 12, 78),         # full causal triangle
    (True, 4, 12, 12, 4 * 5 // 2 + 8 * 4),
    (False, 0, 1, 40, 40),         # decode: one row over the whole cache
    (True, 0, 10, 6, 6 * 7 // 2 + 4 * 6),
])
def test_flash_ops_count_their_formulas(causal, window, sq, skv, pairs):
    assert fa.visible_pairs(sq, skv, causal, window) == pairs
    q = torch.zeros(2, 3, sq, 16, requires_grad=True)
    k, v = (torch.zeros(2, 3, skv, 16, requires_grad=True) for _ in range(2))
    with FlopCounterMode(display=False) as fwd:
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
    with FlopCounterMode(display=False) as bwd:
        out.sum().backward()
    assert fwd.get_total_flops() == 4 * 2 * 3 * 16 * pairs
    assert bwd.get_total_flops() == 10 * 2 * 3 * 16 * pairs


# --------------------------------------------------------------------------
# run_cell at test scale
# --------------------------------------------------------------------------
CUT = {"train_4k": ShapeSpec("train_4k", 32, 8, "train"),
       "decode_32k": ShapeSpec("decode_32k", 64, 4, "decode")}
RECORD_KEYS = {"arch", "shape", "optimized", "mesh", "devices", "mode", "params",
               "active_params", "trace_s", "flops", "flops_scope", "flash_flops", "flash_calls",
               "hlo_bytes", "memory", "collectives", "rules", "device_type"}


class _StubMesh:
    mesh_dim_names = ("data", "model")
    shape = (2, 4)


def _local_param_bytes(cfg, spec) -> int:
    rules = make_rules(cfg, _StubMesh(), global_batch=spec.global_batch,
                       shape_name=spec.name)
    sizes = dict(zip(_StubMesh.mesh_dim_names, _StubMesh.shape))
    model = LMModel(cfg, device="meta")
    params = dict(model.named_parameters())
    total = 0
    for name, axes in model.param_specs().items():
        p = params[name]
        shape = list(p.shape)
        for d, entry in enumerate(logical_to_spec(axes, rules)):
            for ax in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                shape[d] //= sizes.get(ax, 1)
        total += math.prod(shape) * p.element_size()
    return total


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_run_cell_on_a_small_fake_mesh(shape_name):
    cfg = get_config("yi-9b", reduced=True)
    spec = CUT[shape_name]
    record = dryrun.run_cell("yi-9b", shape_name, verbose=False, device_type="cpu",
                             mesh_shape=(2, 4), mesh_axes=("data", "model"), cfg=cfg,
                             spec=spec)
    assert not dist.is_initialized(), "run_cell destroys its process group"
    json.dumps(record)
    assert RECORD_KEYS <= record.keys()
    assert record["mesh"] == "2x4" and record["devices"] == 8 and record["hlo_bytes"] is None
    assert record["flops_scope"] == "per_device" and record["flops"] > record["flash_flops"] > 0
    mem = record["memory"]
    assert {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
            "breakdown"} <= mem.keys()
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"] > 0
    assert mem["breakdown"]["parameters"] == _local_param_bytes(cfg, spec)
    assert set(meters.KINDS) | {"count", "other"} == record["collectives"].keys()
    assert record["collectives"]["count"] > 0 and record["collectives"]["other"] == 0

    # The flash ops count at the local shapes: batch over "data" (2), heads
    # over "model" (4 heads, one a rank), two layers.
    b_local = (spec.global_batch // record.get("microbatches", 1)) // 2
    if shape_name == "decode_32k":
        per_call = 4 * b_local * 1 * cfg.head_dim * fa.visible_pairs(1, spec.seq_len, False, 0)
        assert record["flash_flops"] == cfg.num_layers * per_call
        assert record["flash_calls"] == {"forward": cfg.num_layers, "backward": 0}
    else:
        per_call = 4 * b_local * 1 * cfg.head_dim * fa.visible_pairs(spec.seq_len,
                                                                    spec.seq_len, True, 0)
        # forward, the remat's recompute, and the backward at 2.5 times
        per_layer = per_call * (1 + 1 + 2.5)
        assert record["microbatches"] == 4
        assert record["flash_flops"] == record["microbatches"] * cfg.num_layers * per_layer
        calls = record["microbatches"] * cfg.num_layers
        assert record["flash_calls"] == {"forward": 2 * calls, "backward": calls}


def test_dryrun_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "yi-9b", "--shape", "decode_32k"])
