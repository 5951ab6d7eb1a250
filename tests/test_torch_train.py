"""The port's training loop on the CPU (``repro_torch.runtime.train_loop``,
``runtime/checkpoint.py``, ``launch/train.py``): three steps of
``make_train_step`` with two microbatches against the reference's jitted step
from one carried-over state (``params_from_reference``,
``opt_state_from_reference``); the port's copies of
``tests/test_train_and_serve.py``'s four training tests (the loss decreases,
microbatch equivalence, a checkpoint restart bitwise, failure recovery);
checkpoint replay giving the failed step's loss bit for bit; the launcher.

Tolerances for the steps against the reference (float32, yi-9b reduced):
ce, the loss, the gradient norm and the rate within ``rtol = 1e-5`` at every
step (the largest differences seen: 1.5e-7, 3.1e-7 for the norm), parameters
within ``atol = 1e-6`` after three (AdamW's normalised step moves a weight
by ~lr whatever the gradient's size, so a gradient element near zero whose
last bits differ can move it by up to ~2 lr: the largest difference seen
was 2.4e-7 at lr 1e-4).
"""
import contextlib
import io
import json
import threading

import jax
import numpy as np
import pytest
import torch

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.data.tokens import pipeline_for as ref_pipeline_for
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.schedule import ScheduleConfig as RefScheduleConfig
from repro.runtime.train_loop import make_train_step as ref_make_train_step
from repro_torch.data.tokens import pipeline_for
from repro_torch.launch import train as train_launcher
from repro_torch.models.model import LMModel, opt_state_from_reference, params_from_reference
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.schedule import ScheduleConfig
from repro_torch.runtime.checkpoint import CheckpointManager, flatten
from repro_torch.runtime.train_loop import (
    SimulatedNodeFailure, TrainConfig, Trainer, make_train_step,
)

TINY = cases.TINY


@pytest.fixture(scope="module")
def tiny_model():
    return LMModel(TINY, device="cpu")


def test_train_steps_match_the_reference_from_one_state():
    ref, params, _, port = cases.model_pair("yi-9b", "float32", port_init=True)
    cfg = port.cfg
    sched = dict(peak_lr=1e-4, warmup_steps=1, total_steps=10)
    ref_step = ref_make_train_step(ref, RefAdamWConfig(), RefScheduleConfig(**sched),
                                   microbatches=2, donate=False)
    opt = ref_adamw_init(params, RefAdamWConfig())
    ref_state = (params, opt)
    # one reference step first, so that the carried state has non-zero moments
    ref_pipe = ref_pipeline_for(cfg, batch=4, seq_len=32, seed=9)
    ref_state = ref_step(*ref_state, ref_pipe.batch_at(0))[:2]

    port.load_state_dict(params_from_reference(cfg, jax.tree.map(np.asarray, ref_state[0])))
    port_params = dict(port.named_parameters())
    port_opt = opt_state_from_reference(cfg, jax.tree.map(np.asarray, ref_state[1]))
    assert int(port_opt["step"]) == 1 and port_opt["m"]["embed"].dtype == torch.float32
    step = make_train_step(port, AdamWConfig(), ScheduleConfig(**sched), microbatches=2)
    pipe = pipeline_for(cfg, batch=4, seq_len=32, seed=9, device="cpu")
    for i in (1, 2, 3):
        *ref_state, want = ref_step(*ref_state, ref_pipe.batch_at(i))
        port_params, port_opt, got = step(port_params, port_opt, pipe.batch_at(i))
        for key in ("ce", "loss_mean", "grad_norm", "lr"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    want_params = params_from_reference(cfg, jax.tree.map(np.asarray, ref_state[0]))
    for name, w in want_params.items():
        np.testing.assert_allclose(port_params[name].detach().numpy(), w.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)


def test_loss_decreases(tiny_model, tmp_path):
    pipe = pipeline_for(TINY, batch=4, seq_len=64, seed=0, device="cpu")
    trainer = Trainer(
        tiny_model, pipe,
        TrainConfig(num_steps=30, ckpt_every=100, ckpt_dir=str(tmp_path), log_every=1),
        sched_cfg=ScheduleConfig(peak_lr=1e-2, warmup_steps=5, total_steps=30),
    )
    result = trainer.train(state=trainer.init_state())
    ces = [h["ce"] for h in result["history"]]
    assert ces[-1] < ces[0] - 0.1, f"no learning: {ces[0]} -> {ces[-1]}"


def test_microbatch_equivalence(tiny_model):
    """grad accumulation over 4 microbatches == single big batch."""
    batch = pipeline_for(TINY, batch=8, seq_len=32, seed=1, device="cpu").batch_at(0)
    tiny_model.init(0)
    opt_cfg = AdamWConfig()
    sched = ScheduleConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10, kind="constant")
    s1 = make_train_step(tiny_model, opt_cfg, sched, microbatches=1)
    s4 = make_train_step(tiny_model, opt_cfg, sched, microbatches=4)
    start = {n: p.detach().clone() for n, p in tiny_model.named_parameters()}
    p1 = {n: p.clone() for n, p in start.items()}
    p4 = {n: p.clone() for n, p in start.items()}
    s1(p1, adamw_init(p1, opt_cfg), batch)
    s4(p4, adamw_init(p4, opt_cfg), batch)
    diffs = [float((p1[n].float() - p4[n].float()).abs().max()) for n in start]
    assert max(diffs) < 5e-2   # bf16 accumulation noise
    assert any(not torch.equal(p1[n], start[n]) for n in start)


def _trainer(model, ckdir, num_steps, ckpt_every, seed=2, injector=None, log_every=100):
    pipe = pipeline_for(TINY, batch=4, seq_len=32, seed=seed, device="cpu")
    return Trainer(
        model, pipe,
        TrainConfig(num_steps=num_steps, ckpt_every=ckpt_every, ckpt_dir=ckdir,
                    log_every=log_every),
        sched_cfg=ScheduleConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10),
        failure_injector=injector,
    )


def test_checkpoint_restart_bitwise(tiny_model, tmp_path):
    """Training 10 straight == training 5, restarting, training 5."""
    t_a = _trainer(tiny_model, str(tmp_path / "a"), 10, 5)
    res_a = t_a.train(state=t_a.init_state())
    want = {n: p.detach().clone() for n, p in res_a["state"]["params"].items()}

    t_b1 = _trainer(tiny_model, str(tmp_path / "b"), 5, 5)
    t_b1.train(state=t_b1.init_state())
    tiny_model.init(123)                       # the restart must not depend on the live weights
    t_b2 = _trainer(tiny_model, str(tmp_path / "b"), 10, 5)    # resumes from step 5
    res_b = t_b2.train()
    assert res_b["step"] == 10
    for name, p in res_b["state"]["params"].items():
        assert torch.equal(p, want[name]), name


def test_failure_recovery(tiny_model, tmp_path):
    crashed = {"n": 0}

    def injector(step):
        if step == 7 and crashed["n"] == 0:
            crashed["n"] += 1
            raise SimulatedNodeFailure("node lost")

    trainer = _trainer(tiny_model, str(tmp_path), 10, 5, seed=3, injector=injector)
    result = trainer.train(state=trainer.init_state())
    assert result["failures"] == 1
    assert result["step"] == 10


def test_replayed_step_repeats_its_loss_bitwise(tiny_model, tmp_path):
    """A failure before step 3's batch restores step 2's checkpoint and runs
    the step from 2 to 3 again: ``history`` holds it twice, equal."""
    fired = []

    def injector(step):
        if step == 3 and not fired:
            fired.append(step)
            raise SimulatedNodeFailure("node lost")

    trainer = _trainer(tiny_model, str(tmp_path), 6, 2, injector=injector, log_every=1)
    result = trainer.train(state=trainer.init_state())
    steps = [h["step"] for h in result["history"]]
    assert steps == [1, 2, 3, 3, 4, 5, 6] and result["failures"] == 1
    first, again = (h for h in result["history"] if h["step"] == 3)
    assert {k: v for k, v in first.items() if k != "step_time_s"} == \
        {k: v for k, v in again.items() if k != "step_time_s"}


def test_async_checkpoint_holds_the_state_at_save(tiny_model, tmp_path, monkeypatch):
    """A step that updates the CPU state in place after save() returns, while
    the writer thread has written no file yet, leaves the checkpoint as the
    state was at save time, bit for bit (bf16 weights, float32 moments)."""
    trainer = _trainer(tiny_model, str(tmp_path / "run"), 2, 100)
    state = trainer.init_state()
    params, opt, _ = trainer.step_fn(state["params"], state["opt"], trainer.pipeline.batch_at(0))
    state = {"params": params, "opt": opt}
    want = [(key, leaf.clone()) for key, leaf in flatten(state)]
    stepped = threading.Event()
    np_save = np.save

    def save_after_the_step(*args, **kwargs):
        assert stepped.wait(timeout=60)
        np_save(*args, **kwargs)

    monkeypatch.setattr(np, "save", save_after_the_step)
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(1, state)
    trainer.step_fn(params, opt, trainer.pipeline.batch_at(1))       # in place
    stepped.set()
    mgr.wait()
    assert any(not torch.equal(leaf, w) for (_, w), (_, leaf) in zip(want, flatten(state)))
    step, got = mgr.restore(state)
    assert step == 1
    for (key, w), (_, leaf) in zip(want, flatten(got)):
        assert leaf.dtype == w.dtype and torch.equal(leaf, w), key


def test_launcher_trains_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train_launcher.main(["--arch", "yi-9b", "--reduced", "--steps", "4", "--batch", "2",
                                  "--seq", "32", "--microbatches", "2", "--warmup", "1",
                                  "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                                  "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert rc == 0
    assert lines[0].startswith("arch=yi-9b-reduced params=") and "device=cpu" in lines[0]
    history = [json.loads(line) for line in lines[1:-1]]
    assert [h["step"] for h in history] == [1, 2, 3, 4]
    assert lines[-1].startswith("done: steps=4 ce ") and "failures recovered: 0" in lines[-1]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_2", "step_4"]


def test_launcher_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_launcher.main(["--arch", "yi-9b", "--reduced", "--steps", "1",
                             "--ckpt-dir", str(tmp_path)])
