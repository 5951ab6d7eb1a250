"""The port's training plumbing against the JAX package on the CPU: the
token pipeline (``repro_torch.data.tokens``), the learning-rate schedule,
AdamW, error-feedback compression, the checkpoint manager and
``run_with_recovery``.

Tolerances.  The pipeline's arrays are bit-equal (the same numpy draws).
The schedule: ``rtol = 1e-6`` (float32 cos and pow round otherwise in the
two libraries; the largest difference seen over steps 0-150 was 2.4e-7 of
the rate).  AdamW against the eager reference: the moments bit-equal, the
parameters within ``atol = 1e-8`` after three steps (bit-equal with float32
moments; 1.9e-9 on parameters of ~1 with bf16 moments).  Compression: the
int8 codes and the scales are equal, the error within one float32 ulp of the
block's scale.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.data import tokens as ref_tokens
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_compression
from repro.optim import schedule as ref_schedule
from repro.runtime import fault_tolerance as ref_ft
from repro_torch.data import tokens
from repro_torch.optim import adamw, compression, schedule
from repro_torch.runtime.checkpoint import CheckpointManager, flatten
from repro_torch.runtime.fault_tolerance import run_with_recovery


# --------------------------------------------------------------------------
# the token pipeline
# --------------------------------------------------------------------------
PIPES = [
    dict(vocab_size=256, batch=4, seq_len=64),
    dict(vocab_size=1000, batch=2, seq_len=16),                      # no induction span
    dict(vocab_size=64, batch=2, seq_len=40, frontend="vision_stub", d_model=24, mrope=True),
    dict(vocab_size=64, batch=3, seq_len=33, frontend="audio_stub", d_model=16),
]


@pytest.mark.parametrize("kw", PIPES, ids=lambda kw: f"{kw.get('frontend', 'tokens')}-"
                                                     f"{kw['seq_len']}")
@pytest.mark.parametrize("seed", [0, 7])
def test_batches_equal_the_reference(kw, seed):
    ref = ref_tokens.TokenPipeline(seed=seed, **kw)
    port = tokens.TokenPipeline(seed=seed, device="cpu", **kw)
    for step in (0, 1, 13):
        want = ref.batch_at(step)
        got = port.batch_at(step)
        assert got.keys() == want.keys()
        for key in want:
            w = np.asarray(want[key])
            g = got[key].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)


def test_pipeline_for_matches_config_modality():
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-vl-7b", reduced=True)
    pipe = tokens.pipeline_for(cfg, batch=2, seq_len=8, seed=3, device="cpu")
    batch = pipe.batch_at(0)
    assert batch["inputs"].shape == (2, 8, cfg.d_model)
    assert batch["positions"].shape == (2, 8, 3)
    ref = ref_tokens.pipeline_for(cfg, batch=2, seq_len=8, seed=3)
    np.testing.assert_array_equal(batch["inputs"].numpy(), np.asarray(ref.batch_at(0)["inputs"]))


def test_iterate_prefetches_in_order():
    pipe = tokens.TokenPipeline(vocab_size=50, batch=2, seq_len=8, seed=1, device="cpu")
    it = pipe.iterate(start_step=5)
    for step in (5, 6, 7):
        got = next(it)
        np.testing.assert_array_equal(got["targets"].numpy(), pipe.arrays_at(step)["targets"])
    it.close()


def test_pipeline_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tokens.TokenPipeline(vocab_size=10, batch=1, seq_len=4)


# --------------------------------------------------------------------------
# the schedule
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_learning_rate_matches_reference(kind, warmup):
    cfg = dict(peak_lr=3e-4, warmup_steps=warmup, total_steps=100, min_lr_ratio=0.1, kind=kind)
    ref_cfg, port_cfg = ref_schedule.ScheduleConfig(**cfg), schedule.ScheduleConfig(**cfg)
    for step in [0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 150]:
        want = np.asarray(ref_schedule.learning_rate(step, ref_cfg))
        got = schedule.learning_rate(step, port_cfg)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert float(schedule.learning_rate(torch.tensor(3, dtype=torch.int32), port_cfg)) == \
        float(schedule.learning_rate(3, port_cfg))


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------
SHAPES = {"a": (7, 5), "b": (33,), "c.w": (4, 3, 2), "norm": (16,)}


def _tree(seed: int, scale: float = 1.0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_matches_reference(moments, clip):
    cfg = dict(m_dtype=moments, v_dtype=moments, clip_norm=clip)
    ref_cfg, port_cfg = ref_adamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    params = _tree(0)
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_s = ref_adamw.adamw_init(ref_p, ref_cfg)
    port_p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    port_s = adamw.adamw_init(port_p, port_cfg)
    assert port_s["m"]["a"].dtype == getattr(torch, moments)
    for step in range(3):
        grads = _tree(10 + step, scale=0.5)
        lr = 1e-2 * (step + 1)
        ref_p, ref_s, ref_m = ref_adamw.adamw_update(
            ref_p, {k: jnp.asarray(v) for k, v in grads.items()}, ref_s, ref_cfg,
            jnp.float32(lr))
        got_p, port_s, port_m = adamw.adamw_update(
            port_p, {k: torch.from_numpy(v) for k, v in grads.items()}, port_s, port_cfg,
            torch.tensor(lr, dtype=torch.float32))
        assert got_p is port_p                      # updated in place
        assert int(port_s["step"]) == int(ref_s["step"]) == step + 1
        np.testing.assert_allclose(float(port_m["grad_norm"]), float(ref_m["grad_norm"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(port_m["clip_scale"]), float(ref_m["clip_scale"]),
                                   rtol=1e-6)
        for k in SHAPES:
            np.testing.assert_allclose(port_p[k].numpy(), np.asarray(ref_p[k]), rtol=0,
                                       atol=1e-8, err_msg=k)
            for mom in ("m", "v"):
                want = np.asarray(ref_s[mom][k].astype(jnp.float32))
                np.testing.assert_array_equal(port_s[mom][k].float().numpy(), want, err_msg=k)


def test_adamw_bf16_params_round_once():
    """bf16 parameters: the update runs in float32 and rounds once."""
    cfg = adamw.AdamWConfig()
    p = {"w": torch.tensor([1.0, -2.0, 0.5], dtype=torch.bfloat16)}
    g = {"w": torch.tensor([0.1, 0.2, -0.3], dtype=torch.bfloat16)}
    want = p["w"].float().clone()
    state = adamw.adamw_init(p, cfg)
    adamw.adamw_update(p, g, state, cfg, torch.tensor(1e-2))
    gf = g["w"].float() * min(1.0, cfg.clip_norm / float(torch.linalg.vector_norm(g["w"].float())))
    delta = gf / (gf.abs() + cfg.eps) + cfg.weight_decay * want
    assert p["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"], (want - 1e-2 * delta).to(torch.bfloat16))


def test_global_norm_matches_reference():
    tree = _tree(3)
    want = float(ref_adamw.global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = float(adamw.global_norm({k: torch.from_numpy(v) for k, v in tree.items()}))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# --------------------------------------------------------------------------
# compression
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(256,), (3, 100), (1000,), (5,)])
def test_ef_compress_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    err = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    q, s, e = ref_compression.ef_compress(jnp.asarray(x), jnp.asarray(err))
    gq, gs, ge = compression.ef_compress(torch.from_numpy(x), torch.from_numpy(err))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(q))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(s))
    ulp = np.spacing(np.repeat(np.asarray(s)[:, 0], compression.BLOCK)[:x.size]).reshape(shape)
    assert np.all(np.abs(ge.numpy() - np.asarray(e)) <= ulp)
    want = np.asarray(ref_compression.ef_decompress(q, s, shape))
    got = compression.ef_decompress(gq, gs, shape).numpy()
    np.testing.assert_array_equal(got, want)
    assert compression.compression_ratio(shape) == ref_compression.compression_ratio(shape)
    q0, _, _ = compression.ef_compress(torch.from_numpy(x))
    np.testing.assert_array_equal(q0.numpy(), np.asarray(ref_compression.ef_compress(
        jnp.asarray(x))[0]))


# --------------------------------------------------------------------------
# checkpoints and recovery
# --------------------------------------------------------------------------
def _state(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(3, 4, generator=g).to(torch.bfloat16),
                       "b": torch.randn(4, generator=g)},
            "opt": {"m": {"w": torch.randn(3, 4, generator=g), "b": torch.zeros(4)},
                    "step": torch.tensor(seed, dtype=torch.int32)}}


def test_checkpoint_round_trip_bitwise(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = _state(5)
    mgr.save(5, state)
    mgr.wait()
    assert mgr.latest_step() == 5
    step, got = mgr.restore(state)
    assert step == 5
    for (k, a), (k2, b) in zip(flatten(state), flatten(got)):
        assert k == k2 and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                           b.view(torch.int16) if b.dtype == torch.bfloat16 else b), k
    with pytest.raises(ValueError, match="other leaves"):
        mgr.restore({"params": state["params"]})


def test_checkpoint_keep_gc_and_torn_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        mgr.save(step, _state(step), blocking=step == 3)
    mgr.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    torn = tmp_path / "step_9.tmp-deadbeef"
    torn.mkdir()
    (tmp_path / "step_8").mkdir()            # no manifest: never restored
    assert mgr.latest_step() == 3
    assert mgr.cleanup_torn() == 1 and not torn.exists()
    step, got = mgr.restore(_state(0), step=2)
    assert step == 2 and int(got["opt"]["step"]) == 2
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_state(0))


def test_run_with_recovery_replays_as_the_reference(tmp_path):
    """The same step function, failing once at step 6, through both packages'
    ``run_with_recovery``: the same final state, step and failure count."""
    def drive(run, directory):
        mgr = CheckpointManager(directory)
        failed = []

        def step_fn(step, state):
            if step == 6 and not failed:
                failed.append(step)
                raise RuntimeError("lost a node")
            return {"x": state["x"] * 2 + step}

        def restore_fn():
            return mgr.restore({"x": None})

        return run(step_fn, {"x": torch.tensor(1)}, 0, 10, mgr, 4, restore_fn)

    got = drive(run_with_recovery, str(tmp_path / "a"))
    want = drive(ref_ft.run_with_recovery, str(tmp_path / "b"))
    assert int(got[0]["x"]) == int(want[0]["x"]) and got[1:] == want[1:] == (10, 1)
