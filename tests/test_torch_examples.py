"""The port's examples (``examples/torch_*.py``) on the CPU against the JAX
package: the quickstart at a small scene (both maps, and the printed
bad-pixel rates, Eq. 1 errors and valid share, bit for bit against the JAX
``ielas_disparity`` and ``elas_baseline_disparity``), stereo serving (every
delivered frame and single-frame output bit for bit against the JAX
``ielas_disparity``), LM serving on the reference's ``init(PRNGKey(0))``
weights (tokens under the bf16 rule of tests/torch_lm_cases.py), the train
example's fast preset for a few steps (the reference's history keys, ce
finite and falling), the whole fault-tolerance demo (2 failures recovered,
a 0.0 parameter diff between distinct tensors, the heartbeat's verdicts
against the reference ``HeartbeatMonitor``), and each example's default
device raising on a host without a card.

The examples are scripts, not a package: each is loaded from its file.
"""
import contextlib
import importlib.util
import io
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from torch_serving_cases import expected_output
from repro.configs.elas_stereo import SYNTH as REF_SYNTH
from repro.core import pipeline as ref_pipeline
from repro.data.stereo import synthetic_stereo_pair
from repro.data.tokens import pipeline_for as ref_pipeline_for
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.model import LMModel as RefModel
from repro.optim.adamw import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.schedule import ScheduleConfig as RefScheduleConfig
from repro.runtime.fault_tolerance import HeartbeatMonitor as RefHeartbeatMonitor
from repro.runtime.train_loop import make_train_step as ref_make_train_step
from repro_torch.models.model import LMModel, params_from_reference

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "stereo_serving", "lm_serving", "train_lm", "fault_tolerance_demo")
RP = REF_SYNTH.params
QUICK_H, QUICK_W = 60, 80       # the quickstart's scene here (its own: 240 x 320)


def _load(name: str):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *args, **kw):
    """(what ``fn`` returned, what it printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = fn(*args, **kw)
    return got, out.getvalue()


def test_quickstart_matches_reference():
    got, printed = _run(_load("quickstart").run, device="cpu", height=QUICK_H, width=QUICK_W)
    il, ir, gt = synthetic_stereo_pair(height=QUICK_H, width=QUICK_W, d_max=40,
                                       n_objects=5, seed=7)
    il_j, ir_j, gt_j = jnp.asarray(il, jnp.float32), jnp.asarray(ir, jnp.float32), jnp.asarray(gt)
    d_i = ref_pipeline.ielas_disparity(il_j, ir_j, RP)
    d_b = ref_pipeline.elas_baseline_disparity(il_j, ir_j, RP)
    for key, want in (("ielas", d_i), ("baseline", d_b)):
        want = np.asarray(want)
        assert got[key].dtype == np.float32 and got[key].shape == want.shape
        assert int(np.sum(got[key] != want)) == 0, key
    bad_i = float(ref_pipeline.bad_pixel_rate(d_i, gt_j))
    bad_b = float(ref_pipeline.bad_pixel_rate(d_b, gt_j))
    err_i = float(ref_pipeline.disparity_error(d_i, gt_j))
    err_b = float(ref_pipeline.disparity_error(d_b, gt_j))
    valid = float(np.mean(np.asarray(d_i) != RP.invalid))
    assert (got["bad_ielas"], got["bad_baseline"], got["err_ielas"], got["err_baseline"],
            got["valid"]) == (bad_i, bad_b, err_i, err_b, valid)
    assert f"{'bad-pixel rate (>3px)':24}{bad_i:>16.3f}{bad_b:>18.3f}" in printed
    assert f"{'rel. error (Eq. 1)':24}{err_i:>16.3f}{err_b:>18.3f}" in printed
    assert f"valid pixels: {valid:.1%};" in printed


def test_stereo_serving_matches_reference():
    streams, frames, h, w = 2, 2, 40, 64
    got, printed = _run(_load("stereo_serving").main,
                        ["--streams", str(streams), "--frames", str(frames), "--height", str(h),
                         "--width", str(w), "--device", "cpu"])
    pairs = {(sid, s): synthetic_stereo_pair(height=h, width=w, d_max=40, seed=17 * sid + s)[:2]
             for sid in range(streams) for s in range(frames)}
    assert len(got["done"]) == streams * frames
    assert sorted((c.stream_id, c.frame_id) for c in got["done"]) == sorted(pairs)
    for c in got["done"]:
        assert c.ok, c.error
        want = expected_output(*pairs[(c.stream_id, c.frame_id)])
        assert c.disparity.dtype == np.float32 and int(np.sum(c.disparity != want)) == 0
    for key, out in got["serial"].items():
        assert int(np.sum(out.numpy() != expected_output(*pairs[key]))) == 0, key
    st = got["stats"]
    assert (st.completed, st.cache_misses, st.programs_cached) == (streams * frames, 0, 1)
    d = got["done"][0].disparity
    assert f"range [{d[d >= 0].min():.0f}, {d.max():.0f}]" in printed


def test_lm_serving_matches_reference():
    mod = _load("lm_serving")
    ref = RefModel(RefModelConfig(**{f: getattr(mod.CFG, f) for f in (
        "name", "family", "num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
        "vocab_size", "q_chunk", "kv_chunk")}))
    assert ref.cfg.dtype == mod.CFG.dtype == "bfloat16"
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    port = LMModel(mod.CFG, device="cpu")
    port.load_state_dict(params_from_reference(mod.CFG, tree))
    got, printed = _run(mod.serve, port)
    prompts = got["prompts"]
    assert len(prompts) == 10 and all(4 <= len(p) < 24 for p in prompts)
    assert all(len(o) == 32 for o in got["outs"]) and got["tokens"] == 320
    params = jax.tree.map(jnp.asarray, tree)
    held = 0
    for start in range(0, len(prompts), 4):
        wave = [np.asarray(p, np.int32) for p in prompts[start:start + 4]]
        wave += [np.zeros(1, np.int32)] * (4 - len(wave))        # the engine's padding
        want = cases.reference_wave(ref, params, wave, 32, 96)
        for i, (tokens, margins) in enumerate(want[:len(prompts) - start]):
            held += cases.gated_prefix(got["outs"][start + i], tokens, margins)
    assert held > 0, "no token was held: every margin under the bound"
    assert "10 requests (len 4..24) -> 320 tokens" in printed


def test_train_lm_fast_preset(tmp_path):
    steps = 4
    got, printed = _run(_load("train_lm").main,
                        ["--steps", str(steps), "--batch", "4", "--seq", "64",
                         "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    cfg = RefModelConfig(name="lm-fast", family="dense", num_layers=4, d_model=128, num_heads=4,
                         num_kv_heads=2, d_ff=512, vocab_size=2048, q_chunk=64, kv_chunk=64)
    ref = RefModel(cfg)
    step = ref_make_train_step(ref, RefAdamWConfig(), RefScheduleConfig(total_steps=steps),
                               microbatches=2, donate=False, jit=False)
    params = ref.abstract_params()
    opt = jax.eval_shape(lambda p: ref_adamw_init(p, RefAdamWConfig()), params)
    metrics = jax.eval_shape(step, params, opt, ref_pipeline_for(cfg, 4, 64).batch_at(0))[2]
    want_keys = set(metrics) | {"step", "step_time_s"}
    hist = got["history"]
    assert [h["step"] for h in hist] == list(range(1, steps + 1)) and got["step"] == steps
    assert all(set(h) == want_keys for h in hist), (sorted(hist[0]), sorted(want_keys))
    ces = [h["ce"] for h in hist]
    assert np.isfinite(ces).all() and ces[-1] < ces[0], ces
    assert got["params"] == 1_508_480
    assert f"ce: {ces[0]:.3f} -> {ces[-1]:.3f} over {steps} steps" in printed


@pytest.fixture(scope="module")
def fault_demo(tmp_path_factory):
    """The whole demo on the CPU, its temporary directories under pytest's."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tempfile, "tempdir", str(tmp_path_factory.mktemp("ft")))
        return _run(_load("fault_tolerance_demo").main, ["--device", "cpu"])


def test_fault_demo_recovers_bitwise(fault_demo):
    got, printed = fault_demo
    assert (got["failures"], got["step"], got["max_param_diff"]) == (2, 20, 0.0)
    assert "recovered from 2 failures, finished at step 20" in printed
    assert "max param diff vs failure-free run: 0.00e+00" in printed
    assert (got["restored_step"], got["restored_leaves"]) == (20, 3 * len(got["params"]) + 1)
    assert f"restored checkpoint at step 20; leaves: {got['restored_leaves']}" in printed


def test_fault_demo_compares_distinct_trained_tensors(fault_demo):
    """The diff is taken between two models' tensors, each trained: not
    between a tensor and itself, nor between fresh weights."""
    got, _ = fault_demo
    params, clean = got["params"], got["clean_params"]
    assert params.keys() == clean.keys()
    fresh = dict(LMModel(_load("fault_tolerance_demo").CFG, device="cpu").init(0)
                 .named_parameters())
    for name in params:
        assert params[name].untyped_storage().data_ptr() != clean[name].untyped_storage().data_ptr()
        assert torch.equal(params[name], clean[name]), name
        assert not torch.equal(params[name], fresh[name]), name


def test_fault_demo_heartbeat_matches_reference(fault_demo):
    got, printed = fault_demo
    t = [0.0]
    mon = RefHeartbeatMonitor(["host0", "host1", "host2"], timeout=10.0,
                              straggler_factor=2.0, clock=lambda: t[0])
    for step in range(1, 13):
        t[0] = float(step)
        mon.beat("host0", step)
        if step <= 3:
            mon.beat("host1", step)
        if step % 4 == 0:
            mon.beat("host2", step // 4)
    t[0] = 14.0
    assert (got["dead_hosts"], got["stragglers"]) == (mon.dead_hosts(), mon.stragglers())
    assert (got["dead_hosts"], got["stragglers"]) == (["host1"], ["host2"])
    assert f"dead hosts: {mon.dead_hosts()}  stragglers: {mon.stragglers()}" in printed


@pytest.mark.parametrize("name", EXAMPLES)
def test_default_device_raises_without_a_card(name, monkeypatch):
    """No CPU fallback: without ``--device`` an example asks for the card,
    and on a host without one it raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])
