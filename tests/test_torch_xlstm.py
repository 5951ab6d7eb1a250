"""xLSTM on the port (``repro_torch.models.xlstm``, ``configs/xlstm_350m``:
seven mLSTM layers to one sLSTM) against the JAX package on the CPU: the
mLSTM block over 128 positions (two chunks of 64) at xlstm-350m-reduced's
width, decode token by token through a state, a prefill into a state then
decode, with every state field; the sLSTM block with and without a state;
the whole reduced model through ``LMModel.apply`` and ``ServeEngine``, and
its chunked forward against its own step-by-step decode; the
config and ``count_params``, reduced and at full width; the initial weights.

Tolerances: float32 blocks ``atol = rtol = 1e-5`` (the largest difference
seen was 5.2e-8 on outputs up to 0.12: XLA's exp, log-sigmoid and cumsum
round otherwise than torch's, and the sums run in other orders; a torch
``cumsum`` differs from ``jax.jit(jnp.cumsum)`` in the last bit of ~1/3 of a
chunk's prefix sums); states within ``atol = rtol = 1e-5`` too.  bfloat16
blocks: ``torch_lm_cases.bf16_steps`` (4 bfloat16 steps of the binade of the
largest output; seen: one step).  Models: tests/torch_lm_cases.py's
(float32 logits within 1e-5 and equal greedy tokens; bfloat16 logits within
0.0625, tokens equal wherever the reference's top-2 margin exceeds 0.125).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.configs import get_config as ref_get_config
from repro.models import xlstm as ref_xlstm
from repro.models.model import count_params as ref_count_params
from repro_torch import configs as port_configs
from repro_torch.models import xlstm
from repro_torch.models.config import LayerKind
from repro_torch.models.model import LMModel, XlstmLayer, count_params
from repro_torch.serving import ServeEngine

ARCH = "xlstm-350m"
ref_mlstm = jax.jit(ref_xlstm.mlstm_block, static_argnums=(2,))
ref_slstm = jax.jit(ref_xlstm.slstm_block, static_argnums=(2,))
STATE_FIELDS = {"mlstm": ("c", "n", "m", "conv"), "slstm": ("c", "n", "h", "m")}


def _np(a) -> np.ndarray:
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else jnp.asarray(a, jnp.float32))


def _pair(block, dtype, seed):
    """(reference cfg, port cfg, reference params, port params) of one
    block, with a nonzero conv bias, skip and gate biases so that each is
    tested."""
    ref_cfg, cfg = cases.configs(ARCH, dtype)
    init = ref_xlstm.init_mlstm_params if block == "mlstm" else ref_xlstm.init_slstm_params
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), ref_cfg))
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "ogate_skip", "if_bias", "gate_bias"):
        if name in tree:
            tree[name] = tree[name] + 0.1 * rng.standard_normal(tree[name].shape).astype(np.float32)
    shapes = (xlstm.mlstm_shapes if block == "mlstm" else xlstm.slstm_shapes)(cfg)
    assert {k: v.shape for k, v in tree.items()} == shapes
    tdt = getattr(torch, dtype)
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, tree), {
        k: torch.from_numpy(v.copy()).to(torch.float32 if k in xlstm.FLOAT32 else tdt)
        for k, v in tree.items()}


def _x(cfg, s, seed):
    x = np.random.default_rng(seed).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, cfg.dtype)
    return jx, torch.from_numpy(_np(jx).copy()).to(getattr(torch, cfg.dtype))


def _close(got, want, dtype):
    want = _np(want)
    tol = cases.F32_TOL if dtype == "float32" else cases.bf16_steps(want)
    np.testing.assert_allclose(_np(got), want, **tol)


def _states_close(got, want, block):
    assert got.index == int(want.index)
    for name in STATE_FIELDS[block]:
        g, w = getattr(got, name), getattr(want, name)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
        np.testing.assert_allclose(_np(g), _np(w), **cases.F32_TOL, err_msg=name)


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_block_two_chunks(dtype):
    ref_cfg, cfg, ref_p, p = _pair("mlstm", dtype, 1)
    jx, x = _x(cfg, 2 * xlstm.MLSTM_CHUNK, 2)
    want, _ = ref_mlstm(ref_p, jx, ref_cfg)
    got, state = xlstm.mlstm_block(p, x, cfg)
    assert state is None and got.dtype == x.dtype
    _close(got, want, dtype)


def test_mlstm_sequence_not_a_multiple_of_the_chunk_raises():
    _, cfg, _, p = _pair("mlstm", "float32", 1)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        xlstm.mlstm_block(p, torch.zeros(1, xlstm.MLSTM_CHUNK + 2, cfg.d_model), cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_decode_through_a_state(dtype):
    """Token by token from a fresh state: the outputs and every state field
    (the conv tail comes back in x's dtype, as the reference's)."""
    ref_cfg, cfg, ref_p, p = _pair("mlstm", dtype, 3)
    jx, x = _x(cfg, 12, 4)
    ref_state, state = ref_xlstm.init_mlstm_state(ref_cfg, 2), xlstm.init_mlstm_state(cfg, 2)
    _states_close(state, ref_state, "mlstm")
    for t in range(12):
        want, ref_state = ref_mlstm(ref_p, jx[:, t:t + 1], ref_cfg, ref_state)
        got, new = xlstm.mlstm_block(p, x[:, t:t + 1], cfg, state)
        assert new is not state and state.index == t
        state = new
        _close(got, want, dtype)
        _states_close(state, ref_state, "mlstm")


def test_mlstm_prefill_into_a_state_then_decode():
    ref_cfg, cfg, ref_p, p = _pair("mlstm", "float32", 5)
    jx, x = _x(cfg, 20, 6)
    ref_state, state = ref_xlstm.init_mlstm_state(ref_cfg, 2), xlstm.init_mlstm_state(cfg, 2)
    for sl in (slice(0, 16), slice(16, 17), slice(17, 18)):
        want, ref_state = ref_mlstm(ref_p, jx[:, sl], ref_cfg, ref_state)
        got, state = xlstm.mlstm_block(p, x[:, sl], cfg, state)
        _close(got, want, "float32")
        _states_close(state, ref_state, "mlstm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_block_with_and_without_state(dtype):
    ref_cfg, cfg, ref_p, p = _pair("slstm", dtype, 7)
    jx, x = _x(cfg, 16, 8)
    want, _ = ref_slstm(ref_p, jx, ref_cfg)
    got, state = xlstm.slstm_block(p, x, cfg)
    assert state is None
    _close(got, want, dtype)
    ref_state, state = ref_xlstm.init_slstm_state(ref_cfg, 2), xlstm.init_slstm_state(cfg, 2)
    _states_close(state, ref_state, "slstm")
    for sl in (slice(0, 10), slice(10, 11), slice(11, 12)):
        want, ref_state = ref_slstm(ref_p, jx[:, sl], ref_cfg, ref_state)
        got, state = xlstm.slstm_block(p, x[:, sl], cfg, state)
        _close(got, want, dtype)
        _states_close(state, ref_state, "slstm")


def test_log_sigmoid_is_minus_softplus_of_minus_x():
    x = np.linspace(-120, 120, 481, dtype=np.float32)
    np.testing.assert_allclose(xlstm.log_sigmoid(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.log_sigmoid(jnp.asarray(x))), **cases.F32_TOL)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def test_apply_float32_with_and_without_state():
    """The forward over 128 positions (two chunks a layer), and 16 decode
    steps through the states."""
    ref, params, ref_apply, port = cases.model_pair(ARCH, "float32", port_init=True)
    toks = cases.tokens(port.cfg.vocab_size, (2, 2 * xlstm.MLSTM_CHUNK), seed=9)
    want = np.asarray(ref_apply(params, jnp.asarray(toks), None)[0])
    got, _ = cases.port_logits(port, toks)
    np.testing.assert_allclose(got, want, **cases.F32_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    ref_caches, caches = ref.init_caches(2, 4), port.init_caches(2, 4)
    for t in range(16):
        want, ref_caches = ref_apply(params, jnp.asarray(toks[:, t:t + 1]), ref_caches)
        got, caches = cases.port_logits(port, toks[:, t:t + 1], caches)
        np.testing.assert_allclose(got, np.asarray(want), **cases.F32_TOL)
        np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1))
    assert [type(c).__name__ for c in caches] == ["MLSTMState"] * 7 + ["SLSTMState"]
    assert all(c.index == 16 for c in caches)


def test_chunked_forward_equals_stepwise_decode():
    """The port against itself, float32: the forward over 128 positions
    (two chunks of 64 on every mLSTM layer) and 128 decode steps through the
    states give the same logits within ``atol = rtol = 1e-5`` (seen: 1.4e-6
    on logits up to 4.4; 5.5e-6 on logits up to 5.3 for one sequence at
    xlstm-350m's full width, which chip_smoke.py holds on the card to this
    tolerance)."""
    cfg = dataclasses.replace(port_configs.get_config(ARCH, True), dtype="float32")
    model = LMModel(cfg, device="cpu").init(0)
    toks = torch.from_numpy(cases.tokens(cfg.vocab_size, (2, 2 * xlstm.MLSTM_CHUNK), seed=12))
    with torch.inference_mode():
        whole = model.apply(toks)[0]
        caches = model.init_caches(2, 1, torch.float32)
        for t in range(toks.shape[1]):
            step, caches, _ = model.apply(toks[:, t:t + 1], caches=caches)
            np.testing.assert_allclose(step[:, 0].numpy(), whole[:, t].numpy(), **cases.F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_engine_matches_reference_wave(dtype):
    ref, params, _, port = cases.model_pair(ARCH, None if dtype == "bfloat16" else dtype,
                                            port_init=True)
    prompts = cases.prompts(port.cfg.vocab_size, 2, seed=10)
    got = ServeEngine(port, batch=2, max_len=24).generate(prompts, 8)
    want = cases.reference_wave(ref, params, prompts, 8, 24)
    if dtype == "float32":
        assert got == [w for w, _ in want]
    else:
        held = [cases.gated_prefix(g, w, m) for g, (w, m) in zip(got, want)]
        assert sum(held) > 0, "no token was held: every margin under the bound"


# --------------------------------------------------------------------------
# config, counts, weights
# --------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_count_match_reference(reduced):
    cfg, ref_cfg = port_configs.get_config(ARCH, reduced), ref_get_config(ARCH, reduced)
    fields = [{k: (tuple(x.value for x in v) if isinstance(v, tuple) else v)
               for k, v in dataclasses.asdict(c).items()} for c in (cfg, ref_cfg)]
    assert fields[0] == fields[1]
    assert count_params(cfg) == cfg.param_count() == ref_count_params(ref_cfg)
    if not reduced:
        assert count_params(cfg) == 528_729_256
        model = LMModel(cfg, device="meta")
        assert [layer.kind for layer in model.layers] == list(cfg.layer_kinds)
        assert all(isinstance(layer, XlstmLayer) and not hasattr(layer, "mlp")
                   for layer in model.layers)
        assert model.layers[7].mixer["w_ff_gate"].shape == (1024, 1408)
        assert model.layers[0].mixer["w_q"].shape == (2048, 2048)


def test_init_draws_the_reference_distributions():
    """At a quarter of xlstm-350m's width (one unit of eight layers, a small
    vocabulary, so that it draws quickly)."""
    cfg = dataclasses.replace(port_configs.get_config(ARCH), d_model=256, vocab_size=512)
    model = LMModel(cfg, device="cpu").init(0)
    m, s = model.layers[0].mixer, model.layers[7].mixer
    assert m["w_up"].dtype == torch.bfloat16 and m["conv_w"].dtype == torch.float32
    assert s["r_gates"].dtype == torch.float32 and s["gate_bias"].dtype == torch.float32
    assert s["w_ff_gate"].shape == (256, 384)            # int(256 * 4/3 / 64 + 1) * 64
    for w, fan_in in ((m["w_up"], 256), (m["w_q"], 512), (m["w_if"], 512),
                      (m["w_down"], 512), (s["w_gates"], 256), (s["w_ff_down"], 384)):
        w = w.float() * fan_in ** 0.5
        # a unit normal truncated at +-3 has std 0.9866
        assert abs(float(w.std()) - 0.9866) < 0.03 and float(w.abs().max()) <= 3.0 + 0.02
    for w in (m["conv_w"], s["r_gates"]):
        assert abs(float(w.std()) - 0.1) < 0.01
    assert not m["conv_b"].any() and not m["ogate_skip"].any()
    assert m["if_bias"].tolist() == [0.0] * 4 + [3.0] * 4
    assert s["gate_bias"].tolist() == [0.0] * 256 + [3.0] * 256 + [0.0] * 512
    assert not model.layers[0].norm.any() and not model.layers[7].norm.any()
    full = port_configs.get_config(ARCH)
    state = xlstm.init_mlstm_state(full, 2)
    assert state.m.eq(-1e30).all() and state.c.shape == (2, 4, 512, 512)
    assert state.conv.shape == (2, 3, 2048) and state.conv.dtype == torch.float32
    assert xlstm.init_slstm_state(full, 2).m.eq(-1e30).all()
    assert all(k in (LayerKind.MLSTM, LayerKind.SLSTM) for k in cfg.layer_kinds)
