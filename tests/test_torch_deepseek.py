"""deepseek-v2 on the port (``repro_torch.configs.deepseek_v2_lite_16b``,
``deepseek_v2_236b``: MLA layers, a dense first layer, then static-capacity
MoE) against the JAX package on the CPU: both reduced models through
``LMModel.apply`` with and without caches and through ``ServeEngine``, on
weights carried across with ``params_from_reference``; the MoE aux terms
summed over layers; the configs field for field; ``count_params`` total and
active; ``_layer_is_moe``; the initial weights; the ``serve lm`` launcher.

Tolerances (tests/torch_lm_cases.py): float32 logits within ``atol = rtol =
1e-5`` with equal greedy tokens and equal expert choices (decode through
float32 caches; bfloat16 caches: tests/test_torch_bf16_cache_drift.py), the
aux terms within the same; bfloat16 logits within 0.0625, tokens equal
wherever the reference's top-2 margin exceeds 0.125.

Routing gate (bfloat16).  A MoE layer's choice of experts is a step
function of its input: where the k-th and (k+1)-th router probabilities
nearly tie, a last-bit difference upstream (MLA's attention sums in
another order) picks another expert, and that token's logits, its
sequence's later positions and, through the capacity, other tokens' slots
move by far more than 0.0625 (0.43 here).  Both sides' choices are recorded
at every MoE call (the reference's through ``jax.debug.callback``); each
position keeps the bound until its sequence's first position whose experts
or kept slots differ, and every such first flip must be a near tie on the
reference's side (``torch_lm_cases.FLIP_MARGIN``).  Measured (x86-64, JAX
0.9, torch 2.13), with the port's roundings as the jitted reference's (the
silu as ``jax.nn.silu``, norms reading unrounded residual sums within a
unit and rounded ones across the reference's scanned units, MLA's two
scores summed in float32; ``models/model.py``, ``mla.py``):
neither reduced model flips in bfloat16 on these inputs.
deepseek-v2-lite-16b-reduced holds all 64 forward positions (within 1.9e-6)
and all 64 decode positions (within 0.0156; the logits equal the
reference's bit for bit at 61 of the 64 (sequence, step) pairs);
deepseek-v2-236b-reduced holds all 128 (within 0.027 and 0).  Before those
repairs the lite model flipped:
29 and 19 positions held (49 with the silu and the unrounded norms alone),
at reference top-k margins of 2.4e-4 to 1.04e-3.  In float32 neither flips:
the smallest top-k margins the reference saw were 1.8e-4 (lite) and 2.1e-4
(236b), far above the ~1e-7 by which the two sides' router inputs differ.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.configs import get_config as ref_get_config
from repro.models.model import _layer_is_moe as ref_layer_is_moe
from repro.models.model import count_params as ref_count_params
from repro.serving.engine import ServeEngine as RefServeEngine
from repro_torch import configs as port_configs
from repro_torch.launch import serve
from repro_torch.models.config import LayerKind
from repro_torch.models.model import LMModel, _layer_is_moe, count_params
from repro_torch.serving import ServeEngine

S = 32                      # two of the reduced configs' chunks of 16


# --------------------------------------------------------------------------
# LMModel.apply
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", cases.DEEPSEEK)
def test_apply_float32_with_and_without_cache(name, monkeypatch):
    routing = cases.Routing(monkeypatch)
    ref, params, ref_apply, port = cases.model_pair(name, "float32")
    assert [layer.is_moe for layer in port.layers] == [False, True, True]
    assert [layer.kind for layer in port.layers] == [LayerKind.MLA] * 3
    toks = cases.tokens(port.cfg.vocab_size, (2, S), seed=30)
    want, _, want_aux = jax.jit(ref.apply)(params, jnp.asarray(toks))
    with torch.inference_mode():
        got, _, aux = port.apply(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **cases.F32_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    for key in ("aux_loss", "z_loss", "fraction_dropped"):
        assert aux[key].dtype == torch.float32
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]), **cases.F32_TOL)
    for ref_e, port_e, _ in routing.take():
        np.testing.assert_array_equal(port_e, ref_e)
    # prefill 16, then decode 16 steps, through float32 caches
    ref_caches, caches = ref.init_caches(2, S, jnp.float32), port.init_caches(2, S, torch.float32)
    for lo, hi in [(0, 16)] + [(t, t + 1) for t in range(16, S)]:
        want, ref_caches = ref_apply(params, jnp.asarray(toks[:, lo:hi]), ref_caches)
        got, caches = cases.port_logits(port, toks[:, lo:hi], caches)
        np.testing.assert_allclose(got, np.asarray(want), **cases.F32_TOL)
        np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1))
        for ref_e, port_e, _ in routing.take():
            np.testing.assert_array_equal(port_e, ref_e)
    assert all(c.index == S for c in caches)


@pytest.mark.parametrize("name", cases.DEEPSEEK)
def test_apply_bfloat16_with_and_without_cache(name, monkeypatch):
    routing = cases.Routing(monkeypatch)
    ref, params, ref_apply, port = cases.model_pair(name)
    assert port.embed.dtype == torch.bfloat16
    assert all(layer.mlp.router.dtype == torch.float32 for layer in port.layers if layer.is_moe)
    toks = cases.tokens(port.cfg.vocab_size, (2, S), seed=31)
    want = np.asarray(ref_apply(params, jnp.asarray(toks), None)[0])
    got, _ = cases.port_logits(port, toks)
    flip_margins = []
    held = ~cases.taint(routing.take(), port.cfg, np.zeros((2, S), bool), flip_margins)
    np.testing.assert_allclose(got[held], want[held], atol=cases.BF16_ATOL, rtol=0)
    n_held = int(held.sum())
    tokens_held = cases.argmax_agree(got, want, held, 2 * cases.BF16_ATOL)
    # decode one token at a time through the bfloat16 caches
    ref_caches, caches = ref.init_caches(2, S), port.init_caches(2, S)
    tainted = np.zeros((2, 1), bool)
    for t in range(S):
        want, ref_caches = ref_apply(params, jnp.asarray(toks[:, t:t + 1]), ref_caches)
        got, caches = cases.port_logits(port, toks[:, t:t + 1], caches)
        tainted = cases.taint(routing.take(), port.cfg, tainted, flip_margins)
        alive = ~tainted[:, 0]
        want = np.asarray(want)
        np.testing.assert_allclose(got[alive], want[alive], atol=cases.BF16_ATOL, rtol=0)
        n_held += int(alive.sum())
        tokens_held += cases.argmax_agree(got, want, alive[:, None], 2 * cases.BF16_ATOL)
    assert n_held >= S and tokens_held > 0, (n_held, tokens_held, flip_margins)


# --------------------------------------------------------------------------
# ServeEngine
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", cases.DEEPSEEK)
def test_serve_engine_float32(name):
    ref, params, _, port = cases.model_pair(name, "float32")
    prompts = cases.prompts(port.cfg.vocab_size, 3, seed=32)     # two waves, one padded
    want = RefServeEngine(ref, params, batch=2, max_len=24).generate(prompts, 8)
    got = ServeEngine(port, batch=2, max_len=24).generate(prompts, 8)
    assert got == want and all(len(o) == 8 for o in got)


@pytest.mark.parametrize("name", cases.DEEPSEEK)
def test_serve_engine_bfloat16(name, monkeypatch):
    """One wave of 2 requests: tokens equal up to each request's first token
    whose reference margin is at most 0.125 or whose step's routing differs."""
    routing = cases.Routing(monkeypatch)
    ref, params, _, port = cases.model_pair(name)
    prompts = cases.prompts(port.cfg.vocab_size, 2, seed=33)
    got = ServeEngine(port, batch=2, max_len=24).generate(prompts, 8)
    want = cases.reference_wave(ref, params, prompts, 8, 24)
    n_moe = sum(layer.is_moe for layer in port.layers)
    pairs = routing.take()                   # step by step, layer by layer
    tainted, alive = np.zeros((2, 1), bool), []
    for t in range(0, len(pairs), n_moe):
        tainted = cases.taint(pairs[t:t + n_moe], port.cfg, tainted, [])
        alive.append(~tainted[:, 0])
    alive = np.stack(alive, axis=1)           # (request, step)
    held = 0
    for i, (g, (w, margins)) in enumerate(zip(got, want)):
        first_new = len(prompts[i]) - 1              # the step of the first new token
        ok = alive[i, first_new:first_new + len(margins)]
        margins = [m if keep else 0.0 for m, keep in zip(margins, ok)]
        held += cases.gated_prefix(g, w, margins)
    assert held > 0


# --------------------------------------------------------------------------
# configs, counts, layers, weights, launcher
# --------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", cases.DEEPSEEK)
def test_config_and_param_counts_match_reference(arch, reduced):
    cfg, ref_cfg = port_configs.get_config(arch, reduced), ref_get_config(arch, reduced)
    fields = [{k: (tuple(x.value for x in v) if isinstance(v, tuple) else
                   dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
               for k, v in dataclasses.asdict(c).items()} for c in (cfg, ref_cfg)]
    assert fields[0] == fields[1]
    assert count_params(cfg) == cfg.param_count() == ref_count_params(ref_cfg)
    assert count_params(cfg, active_only=True) == cfg.active_param_count() == \
        ref_count_params(ref_cfg, active_only=True)


def test_full_width_counts():
    lite, big = (port_configs.get_config(a) for a in cases.DEEPSEEK)
    assert (count_params(lite), count_params(lite, True)) == (15_706_470_400, 2_661_136_384)
    assert (count_params(big), count_params(big, True)) == (235_741_312_000, 21_375_677_440)
    cut = dataclasses.replace(big, num_layers=4)               # chip_smoke.py's cut
    assert count_params(cut) == 13_302_903_808


@pytest.mark.parametrize("arch", cases.DEEPSEEK)
def test_layer_zero_is_dense(arch):
    """``first_dense = 1``: layer 0 is a dense MLP, every later layer MoE, as
    the reference's ``_layer_is_moe``; ``ModelConfig.layer_is_moe`` (an index
    within the unit, no ``first_dense``) would call layer 0 MoE."""
    cfg, ref_cfg = port_configs.get_config(arch), ref_get_config(arch)
    flags = [_layer_is_moe(cfg, i) for i in range(cfg.num_layers)]
    assert flags == [ref_layer_is_moe(ref_cfg, i) for i in range(cfg.num_layers)]
    assert flags == [False] + [True] * (cfg.num_layers - 1)
    assert cfg.layer_is_moe(0)
    model = LMModel(port_configs.get_config(arch, reduced=True), device="meta")
    assert "w_gate" in dict(model.layers[0].mlp.named_parameters())
    assert model.layers[0].mlp["w_gate"].dim() == 2 and model.layers[1].mlp["w_gate"].dim() == 3


def test_init_draws_the_reference_distributions():
    """Fan-ins: d_model for w_dkv, w_kr, w_dq and the router; the first axis
    (R, the query rank) for w_uk, w_uv, w_uq; H for w_o; d_model for the
    experts' w_gate / w_up and d_expert for w_down (their second axis)."""
    cfg = dataclasses.replace(port_configs.get_config("deepseek-v2-236b", reduced=True),
                              d_model=256, num_heads=8,
                              mla=dataclasses.replace(port_configs.get_config(
                                  "deepseek-v2-236b", reduced=True).mla,
                                  kv_lora_rank=128, q_lora_rank=96),
                              moe=dataclasses.replace(port_configs.get_config(
                                  "deepseek-v2-236b", reduced=True).moe, d_expert=160))
    model = LMModel(cfg, device="cpu").init(0)
    assert torch.equal(model.embed, LMModel(cfg, device="cpu").init(0).embed)
    attn, mlp = model.layers[1].attn, model.layers[1].mlp
    assert mlp.router.dtype == torch.float32 and mlp.w_gate.dtype == torch.bfloat16
    for w, fan_in in ((attn["w_dkv"], 256), (attn["w_kr"], 256), (attn["w_dq"], 256),
                      (attn["w_uk"], 128), (attn["w_uv"], 128), (attn["w_uq"], 96),
                      (attn["w_o"], 8), (mlp.router, 256), (mlp.w_gate, 256), (mlp.w_up, 256),
                      (mlp.w_down, 160), (mlp.shared["w_down"], 320)):
        w = w.float() * fan_in ** 0.5
        # a unit normal truncated at +-3 has std 0.9866
        assert abs(float(w.std()) - 0.9866) < 0.05 and float(w.abs().max()) <= 3.0 + 0.03
    assert not model.layers[1].norm_attn.any() and not model.layers[1].norm_mlp.any()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMModel(port_configs.get_config("deepseek-v2-lite-16b", reduced=True))


def test_serve_lm_launcher_serves_deepseek_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["lm", "--device", "cpu", "--arch", "deepseek-v2-lite-16b",
                         "--requests", "3", "--max-new", "4"])
    text = out.getvalue()
    assert rc == 0, text
    assert "3 requests, 12 tokens" in text and "deepseek-v2-lite-16b-reduced" in text
