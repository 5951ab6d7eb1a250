"""jamba on the port (``repro_torch.configs.jamba_1_5_large_398b``: Mamba
layers with one GQA layer in eight, MoE of 16 routed experts, top-2, on every
other layer) against the JAX package on the CPU: ``jamba-1.5-large-398b-
reduced`` through ``LMModel.apply`` with and without caches and through
``ServeEngine``, on the port's seeded weights carried to the reference
(``torch_lm_cases.reference_tree``; the reference's own eager init takes
~10 s) and back with ``params_from_reference``;
the configs field for field; ``count_params`` total and active at full
width, for the four-layer cut that chip_smoke.py serves, and for the reduced
config (where the reference's active rule miscounts); the layers' MLPs; the
initial weights and their order of draws; the ``serve lm`` launcher.

Tolerances (tests/torch_lm_cases.py): float32 logits within ``atol = rtol
= 1e-5`` with equal greedy tokens and equal expert choices; bfloat16 logits
within 0.0625, tokens equal wherever the reference's top-2 margin exceeds
0.125, each sequence held up to its first routing flip, which must be a near
tie (``torch_lm_cases.FLIP_MARGIN``).
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
from repro.models.model import _apply_layer as ref_apply_layer
from repro.models.model import _layer_is_moe as ref_layer_is_moe
from repro.models.model import count_params as ref_count_params
from repro.serving.engine import ServeEngine as RefServeEngine
from repro_torch import configs as port_configs
from repro_torch.launch import serve
from repro_torch.models import attention, common, mamba, mla
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import LayerKind
from repro_torch.models.mlp import init_mlp_params
from repro_torch.models.model import (LMModel, _apply_layer, _layer_is_moe, count_params,
                                      params_from_reference)
from repro_torch.serving import ServeEngine

ARCH = "jamba-1.5-large-398b"
S = 32                      # the forward: two of the reduced config's chunks of 16
STEPS = 16                  # decode steps: from position 0 (bf16), after a prefill of 16 (float32)
M, A = LayerKind.MAMBA, LayerKind.ATTN


def _cut(cfg, layers: int = 4):
    """chip_smoke.py's cut: the first ``layers`` layers of the unit."""
    return dataclasses.replace(cfg, num_layers=layers, pattern_unit=cfg.pattern_unit[:layers])


# --------------------------------------------------------------------------
# LMModel.apply
# --------------------------------------------------------------------------
def test_apply_float32_with_and_without_cache(monkeypatch):
    routing = cases.Routing(monkeypatch)
    ref, params, ref_apply, port = cases.model_pair(ARCH, "float32", port_init=True)
    assert [layer.kind for layer in port.layers] == [M, M, M, A, M, M, M, M]
    assert [layer.is_moe for layer in port.layers] == [False, True] * 4
    toks = cases.tokens(port.cfg.vocab_size, (2, S), seed=40)
    want, _, want_aux = jax.jit(ref.apply)(params, jnp.asarray(toks))
    with torch.inference_mode():
        got, _, aux = port.apply(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **cases.F32_TOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))
    for key in ("aux_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]), **cases.F32_TOL)
    for ref_e, port_e, _ in routing.take():
        np.testing.assert_array_equal(port_e, ref_e)
    # prefill 16 into fresh caches, then decode 8 steps, through float32
    # caches (a bfloat16 cache can round a float32 key whose last bit differs
    # to another value: tests/test_torch_bf16_cache_drift.py); the Mamba
    # states are float32 whatever the caches' dtype
    ref_caches, caches = ref.init_caches(2, S, jnp.float32), port.init_caches(2, S, torch.float32)
    for lo, hi in [(0, STEPS)] + [(t, t + 1) for t in range(STEPS, STEPS + 8)]:
        want, ref_caches = ref_apply(params, jnp.asarray(toks[:, lo:hi]), ref_caches)
        got, caches = cases.port_logits(port, toks[:, lo:hi], caches)
        np.testing.assert_allclose(got, np.asarray(want), **cases.F32_TOL)
        np.testing.assert_array_equal(got.argmax(-1), np.asarray(want).argmax(-1))
        for ref_e, port_e, _ in routing.take():
            np.testing.assert_array_equal(port_e, ref_e)
    assert all(c.index == STEPS + 8 for c in caches)
    assert caches[0].ssm.dtype == torch.float32
    assert port.init_caches(2, S)[0].conv.dtype == torch.float32       # under bfloat16 caches


def test_apply_bfloat16_with_and_without_cache(monkeypatch):
    routing = cases.Routing(monkeypatch)
    ref, params, ref_apply, port = cases.model_pair(ARCH, port_init=True)
    assert port.embed.dtype == torch.bfloat16
    mixer = port.layers[0].mixer
    assert mixer["w_in"].dtype == torch.bfloat16 and mixer["a_log"].dtype == torch.float32
    toks = cases.tokens(port.cfg.vocab_size, (2, S), seed=41)
    want = np.asarray(ref_apply(params, jnp.asarray(toks), None)[0])
    got, _ = cases.port_logits(port, toks)
    flip_margins = []
    held = ~cases.taint(routing.take(), port.cfg, np.zeros((2, S), bool), flip_margins)
    np.testing.assert_allclose(got[held], want[held], atol=cases.BF16_ATOL, rtol=0)
    n_held = int(held.sum())
    tokens_held = cases.argmax_agree(got, want, held, 2 * cases.BF16_ATOL)
    # decode one token at a time through the default caches
    ref_caches, caches = ref.init_caches(2, S), port.init_caches(2, S)
    tainted = np.zeros((2, 1), bool)
    for t in range(STEPS):
        want, ref_caches = ref_apply(params, jnp.asarray(toks[:, t:t + 1]), ref_caches)
        got, caches = cases.port_logits(port, toks[:, t:t + 1], caches)
        tainted = cases.taint(routing.take(), port.cfg, tainted, flip_margins)
        alive = ~tainted[:, 0]
        want = np.asarray(want)
        np.testing.assert_allclose(got[alive], want[alive], atol=cases.BF16_ATOL, rtol=0)
        n_held += int(alive.sum())
        tokens_held += cases.argmax_agree(got, want, alive[:, None], 2 * cases.BF16_ATOL)
    assert n_held >= S and tokens_held > 0, (n_held, tokens_held, flip_margins)


@pytest.mark.parametrize("index", [0, 1], ids=["mamba_mlp", "mamba_moe"])
def test_bfloat16_mamba_layer_equals_the_reference_layer(index):
    """On the same bfloat16 input a Mamba layer (with its dense MLP, or its
    MoE) gives the jitted reference layer's bits: ``common.silu`` rounds as
    ``jax.nn.silu`` does, and the RMSNorm after a residual add reads the
    unrounded float32 sum, as XLA's excess precision has it
    (``model._add``).  The attention layer is held by the model tests: its
    attention sums in another order."""
    ref, params, _, port = cases.model_pair(ARCH, port_init=True)
    unit = jax.tree.map(lambda a: a[0], params["units"])
    toks = cases.tokens(port.cfg.vocab_size, (2, 16), seed=43)
    pos = np.tile(np.arange(16), (2, 1))
    x = params["embed"].astype(jnp.bfloat16)[toks]
    want = jax.jit(lambda p, x: ref_apply_layer(p, x, pos, ref.cfg, ref.cfg.pattern_unit[index],
                                                index, None)[0])(unit[index], x)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    with torch.inference_mode():
        got = _apply_layer(port.layers[index], xt, xt.float(), torch.from_numpy(pos), port.cfg,
                           None)[0]
    assert port.layers[index].kind == M and port.layers[index].is_moe == bool(index)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


# --------------------------------------------------------------------------
# ServeEngine
# --------------------------------------------------------------------------
def test_serve_engine_float32():
    """Two waves, the second padded, through the default caches (bfloat16
    keys and values, float32 Mamba states) on both sides."""
    ref, params, _, port = cases.model_pair(ARCH, "float32", port_init=True)
    prompts = cases.prompts(port.cfg.vocab_size, 3, seed=42)
    want = RefServeEngine(ref, params, batch=2, max_len=24).generate(prompts, 8)
    got = ServeEngine(port, batch=2, max_len=24).generate(prompts, 8)
    assert got == want and all(len(o) == 8 for o in got)


def test_serve_lm_launcher_serves_jamba_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve.main(["lm", "--device", "cpu", "--arch", ARCH, "--requests", "3",
                         "--prompt-len", "4", "--max-new", "4"])
    text = out.getvalue()
    assert rc == 0, text
    assert "3 requests, 12 tokens" in text and f"{ARCH}-reduced" in text


# --------------------------------------------------------------------------
# configs, counts, layers, weights
# --------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_total_count_match_reference(reduced):
    cfg, ref_cfg = port_configs.get_config(ARCH, reduced), ref_get_config(ARCH, reduced)
    fields = [{k: (tuple(x.value for x in v) if isinstance(v, tuple) else
                   dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
               for k, v in dataclasses.asdict(c).items()} for c in (cfg, ref_cfg)]
    assert fields[0] == fields[1]
    assert count_params(cfg) == cfg.param_count() == ref_count_params(ref_cfg)


def test_full_width_and_cut_counts_match_reference():
    cfg, ref_cfg = port_configs.get_config(ARCH), ref_get_config(ARCH)
    for port_c, ref_c, total, active in (
            (cfg, ref_cfg, 398_555_111_424, 94_149_304_320),
            (_cut(cfg), _cut(ref_cfg), 23_021_379_584, 6_109_945_856)):
        assert count_params(port_c) == ref_count_params(ref_c) == total
        assert count_params(port_c, active_only=True) == \
            ref_count_params(ref_c, active_only=True) == active


def test_reduced_active_count_differs_from_the_references_rule():
    """The reference scales every stacked leaf whose second axis equals
    ``num_experts`` (4 in the reduced config): besides the routed experts it
    catches the Mamba layers' ``conv_w`` (d_conv = 4) and ``w_dt`` (dt_rank
    = 4) of its seven Mamba layers and the attention's ``wo`` (4 heads), and
    counts them at top_k / num_experts = 1/2.  The port counts the routed
    tensors only: 5,632 = (3,584 + 3,584 + 4,096) / 2 more."""
    cfg, ref_cfg = port_configs.get_config(ARCH, True), ref_get_config(ARCH, True)
    assert count_params(cfg, active_only=True) == 581_824
    assert ref_count_params(ref_cfg, active_only=True) == 576_192
    model = LMModel(cfg, device="meta")
    mixers = [layer.mixer for layer in model.layers if layer.kind == M]
    scaled = (sum(m["conv_w"].numel() for m in mixers), sum(m["w_dt"].numel() for m in mixers),
              model.layers[3].attn["wo"].numel())
    assert scaled == (3_584, 3_584, 4_096)
    assert 581_824 - 576_192 == sum(scaled) * (1 - cfg.moe.top_k / cfg.moe.num_experts)


def test_layers_and_their_mlps_follow_the_reference():
    """MoE on the odd layers (``_layer_is_moe``); the Mamba layers at even
    positions keep a dense MLP of d_ff (the reference's ``_init_layer`` gives
    one whenever d_ff > 0), and without d_ff they have none."""
    cfg, ref_cfg = port_configs.get_config(ARCH), ref_get_config(ARCH)
    flags = [_layer_is_moe(cfg, i) for i in range(cfg.num_layers)]
    assert flags == [ref_layer_is_moe(ref_cfg, i) for i in range(cfg.num_layers)]
    assert flags == [False, True] * 36
    model = LMModel(_cut(cfg), device="meta")
    assert [type(layer).__name__ for layer in model.layers] == \
        ["MambaLayer"] * 3 + ["AttnLayer"]
    assert model.layers[0].mlp["w_gate"].shape == (8192, 24576)
    assert model.layers[1].mlp["w_gate"].shape == (16, 8192, 24576)
    assert model.layers[0].mixer["w_x"].shape == (16384, 512 + 2 * 16)
    no_ff = LMModel(dataclasses.replace(port_configs.get_config(ARCH, True), d_ff=0),
                    device="meta")
    assert not hasattr(no_ff.layers[0], "mlp") and not hasattr(no_ff.layers[0], "norm_mlp")
    assert hasattr(no_ff.layers[1], "mlp")
    with torch.inference_mode():
        small = LMModel(dataclasses.replace(port_configs.get_config(ARCH, True), d_ff=0,
                                            dtype="float32"), device="cpu").init(0)
        logits, _, _ = small.apply(torch.zeros((1, 4), dtype=torch.long))
    assert torch.isfinite(logits).all()


def test_init_draws_the_reference_distributions():
    cfg = port_configs.get_config(ARCH, reduced=True)
    model = LMModel(cfg, device="cpu").init(0)
    mixer = model.layers[2].mixer
    d_in, n = 128, 8
    assert torch.equal(mixer["a_log"], torch.log(torch.arange(1.0, n + 1)).expand(d_in, n))
    assert torch.equal(mixer["dt_bias"],
                       torch.full((d_in,), 0.01).expm1().log())
    assert torch.equal(mixer["d_skip"], torch.ones(d_in)) and not mixer["conv_b"].any()
    assert abs(float(mixer["conv_w"].std()) - 0.1) < 0.01
    for name in mamba.FLOAT32:
        assert mixer[name].dtype == torch.float32
    for name, fan_in in (("w_in", 64), ("w_x", 128), ("w_dt", 4), ("w_out", 128)):
        w = mixer[name].float() * fan_in ** 0.5
        assert mixer[name].dtype == torch.bfloat16
        # a unit normal truncated at +-3 has std 0.9866 (w_dt has 512 draws)
        assert abs(float(w.std()) - 0.9866) < 0.08 and float(w.abs().max()) <= 3.0 + 0.03
    assert not model.layers[2].norm.any() and not model.layers[2].norm_mlp.any()


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", ARCH])
def test_init_keeps_its_order_of_draws(arch):
    """``init`` draws a MoE layer's routed tensors one at a time, each copied
    into its parameter before the next: the same numbers as drawing every
    tensor of the layer first and copying them after, in the same order from
    the same generator (the init of earlier releases, written out here)."""
    cfg = port_configs.get_config(arch, reduced=True)
    got = LMModel(cfg, device="cpu").init(7).state_dict()
    gen = torch.Generator().manual_seed(7)
    want = {"embed": common.embed_init(gen, (cfg.vocab_size, cfg.d_model)),
            "final_norm": torch.zeros(cfg.d_model)}
    want["lm_head"] = common.dense_init(gen, (cfg.d_model, cfg.vocab_size))
    for i, kind in enumerate(cfg.layer_kinds):
        if kind == M:
            blocks = {"mixer": mamba.init_mamba_params(gen, cfg)}
            norms = ("norm", "norm_mlp")
        else:
            blocks = {"attn": (mla.init_mla_params if kind == LayerKind.MLA
                               else attention.init_attn_params)(gen, cfg)}
            norms = ("norm_attn", "norm_mlp")
        blocks["mlp"] = (dict(moe_mod.draw_moe_params(gen, cfg.d_model, cfg.moe))
                         if _layer_is_moe(cfg, i)
                         else init_mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act))
        for block, weights in blocks.items():
            for name, w in weights.items():
                for sub, v in (w.items() if isinstance(w, dict) else [("", w)]):
                    want[f"layers.{i}.{block}.{name}{'.' + sub if sub else ''}"] = v
        for name in norms:
            want[f"layers.{i}.{name}"] = torch.zeros(cfg.d_model)
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert torch.equal(got[key], w.to(got[key].dtype)), key


def test_weights_carried_to_the_reference_and_back():
    ref_cfg, cfg = cases.configs(ARCH)
    port = LMModel(cfg, device="cpu").init(3)
    tree = cases.reference_tree(cases.RefModel(ref_cfg), port)
    assert tree["units"][0]["mixer"]["w_in"].shape == (1, 64, 256)
    back = params_from_reference(cfg, tree)
    for key, w in port.state_dict().items():
        assert torch.equal(back[key].to(w.dtype), w), key


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMModel(port_configs.get_config(ARCH, reduced=True))
