"""The port's LM model (``repro_torch.models``, ``repro_torch.configs``)
against the JAX package on the CPU: the primitives, the MLP, the attention
block (no cache, and decode step by step against the reference's
``KVCache``), ``LMModel.apply`` for yi-9b, qwen2.5-32b (with qkv biases) and
mistral-large-123b, all reduced, and tests/test_serve_engine.py's TINY, on
weights carried across with ``params_from_reference``; the configs field for
field and ``count_params`` full and reduced; gemma2's options each alone on
TINY (gemma2 itself: tests/test_torch_gemma2.py); the layer kinds and options
of xlstm, qwen2-vl and musicgen each on TINY.

Tolerances (reasons in tests/torch_lm_cases.py): float32 ``atol = rtol =
1e-5`` and equal greedy tokens; bfloat16 logits within 0.0625 and tokens
equal wherever the reference's top-2 margin exceeds 0.125.  On the CPU the
attention runs the flash kernel's plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.configs import ARCH_IDS as ref_arch_ids
from repro.configs import get_config as ref_get_config
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro.models import mlp as ref_mlp
from repro.models.config import LayerKind as RefLayerKind
from repro.models.model import count_params as ref_count_params
from repro_torch import configs as port_configs
from repro_torch.models import attention, common, mlp
from repro_torch.models.config import LayerKind
from repro_torch.models.model import LMModel, count_params, params_from_reference

MODELS = (*cases.ARCHS, "tiny")
# The reference's attention block under jax.jit: one compile per shape.
ref_attention_block = jax.jit(ref_attention.attention_block, static_argnums=(3, 4))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    want = ref_common.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale), 1e-6)
    got = common.rms_norm(_t(x).to(getattr(torch, dtype)), _t(scale), 1e-6)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = cases.F32_TOL if dtype == "float32" else dict(atol=0, rtol=2.0 ** -7)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def test_rope_halves_and_frequencies():
    np.testing.assert_allclose(common.rope_frequencies(32, 1e6).numpy(),
                               np.asarray(ref_common.rope_frequencies(32, 1e6)), rtol=1e-6)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    want = ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = common.apply_rope(_t(x), _t(pos), 1e4)
    # angles up to 4096 rad: cos/sin of one float32 angle differ by a few ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


def test_softcap():
    x = np.linspace(-100, 100, 41, dtype=np.float32)
    for cap in (0.0, 30.0):
        np.testing.assert_allclose(common.softcap(_t(x), cap).numpy(),
                                   np.asarray(ref_common.softcap(jnp.asarray(x), cap)),
                                   **cases.F32_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_mlp"])
def test_mlp_block(act):
    params = jax.tree.map(np.asarray, ref_mlp.init_mlp_params(jax.random.PRNGKey(3), 32, 48, act))
    x = np.random.default_rng(3).standard_normal((2, 5, 32)).astype(np.float32)
    want = ref_mlp.mlp_block(jax.tree.map(jnp.asarray, params), jnp.asarray(x), act)
    got = mlp.mlp_block({k: _t(v) for k, v in params.items()}, _t(x), act)
    assert set(params) == set(mlp.mlp_shapes(32, 48, act))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **cases.F32_TOL)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------
def _attn_pair(name, seed=4):
    """(reference cfg, port cfg, reference params, port params), float32."""
    ref_cfg, cfg = cases.configs(name, "float32")
    tree = jax.tree.map(np.asarray, ref_attention.init_attn_params(jax.random.PRNGKey(seed),
                                                                   ref_cfg))
    if cfg.qkv_bias:                       # nonzero biases, so that they are tested
        rng = np.random.default_rng(seed)
        tree = {k: rng.standard_normal(v.shape).astype(np.float32) if k[0] == "b" else v
                for k, v in tree.items()}
    shapes = attention.attn_shapes(cfg)
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, tree), {k: _t(v).reshape(shapes[k])
                                                           for k, v in tree.items()}


def test_expand_kv_serves_contiguous_query_heads():
    # KV head j serves query heads j*g .. j*g + g - 1 (jnp.repeat), not j, j + KV, ...
    k = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)     # (B, S, KV, D)
    want = np.asarray(ref_attention._expand_kv(jnp.asarray(k), 8))         # (B, S, H, D)
    got = attention._expand_kv(_t(k), 8)                                   # (B, H, S, D)
    np.testing.assert_array_equal(got.transpose(1, 2).numpy(), want)


@pytest.mark.parametrize("name", ["mistral-large-123b", "qwen2.5-32b"])
def test_attention_block_without_cache(name):
    ref_cfg, cfg, ref_p, p = _attn_pair(name)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    want, _ = ref_attention_block(ref_p, jnp.asarray(x), jnp.asarray(pos), ref_cfg,
                                            RefLayerKind.ATTN)
    got, cache = attention.attention_block(p, _t(x), _t(pos), cfg, LayerKind.ATTN)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **cases.F32_TOL)


@pytest.mark.parametrize("name", ["mistral-large-123b", "qwen2.5-32b"])
def test_attention_block_decode_step_by_step(name):
    """Each step inserts one token into the bfloat16 cache and attends over
    it: the outputs and the cache contents against the reference's."""
    ref_cfg, cfg, ref_p, p = _attn_pair(name)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    ref_cache = ref_attention.init_kv_cache(ref_cfg, 2, 12)
    cache = attention.init_kv_cache(cfg, 2, 12)
    assert cache.k.dtype == torch.bfloat16 and cache.k.shape == tuple(ref_cache.k.shape)
    for t in range(9):
        pos = np.full((2, 1), t, np.int32)
        want, ref_cache = ref_attention_block(
            ref_p, jnp.asarray(x[:, t:t + 1]), jnp.asarray(pos), ref_cfg, RefLayerKind.ATTN,
            ref_cache)
        got, cache = attention.attention_block(p, _t(x[:, t:t + 1]), _t(pos), cfg,
                                               LayerKind.ATTN, cache)
        assert cache.index == int(ref_cache.index) == t + 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **cases.F32_TOL)
    for got_c, want_c in ((cache.k, ref_cache.k), (cache.v, ref_cache.v)):
        # bfloat16 roundings of float32 values that differ in the last bits
        np.testing.assert_allclose(_np(got_c), _np(want_c), atol=0, rtol=2.0 ** -7)


def test_prefill_into_empty_cache_then_decode():
    ref_cfg, cfg, ref_p, p = _attn_pair("yi-9b")
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    ref_cache = ref_attention.init_kv_cache(ref_cfg, 2, 8)
    cache = attention.init_kv_cache(cfg, 2, 8)
    for sl in (slice(0, 5), slice(5, 6)):
        want, ref_cache = ref_attention_block(
            ref_p, jnp.asarray(x[:, sl]), jnp.asarray(pos[:, sl]), ref_cfg, RefLayerKind.ATTN,
            ref_cache)
        got, cache = attention.attention_block(p, _t(x[:, sl]), _t(pos[:, sl]), cfg,
                                               LayerKind.ATTN, cache)
        assert cache.index == int(ref_cache.index)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **cases.F32_TOL)


def test_prefill_at_nonzero_index_raises():
    _, cfg, _, p = _attn_pair("yi-9b")
    cache = attention.init_kv_cache(cfg, 1, 8)
    x = torch.zeros(1, 1, cfg.d_model)
    _, cache = attention.attention_block(p, x, torch.zeros(1, 1, dtype=torch.long), cfg,
                                         LayerKind.ATTN, cache)
    with pytest.raises(NotImplementedError, match="new tokens only"):
        attention.attention_block(p, torch.zeros(1, 2, cfg.d_model),
                                  torch.ones(1, 2, dtype=torch.long), cfg, LayerKind.ATTN, cache)


# --------------------------------------------------------------------------
# LMModel.apply
# --------------------------------------------------------------------------
def _argmax_agree(got, want, margin_bound):
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > margin_bound
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    return int(clear.sum())


@pytest.mark.parametrize("name", MODELS)
def test_apply_float32(name):
    _, params, ref_apply, port = cases.model_pair(name, "float32",
                                                  bias_seed=8 if "qwen" in name else None)
    toks = cases.tokens(port.cfg.vocab_size, (2, 16), seed=9)
    want = np.asarray(ref_apply(params, jnp.asarray(toks), None)[0])
    got, _ = cases.port_logits(port, toks)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **cases.F32_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("name", MODELS)
def test_apply_bfloat16(name):
    _, params, ref_apply, port = cases.model_pair(name, bias_seed=8 if "qwen" in name else None)
    assert port.cfg.dtype == "bfloat16" and port.embed.dtype == torch.bfloat16
    toks = cases.tokens(port.cfg.vocab_size, (2, 16), seed=10)
    want = np.asarray(ref_apply(params, jnp.asarray(toks), None)[0])
    got, _ = cases.port_logits(port, toks)
    np.testing.assert_allclose(got, want, atol=cases.BF16_ATOL, rtol=0)
    assert _argmax_agree(got, want, 2 * cases.BF16_ATOL) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["yi-9b", "mistral-large-123b"])
def test_apply_decode_step_by_step(name, dtype):
    """One token at a time through the caches (the reference's KVCache,
    bfloat16 whatever the model's dtype) against the reference."""
    ref, params, ref_apply, port = cases.model_pair(name, dtype)
    toks = cases.tokens(port.cfg.vocab_size, (2, 10), seed=11)
    ref_caches, caches = ref.init_caches(2, 12), port.init_caches(2, 12)
    for t in range(10):
        want, ref_caches = ref_apply(params, jnp.asarray(toks[:, t:t + 1]), ref_caches)
        got, caches = cases.port_logits(port, toks[:, t:t + 1], caches)
        want = np.asarray(want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **cases.F32_TOL)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        else:
            np.testing.assert_allclose(got, want, atol=cases.BF16_ATOL, rtol=0)
            _argmax_agree(got, want, 2 * cases.BF16_ATOL)
    assert all(c.index == 10 for c in caches)


def test_apply_geglu_with_nonzero_norm_scales():
    """GeGLU, the dense MLP activation the three configs leave off, through
    the whole model, with every norm scale nonzero so that each is tested."""
    ref_cfg, cfg = (dataclasses.replace(c, dtype="float32", mlp_act="gelu")
                    for c in (cases.REF_TINY, cases.TINY))
    ref = cases.RefModel(ref_cfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(12)))
    rng = np.random.default_rng(12)
    for node, keys in ((tree, ("final_norm",)),
                       *((unit, ("norm_attn", "norm_mlp")) for unit in tree["units"])):
        for key in keys:
            node[key] = rng.standard_normal(node[key].shape).astype(np.float32) * 0.1
    port = LMModel(cfg, device="cpu")
    port.load_state_dict(params_from_reference(cfg, tree))
    toks = cases.tokens(cfg.vocab_size, (2, 12), seed=12)
    want = np.asarray(jax.jit(ref.apply)(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks))[0])
    got, _ = cases.port_logits(port, toks)
    np.testing.assert_allclose(got, want, **cases.F32_TOL)


def test_params_from_reference_rejects_another_config():
    tree = jax.tree.map(np.asarray, cases.RefModel(cases.REF_TINY).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="does not fit"):
        params_from_reference(dataclasses.replace(cases.TINY, qkv_bias=True), tree)


# --------------------------------------------------------------------------
# init, devices, configs
# --------------------------------------------------------------------------
def test_init_draws_the_reference_distributions():
    cfg = dataclasses.replace(cases.TINY, d_model=256, num_heads=8, num_kv_heads=2, d_ff=512,
                              qkv_bias=True)
    model = LMModel(cfg, device="cpu").init(0)
    again = LMModel(cfg, device="cpu").init(0)
    other = LMModel(cfg, device="cpu").init(1)
    state, state2 = model.state_dict(), again.state_dict()
    assert all(torch.equal(state[k], state2[k]) for k in state)
    assert not torch.equal(state["embed"], other.state_dict()["embed"])
    assert model.embed.dtype == torch.bfloat16 and model.final_norm.dtype == torch.float32
    emb = model.embed.float()
    assert abs(float(emb.std()) - 1.0) < 0.02 and abs(float(emb.mean())) < 0.02
    layer = model.layers[0]
    # fan-in: d_model for the projections, H (not H * hd) for wo, d_ff for w_down
    for w, fan_in in ((layer.attn["wq"], 256), (layer.attn["wk"], 256),
                      (layer.attn["wo"], 8), (layer.mlp["w_gate"], 256),
                      (layer.mlp["w_down"], 512), (model.lm_head, 256)):
        w = w.float() * fan_in ** 0.5
        # a unit normal truncated at +-3 has std 0.9866
        assert abs(float(w.std()) - 0.9866) < 0.03 and float(w.abs().max()) <= 3.0 + 0.02
    for name in ("bq", "bk", "bv"):
        assert not layer.attn[name].any()
    assert not model.final_norm.any() and not layer.norm_attn.any() and not layer.norm_mlp.any()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMModel(cases.TINY)


def _fields(cfg) -> dict:
    return {k: (tuple(x.value for x in v) if isinstance(v, tuple) else v)
            for k, v in dataclasses.asdict(cfg).items()}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", cases.ARCHS)
def test_configs_and_param_counts_match_reference(arch, reduced):
    cfg, ref_cfg = port_configs.get_config(arch, reduced), ref_get_config(arch, reduced)
    assert _fields(cfg) == _fields(ref_cfg)
    assert count_params(cfg) == cfg.param_count() == ref_count_params(ref_cfg)
    assert cfg.active_param_count() == ref_count_params(ref_cfg, active_only=True)


def test_yi_9b_full_width_count():
    assert count_params(port_configs.get_config("yi-9b")) == 8_829_407_232


def test_registry_covers_the_ported_archs_only():
    # gemma2: tests/test_torch_gemma2.py; deepseek-v2: tests/test_torch_deepseek.py;
    # jamba: tests/test_torch_jamba.py; xlstm: tests/test_torch_xlstm.py; qwen2-vl and
    # musicgen: tests/test_torch_frontends.py
    ported = (*cases.ARCHS, "gemma2-27b", *cases.DEEPSEEK, "jamba-1.5-large-398b",
              "xlstm-350m", "qwen2-vl-7b", "musicgen-large")
    assert port_configs.ARCH_IDS == ported
    assert set(ported) == set(ref_arch_ids)
    for reduced in (False, True):
        configs = port_configs.all_configs(reduced)
        assert set(configs) == set(ported)
        assert all(cfg.name == ref_get_config(arch, reduced).name for arch, cfg in configs.items())
    with pytest.raises(KeyError, match="unknown arch"):
        port_configs.get_config("llama-7b")


# gemma2's options, each alone on TINY, at values that bite at TINY's
# magnitudes (scores and logits ~N(0, 1)): a window of 4 of 12 positions,
# caps of 0.5.
GEMMA2_OPTIONS = {
    "attn_local": dict(pattern_unit=(LayerKind.ATTN_LOCAL, LayerKind.ATTN), sliding_window=4),
    "attn_softcap": dict(attn_softcap=0.5),
    "logit_softcap": dict(logit_softcap=0.5),
    "post_block_norm": dict(post_block_norm=True),
    "tie_embeddings": dict(tie_embeddings=True),
}


@pytest.mark.parametrize("change", GEMMA2_OPTIONS.values(), ids=GEMMA2_OPTIONS.keys())
def test_gemma2_option_alone_matches_reference(change):
    """float32, with and without a cache (float32 caches on both sides: see
    tests/test_torch_gemma2.py).  Tied embeddings make the logits, and their
    rounding differences, sqrt(d_model) = 8 times larger (the head's rows are
    unit normals, not fan-in normals), so the absolute tolerance is 8 times
    F32_TOL's there."""
    ref_cfg, cfg = (dataclasses.replace(c, dtype="float32", **change)
                    for c in (cases.REF_TINY, cases.TINY))
    ref = cases.RefModel(ref_cfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(13)))
    port = LMModel(cfg, device="cpu")
    port.load_state_dict(params_from_reference(cfg, tree))
    assert count_params(cfg) == ref_count_params(ref_cfg)
    params = jax.tree.map(jnp.asarray, tree)
    ref_apply = jax.jit(lambda p, t, c: ref.apply(p, t, caches=c)[:2])
    tol = dict(cases.F32_TOL)
    if cfg.tie_embeddings:
        tol["atol"] *= cfg.d_model ** 0.5
    toks = cases.tokens(cfg.vocab_size, (2, 12), seed=13)
    want = np.asarray(ref_apply(params, jnp.asarray(toks), None)[0])
    got, _ = cases.port_logits(port, toks)
    np.testing.assert_allclose(got, want, **tol)
    ref_caches, caches = ref.init_caches(2, 12, jnp.float32), port.init_caches(2, 12, torch.float32)
    for t in range(12):
        want, ref_caches = ref_apply(params, jnp.asarray(toks[:, t:t + 1]), ref_caches)
        got, caches = cases.port_logits(port, toks[:, t:t + 1], caches)
        np.testing.assert_allclose(got, np.asarray(want), **tol)


# The layer kinds and options of xlstm-350m, qwen2-vl-7b and musicgen-large,
# each on TINY (a full sequence of 12 and 12 decode steps; xLSTM chunks of
# 12, and 4 heads of 32: the mLSTM's d_inner 128).
OTHER_OPTIONS = {
    "mlstm": dict(pattern_unit=(LayerKind.MLSTM,)),
    "slstm": dict(pattern_unit=(LayerKind.ATTN, LayerKind.SLSTM)),
    "xlstm": dict(pattern_unit=(LayerKind.MLSTM, LayerKind.SLSTM)),
    "mrope": dict(pos_embedding="mrope"),
    "frontend": dict(frontend="audio_stub", pos_embedding="sinusoidal", mlp_act="gelu_mlp"),
}


@pytest.mark.parametrize("change", OTHER_OPTIONS.values(), ids=OTHER_OPTIONS.keys())
def test_unported_layers_raise(change):
    """The layer kinds and options that raised before the port ran them
    (the test keeps its name) now match the reference: float32, without a
    cache and token by token through float32 caches (and states), as
    ``test_gemma2_option_alone_matches_reference``; the stub frontend's
    inputs are (B, S, d_model) embeddings for the forward and token ids for
    the decode steps."""
    ref_cfg, cfg = (dataclasses.replace(c, dtype="float32", **change)
                    for c in (cases.REF_TINY, cases.TINY))
    ref = cases.RefModel(ref_cfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(14)))
    port = LMModel(cfg, device="cpu")
    port.load_state_dict(params_from_reference(cfg, tree))
    assert count_params(cfg) == ref_count_params(ref_cfg)
    params = jax.tree.map(jnp.asarray, tree)
    ref_apply = jax.jit(lambda p, t, c: ref.apply(p, t, caches=c)[:2])
    toks = cases.tokens(cfg.vocab_size, (2, 12), seed=14)
    inputs = (np.random.default_rng(14).standard_normal((2, 12, cfg.d_model)).astype(np.float32)
              if cfg.frontend != "none" else toks)
    want = np.asarray(ref_apply(params, jnp.asarray(inputs), None)[0])
    got, _ = cases.port_logits(port, inputs)
    np.testing.assert_allclose(got, want, **cases.F32_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    ref_caches, caches = ref.init_caches(2, 12, jnp.float32), port.init_caches(2, 12, torch.float32)
    for t in range(12):
        want, ref_caches = ref_apply(params, jnp.asarray(toks[:, t:t + 1]), ref_caches)
        got, caches = cases.port_logits(port, toks[:, t:t + 1], caches)
        np.testing.assert_allclose(got, np.asarray(want), **cases.F32_TOL)
    assert all(c.index == 12 for c in caches)
