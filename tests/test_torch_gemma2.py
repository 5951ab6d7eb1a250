"""gemma2 on the port (``repro_torch.configs.gemma2_27b``) against the JAX
package on the CPU: the flash kernel's plain version with a sliding window
and a score softcap against the reference's ``blockwise_attention`` and
``decode_attention``; the attention block on ``ATTN_LOCAL`` layers; the
embedding scale; ``gemma2-27b-reduced`` through ``LMModel.apply`` with and
without a cache past its window of 16; ``ServeEngine`` on a wave whose
decode crosses the window; the configs field for field and
``count_params(gemma2-27b)``.

Tolerances.  float32: tests/torch_lm_cases.py's ``atol = rtol = 1e-5``
and equal greedy tokens; the float32 decode runs on float32 caches on both
sides (the largest difference seen over 48 steps was 0.45 of the bound):
with the models' default bfloat16 caches, a float32 key that differs in its
last bit between the two sides can round to another bfloat16 value, and
from that step on the logits differ by up to 200 times the bound (yi-9b
reduced, step 45 of 48; gemma2 18 times).  bfloat16: logits within
``BF16_ATOL``, tests/torch_lm_cases.py's 0.0625 (four bfloat16 ulps of yi's
logits in [2, 4)) times sqrt(d_model) = 8.  gemma2 ties the output head to
the embedding, whose rows are unit normals, where an untied head's columns
are fan-in normals of std 1/sqrt(d_model); so its pre-cap logits, and the
rounding differences carried into them, are sqrt(d_model) times yi's (the
same run with ``tie_embeddings=False`` differs by 0.031, as yi's; tied, by
0.23).  bfloat16 tokens are gated by the reference's top-2 margin at twice
the bound.
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
from repro.models import attention as ref_attention
from repro.models.config import LayerKind as RefLayerKind
from repro.models.model import count_params as ref_count_params
from repro.serving.engine import ServeEngine as RefServeEngine
from repro_torch import configs as port_configs
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.models import attention
from repro_torch.models.config import LayerKind
from repro_torch.models.model import LMModel, count_params, params_from_reference
from repro_torch.serving import ServeEngine

ARCH = "gemma2-27b"
BF16_ATOL = cases.BF16_ATOL * 64 ** 0.5    # sqrt(d_model) of gemma2-27b-reduced
WINDOW = 16                      # gemma2-27b-reduced's sliding window
S = 48                           # three windows
ref_blockwise = jax.jit(ref_attention.blockwise_attention,
                        static_argnames=("window", "attn_softcap", "q_chunk", "kv_chunk"))
ref_decode = jax.jit(ref_attention.decode_attention, static_argnames=("window", "attn_softcap"))
ref_attention_block = jax.jit(ref_attention.attention_block, static_argnums=(3, 4))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _qkv(seed, b, s, h, d, q_scale):
    """(B, S, H, D) float32; q scaled so that the softcap bites."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(3))
    return q * q_scale, k, v


# windows below, at and above the key count; softcap off and on (at cap 50,
# q scaled by 30 gives scaled scores of std 30, so the cap bites)
FLASH_CASES = [(w, cap) for w in (0, 1, 5, 16, 47, 48, 100) for cap in (0.0, 50.0)]


@pytest.mark.parametrize("window,cap", FLASH_CASES, ids=lambda x: str(x))
def test_plain_flash_matches_blockwise_attention(window, cap):
    q, k, v = _qkv(window + int(cap), 2, S, 2, 16, 30.0 if cap else 1.0)
    want = ref_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
                         attn_softcap=cap, q_chunk=16, kv_chunk=16)
    got = port_flash.flash_attention(_t(q).transpose(1, 2), _t(k).transpose(1, 2),
                                     _t(v).transpose(1, 2), causal=True, window=window,
                                     softcap=cap)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want), **cases.F32_TOL)


@pytest.mark.parametrize("window,cap", FLASH_CASES, ids=lambda x: str(x))
def test_plain_flash_matches_decode_attention(window, cap):
    """One query at position n - 1 against a cache of 48 positions, over
    ``attention.decode_span`` of it, at several fill levels."""
    q, k, v = _qkv(100 + window + int(cap), 2, S, 2, 16, 30.0 if cap else 1.0)
    for n in (1, 7, 16, 17, 33, 48):
        want = ref_decode(jnp.asarray(q[:, n - 1:n]), jnp.asarray(k), jnp.asarray(v),
                          jnp.int32(n), window=window, attn_softcap=cap)
        lo, hi = attention.decode_span(n, window)
        assert hi == n and lo == (max(0, n - window) if window else 0)
        got = port_flash.flash_attention(_t(q[:, n - 1:n]).transpose(1, 2),
                                         _t(k[:, lo:hi]).transpose(1, 2),
                                         _t(v[:, lo:hi]).transpose(1, 2), causal=False,
                                         softcap=cap)
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                                   **cases.F32_TOL)


def test_plain_flash_window_semantics():
    """Row i sees keys max(0, i - window + 1) .. i: the output of row i with
    window 1 is v[i], and a window past the rows changes nothing."""
    q, k, v = (_t(x).transpose(1, 2) for x in _qkv(3, 1, 40, 2, 16, 1.0))
    one = port_flash.flash_attention(q, k, v, window=1)
    torch.testing.assert_close(one, v, atol=0, rtol=0)
    full = port_flash.flash_attention(q, k, v)
    assert torch.equal(port_flash.flash_attention(q, k, v, window=40), full)
    assert not torch.equal(port_flash.flash_attention(q, k, v, window=39), full)


def test_wrapper_validates_window_and_softcap():
    q, k, v = (_t(x).transpose(1, 2) for x in _qkv(4, 1, 16, 2, 16, 1.0))
    with pytest.raises(ValueError, match="window"):
        port_flash.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="window"):
        port_flash.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="window"):           # a row would see no key
        port_flash.flash_attention(q, k[:, :, :8], v[:, :, :8], window=4)
    for cap in (-1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="softcap"):
            port_flash.flash_attention(q, k, v, softcap=cap)


# --------------------------------------------------------------------------
# the attention block, the embedding
# --------------------------------------------------------------------------
def _attn_pair(seed=5):
    """gemma2-27b-reduced's attention in float32, with the softcap at 2
    instead of 50, so that it bites at these scores (~N(0, 1))."""
    ref_cfg, cfg = (dataclasses.replace(c, attn_softcap=2.0)
                    for c in cases.configs(ARCH, "float32"))
    tree = jax.tree.map(np.asarray, ref_attention.init_attn_params(jax.random.PRNGKey(seed),
                                                                   ref_cfg))
    shapes = attention.attn_shapes(cfg)
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, tree), {k: _t(v).reshape(shapes[k])
                                                           for k, v in tree.items()}


@pytest.mark.parametrize("kind", ["attn_local", "attn"])
def test_attention_block_without_cache_and_decoding(kind):
    """The block with the window (attn_local) and the softcap, over 48
    positions, without a cache and then token by token through the cache."""
    ref_cfg, cfg, ref_p, p = _attn_pair()
    ref_kind, port_kind = RefLayerKind(kind), LayerKind(kind)
    x = np.random.default_rng(6).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    want, _ = ref_attention_block(ref_p, jnp.asarray(x), jnp.asarray(pos), ref_cfg, ref_kind)
    got, _ = attention.attention_block(p, _t(x), _t(pos), cfg, port_kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **cases.F32_TOL)
    ref_cache = ref_attention.init_kv_cache(ref_cfg, 2, S)
    cache = attention.init_kv_cache(cfg, 2, S)
    for t in range(S):
        sl = slice(t, t + 1)
        want, ref_cache = ref_attention_block(ref_p, jnp.asarray(x[:, sl]), jnp.asarray(pos[:, sl]),
                                              ref_cfg, ref_kind, ref_cache)
        got, cache = attention.attention_block(p, _t(x[:, sl]), _t(pos[:, sl]), cfg, port_kind,
                                               cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **cases.F32_TOL)


def test_attention_block_refuses_other_kinds():
    _, cfg, _, p = _attn_pair()
    with pytest.raises(NotImplementedError, match="mla"):
        attention.attention_block(p, torch.zeros(1, 2, cfg.d_model),
                                  torch.zeros(1, 2, dtype=torch.long), cfg, LayerKind.MLA)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_embedding_scale_is_cast_to_the_model_dtype_first(dtype):
    """sqrt(d_model) in the model's dtype before the multiply, as the
    reference: at d_model 72, sqrt = 8.485 becomes 8.5 in bfloat16 (at
    gemma2-27b's 4608, 67.88 becomes 68.0).  Equal bit for bit."""
    ref_cfg, cfg = (dataclasses.replace(c, d_model=72, num_heads=4, head_dim=16, dtype=dtype)
                    for c in cases.configs(ARCH))
    ref = cases.RefModel(ref_cfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(7)))
    port = LMModel(cfg, device="cpu")
    port.load_state_dict(params_from_reference(cfg, tree))
    toks = cases.tokens(cfg.vocab_size, (2, 5), seed=7)
    pos = jnp.broadcast_to(jnp.arange(5), (2, 5))
    want = ref._embed(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks), pos)
    got = port._embed(torch.from_numpy(toks))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    if dtype == "bfloat16":
        unscaled = port.embed[torch.from_numpy(toks).long()].float()
        assert torch.equal(got.float(), (unscaled * 8.5).to(torch.bfloat16).float())


# --------------------------------------------------------------------------
# LMModel.apply, ServeEngine
# --------------------------------------------------------------------------
def test_apply_float32_with_and_without_cache():
    ref, params, ref_apply, port = cases.model_pair(ARCH, "float32")
    assert port.cfg.sliding_window == WINDOW < S
    assert [layer.kind for layer in port.layers] == list(port.cfg.layer_kinds)
    assert "lm_head" not in port.state_dict()
    toks = cases.tokens(port.cfg.vocab_size, (2, S), seed=20)
    want = np.asarray(ref_apply(params, jnp.asarray(toks), None)[0])
    got, _ = cases.port_logits(port, toks)
    np.testing.assert_allclose(got, want, **cases.F32_TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    ref_caches = ref.init_caches(2, S, jnp.float32)
    caches = port.init_caches(2, S, torch.float32)
    for t in range(S):
        want, ref_caches = ref_apply(params, jnp.asarray(toks[:, t:t + 1]), ref_caches)
        got, caches = cases.port_logits(port, toks[:, t:t + 1], caches)
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, **cases.F32_TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert all(c.index == S for c in caches)


def _argmax_agree(got, want):
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * BF16_ATOL
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    return int(clear.sum())


def test_apply_bfloat16_with_and_without_cache():
    ref, params, ref_apply, port = cases.model_pair(ARCH)
    assert port.embed.dtype == torch.bfloat16
    toks = cases.tokens(port.cfg.vocab_size, (2, S), seed=21)
    want = np.asarray(ref_apply(params, jnp.asarray(toks), None)[0])
    got, _ = cases.port_logits(port, toks)
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    held = _argmax_agree(got, want)
    ref_caches, caches = ref.init_caches(2, S), port.init_caches(2, S)
    for t in range(S):
        want, ref_caches = ref_apply(params, jnp.asarray(toks[:, t:t + 1]), ref_caches)
        got, caches = cases.port_logits(port, toks[:, t:t + 1], caches)
        np.testing.assert_allclose(got, np.asarray(want), atol=BF16_ATOL, rtol=0)
        held += _argmax_agree(got, np.asarray(want))
    assert held > 0


def test_bfloat16_decode_logits_equal_the_jitted_reference():
    """Every bfloat16 decode logit of 12 steps equals the jitted reference's,
    bit for bit (ROADMAP.md queue 3: ~84% differed at every step while the
    port took torch's tanh and ``F.gelu``).
    The jitted reference computes the logit cap as XLA's float32 tanh
    (``kernels/ref.py::xla_tanh_f32``) of a multiply by the float32 ``1 /
    cap``, and GeGLU's ``jax.nn.gelu`` rounding every operation to bfloat16
    (``common.gelu``)."""
    ref, params, ref_apply, port = cases.model_pair(ARCH)
    steps = 12
    toks = cases.tokens(port.cfg.vocab_size, (2, steps), seed=21)
    ref_caches, caches = ref.init_caches(2, steps), port.init_caches(2, steps)
    differ = 0
    for t in range(steps):
        want, ref_caches = ref_apply(params, jnp.asarray(toks[:, t:t + 1]), ref_caches)
        got, caches = cases.port_logits(port, toks[:, t:t + 1], caches)
        differ += int(np.sum(got != np.asarray(want)))
    assert differ == 0


def test_serve_engine_float32_across_the_window():
    """Prompts of 10-16 tokens and 12 new ones: every wave decodes past the
    window of 16, so the local layers attend over a sliding cache span."""
    ref, params, _, port = cases.model_pair(ARCH, "float32")
    prompts = cases.prompts(port.cfg.vocab_size, 3, lo=10, hi=17, seed=22)
    want = RefServeEngine(ref, params, batch=2, max_len=30).generate(prompts, 12)
    got = ServeEngine(port, batch=2, max_len=30).generate(prompts, 12)
    assert got == want and all(len(o) == 12 for o in got)


def test_serve_engine_bfloat16_across_the_window():
    ref, params, _, port = cases.model_pair(ARCH)
    prompts = cases.prompts(port.cfg.vocab_size, 2, lo=10, hi=17, seed=23)
    got = ServeEngine(port, batch=2, max_len=30).generate(prompts, 12)
    want = cases.reference_wave(ref, params, prompts, 12, 30)
    n = [next((i for i, m in enumerate(ms) if m <= 2 * BF16_ATOL), len(ms)) for _, ms in want]
    for g, (w, _), k in zip(got, want, n):
        assert g[:k] == w[:k]
    assert sum(n) > 0


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
def test_config_and_param_count_match_reference(reduced):
    cfg, ref_cfg = port_configs.get_config(ARCH, reduced), ref_get_config(ARCH, reduced)
    fields = [{k: (tuple(x.value for x in v) if isinstance(v, tuple) else v)
               for k, v in dataclasses.asdict(c).items()} for c in (cfg, ref_cfg)]
    assert fields[0] == fields[1]
    assert count_params(cfg) == ref_count_params(ref_cfg)


def test_gemma2_27b_full_width_count():
    assert count_params(port_configs.get_config(ARCH)) == 27_227_128_320
