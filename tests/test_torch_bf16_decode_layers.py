"""One bfloat16 decode step of an attention layer against the jitted
reference, output by output: a GQA layer (yi-9b-reduced, at its head width
of 16 and at yi-9b's 128) through the flash kernel's plain version
(``kernels/ref.py::flash_attention_ref``), and an MLA layer
(deepseek-v2-lite-16b-reduced, the absorbed decode); then the whole bfloat16
models' first decode step.

Each stage of the port is fed the reference's previous stage, so that a
difference shows where it arises.  The reference's stages come from a jitted
copy of its expressions, whose last stage is checked to be the jitted
reference's own output bit for bit.  Each test counts the differing outputs
"before" and "after": before is the port as it was, whose plain attention
divided the scores by sqrt(D) and normalised with ``torch.softmax``, whose MLA
added its two bfloat16 scores in bfloat16, and whose models' RMSNorms all
read the unrounded residual sum.  After is the port now:

- the scores are multiplied by the float32 ``1 / sqrt(D)``, as the reference
  does.  At D = 128 dividing differs in 56 of the 176 scaled scores here.
  At D = 16 the scale is a power of two, so both agree;
- the softmax is ``jax.nn.softmax`` as XLA:CPU evaluates it
  (``ref.xla_softmax_f32``): XLA's exp polynomial of ``scores * scale -
  max``, which XLA contracts into one FMA, then a division by the sum.  At
  D = 128, ``torch.exp`` differs in 40 of 176, XLA's exp without the FMA in
  23, ``torch.softmax`` in 62 (at D = 16: 21, 0, 31);
- MLA adds ``s_lat + s_rope`` in float32 and keeps the sum unrounded, as
  XLA's excess precision does (the optimized HLO drops the add's bfloat16
  round trip before the cast).  Rounding the sum differed in 2,167 of 4,096
  layer outputs over 16 steps, and now in 0 (its softmax stays
  ``torch.softmax``: the bfloat16 readout rounds the difference away);
- ``LMModel.apply`` rounds the residual stream to the model's dtype where
  the reference's scan carries it from one unit to the next, and before
  the final norm.  Before, the first decode step's logits differed in 346 of
  512 (deepseek-v2-lite-16b-reduced) and ~70% (yi-9b-reduced); now in 0 of
  4,096 for each (four token seeds, the port's seeded weights carried to the
  reference; 1 of 4,096 on the reference's own weights).

What is left is the order of float32 sums: the two dots (q k and p v) and
the softmax's row sum.  XLA's plan for the row sum depends on the row's
length: sequential at 16, another at 33.  These stages are held within a
last-bit tolerance, not compared bit for bit.  Measured on x86-64 with JAX
0.9 and torch 2.13: at D = 128 the scores differ in 94 of 176, the sums in
8 of 16 and the readout in 1,327 of 2,048, yet the layer's bfloat16 output
differs in 9 of 4,096 over 16 steps (20 before).  At D = 16 the sums differ
in 9 of 16 and the readout in 168 of 256, and the output in 0 of 4,096.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.models import attention as ref_attention
from repro.models import mla as ref_mla
from repro.models.config import LayerKind as RefLayerKind
from repro_torch.kernels import ref
from repro_torch.models import attention, mla
from repro_torch.models.config import LayerKind

B, SMAX, STEPS = 4, 16, 16


def _sum_tol(want: torch.Tensor) -> dict:
    """Sums in another order: 8 float32 ulps of the largest output."""
    return dict(atol=2.0 ** -20 * float(want.abs().max()), rtol=0)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


def _count(got, want) -> int:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return int((got != np.asarray(jnp.asarray(want, jnp.float32))).sum())


def _flash_before(q, k, v, causal=True, window=0, softcap=0.0):
    """The plain attention as it was: scores divided by sqrt(D),
    ``torch.softmax`` (decode calls: full, no window, no cap)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (q.shape[-1] ** 0.5)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1), v.float()).to(q.dtype)


def _gqa(head_dim):
    ref_cfg, cfg = (dataclasses.replace(c, head_dim=head_dim) for c in cases.configs("yi-9b"))
    tree = jax.tree.map(np.asarray, ref_attention.init_attn_params(jax.random.PRNGKey(4),
                                                                   ref_cfg))
    shapes = attention.attn_shapes(cfg)
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, tree), {
        k: torch.from_numpy(v.copy()).reshape(shapes[k]).bfloat16() for k, v in tree.items()}


def _decode_stages(q, ck, cv, index):
    """``repro.models.attention.decode_attention``'s expressions, each
    stage returned (jitted by the caller)."""
    h, d = q.shape[2], q.shape[3]
    k = ref_attention._expand_kv(ck, h, from_cache=True).astype(jnp.float32)
    v = ref_attention._expand_kv(cv, h, from_cache=True).astype(jnp.float32)
    scores = jnp.einsum("bqhd,bshd->bhqs", q.astype(jnp.float32), k)
    scaled = scores * (1.0 / d ** 0.5)
    masked = jnp.where((jnp.arange(ck.shape[1]) < index)[None, None, None], scaled, -1e30)
    mx = jnp.max(masked, -1, keepdims=True)
    e = jnp.exp(masked - mx)
    total = jnp.sum(e, -1, keepdims=True)
    p = e / total
    out = jnp.einsum("bhqs,bshd->bqhd", p, v)
    return dict(scores=scores, scaled=scaled, max=mx, exp=e, sum=total, p=p, readout=out,
                out=out.astype(q.dtype))


@pytest.mark.parametrize("head_dim", [16, 128])
def test_gqa_decode_step_stage_by_stage(head_dim):
    ref_cfg, cfg, _, _ = _gqa(head_dim)
    rng = np.random.default_rng(head_dim)
    h, kvh, n = cfg.num_heads, cfg.num_kv_heads, 11
    q, ck, cv = (jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
                 for s in ((B, 1, h, head_dim), (B, SMAX, kvh, head_dim),
                           (B, SMAX, kvh, head_dim)))
    want = jax.jit(_decode_stages, static_argnums=3)(q, ck, cv, n)
    whole = jax.jit(lambda q, k, v: ref_attention.decode_attention(q, k, v, n))(q, ck, cv)
    assert _count(want["out"], whole) == 0              # the stages are the reference's
    w = {name: _t(a)[..., :n] if name in ("scores", "scaled", "exp", "p") else _t(a)
         for name, a in want.items()}
    qh = _t(q).bfloat16().transpose(1, 2)
    kh, vh = (attention._expand_kv(_t(c).bfloat16()[:, :n], h) for c in (ck, cv))
    counts = {}

    # sums in another order: held within a last-bit tolerance
    scores = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float())
    e = w["exp"]
    readout = torch.einsum("bhqk,bhkd->bhqd", w["p"], vh.float()).transpose(1, 2)
    for name, got in (("scores", scores), ("sum", e.sum(-1, keepdim=True)),
                      ("readout", readout)):
        counts[name] = _count(got, w[name])
        np.testing.assert_allclose(got.numpy(), w[name].numpy(), **_sum_tol(w[name]),
                                   err_msg=name)
    # the roundings the port copies: equal, each from the reference's inputs
    s = w["scaled"]
    after = {"scaled": w["scores"] * (1.0 / head_dim ** 0.5), "max": s.amax(-1, keepdim=True),
             "exp": ref.xla_exp_f32(ref.fma_f32(w["scores"], 1.0 / head_dim ** 0.5, -w["max"])),
             "p": e / w["sum"]}
    for name, got in after.items():
        assert _count(got, w[name]) == 0, name
    before = {"scaled": _count(w["scores"] / head_dim ** 0.5, w["scaled"]),
              "exp": _count(torch.exp(s - w["max"]), w["exp"]),
              "exp_unfused": _count(ref.xla_exp_f32(s - w["max"]), w["exp"]),
              "p": _count(torch.softmax(s, -1), w["p"])}
    assert before["exp"] + before["p"] > 0
    assert (before["scaled"] > 0) == (math.log2(head_dim) % 2 == 1)   # 1 / sqrt(D) inexact
    # the whole plain attention, and its layer over STEPS decode steps
    got = ref.flash_attention_ref(qh, kh, vh, causal=False).transpose(1, 2)
    np.testing.assert_allclose(got.float().numpy(), w["out"].numpy(), atol=0, rtol=2.0 ** -7)
    layer_after = _gqa_layer_mismatches(head_dim, None)
    layer_before = _gqa_layer_mismatches(head_dim, _flash_before)
    print(f"head_dim {head_dim}: stage mismatches {counts}, before the repair {before}; "
          f"layer outputs {layer_after} of {B * STEPS * cfg.d_model} (before {layer_before})")
    if head_dim == 16:
        assert layer_after == 0


def _gqa_layer_mismatches(head_dim, flash) -> int:
    """bfloat16 attention-layer outputs that differ from the jitted
    reference layer's over STEPS decode steps, each step on the reference's
    cache; ``flash`` replaces the port's attention when given."""
    ref_cfg, cfg, ref_p, p = _gqa(head_dim)
    x = jnp.asarray(np.random.default_rng(6).standard_normal((B, STEPS, cfg.d_model)),
                    jnp.bfloat16)
    block = jax.jit(ref_attention.attention_block, static_argnums=(3, 4))
    ref_cache, cache = ref_attention.init_kv_cache(ref_cfg, B, SMAX), attention.init_kv_cache(
        cfg, B, SMAX)
    kept = attention.flash_attention
    attention.flash_attention = flash or kept
    try:
        n = 0
        for t in range(STEPS):
            pos = np.full((B, 1), t, np.int32)
            cache.k.copy_(_t(ref_cache.k))
            cache.v.copy_(_t(ref_cache.v))
            want, ref_cache = block(ref_p, x[:, t:t + 1], jnp.asarray(pos), ref_cfg,
                                    RefLayerKind.ATTN, ref_cache)
            got, _ = attention.attention_block(p, _t(x[:, t:t + 1]).bfloat16(),
                                               torch.from_numpy(pos), cfg, LayerKind.ATTN,
                                               attention.KVCache(cache.k, cache.v, t))
            n += _count(got, want)
    finally:
        attention.flash_attention = kept
    return n


def _mla_decode_before(params, q_nope, q_rope, c_kv, k_rope, cfg):
    """The absorbed decode as it was: the two scores added in bfloat16."""
    m = cfg.mla
    h, r = cfg.num_heads, m.kv_lora_rank
    w_uk = params["w_uk"].view(r, h, m.nope_head_dim).permute(1, 2, 0)
    q_lat = (q_nope.transpose(0, 1) @ w_uk).transpose(0, 1)
    s = q_lat @ c_kv.transpose(1, 2) + q_rope @ k_rope.transpose(1, 2)
    p = torch.softmax(s.float() * (1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)), -1)
    w_uv = params["w_uv"].view(r, h, m.v_head_dim).transpose(0, 1)
    return ((p.to(c_kv.dtype) @ c_kv).transpose(0, 1) @ w_uv).transpose(0, 1)


def _mla_layer_mismatches(decode) -> int:
    ref_cfg, cfg = cases.configs("deepseek-v2-lite-16b")
    tree = jax.tree.map(np.asarray, ref_mla.init_mla_params(jax.random.PRNGKey(4), ref_cfg))
    shapes = mla.mla_shapes(cfg)
    ref_p = jax.tree.map(jnp.asarray, tree)
    p = {k: torch.from_numpy(v.copy()).reshape(shapes[k]).bfloat16() for k, v in tree.items()}
    x = jnp.asarray(np.random.default_rng(6).standard_normal((B, STEPS, cfg.d_model)),
                    jnp.bfloat16)
    block = jax.jit(ref_mla.mla_block, static_argnums=(3,))
    ref_cache, cache = ref_mla.init_mla_cache(ref_cfg, B, SMAX), mla.init_mla_cache(cfg, B, SMAX)
    kept = mla._decode
    mla._decode = decode or kept
    try:
        n = 0
        for t in range(STEPS):
            pos = np.full((B, 1), t, np.int32)
            cache.c_kv.copy_(_t(ref_cache.c_kv))
            cache.k_rope.copy_(_t(ref_cache.k_rope))
            want, ref_cache = block(ref_p, x[:, t:t + 1], jnp.asarray(pos), ref_cfg, ref_cache)
            got, _ = mla.mla_block(p, _t(x[:, t:t + 1]).bfloat16(), torch.from_numpy(pos), cfg,
                                   mla.MLACache(cache.c_kv, cache.k_rope, t))
            n += _count(got, want)
    finally:
        mla._decode = kept
    return n


def test_mla_decode_layer_equals_the_reference_layer():
    """The absorbed decode with the scores summed in float32: every bfloat16
    output of the layer equals the jitted reference's over 16 steps (before,
    summed in bfloat16: 2,167 of 4,096 differed)."""
    after, before = _mla_layer_mismatches(None), _mla_layer_mismatches(_mla_decode_before)
    print(f"MLA layer outputs differing over {STEPS} steps: {after} (before {before})")
    assert after == 0 < before


@pytest.mark.parametrize("name", ["yi-9b", "deepseek-v2-lite-16b"])
def test_first_decode_step_logits_equal_the_reference(name):
    """The whole bfloat16 model, one token per sequence from empty caches,
    for four token seeds: now that the residual stream is rounded where the
    reference's scan carries it, at most 1% of the logits differ from the
    jitted reference's, each by one bfloat16 step (a last-bit difference in
    a sum; seen: 0 of 4,096 for both), where before ~70% differed."""
    ref_m, params, ref_apply, port = cases.model_pair(name, port_init=True)
    differ = total = 0
    for seed in range(4):
        toks = cases.tokens(port.cfg.vocab_size, (2, 1), seed=31 + seed)
        want = np.asarray(ref_apply(params, jnp.asarray(toks), ref_m.init_caches(2, 4))[0])
        got, _ = cases.port_logits(port, toks, port.init_caches(2, 4))
        np.testing.assert_allclose(got, want, **cases.bf16_steps(want, 1))
        differ, total = differ + int((got != want).sum()), total + got.size
    print(f"{name}: {differ} of {total} first-step logits differ")
    assert differ <= total // 100
