"""The port's multi-head latent attention (``repro_torch.models.mla``)
against the JAX package's ``repro.models.mla.mla_block`` on the CPU, for
both reduced deepseek-v2 configs (lite: queries from ``w_q``; 236b: the
low-rank ``w_dq`` -> ``w_uq`` queries), in float32 and bfloat16: the forward
without a cache, prefill into an empty cache, prefill at a non-zero index
(queries at ``cache.index`` onwards over the whole cache, causally), and
decode token by token in the absorbed form, with the cache's contents; the
absorbed decode against the expanded attention; the cache's layout.

Tolerances: float32 ``atol = rtol = 1e-5`` (tests/torch_lm_cases.py's; the
reference's prefill is a chunked online softmax over chunks of 16, the
port's a single pass); bfloat16 within ``cases.bf16_steps`` (4 bfloat16
steps of the binade of the largest reference output; the attention's float32
results round to bfloat16 at every projection).  The caches hold bfloat16 on
both sides: equal up to the bfloat16 rounding of float32 keys that differ in
their last bits (``rtol = 2**-7``).  Lengths are multiples of the reduced
configs' chunk of 16, as the reference's prefill asserts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.models import mla as ref_mla
from repro_torch.models import mla

ref_mla_block = jax.jit(ref_mla.mla_block, static_argnums=(3,))
DTYPES = ["float32", "bfloat16"]


def _pair(name, dtype, seed=4):
    """(reference cfg, port cfg, reference params, port params)."""
    ref_cfg, cfg = cases.configs(name, dtype)
    tree = jax.tree.map(np.asarray, ref_mla.init_mla_params(jax.random.PRNGKey(seed), ref_cfg))
    shapes = mla.mla_shapes(cfg)
    assert set(tree) == set(shapes)
    tdt = getattr(torch, dtype)
    return ref_cfg, cfg, jax.tree.map(jnp.asarray, tree), {
        k: torch.from_numpy(np.array(v)).reshape(shapes[k]).to(tdt) for k, v in tree.items()}


def _x(cfg, shape, seed):
    """Inputs in the config's dtype, equal on both sides."""
    x = np.random.default_rng(seed).standard_normal((*shape, cfg.d_model)).astype(np.float32)
    jdt = jnp.dtype(cfg.dtype)
    return jnp.asarray(x, jdt), torch.from_numpy(np.asarray(jnp.asarray(x, jdt), np.float32)).to(
        getattr(torch, cfg.dtype))


def _pos(b, start, s):
    pos = np.broadcast_to(np.arange(start, start + s, dtype=np.int32), (b, s))
    return jnp.asarray(pos), torch.from_numpy(pos.copy()).long()


def _close(got, want, dtype):
    want = np.asarray(want, np.float32)
    tol = cases.F32_TOL if dtype == "float32" else cases.bf16_steps(want)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def _cache_close(cache, ref_cache, n):
    assert cache.index == int(ref_cache.index) == n
    for got, want in ((cache.c_kv, ref_cache.c_kv), (cache.k_rope, ref_cache.k_rope)):
        assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0,
                                   rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", cases.DEEPSEEK)
def test_mla_block_without_cache(name, dtype):
    ref_cfg, cfg, ref_p, p = _pair(name, dtype)
    jx, tx = _x(cfg, (2, 32), seed=5)
    jpos, tpos = _pos(2, 0, 32)
    want, _ = ref_mla_block(ref_p, jx, jpos, ref_cfg)
    got, cache = mla.mla_block(p, tx, tpos, cfg)
    assert cache is None and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", cases.DEEPSEEK)
def test_mla_prefill_prefill_at_an_index_then_decode(name, dtype):
    """16 tokens into an empty cache of 48, 16 more at index 16 (queries at
    positions 16-31 over the cache's 32 keys), then 10 decode steps."""
    ref_cfg, cfg, ref_p, p = _pair(name, dtype)
    jx, tx = _x(cfg, (2, 42), seed=6)
    ref_cache = ref_mla.init_mla_cache(ref_cfg, 2, 48)
    cache = mla.init_mla_cache(cfg, 2, 48)
    for lo, hi in [(0, 16), (16, 32)] + [(t, t + 1) for t in range(32, 42)]:
        jpos, tpos = _pos(2, lo, hi - lo)
        want, ref_cache = ref_mla_block(ref_p, jx[:, lo:hi], jpos, ref_cfg, ref_cache)
        got, cache = mla.mla_block(p, tx[:, lo:hi], tpos, cfg, cache)
        _close(got, want, dtype)
        _cache_close(cache, ref_cache, hi)


@pytest.mark.parametrize("name", cases.DEEPSEEK)
def test_mla_decode_from_the_first_token(name):
    """Decode only, from an empty cache: every step the absorbed form."""
    ref_cfg, cfg, ref_p, p = _pair(name, "float32", seed=7)
    jx, tx = _x(cfg, (3, 12), seed=7)
    ref_cache, cache = ref_mla.init_mla_cache(ref_cfg, 3, 16), mla.init_mla_cache(cfg, 3, 16)
    for t in range(12):
        jpos, tpos = _pos(3, t, 1)
        want, ref_cache = ref_mla_block(ref_p, jx[:, t:t + 1], jpos, ref_cfg, ref_cache)
        got, cache = mla.mla_block(p, tx[:, t:t + 1], tpos, cfg, cache)
        _close(got, want, "float32")
    _cache_close(cache, ref_cache, 12)


@pytest.mark.parametrize("name", cases.DEEPSEEK)
def test_absorbed_decode_equals_expanded_attention(name):
    """The absorbed form (scores and readout in latent space) is the expanded
    attention's last row, reassociated: equal within float32 tolerance."""
    _, cfg, _, p = _pair(name, "float32", seed=8)
    m = cfg.mla
    rng = np.random.default_rng(8)
    q_nope, q_rope = (torch.from_numpy(rng.standard_normal((2, cfg.num_heads, d)).astype(np.float32))
                      for d in (m.nope_head_dim, m.rope_head_dim))
    c_kv, k_rope = (torch.from_numpy(rng.standard_normal((2, 9, d)).astype(np.float32))
                    for d in (m.kv_lora_rank, m.rope_head_dim))
    got = mla._decode(p, q_nope, q_rope, c_kv, k_rope, cfg)
    h = cfg.num_heads
    k_nope = (c_kv @ p["w_uk"]).view(2, 9, h, m.nope_head_dim)
    v = (c_kv @ p["w_uv"]).view(2, 9, h, m.v_head_dim)
    k = torch.cat([k_nope, k_rope[:, :, None].expand(2, 9, h, m.rope_head_dim)], -1)
    q = torch.cat([q_nope, q_rope], -1)[:, None]
    want = mla._attend(q, k, v, q_offset=8)[:, 0]
    torch.testing.assert_close(got, want, **cases.F32_TOL)


def test_cache_layout_matches_reference():
    ref_cfg, cfg = cases.configs("deepseek-v2-lite-16b")
    want = ref_mla.init_mla_cache(ref_cfg, 3, 20)
    got = mla.init_mla_cache(cfg, 3, 20)
    assert got.c_kv.shape == tuple(want.c_kv.shape) and got.k_rope.shape == tuple(
        want.k_rope.shape)
    assert got.c_kv.dtype == got.k_rope.dtype == torch.bfloat16 and got.index == 0
    assert mla.init_mla_cache(cfg, 1, 4, torch.float32).c_kv.dtype == torch.float32
