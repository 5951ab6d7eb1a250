"""The port's static-capacity MoE (``repro_torch.models.moe``) against the
JAX package's ``repro.models.moe.moe_block`` on the CPU, on identical inputs
and weights: the outputs, the three aux terms, the experts each token picks
and the capacity drops; tests/test_mixers_oracle.py's cases (capacity factor
8.0 with no drops, 0.5 with drops, an unused expert changes nothing); a
router tie, which both sides break towards the lower expert index; and a
hypothesis property over (tokens, experts, top-k, capacity factor).

Tolerances: float32 outputs and aux terms within ``atol = rtol = 1e-5``
(tests/torch_lm_cases.py's; the two sides sum the k gated expert rows and
the shared experts' products in other orders); the experts picked and
``fraction_dropped`` equal.  bfloat16 outputs within ``cases.bf16_steps``
(4 bfloat16 steps of the binade of the largest reference output): the
experts' silu (``common.silu``) rounds ``exp(-x)``, ``1 + exp(-x)``, its
reciprocal and the product each to bfloat16 as the reference's
``jax.nn.silu`` does, but the two sides sum the gated expert rows in other
orders.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from hypothesis_compat import given, settings, st
from repro.models import moe as ref_moe
from repro.models.config import MoeConfig as RefMoeConfig
from repro_torch.models import moe
from repro_torch.models.config import MoeConfig

ref_moe_block = jax.jit(ref_moe.moe_block, static_argnums=(2,))


def _configs(**kw):
    return RefMoeConfig(**kw), MoeConfig(**kw)


def _weights(ref_cfg, d, seed=0):
    """The reference's float32 weights as numpy."""
    return jax.tree.map(np.asarray, ref_moe.init_moe_params(jax.random.PRNGKey(seed), d, ref_cfg))


def _port_params(tree, dtype):
    """The port's layout: the router stays float32, the rest in ``dtype``."""
    out = {}
    for name, w in tree.items():
        if isinstance(w, dict):
            out[name] = {k: torch.from_numpy(np.array(v)).to(dtype) for k, v in w.items()}
        else:
            out[name] = torch.from_numpy(np.array(w)).to(torch.float32 if name == "router"
                                                         else dtype)
    return out


def _ref_choices(tree, x, k):
    """The reference's experts for each token, from its own expressions."""
    xt = jnp.asarray(x, jnp.float32).reshape(-1, x.shape[-1])
    logits = jnp.einsum("td,de->te", xt, jnp.asarray(tree["router"]))
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)[1])


def _run(ref_cfg, cfg, tree, x, dtype):
    """(reference out, aux; port out, aux, experts) on the same inputs."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    want, want_aux = ref_moe_block(jax.tree.map(jnp.asarray, tree), jnp.asarray(x, jdt), ref_cfg)
    seen = []
    route = moe.route

    def spy(logits, moe_cfg, cap):
        r = route(logits, moe_cfg, cap)
        seen.append(r[3])
        return r

    moe.route = spy
    try:
        got, aux = moe.moe_block(_port_params(tree, dtype), torch.from_numpy(x).to(dtype), cfg)
    finally:
        moe.route = route
    return want, want_aux, got, aux, seen[0].numpy()


def _check(want, want_aux, got, aux, dtype, choices):
    want = np.asarray(want, np.float32)
    tol = cases.F32_TOL if dtype == torch.float32 else cases.bf16_steps(want)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    for key in ("aux_loss", "z_loss", "fraction_dropped"):
        np.testing.assert_allclose(float(aux[key]), float(want_aux[key]), **cases.F32_TOL)
    # the same count of dropped choices (the reference's mean sums in its own
    # order: -2.98e-8 where every one of 12 choices is kept)
    assert round(float(aux["fraction_dropped"]) * choices) == \
        round(float(want_aux["fraction_dropped"]) * choices)


# --------------------------------------------------------------------------
# tests/test_mixers_oracle.py's cases, against the reference
# --------------------------------------------------------------------------
CASES = {   # capacity factor, shared experts
    "no_drops": (8.0, 0),
    "drops": (0.5, 0),
    "default_capacity_shared": (1.25, 2),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES.values(), ids=CASES.keys())
def test_moe_block_matches_reference(case, dtype):
    cap_factor, shared = case
    ref_cfg, cfg = _configs(num_experts=8, top_k=2, d_expert=24, capacity_factor=cap_factor,
                            num_shared=shared)
    tree = _weights(ref_cfg, 16)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 16, 16), jnp.float32))
    if dtype == torch.bfloat16:        # the same bfloat16 inputs on both sides
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want, want_aux, got, aux, experts = _run(ref_cfg, cfg, tree, x, dtype)
    _check(want, want_aux, got, aux, dtype, 64)
    np.testing.assert_array_equal(experts, _ref_choices(tree, x, 2))
    dropped = float(aux["fraction_dropped"])
    if cap_factor == 8.0:
        assert dropped == 0.0
    elif cap_factor == 0.5:            # capacity 4 of 8 tokens' loads: some drop
        assert 0.0 < dropped < 1.0


def test_output_depends_only_on_selected_experts():
    """Perturbing an expert no token routed to changes no output bit (four
    tokens: at most eight of the eight experts' slots are taken)."""
    ref_cfg, cfg = _configs(num_experts=8, top_k=2, d_expert=24, capacity_factor=8.0)
    tree = _weights(ref_cfg, 16)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 4, 16), jnp.float32))
    used = set(_ref_choices(tree, x, 2).ravel().tolist())
    unused = [e for e in range(8) if e not in used]
    assert unused, "every expert used: the case tests nothing"
    params = _port_params(tree, torch.float32)
    out1, _ = moe.moe_block(params, torch.from_numpy(x), cfg)
    for name in ("w_gate", "w_up", "w_down"):
        params[name][unused[0]] = 999.0
    out2, _ = moe.moe_block(params, torch.from_numpy(x), cfg)
    assert torch.equal(out1, out2)


def test_capacity_matches_reference():
    for tokens in (1, 2, 4, 7, 32, 132, 4096):
        for e, k, f in ((8, 2, 1.25), (64, 6, 1.25), (160, 6, 1.25), (4, 2, 0.5), (8, 2, 8.0)):
            ref_cfg, cfg = _configs(num_experts=e, top_k=k, d_expert=8, capacity_factor=f)
            assert moe._capacity(tokens, cfg) == ref_moe._capacity(tokens, ref_cfg)
    # deepseek-v2-lite at decode (4 tokens): int(4*6*1.25/64) = 0, raised to 4
    assert moe._capacity(4, MoeConfig(num_experts=64, top_k=6, d_expert=8)) == 4


# --------------------------------------------------------------------------
# ties, slots
# --------------------------------------------------------------------------
@pytest.mark.parametrize("scales,want", [
    ((0.1, 0.9, 0.3, 0.5, 0.2, 0.5, 0.0, 0.4), [1, 3]),     # 3 and 5 tie for second
    ((0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5), [0, 1]),     # every expert ties
    ((0.0, 0.2, 0.7, 0.2, 0.7, 0.2, 0.1, 0.7), [2, 4]),     # three tie for first
], ids=["second_place", "all", "first_place"])
def test_router_tie_picks_the_lower_expert_index(scales, want):
    """Router columns that are multiples of one positive vector, on positive
    inputs: equal scales give bit-equal logits, so a real tie.  Both sides
    pick the lower expert index first (``jax.lax.top_k``'s order)."""
    ref_cfg, cfg = _configs(num_experts=8, top_k=2, d_expert=8, capacity_factor=8.0)
    tree = _weights(ref_cfg, 16, seed=3)
    u = np.linspace(0.5, 1.5, 16, dtype=np.float32)
    tree["router"] = (u[:, None] * np.asarray(scales, np.float32)[None, :]).astype(np.float32)
    x = np.abs(np.random.default_rng(3).standard_normal((1, 6, 16))).astype(np.float32)
    want_out, want_aux, got, aux, experts = _run(ref_cfg, cfg, tree, x, torch.float32)
    np.testing.assert_array_equal(_ref_choices(tree, x, 2), [want] * 6)
    np.testing.assert_array_equal(experts, [want] * 6)
    _check(want_out, want_aux, got, aux, torch.float32, 12)


def test_slots_are_numbered_choice_major():
    """Even tokens pick experts (0, 1), odd tokens (1, 0); capacity 4.  Slots
    go to every token's choice 0 first, then to choice 1: each expert fills
    with its four choice-0 tokens and drops every choice 1 (a token-major
    order would keep tokens 0-3's both choices instead)."""
    cfg = MoeConfig(num_experts=8, top_k=2, d_expert=8)
    logits = torch.tensor([[3.0, 2.0] + [0.0] * 6, [2.0, 3.0] + [0.0] * 6] * 4)
    probs, sel, gate, experts, slot, kept = moe.route(logits, cfg, 4)
    assert experts.tolist() == [[0, 1], [1, 0]] * 4
    assert slot.tolist() == [[t // 2, 4 + t // 2] for t in range(8)]
    assert kept.tolist() == [[True, False]] * 8
    assert not gate[:, 1].any() and torch.all(gate[:, 0] > 0)
    assert sel.sum().item() == 16


# --------------------------------------------------------------------------
# property
# --------------------------------------------------------------------------
@given(st.integers(1, 24), st.sampled_from([(4, 1), (4, 2), (8, 2), (8, 3), (16, 6)]),
       st.sampled_from([0.25, 0.5, 1.0, 1.25, 8.0]), st.integers(0, 2 ** 16))
@settings(max_examples=15, deadline=None)
def test_property_matches_reference(tokens, experts, cap_factor, seed):
    """Over tokens, experts, top-k and capacity factor: the same experts, the
    same drops, outputs and aux terms within float32 tolerance."""
    e, k = experts
    ref_cfg, cfg = _configs(num_experts=e, top_k=k, d_expert=8, capacity_factor=cap_factor,
                            num_shared=1)
    tree = _weights(ref_cfg, 8, seed=seed % 7)
    x = np.random.default_rng(seed).standard_normal((1, tokens, 8)).astype(np.float32)
    want, want_aux, got, aux, got_e = _run(ref_cfg, cfg, tree, x, torch.float32)
    _check(want, want_aux, got, aux, torch.float32, tokens * k)
    np.testing.assert_array_equal(got_e, _ref_choices(tree, x, k))


def test_moe_config_fields_match_reference():
    assert dataclasses.asdict(MoeConfig(num_experts=4, top_k=2, d_expert=8)) == \
        dataclasses.asdict(RefMoeConfig(num_experts=4, top_k=2, d_expert=8))
