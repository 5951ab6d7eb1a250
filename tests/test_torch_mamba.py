"""The Mamba mixer on the port (``repro_torch.models.mamba``) against the JAX
package's (``repro.models.mamba``) on the CPU, at jamba-1.5-large-398b-reduced's
widths (d_model 64, d_inner 128, d_state 8, d_conv 4), on the same weights
(the reference's ``init_mamba_params``) and inputs made by numpy from a seed.

Tolerance: float32 outputs and states within ``atol = rtol = 1e-5``
(tests/torch_lm_cases.py's ``F32_TOL``): the two sides sum their products
in other orders, and XLA:CPU contracts ``a * b + c`` into FMAs (the scan's
combine, the skip); the largest difference seen was 9.5e-7 (the chunked
scan).  bfloat16: within ``bf16_steps`` of the largest output (each product
is rounded to bfloat16, after sums in other orders); ``common.silu`` rounds
each of its operations as ``jax.nn.silu`` does, and equals it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.models import mamba as ref_mamba
from repro_torch.models import common, mamba

B = 2


def _pair(dtype: str = "float32", seed: int = 0):
    """(reference config, port config, reference params as numpy, the port's
    params on the same values: the ``FLOAT32`` tensors float32, the
    projections in ``dtype``)."""
    ref_cfg, cfg = cases.configs("jamba-1.5-large-398b", dtype)
    tree = jax.tree.map(np.asarray, ref_mamba.init_mamba_params(jax.random.PRNGKey(seed),
                                                                ref_cfg))
    # a non-zero conv bias, so that it is tested (the init's is zero)
    tree["conv_b"] = np.random.default_rng(seed).standard_normal(tree["conv_b"].shape).astype(
        np.float32) * 0.1
    port = {k: torch.from_numpy(np.array(v)).to(torch.float32 if k in mamba.FLOAT32
                                                else getattr(torch, dtype))
            for k, v in tree.items()}
    return ref_cfg, cfg, tree, port


def _x(shape, seed=1, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(tol or cases.F32_TOL))


def test_forward_matches_reference():
    """One chunk: S = 32 < MAMBA_CHUNK."""
    ref_cfg, cfg, tree, params = _pair()
    x = _x((B, 32, cfg.d_model))
    want, _ = jax.jit(lambda p, x: ref_mamba.mamba_block(p, x, ref_cfg))(tree, x)
    got, state = mamba.mamba_block(params, torch.from_numpy(x), cfg)
    assert state is None and got.dtype == torch.float32
    _close(got, want)


def test_forward_bfloat16_within_bf16_steps():
    ref_cfg, cfg, tree, params = _pair("bfloat16")
    x = _x((B, 32, cfg.d_model))
    want, _ = jax.jit(lambda p, x: ref_mamba.mamba_block(p, x.astype(jnp.bfloat16), ref_cfg))(
        tree, x)
    got, _ = mamba.mamba_block(params, torch.from_numpy(x).bfloat16(), cfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    _close(got, want, **cases.bf16_steps(want))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_silu_rounds_as_jax_nn_silu(dtype):
    """bfloat16: every output equal (``F.silu`` differs in ~37%); float32
    within a unit in the last place or two (XLA's exp is not torch's)."""
    x = jnp.asarray(_x((1 << 16,)) * 6).astype(dtype)
    want = np.asarray(jax.jit(jax.nn.silu)(x).astype(jnp.float32))
    got = common.silu(torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype)))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-30)


@pytest.mark.parametrize("s", [16, 12, 7])
def test_selective_scan_across_chunks_matches_reference(s):
    """Chunks of 4 (S = 16: four; 12: three) carry the state from chunk to
    chunk; S = 7 is one chunk of odd length (the odd branch of the
    recursion).  a_bar in (0.5, 1), as a decaying state has."""
    rng = np.random.default_rng(s)
    d_in, n = 8, 4
    a_bar = rng.uniform(0.5, 1.0, (B, s, d_in, n)).astype(np.float32)
    bx, c, h0 = (rng.standard_normal(shape).astype(np.float32)
                 for shape in ((B, s, d_in, n), (B, s, n), (B, d_in, n)))
    chunk = 4 if s % 4 == 0 else s
    want_y, want_h = jax.jit(lambda *t: ref_mamba._selective_scan(*t, chunk))(a_bar, bx, c, h0)
    got_y, got_h = mamba._selective_scan(*map(torch.from_numpy, (a_bar, bx, c, h0)), chunk)
    _close(got_y, want_y)
    _close(got_h, want_h)
    with pytest.raises(ValueError, match="not a multiple of the chunk"):
        mamba._selective_scan(*map(torch.from_numpy, (a_bar, bx, c, h0)), 5)


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_associative_scan_is_the_inclusive_scan(n):
    """The odd/even recursion computes h_t = a_t h_{t-1} + b_t (float64, so
    that the order cannot show)."""
    rng = np.random.default_rng(n)
    a, b = (torch.from_numpy(rng.standard_normal((2, n, 3))) for _ in range(2))
    got_a, got_b = mamba._associative_scan(a, b)
    h, prod = torch.zeros(2, 3, dtype=torch.float64), torch.ones(2, 3, dtype=torch.float64)
    for t in range(n):
        h, prod = a[:, t] * h + b[:, t], prod * a[:, t]
        torch.testing.assert_close(got_b[:, t], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(got_a[:, t], prod, rtol=1e-12, atol=1e-12)


def _decode_both(ref_cfg, cfg, tree, params, x, ref_state, state, steps):
    step = jax.jit(lambda p, x, st: ref_mamba.mamba_block(p, x, ref_cfg, st))
    for t in range(steps):
        want, ref_state = step(tree, x[:, t:t + 1], ref_state)
        got, state = mamba.mamba_block(params, torch.from_numpy(x[:, t:t + 1]), cfg, state)
        _close(got, want)
        _close(state.conv, ref_state.conv)
        _close(state.ssm, ref_state.ssm)
        assert state.index == int(ref_state.index)
    return ref_state, state


def test_decode_steps_match_reference():
    ref_cfg, cfg, tree, params = _pair()
    x = _x((B, 12, cfg.d_model))
    state = mamba.init_mamba_state(cfg, B)
    given = (state.conv.clone(), state.ssm.clone())
    _, last = _decode_both(ref_cfg, cfg, tree, params, x, ref_mamba.init_mamba_state(ref_cfg, B),
                           state, 12)
    assert last.index == 12
    assert torch.equal(state.conv, given[0]) and torch.equal(state.ssm, given[1])  # not changed


def test_state_stays_float32_under_bfloat16():
    _, cfg, _, params = _pair("bfloat16")
    state = mamba.init_mamba_state(cfg, B)
    assert state.conv.dtype == state.ssm.dtype == torch.float32
    assert state.conv.shape == (B, 3, 128) and state.ssm.shape == (B, 128, 8)
    x = torch.from_numpy(_x((B, 3, cfg.d_model))).bfloat16()
    out, state = mamba.mamba_block(params, x, cfg, state)                  # prefill
    assert out.dtype == torch.bfloat16
    assert state.conv.dtype == state.ssm.dtype == torch.float32
    out, state = mamba.mamba_block(params, x[:, :1], cfg, state)           # decode
    assert out.dtype == torch.bfloat16 and state.index == 4
    assert state.conv.dtype == state.ssm.dtype == torch.float32


def test_prefill_at_nonzero_index_raises():
    _, cfg, _, params = _pair()
    state = dataclasses.replace(mamba.init_mamba_state(cfg, B), index=3)
    with pytest.raises(NotImplementedError, match="at index 3"):
        mamba.mamba_block(params, torch.from_numpy(_x((B, 4, cfg.d_model))), cfg, state)


def test_prefill_of_three_then_decode_matches_reference():
    """Prefill of d_conv - 1 = 3 tokens into a fresh state, then decode: the
    reference keeps the last three inputs as its conv state, as the port."""
    ref_cfg, cfg, tree, params = _pair()
    x = _x((B, 9, cfg.d_model))
    want, ref_state = jax.jit(lambda p, x, st: ref_mamba.mamba_block(p, x, ref_cfg, st))(
        tree, x[:, :3], ref_mamba.init_mamba_state(ref_cfg, B))
    got, state = mamba.mamba_block(params, torch.from_numpy(x[:, :3]), cfg,
                                   mamba.init_mamba_state(cfg, B))
    _close(got, want)
    _close(state.conv, ref_state.conv)
    _close(state.ssm, ref_state.ssm)
    assert state.index == 3
    _decode_both(ref_cfg, cfg, tree, params, x[:, 3:], ref_state, state, 6)


def test_prefill_of_two_then_decode_equals_token_by_token():
    """Prefill of 2 tokens (fewer than d_conv - 1: the reference's state
    would hold 2 conv rows and its next decode step fails), then decode:
    the port equals its own run of one token at a time."""
    _, cfg, _, params = _pair()
    x = torch.from_numpy(_x((B, 6, cfg.d_model)))
    out, state = mamba.mamba_block(params, x[:, :2], cfg, mamba.init_mamba_state(cfg, B))
    assert state.conv.shape == (B, 3, 128)
    outs = [out]
    for t in range(2, 6):
        out, state = mamba.mamba_block(params, x[:, t:t + 1], cfg, state)
        outs.append(out)
    one = mamba.init_mamba_state(cfg, B)
    singles = []
    for t in range(6):
        out, one = mamba.mamba_block(params, x[:, t:t + 1], cfg, one)
        singles.append(out)
    torch.testing.assert_close(torch.cat(outs, 1), torch.cat(singles, 1), **cases.F32_TOL)
    torch.testing.assert_close(state.ssm, one.ssm, **cases.F32_TOL)
    torch.testing.assert_close(state.conv, one.conv, **cases.F32_TOL)
