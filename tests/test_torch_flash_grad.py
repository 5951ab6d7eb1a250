"""Gradients of the port's attention and of the XLA roundings it copies,
against the JAX package on the CPU.

- ``kernels/ref.py::xla_tanh_f32`` equals ``jax.jit(jnp.tanh)`` bit for bit
  (XLA:CPU's rational tanh, not libm's), and ``common.gelu`` and
  ``common.softcap`` equal the jitted reference's ``jax.nn.gelu`` and
  ``softcap`` bit for bit, in float32 and bfloat16;
- the differentiable forms of ``fma_f32``, ``xla_tanh_f32`` and
  ``xla_softmax_f32`` give the derivatives of what they round;
- the plain attention (the flash kernel's plain version, which on the CPU
  is what ``models/attention.py::_attend`` calls) differentiated by autograd
  against ``jax.grad`` of the reference's ``blockwise_attention``: causal,
  a sliding window and the softcap, with grouped-query heads (the KV
  expansion's ``repeat_interleave`` sums the expanded heads' gradients).

Tolerance for the gradients: within ``GRAD_TOL`` = 1e-5 of each gradient's
largest magnitude (the reference sums over chunks of 16 keys with online
rescaling, the port in one pass: the largest difference seen was 4.4e-7 of
it uncapped, 1.9e-6 with the cap biting at scores of +-150).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro.models import attention as ref_attention
from repro.models import common as ref_common
from repro_torch.kernels import flash_attention as port_flash
from repro_torch.kernels import ref
from repro_torch.models import attention, common

GRAD_TOL = 1e-5


# --------------------------------------------------------------------------
# XLA's float32 tanh, gelu and softcap
# --------------------------------------------------------------------------
def _bits_equal(got: torch.Tensor, want) -> int:
    """Number of outputs whose bits differ."""
    g = got.float().numpy().view(np.int32)
    w = np.asarray(want).astype(np.float32).view(np.int32)
    return int(np.sum(g != w))


def test_xla_tanh_equals_jitted_jnp_tanh_bitwise():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(0.0, 3.0, 1 << 16),
        rng.uniform(-0.0005, 0.0005, 1 << 12),          # the |x| < 0.0004 branch and its edge
        rng.uniform(-30.0, 30.0, 1 << 12),             # past the clamp at 7.9988
        [0.0, -0.0, 0.0004, -0.0004, 7.99881172180175781, 8.0, -8.0, 1e4, -1e4, 1e-30],
    ]).astype(np.float32)
    want = jax.jit(jnp.tanh)(x)
    assert _bits_equal(ref.xla_tanh_f32(torch.from_numpy(x)), want) == 0
    assert _bits_equal(torch.tanh(torch.from_numpy(x)), want) > 0.3 * x.size


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_and_softcap_equal_the_jitted_reference(dtype):
    rng = np.random.default_rng(1)
    x32 = (rng.standard_normal(1 << 15) * 3).astype(np.float32)
    xj = jnp.asarray(x32).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    assert _bits_equal(common.gelu(xt), jax.jit(jax.nn.gelu)(xj)) == 0
    if dtype == "float32":
        for cap in (30.0, 50.0):
            logits = jnp.asarray(x32 * 40)
            want = jax.jit(ref_common.softcap, static_argnums=1)(logits, cap)
            assert _bits_equal(common.softcap(torch.from_numpy(x32 * 40), cap), want) == 0


def test_rounded_forms_have_the_plain_derivatives():
    g = torch.Generator().manual_seed(2)
    a, b, c = (torch.randn(5, 7, generator=g, requires_grad=True) for _ in range(3))
    ref.fma_f32(a, b, c).sum().backward()
    assert torch.equal(a.grad, b.detach()) and torch.equal(b.grad, a.detach())
    assert torch.equal(c.grad, torch.ones_like(c))
    row = torch.randn(1, 7, generator=g, requires_grad=True)
    ref.fma_f32(2.0, row, a.detach()).sum().backward()          # broadcast, a number operand
    assert torch.equal(row.grad, torch.full((1, 7), 10.0))

    x = torch.randn(3, 9, generator=g, dtype=torch.float64).float().requires_grad_()
    y = ref.xla_tanh_f32(x)
    y.backward(torch.ones_like(y))
    torch.testing.assert_close(x.grad, 1 - torch.tanh(x.detach()) ** 2, atol=1e-6, rtol=1e-6)

    mask = torch.rand(3, 9, generator=g) > 0.3
    mask[:, 0] = True
    s = torch.randn(3, 9, generator=g, requires_grad=True)
    up = torch.randn(3, 9, generator=g)
    (ref.xla_softmax_f32(s, 0.5, mask) * up).sum().backward()
    s2 = s.detach().clone().requires_grad_()
    (torch.softmax(torch.where(mask, s2 * 0.5, -1e30), -1) * up).sum().backward()
    torch.testing.assert_close(s.grad, s2.grad, atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# the plain attention's gradients against jax.grad of blockwise_attention
# --------------------------------------------------------------------------
GRAD_CASES = [
    # (window, softcap, q scale)
    (0, 0.0, 1.0),
    (5, 0.0, 1.0),
    (0, 50.0, 30.0),       # the cap bites: scaled scores of std 30
    (16, 50.0, 30.0),
]


@pytest.mark.parametrize("window,cap,q_scale", GRAD_CASES)
def test_attend_gradients_match_jax_grad_of_blockwise(window, cap, q_scale):
    b, s, h, kvh, d = 2, 48, 4, 2, 16
    rng = np.random.default_rng(window + int(cap))
    q = (rng.standard_normal((b, s, h, d)) * q_scale).astype(np.float32)
    k, v = (rng.standard_normal((b, s, kvh, d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def ref_loss(q, k, v):
        out = ref_attention.blockwise_attention(q, k, v, window=window, attn_softcap=cap,
                                                q_chunk=16, kv_chunk=16)
        return jnp.sum(out * g)

    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = attention._attend(tq, tk, tv, causal=True, window=window, softcap=cap)
    out.backward(torch.from_numpy(g))
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, atol=GRAD_TOL * np.abs(w).max(), rtol=0,
                                   err_msg=name)


def test_flash_function_wires_forward_and_backward(monkeypatch):
    """The op ``repro_torch::flash_fwd`` under autograd (the kernels' path)
    computes the log-sum-exp where a gradient is wanted and hands its inputs,
    output and log-sum-exp, with the options, to ``repro_torch::flash_bwd``:
    here both implementations are stood in by the plain version."""
    calls = {}

    def fake_forward(q, k, v, causal, window, softcap, with_lse):
        calls["forward"] = (causal, window, softcap, with_lse)
        out = ref.flash_attention_ref(q, k, v, causal, window, softcap)
        return out, torch.zeros((q.shape[0] * q.shape[1], q.shape[2]))

    def fake_backward(q, k, v, out, lse, dout, causal, window, softcap):
        calls["backward"] = (causal, window, softcap, tuple(lse.shape))
        return ref.flash_attention_bwd_ref(q, k, v, dout, causal, window, softcap)

    monkeypatch.setattr(port_flash, "_plain_forward", fake_forward)
    monkeypatch.setattr(port_flash, "_plain_backward", fake_backward)
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 20, 16, generator=gen, requires_grad=True) for _ in range(3))
    out = port_flash.flash_attention(q, k, v, causal=True, window=7, softcap=20.0)
    out.sum().backward()
    assert calls == {"forward": (True, 7, 20.0, True), "backward": (True, 7, 20.0, (2, 20))}
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    ref.flash_attention_ref(q2, k2, v2, True, 7, 20.0).sum().backward()
    for got, want in ((q.grad, q2.grad), (k.grad, k2.grad), (v.grad, v2.grad)):
        assert torch.equal(got, want)
