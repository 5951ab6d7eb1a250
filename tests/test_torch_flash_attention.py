"""The port's flash attention against the reference: on CPU tensors the
wrapper runs its plain version, which must match JAX ``flash_attention_ref``
and ``flash_attention_pallas(interpret=True)`` on the same numpy inputs, at
the shapes and tolerances of tests/test_flash_attention.py (float32
``atol=2e-5, rtol=1e-5``; bfloat16 ``3e-2``).  The ``gpu`` cases hold the
CUDA kernel against its plain version on a card (every head width, both
dtypes, Sq above and below Skv, ragged tiles, more blocks than SMs, peaked
scores, two calls bitwise equal; gemma2's sliding window and softcap) and
skip here.  JAX is imported by a
fixture, so the ``gpu`` cases also run where JAX is not installed:

    python -m pytest -m gpu tests/test_torch_flash_attention.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as port_flash
from repro_torch.kernels import ref

CASES = [
    # b, h, sq, skv, d, reference block sizes (bq, bk)
    (2, 4, 64, 64, 32, 16, 16),
    (1, 2, 128, 128, 16, 32, 64),
    (1, 1, 96, 96, 64, 32, 32),
    (2, 2, 64, 64, 32, 64, 64),
    (1, 8, 256, 256, 32, 64, 32),
    (1, 2, 64, 128, 32, 32, 32),      # Sq != Skv: the mask counts both from 0
    (1, 2, 128, 64, 16, 32, 32),
]


@pytest.fixture(scope="module")
def reference():
    """(jax.numpy, JAX flash_attention_ref, flash_attention_pallas)."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.kernels.ref import flash_attention_ref
    return jnp, flash_attention_ref, flash_attention_pallas


def _qkv(seed, b, h, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, sq, d)).astype(np.float32),
            rng.standard_normal((b, h, skv, d)).astype(np.float32),
            rng.standard_normal((b, h, skv, d)).astype(np.float32))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:5])))
@pytest.mark.parametrize("causal", [True, False])
def test_float32_matches_reference_and_pallas(case, causal, reference):
    jnp, jax_flash_attention_ref, flash_attention_pallas = reference
    b, h, sq, skv, d, bq, bk = case
    q, k, v = _qkv(b * 100 + sq + skv + causal, b, h, sq, skv, d)
    got = port_flash.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, h, sq, d)
    want = np.asarray(jax_flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              causal=causal))
    pallas = np.asarray(flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               causal=causal, block_q=bq, block_k=bk,
                                               interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_bfloat16_matches_reference_and_pallas(causal, reference):
    jnp, jax_flash_attention_ref, flash_attention_pallas = reference
    q, k, v = _qkv(3, 1, 2, 64, 64, 32)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    # The same bf16 values on both sides: round on the JAX side, widen exactly.
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
                  for x in (jq, jk, jv))
    got = port_flash.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jax_flash_attention_ref(jq, jk, jv, causal=causal), np.float32)
    pallas = np.asarray(flash_attention_pallas(jq, jk, jv, causal=causal, block_q=32,
                                               block_k=32, interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got.float().numpy(), pallas, atol=3e-2, rtol=3e-2)


def test_causal_first_row_sees_only_position_zero():
    """Row 0 attends to key 0 alone, so its output is v[..., 0, :]."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(5, 1, 2, 32, 48, 16))
    out = port_flash.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(out[:, :, 0], v[:, :, 0], atol=0, rtol=0)
    assert not torch.equal(out, port_flash.flash_attention(q, k, v, causal=False))


def test_wrapper_validates_inputs():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 2, 16, 16, 16))
    with pytest.raises(ValueError):
        port_flash.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError):
        port_flash.flash_attention(q, k[:, :1], v[:, :1])
    with pytest.raises(ValueError):
        port_flash.flash_attention(q, k[..., :8], v[..., :8])
    with pytest.raises(TypeError):
        port_flash.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        port_flash.flash_attention(q, k.to(torch.bfloat16), v)
    before = port_flash.launches
    port_flash.flash_attention(q, k, v)
    assert port_flash.launches == before, "a CPU call is not a kernel launch"


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: compares the CUDA kernel with its plain version")
    torch.backends.cuda.matmul.allow_tf32 = False    # the plain version in full float32
    return torch.device("cuda", 0)


# float32: the reference test's tolerance; bfloat16: one bfloat16 ulp (both
# sides round float32 results that differ by ~1e-6), at most 2**-7 of the value.
ON_CARD_TOL = [(torch.float32, 2e-5, 1e-5), (torch.bfloat16, 1e-5, 2.0 ** -7)]
# (B, H, Sq, Skv, D).  The bfloat16 kernel's tiles are 128 query rows and
# 128 keys, the float32 kernel's 64 and 128.
ON_CARD_SHAPES = [
    (1, 4, 256, 256, 128),
    (2, 3, 200, 328, 64),
    (1, 2, 130, 70, 16),
    (1, 2, 256, 256, 16),        # every head width
    (1, 2, 256, 256, 32),
    (1, 2, 256, 256, 64),
    (1, 2, 384, 200, 64),        # Sq > Skv
    (1, 2, 200, 384, 128),       # Sq < Skv
    (1, 3, 77, 141, 128),        # ragged: neither a multiple of a tile
    (2, 1, 1, 1, 32),
    (1, 1, 129, 257, 16),
    (4, 40, 256, 256, 128),      # B * H = 160 blocks a query tile, over the 132 SMs
    (4, 32, 1, 17, 128),         # decode: one query against a cache prefix (yi-9b)
    (4, 32, 1, 31, 128),
    (2, 8, 1, 9, 16),
]


def _on_card(shape, dtype, device, q_scale=1.0):
    b, h, sq, skv, d = shape
    q, k, v = _qkv(7, b, h, sq, skv, d)
    return [torch.from_numpy(x).to(device, dtype) for x in (q * q_scale, k, v)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", ON_CARD_TOL)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", ON_CARD_SHAPES, ids=lambda c: "x".join(map(str, c)))
def test_kernel_matches_plain_on_card(shape, causal, dtype, atol, rtol, cuda_device):
    q, k, v = _on_card(shape, dtype, cuda_device)
    before = port_flash.launches
    got = port_flash.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert port_flash.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", ON_CARD_TOL)
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_peaked_scores_on_card(causal, dtype, atol, rtol, cuda_device):
    """q scaled by 8: a few keys take most of each row's weight, so the
    running max moves late and the small probabilities (bfloat16: P's low
    half) must still add up."""
    q, k, v = _on_card((1, 4, 512, 512, 128), dtype, cuda_device, q_scale=8.0)
    got = port_flash.flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_deterministic_on_card(dtype, cuda_device):
    """No split over keys and no atomics: two calls give the same bits."""
    q, k, v = _on_card((1, 8, 640, 640, 128), dtype, cuda_device)
    first = port_flash.flash_attention(q, k, v, causal=True)
    assert torch.equal(first, port_flash.flash_attention(q, k, v, causal=True))


# gemma2's options (B, H, Sq, Skv, D), window, softcap: windows inside one
# tile, on a tile edge, across it, wider than the keys; the softcap with and
# without a window, at the decode shape (full attention) and on ragged tiles.
# With the softcap, q is scaled by 30, so that scaled scores span about
# +-150 and the cap of 50 bites.
ON_CARD_GEMMA2 = [
    ((1, 3, 640, 640, 128), 100, 0.0),
    ((1, 3, 640, 640, 128), 4097, 0.0),
    ((1, 3, 640, 640, 64), 128, 0.0),
    ((1, 3, 640, 640, 32), 129, 50.0),
    ((1, 3, 640, 640, 16), 1, 50.0),
    ((1, 3, 640, 640, 128), 100, 50.0),
    ((1, 3, 640, 640, 128), 0, 50.0),
    ((2, 3, 77, 141, 128), 50, 50.0),        # Sq < Skv, ragged
    ((4, 32, 1, 31, 128), 0, 50.0),          # gemma2 decode
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", ON_CARD_TOL)
@pytest.mark.parametrize("shape,window,softcap", ON_CARD_GEMMA2,
                         ids=lambda c: "x".join(map(str, c)) if isinstance(c, tuple) else str(c))
def test_kernel_window_softcap_on_card(shape, window, softcap, dtype, atol, rtol, cuda_device):
    causal = shape[2] > 1
    q, k, v = _on_card(shape, dtype, cuda_device, q_scale=30.0 if softcap else 1.0)
    before = port_flash.launches
    got = port_flash.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert port_flash.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


@pytest.mark.gpu
def test_kernel_without_keys_on_card(cuda_device):
    """Skv = 0: every row's sum is empty, so the output is zeros, as the
    plain version's; nothing is launched."""
    q, k, v = _on_card((1, 2, 5, 0, 32), torch.bfloat16, cuda_device)
    before = port_flash.launches
    got = port_flash.flash_attention(q, k, v, causal=False)
    assert port_flash.launches == before
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, causal=False))

