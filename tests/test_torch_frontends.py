"""The two stub-frontend backbones on the port against the JAX package on
the CPU: qwen2-vl-7b (M-RoPE over three position streams, qkv biases) and
musicgen-large (sinusoidal positions added to the inputs, a plain GeLU MLP),
both reduced, whose inputs are precomputed embeddings (B, S, d_model):
``common.apply_mrope`` and ``sinusoidal_embedding``; ``LMModel.apply`` on
embeddings (with a 4 x 4 patch grid's (t, h, w) positions for qwen2-vl);
a prefill of embeddings into the caches followed by token-id decode (the
default positions: the caches' index on all three streams); weights carried
across with ``params_from_reference``; the configs and ``count_params``;
``serve lm`` refusing them as the reference does.

Tolerances (tests/torch_lm_cases.py): float32 logits within ``atol = rtol
= 1e-5`` and equal greedy tokens, decode through float32 caches; bfloat16
logits within 0.0625, tokens equal wherever the reference's top-2 margin
exceeds 0.125, through the default bfloat16 caches.  Rotations and sinusoids
within ``atol = 2e-5, rtol = 1e-5``: angles up to 64 rad, whose float32
cos/sin differ between the two libraries by a few ulps (as
``test_torch_lm_model.py::test_rope_halves_and_frequencies``).
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
from repro.models import common as ref_common
from repro.models.model import count_params as ref_count_params
from repro_torch import configs as port_configs
from repro_torch.launch import serve
from repro_torch.models import common
from repro_torch.models.model import count_params

ARCHS = ("qwen2-vl-7b", "musicgen-large")
S = 16                  # the reduced configs' chunk: the reference's prefill needs a multiple
ANGLE_TOL = dict(atol=2e-5, rtol=1e-5)
FULL_COUNTS = {"qwen2-vl-7b": 7_615_616_512, "musicgen-large": 2_424_506_368}


def _grid_positions(b: int, side: int) -> np.ndarray:
    """(B, side*side, 3) M-RoPE positions of a side x side patch grid: t = 0,
    h = row, w = column, row-major."""
    rows, cols = np.divmod(np.arange(side * side), side)
    pos = np.stack([np.zeros_like(rows), rows, cols], -1).astype(np.int32)
    return np.broadcast_to(pos, (b, side * side, 3)).copy()


def _inputs(cfg, seed):
    """(B=2, S, d_model) embeddings in the config's dtype, equal on both
    sides, and the positions the model takes (a grid for M-RoPE)."""
    x = jnp.asarray(np.random.default_rng(seed).standard_normal((2, S, cfg.d_model)),
                    cfg.dtype)
    pos = (_grid_positions(2, 4) if cfg.pos_embedding == "mrope"
           else np.tile(np.arange(S, dtype=np.int32), (2, 1)))
    return x, torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, cfg.dtype)), pos


# --------------------------------------------------------------------------
# primitives
# --------------------------------------------------------------------------
@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_mrope(head_dim):
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 7, 3, head_dim)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 7, 3)).astype(np.int32)
    want = ref_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = common.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ANGLE_TOL)
    # one stream for all three sections is the plain rotation
    same = np.repeat(pos[..., :1], 3, -1)
    np.testing.assert_allclose(
        common.apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e6).numpy(),
        common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[..., 0]), 1e6).numpy(),
        atol=0, rtol=0)


def test_sinusoidal_embedding():
    pos = np.arange(64, dtype=np.int32).reshape(2, 32)
    for d in (64, 2048):
        want = np.asarray(ref_common.sinusoidal_embedding(jnp.asarray(pos), d))
        got = common.sinusoidal_embedding(torch.from_numpy(pos), d)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **ANGLE_TOL)


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_apply_on_embeddings(name, dtype):
    ref, params, _, port = cases.model_pair(name, dtype, bias_seed=8 if "qwen" in name else None)
    jx, x, pos = _inputs(port.cfg, 12)
    want = np.asarray(jax.jit(lambda p, x, q: ref.apply(p, x, q)[0])(params, jx, jnp.asarray(pos)))
    with torch.inference_mode():
        got = port.apply(x, torch.from_numpy(pos))[0].numpy()
    assert got.shape == (2, S, port.cfg.vocab_size)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **cases.F32_TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        np.testing.assert_allclose(got, want, atol=cases.BF16_ATOL, rtol=0)
        assert cases.argmax_agree(got, want, np.ones(want.shape[:2], bool),
                                  2 * cases.BF16_ATOL) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_embeddings_then_decode_tokens(name, dtype):
    """The reference's ``apply`` with caches on both sides: S embeddings into
    empty caches (float32 caches for the float32 model), then 8 greedy
    decode steps of token ids at the default positions."""
    ref, params, _, port = cases.model_pair(name, dtype, bias_seed=8 if "qwen" in name else None)
    jx, x, pos = _inputs(port.cfg, 13)
    cdt = dict(float32=(jnp.float32, torch.float32), bfloat16=(jnp.bfloat16, torch.bfloat16))
    ref_caches = ref.init_caches(2, S + 8, cdt[dtype][0])
    caches = port.init_caches(2, S + 8, cdt[dtype][1])
    step = jax.jit(lambda p, t, q, c: ref.apply(p, t, q, caches=c)[:2])
    want, ref_caches = step(params, jx, jnp.asarray(pos), ref_caches)
    with torch.inference_mode():
        got, caches, _ = port.apply(x, torch.from_numpy(pos), caches=caches)
    want, got = np.asarray(want[:, -1:]), got[:, -1:].numpy()
    for t in range(9):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **cases.F32_TOL)
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        else:
            np.testing.assert_allclose(got, want, atol=cases.BF16_ATOL, rtol=0)
        if t == 8:
            break
        tok = want.argmax(-1).astype(np.int32)            # (B, 1): the reference's token
        want, ref_caches = step(params, jnp.asarray(tok), None, ref_caches)
        got, caches = cases.port_logits(port, tok, caches)
        want = np.asarray(want)
        assert all(c.index == S + t + 1 for c in caches)


@pytest.mark.parametrize("name", ARCHS)
def test_config_and_counts_match_reference(name):
    for reduced in (False, True):
        cfg, ref_cfg = port_configs.get_config(name, reduced), ref_get_config(name, reduced)
        fields = [{k: (tuple(x.value for x in v) if isinstance(v, tuple) else v)
                   for k, v in dataclasses.asdict(c).items()} for c in (cfg, ref_cfg)]
        assert fields[0] == fields[1]
        assert count_params(cfg) == ref_count_params(ref_cfg)
    assert count_params(port_configs.get_config(name)) == FULL_COUNTS[name]


@pytest.mark.parametrize("name", ARCHS)
def test_serve_lm_refuses_a_stub_frontend(name):
    with pytest.raises(SystemExit, match="stub frontend"), \
            contextlib.redirect_stdout(io.StringIO()):
        serve.main(["lm", "--device", "cpu", "--arch", name])
