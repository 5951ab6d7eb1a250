"""Shared cases for the LM port's CPU tests (tests/test_torch_lm_*.py): the
configs, the reference and port models on the same weights, a lockstep wave
driven through the reference with its logits kept, and the bf16 token gate.

Tolerances, from runs of these tests' inputs on the CPU:
- float32 variants: logits within ``F32_TOL`` (atol = rtol = 1e-5; the
  largest difference seen was 2.4e-6 on logits up to 4: the two sides sum
  their products in other orders), and greedy tokens equal.
- bfloat16 (the configs' own dtype): logits within ``BF16_ATOL`` = 0.0625,
  four bfloat16 ulps of a logit in [2, 4) (the largest difference seen was
  0.0254, so a margin of 2.5x: every matmul output is rounded to bfloat16,
  and a last-bit difference early on can move a later rounding).  Where
  logits differ by at most d, the greedy token can differ only where the top
  two are within 2d of each other, so tokens must be equal wherever the
  reference's top-2 margin exceeds ``2 * BF16_ATOL``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.model import LMModel as RefModel
from repro_torch.configs import get_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import LMModel, params_from_reference

ARCHS = ("yi-9b", "qwen2.5-32b", "mistral-large-123b")
DEEPSEEK = ("deepseek-v2-lite-16b", "deepseek-v2-236b")
F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_ATOL = 0.0625

# tests/test_serve_engine.py's TINY, in both packages.
_TINY = dict(name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=2, d_ff=128, vocab_size=256, q_chunk=32, kv_chunk=32)
TINY = ModelConfig(**_TINY)
REF_TINY = RefModelConfig(**_TINY)


def bf16_steps(want: np.ndarray, steps: int = 4) -> dict:
    """A block's bfloat16 tolerance: ``steps`` bfloat16 steps (2**-7 of the
    binade) of the largest reference output, as chip_smoke.py's
    ``LM_LOGIT_ULPS`` rule: the outputs are sums whose terms each round to
    bfloat16, so a last-bit difference is one step of the terms' scale, not
    of the (possibly small) output's own."""
    top = float(np.abs(want).max())
    return dict(atol=steps * 2.0 ** (np.floor(np.log2(top)) - 7), rtol=0)


def configs(name: str, dtype: str | None = None):
    """(reference config, port config) of ``name`` (an arch id, reduced, or
    "tiny"), with ``dtype`` replaced when given."""
    ref, port = (REF_TINY, TINY) if name == "tiny" else (ref_get_config(name, True),
                                                        get_config(name, True))
    if dtype is not None:
        ref, port = (dataclasses.replace(c, dtype=dtype) for c in (ref, port))
    return ref, port


def model_pair(name: str, dtype: str | None = None, bias_seed: int | None = None):
    """(reference model, its params, its ``apply`` under ``jax.jit``, the
    port's CPU model on the same weights).
    ``bias_seed`` replaces the zero-initialised qkv biases with normals, so
    that the bias path is tested."""
    ref_cfg, cfg = configs(name, dtype)
    ref = RefModel(ref_cfg)
    tree = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    if bias_seed is not None:
        rng = np.random.default_rng(bias_seed)
        for unit in tree["units"]:
            for name_b in ("bq", "bk", "bv"):
                a = unit["attn"][name_b]
                unit["attn"][name_b] = rng.standard_normal(a.shape).astype(np.float32)
    port = LMModel(cfg, device="cpu")
    port.load_state_dict(params_from_reference(cfg, tree))
    ref_apply = jax.jit(lambda p, t, c: ref.apply(p, t, caches=c)[:2])
    return ref, jax.tree.map(jnp.asarray, tree), ref_apply, port


def tokens(vocab: int, shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def prompts(vocab: int, n: int, lo: int = 3, hi: int = 9, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


def reference_wave(ref, params, wave_prompts, max_new: int, max_len: int):
    """The reference's lockstep wave (``ServeEngine._run_wave``) driven by
    hand through a jitted ``apply``: per request, the generated tokens and,
    for each, the top-2 margin of the logits it came from."""
    b = len(wave_prompts)
    step = jax.jit(lambda p, t, c: ref.apply(p, t, caches=c)[:2])
    caches = ref.init_caches(b, max_len)
    lens = [len(p) for p in wave_prompts]
    horizon = max(n + max_new - 1 for n in lens)
    last = np.asarray([p[0] for p in wave_prompts], np.int32)
    out = [([], []) for _ in range(b)]
    for t in range(horizon):
        logits, caches = step(params, jnp.asarray(last)[:, None], caches)
        logits = np.asarray(logits[:, -1])
        top2 = np.sort(logits, axis=-1)[:, -2:]
        for i in range(b):
            if t + 1 < lens[i]:
                last[i] = wave_prompts[i][t + 1]
            else:
                gen = int(np.argmax(logits[i]))
                if len(out[i][0]) < max_new:
                    out[i][0].append(gen)
                    out[i][1].append(float(top2[i, 1] - top2[i, 0]))
                last[i] = gen
    return out


def gated_prefix(got: list[int], want: list[int], margins: list[float]) -> int:
    """Assert ``got == want`` up to the first token whose reference margin is
    at most ``2 * BF16_ATOL``; return how many tokens were held."""
    n = next((i for i, m in enumerate(margins) if m <= 2 * BF16_ATOL), len(margins))
    assert got[:n] == want[:n], (got, want, margins)
    return n


def port_logits(port, toks, caches=None):
    with torch.inference_mode():
        logits, caches, _ = port.apply(torch.from_numpy(toks), caches=caches)
    return logits.numpy(), caches
