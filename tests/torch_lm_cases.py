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

Routing gate (bfloat16 MoE models: deepseek-v2, jamba).  A MoE layer's
choice of experts is a step function of its input: where the k-th and
(k+1)-th router probabilities nearly tie, a last-bit difference upstream
picks another expert, and that token's logits, its sequence's later
positions and, through the capacity, other tokens' slots move by far more
than ``BF16_ATOL``.  ``Routing`` records both sides' choices at every MoE
call; ``taint`` holds each position up to its sequence's first position
whose experts or kept slots differ, and requires every such first flip to
be a near tie on the reference's side (``FLIP_MARGIN``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import moe as ref_moe
from repro.models.config import ModelConfig as RefModelConfig
from repro.models.model import LMModel as RefModel
from repro_torch.configs import get_config
from repro_torch.models import moe
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


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the module's torch work (imported by the
    training tests): their models are small, and the suite's workers share
    the host, where torch's default of a thread per core makes every small
    operation wait for threads that other workers' processes hold."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


def reference_tree(ref, port) -> dict:
    """The port's weights as the reference's parameter pytree (numpy,
    float32): the inverse of ``params_from_reference``, each leaf shaped as
    ``ref.abstract_params()`` has it, the units stacked."""
    cfg = ref.cfg
    sd = {k: v.detach().float().numpy() for k, v in port.state_dict().items()}
    abstract = ref.abstract_params()

    def fill(node, prefix, get):
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}{k}.", get) for k, v in node.items()}
        return get(prefix[:-1], node.shape)

    def layer(i):
        return lambda key, shape: sd[f"layers.{i}.{key}"].reshape(shape)

    def stacked(p):
        first, n = len(cfg.prefix) + p, len(cfg.pattern_unit)
        return lambda key, shape: np.stack([sd[f"layers.{first + u * n}.{key}"].reshape(shape[1:])
                                            for u in range(cfg.num_units)])

    tree = {k: fill(v, f"{k}.", lambda key, shape: sd[key].reshape(shape))
            for k, v in abstract.items() if k not in ("prefix", "units")}
    tree["prefix"] = [fill(node, "", layer(i)) for i, node in enumerate(abstract["prefix"])]
    tree["units"] = [fill(node, "", stacked(p)) for p, node in enumerate(abstract["units"])]
    return tree


def model_pair(name: str, dtype: str | None = None, bias_seed: int | None = None,
               port_init: bool = False):
    """(reference model, its params, its ``apply`` under ``jax.jit``, the
    port's CPU model on the same weights): the reference's ``init(PRNGKey(0))``
    or, with ``port_init``, the port's ``init(0)`` (the same distributions;
    the reference's eager init of a reduced MoE model takes ~10 s).
    ``bias_seed`` replaces the zero-initialised qkv biases with normals, so
    that the bias path is tested."""
    ref_cfg, cfg = configs(name, dtype)
    ref = RefModel(ref_cfg)
    if port_init:
        tree = reference_tree(ref, LMModel(cfg, device="cpu").init(0))
    else:
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


# A token may pick another set of experts than the reference only where the
# reference's k-th and (k+1)-th router probabilities lie within this of each
# other: bfloat16 router inputs a step apart move a probability by ~1e-3
# (first flips seen: 4.7e-5 to 2.9e-3).
FLIP_MARGIN = 0.01


# --------------------------------------------------------------------------
# routing, recorded on both sides
# --------------------------------------------------------------------------
class Routing:
    """Every MoE call's expert choices (T, k), in call order, on both sides:
    ``ref`` from the reference's ``moe_block`` (patched to add a debug
    callback; under jit the callback runs at every call), ``port`` from the
    port's; with the reference's top-k minus top-(k+1) router probability
    of every token."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        ref_block, port_block = ref_moe.moe_block, moe.moe_block

        def ref_recording(params, x, cfg):
            out, aux = ref_block(params, x, cfg)
            logits = jnp.einsum("td,de->te", x.reshape(-1, x.shape[-1]).astype(jnp.float32),
                                params["router"].astype(jnp.float32))
            top_p, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k + 1)
            jax.debug.callback(self._ref, params["router"][0, 0], top_e[:, :cfg.top_k],
                               top_p[:, cfg.top_k - 1] - top_p[:, cfg.top_k])
            return out, aux

        def port_recording(params, x, cfg):
            logits = x.reshape(-1, x.shape[-1]).float() @ params["router"]
            top_e = moe.route(logits, cfg, moe._capacity(logits.shape[0], cfg))[3]
            self.port.append((float(params["router"][0, 0]), top_e.numpy()))
            return port_block(params, x, cfg)

        monkeypatch.setattr(ref_moe, "moe_block", ref_recording)
        monkeypatch.setattr(moe, "moe_block", port_recording)

    def _ref(self, key, top_e, margin):
        self.ref.append((float(key), np.asarray(top_e), np.asarray(margin)))

    def take(self):
        """The calls since the last take, in the port's call order (layer by
        layer, step by step), each paired with the reference's call on the
        same layer (its router's first weight): [(ref experts, port experts,
        ref margins)]."""
        assert len(self.ref) == len(self.port) and self.ref, (len(self.ref), len(self.port))
        by_layer = {}
        for key, top_e, margin in self.ref:
            by_layer.setdefault(key, []).append((top_e, margin))
        pairs = []
        for key, port_e in self.port:
            ref_e, margin = by_layer[key].pop(0)
            pairs.append((ref_e, port_e, margin))
        self.ref, self.port = [], []
        return pairs


def slots(top_e: np.ndarray, e: int) -> np.ndarray:
    """Choice-major slot of each (token, choice) at its expert."""
    t, k = top_e.shape
    seen = np.zeros(e, np.int64)
    slot = np.empty(k * t, np.int64)
    for i, x in enumerate(top_e.T.reshape(-1)):
        slot[i], seen[x] = seen[x], seen[x] + 1
    return slot.reshape(k, t).T


def taint(pairs, cfg, tainted: np.ndarray, flip_margins: list) -> np.ndarray:
    """Carry ``tainted`` (B, S: positions whose inputs may differ between the
    two sides) through one forward's MoE calls, in layer order.  A token whose
    experts or kept slots differ taints itself and its sequence's later
    positions.  A token whose set of experts differs while its inputs were
    still held is a flip of the port's own making: its reference top-k margin
    must be a near tie (``FLIP_MARGIN``) and is kept in ``flip_margins``.
    (Two experts in another order, a near tie between choices, change only
    the slots: ``moved``.)"""
    b, s = tainted.shape
    e = cfg.moe.num_experts
    for ref_e, port_e, margin in pairs:
        cap = moe._capacity(ref_e.shape[0], cfg.moe)
        flips = (np.sort(ref_e, 1) != np.sort(port_e, 1)).any(1).reshape(b, s)
        first = flips & ~tainted
        assert (margin.reshape(b, s)[first] < FLIP_MARGIN).all(), margin.reshape(b, s)[first]
        flip_margins.extend(margin.reshape(b, s)[first].tolist())
        moved = ((slots(ref_e, e) < cap) != (slots(port_e, e) < cap)).any(1).reshape(b, s)
        tainted = np.logical_or.accumulate(tainted | flips | moved, axis=1)
    return tainted


def argmax_agree(got, want, held, margin_bound) -> int:
    """Assert equal greedy tokens at the ``held`` positions whose reference
    top-2 margin exceeds ``margin_bound``; return how many there were."""
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = ((top2[..., 1] - top2[..., 0]) > margin_bound) & held
    np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    return int(clear.sum())
