"""float32 decode through the default bfloat16 caches: how far the port
drifts from the JAX package, against how far the reference drifts from
itself when its float32 keys move by one ulp.

A bfloat16 cache rounds each float32 key (yi: ``k``; deepseek-v2's MLA: the
latent ``c_kv``).  The port's projections sum in another order than
XLA:CPU's dot, so a few keys differ in their last bit, and now and then one
of them rounds to another bfloat16 value; from that step on the logits
part, far past the float32 tolerance of the other tests (which decode on
float32 caches).  The reference does the same to itself: with every element
of ``wk`` (yi) or ``w_dkv`` (deepseek) moved one ulp up or down
(``np.nextafter``, signs from a seed), its own logits part from its
unperturbed run.

Each case runs 48 decode steps of one batch of 32 sequences (token seed 0):
the reference as is, the reference nudged with seeds 1-3, and the port, each
through the models' default bfloat16 caches.  The drift of a sequence is its
largest ``|got - want| / (atol + rtol * |want|)`` at tests/torch_lm_cases.py's
``atol = rtol = 1e-5``, against the unperturbed reference.  Measured on an
x86-64 host with JAX 0.9 and torch 2.13 (CPU):

- yi-9b-reduced: the port's worst sequence 44.43 (10 of 32 past 1); the
  reference against itself 84.13 (17 of 96 past 1): 0.53 of it;
- deepseek-v2-lite-16b-reduced: the port 88.01 (15 of 32 past 1); the
  reference against itself 122.78 (26 of 96 past 1): 0.72 of it.

The port's keys differ from the reference's in more places than one nudged
matrix makes them differ, so more of its sequences drift, but none further
than the reference drifts from itself.  So the port's float32 decode on
bfloat16 caches is held to the reference's own self-drift over the same
inputs (factor 1, computed here, not stored): a last-bit difference in a
float32 key explains it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)

STEPS = 48
BATCH = 32                 # 32 sequences of token seed 0, one batch
NUDGE_SEEDS = (1, 2, 3)


def _drift(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each sequence's largest |got - want| / (atol + rtol |want|)."""
    atol, rtol = cases.F32_TOL["atol"], cases.F32_TOL["rtol"]
    return (np.abs(got - want) / (atol + rtol * np.abs(want))).max(axis=(1, 2))


def _nudged(tree, weight: str, seed: int):
    """Every element of each layer's ``weight`` one float32 ulp up or down."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, tree)
    for layer in list(tree["prefix"]) + list(tree["units"]):
        w = layer["attn"][weight]
        sign = rng.choice(np.asarray([-1.0, 1.0], np.float32), size=w.shape)
        layer["attn"][weight] = np.nextafter(w, sign * np.float32(np.inf))
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("name,weight", [("yi-9b", "wk"), ("deepseek-v2-lite-16b", "w_dkv")])
def test_port_drift_within_reference_self_drift(name, weight):
    ref, params, ref_apply, port = cases.model_pair(name, "float32")
    toks = cases.tokens(port.cfg.vocab_size, (BATCH, STEPS), seed=0)

    def reference(p):
        caches, out = ref.init_caches(BATCH, STEPS), []
        for t in range(STEPS):
            logits, caches = ref_apply(p, jnp.asarray(toks[:, t:t + 1]), caches)
            out.append(np.asarray(logits))
        return np.concatenate(out, axis=1)

    want = reference(params)
    caches, got = port.init_caches(BATCH, STEPS), []
    for t in range(STEPS):
        logits, caches = cases.port_logits(port, toks[:, t:t + 1], caches)
        got.append(logits)
    port_drift = _drift(np.concatenate(got, axis=1), want)
    self_drift = np.concatenate([_drift(reference(_nudged(params, weight, s)), want)
                                 for s in NUDGE_SEEDS])
    assert port_drift.max() <= self_drift.max(), (np.sort(port_drift), np.sort(self_drift))
    assert self_drift.max() > 1.0     # the reference does drift past F32_TOL by itself
