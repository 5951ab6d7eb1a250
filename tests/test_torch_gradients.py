"""``LMModel.loss`` and the gradient of every parameter against
``jax.value_and_grad`` of the reference's ``LMModel.loss`` on the CPU, in
float32, for one reduced model of each family: yi-9b (dense GQA), gemma2-27b
(sliding window, both softcaps, tied embeddings), deepseek-v2-lite-16b (MLA +
MoE, whose aux and z losses enter the total), jamba-1.5-large-398b (Mamba +
attention + MoE) and xlstm-350m (mLSTM + sLSTM).  Both sides take the same
weights (the port's ``init(0)`` carried to the reference) and the same batch
of ``TokenPipeline`` (the reference's draws); the reference's gradient
pytree is carried back to the port's names with ``params_from_reference``.

Tolerances: the loss and ce within ``rtol = 1e-6`` (the largest difference
seen was 7.4e-8 of gemma2's 25.77), the MoE drop fraction equal, and each
parameter's gradient within ``GRAD_TOL`` = 1e-5 of that gradient's largest
magnitude (the two sides sum in other orders, and the reference
rematerialises its units: the largest difference seen was 1.9e-6 of it, on
jamba's ``w_x``; no gradient is all zeros).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_lm_cases as cases
from torch_lm_cases import one_torch_thread  # noqa: F401 (an autouse fixture)
from repro_torch.data.tokens import pipeline_for
from repro_torch.models.model import params_from_reference
from repro_torch.runtime.train_loop import value_and_grad

ARCHS = ("yi-9b", "gemma2-27b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b", "xlstm-350m")
GRAD_TOL = 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax_value_and_grad(arch):
    ref, params, _, port = cases.model_pair(arch, "float32", port_init=True)
    cfg = port.cfg
    batch = pipeline_for(cfg, 2, 32, seed=5, device="cpu").batch_at(0)
    ref_batch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    (want_loss, want_metrics), want_grads = jax.jit(
        jax.value_and_grad(ref.loss, has_aux=True))(params, ref_batch)

    loss, metrics, grads = value_and_grad(port, dict(port.named_parameters()), batch)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert metrics.keys() == want_metrics.keys() == {"loss", "ce", "moe_aux", "moe_dropped"}
    np.testing.assert_allclose(float(metrics["ce"]), float(want_metrics["ce"]), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["moe_aux"]), float(want_metrics["moe_aux"]),
                               rtol=1e-6, atol=1e-9)
    assert float(metrics["moe_dropped"]) == float(want_metrics["moe_dropped"])

    want = params_from_reference(cfg, jax.tree.map(np.asarray, want_grads))
    assert grads.keys() == want.keys()
    for name, w in want.items():
        top = float(w.abs().max())
        assert top > 0, name
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(), atol=GRAD_TOL * top, rtol=0,
                                   err_msg=name)
    assert not any(p.requires_grad for p in port.parameters())   # the module stays frozen
