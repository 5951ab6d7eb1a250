"""The decode-cache size of one (arch, batch, length) cell (counterpart of
``_cache_bytes`` in ``repro/analysis/roofline.py``), which
``launch/mesh.py::make_rules`` reads to budget the optimised serving
layout.

Only this function is ported so far.  The rest of the reference module --
the analytic FLOP and byte model, the compute / memory / collective terms
and the roofline records over the dry run's cells, re-targeted from TPU v5e
to the H100 -- is queue 1 item 3 of ROADMAP.md.
"""
from __future__ import annotations

from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.models.xlstm import MLSTM_HEADS


def _cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> float:
    """Bytes of every layer's decode cache or recurrent state: bfloat16 keys
    and values (GQA), latents and RoPE keys (MLA); float32 states (Mamba,
    mLSTM, sLSTM)."""
    total = 0.0
    for kind in cfg.layer_kinds:
        if kind in (LayerKind.ATTN, LayerKind.ATTN_LOCAL):
            total += 2 * batch * max_len * cfg.num_kv_heads * cfg.head_dim * 2
        elif kind == LayerKind.MLA:
            total += batch * max_len * (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) * 2
        elif kind == LayerKind.MAMBA:
            d_in = cfg.mamba.expand * cfg.d_model
            total += batch * d_in * (cfg.mamba.d_state + cfg.mamba.d_conv) * 4
        elif kind == LayerKind.MLSTM:
            d_inner = 2 * cfg.d_model
            dh = d_inner // MLSTM_HEADS
            total += batch * MLSTM_HEADS * (dh * dh + dh) * 4
        elif kind == LayerKind.SLSTM:
            total += batch * cfg.d_model * 4 * 4
    return total
