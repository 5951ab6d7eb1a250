"""Configurations: the stereo settings (``elas_stereo``) and the LM
architecture registry (counterpart of ``repro.configs``): ``--arch <id>`` ->
``ModelConfig`` (full and reduced).

The port runs the decoders made of attention layers: the dense GQA decoders,
every layer ``LayerKind.ATTN`` or ``ATTN_LOCAL`` with a dense MLP (yi,
qwen2.5, mistral-large; gemma2 with its sliding window, softcaps, post-block
norms, GeGLU and tied embeddings), deepseek-v2 (``LayerKind.MLA`` layers,
a dense first layer, then static-capacity MoE; the 236b with low-rank
queries), and the jamba hybrid (``LayerKind.MAMBA`` layers with one GQA
layer in eight, MoE on every other layer).  The reference's other
architectures are not ported yet: asking for one raises ``KeyError`` that
says so (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "yi-9b": "repro_torch.configs.yi_9b",
    "qwen2.5-32b": "repro_torch.configs.qwen2_5_32b",
    "mistral-large-123b": "repro_torch.configs.mistral_large_123b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
}
# The reference's architectures whose layers the port cannot run yet.
_NOT_PORTED = ("xlstm-350m", "qwen2-vl-7b", "musicgen-large")

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise KeyError(f"arch {arch!r} is not ported yet (ROADMAP.md, queue 1); "
                       f"ported: {sorted(_ARCH_MODULES)}")
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted((*_ARCH_MODULES, *_NOT_PORTED))}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(reduced: bool = False) -> dict[str, ModelConfig]:
    return {a: get_config(a, reduced) for a in ARCH_IDS}
