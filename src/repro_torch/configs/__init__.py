"""Configurations: the stereo settings (``elas_stereo``) and the LM
architecture registry (counterpart of ``repro.configs``): ``--arch <id>`` ->
``ModelConfig`` (full and reduced), for every architecture of the reference:
the dense GQA decoders (yi, qwen2.5, mistral-large; gemma2 with its sliding
window, softcaps, post-block norms, GeGLU and tied embeddings), deepseek-v2
(MLA layers, a dense first layer, then static-capacity MoE; the 236b with
low-rank queries), the jamba hybrid (Mamba layers with one GQA layer in
eight, MoE on every other layer), xlstm-350m (seven mLSTM layers to one
sLSTM), and the two stub-frontend backbones, qwen2-vl-7b (M-RoPE, qkv
biases) and musicgen-large (sinusoidal positions, a plain GeLU MLP).
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
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.REDUCED if reduced else mod.CONFIG


def all_configs(reduced: bool = False) -> dict[str, ModelConfig]:
    return {a: get_config(a, reduced) for a in ARCH_IDS}
