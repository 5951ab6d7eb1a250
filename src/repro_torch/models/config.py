"""Model configuration covering every assigned architecture family (copy of
``repro/models/config.py``).

One frozen dataclass describes dense GQA transformers (llama/yi/qwen/
mistral), gemma2 variants (local/global alternation, softcaps), MLA + MoE
(deepseek-v2), Mamba/attention hybrids with MoE (jamba), xLSTM stacks, and
stub-fronted VLM/audio backbones (qwen2-vl, musicgen).

Layer heterogeneity is expressed as a repeating ``pattern unit`` (plus an
optional non-repeated prefix): the reference scans over units, which keeps the
HLO compact for 88-layer models while allowing interleaves like jamba's
1 attention : 7 mamba or gemma2's local/global alternation.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class LayerKind(str, enum.Enum):
    ATTN = "attn"          # full (global) attention + MLP
    ATTN_LOCAL = "attn_local"  # sliding-window attention + MLP
    MLA = "mla"            # multi-head latent attention + MLP/MoE
    MAMBA = "mamba"        # Mamba-1 SSM block
    MLSTM = "mlstm"        # xLSTM matrix-memory block
    SLSTM = "slstm"        # xLSTM scalar-memory block


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    num_experts: int                 # routed experts
    top_k: int
    d_expert: int                    # per-expert FFN hidden size
    num_shared: int = 0              # always-on shared experts
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2
    # which layers are MoE (others use dense MLP with cfg.d_ff)
    first_dense: int = 0             # leading layers forced dense (deepseek: 1)
    every: int = 1                   # then MoE where ((idx-first_dense) % every)==offset
    offset: int = 0


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class MlaConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0             # 0 = no query compression
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # layer pattern: prefix layers + num_units repetitions of pattern_unit
    pattern_unit: Tuple[LayerKind, ...] = (LayerKind.ATTN,)
    prefix: Tuple[LayerKind, ...] = ()

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 1e4
    pos_embedding: str = "rope"      # rope | mrope | sinusoidal | none
    sliding_window: int = 4096       # for ATTN_LOCAL layers
    attn_softcap: float = 0.0        # gemma2: 50.0 (0 = off)
    logit_softcap: float = 0.0       # gemma2: 30.0 (0 = off)
    post_block_norm: bool = False    # gemma2: extra norms after attn/mlp
    mlp_act: str = "silu"            # silu (SwiGLU) | gelu (GeGLU) | gelu_mlp
    tie_embeddings: bool = False

    moe: Optional[MoeConfig] = None
    mamba: Optional[MambaConfig] = None
    mla: Optional[MlaConfig] = None

    # frontend stubs for [vlm]/[audio]: inputs are precomputed embeddings
    frontend: str = "none"           # none | vision_stub | audio_stub

    # numerics / memory knobs
    dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "nothing"    # nothing | names (save mixer/MLP outs)
    q_chunk: int = 1024              # blockwise attention chunk sizes
    kv_chunk: int = 1024
    causal_skip: bool = False        # skip fully-masked KV blocks (perf opt)
    cache_update: str = "dus"        # dus | onehot (shard-preserving insert
                                     # for seq-sharded decode caches)
    norm_eps: float = 1e-6

    # sub-quadratic? (drives long_500k applicability)
    sub_quadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        n_pattern = len(self.prefix) + len(self.pattern_unit) * self.num_units
        assert n_pattern == self.num_layers, (
            f"{self.name}: prefix {len(self.prefix)} + unit "
            f"{len(self.pattern_unit)} x {self.num_units} != {self.num_layers}"
        )

    @property
    def num_units(self) -> int:
        rem = self.num_layers - len(self.prefix)
        assert rem % len(self.pattern_unit) == 0, (
            f"{self.name}: {rem} layers not divisible by unit "
            f"{len(self.pattern_unit)}"
        )
        return rem // len(self.pattern_unit)

    @property
    def layer_kinds(self) -> Tuple[LayerKind, ...]:
        return self.prefix + self.pattern_unit * self.num_units

    def layer_is_moe(self, kind_index_in_unit: int) -> bool:
        if self.moe is None:
            return False
        return (kind_index_in_unit % self.moe.every) == self.moe.offset

    def param_count(self) -> int:
        """Total parameters (for roofline MODEL_FLOPS = 6*N*D)."""
        from repro_torch.models.model import count_params  # late: avoids cycle
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params
        return count_params(self, active_only=True)
