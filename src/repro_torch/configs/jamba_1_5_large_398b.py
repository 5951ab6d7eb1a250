"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 routed top-2.

Mamba : attention = 7 : 1 -- each 8-layer unit has one attention layer (at
position 3, matching Jamba's mid-block placement); MoE replaces the dense
MLP on every other layer (odd positions); the Mamba layers at even positions
keep a dense MLP of d_ff.  (Copy of ``repro/configs/jamba_1_5_large_398b.py``,
whose dry run takes it to long_500k: the 9 attention layers' KV sharded over
seq/data at 500k.)
"""
from repro_torch.models.config import LayerKind, MambaConfig, ModelConfig, MoeConfig

UNIT = (
    LayerKind.MAMBA, LayerKind.MAMBA, LayerKind.MAMBA, LayerKind.ATTN,
    LayerKind.MAMBA, LayerKind.MAMBA, LayerKind.MAMBA, LayerKind.MAMBA,
)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    pattern_unit=UNIT,
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    moe=MoeConfig(num_experts=16, top_k=2, d_expert=24576, every=2, offset=1),
    sub_quadratic=True,
)

REDUCED = ModelConfig(
    name="jamba-1.5-large-398b-reduced",
    family="hybrid",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    pattern_unit=UNIT,
    mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
    moe=MoeConfig(num_experts=4, top_k=2, d_expert=128, every=2, offset=1),
    sub_quadratic=True,
    q_chunk=16,
    kv_chunk=16,
)
