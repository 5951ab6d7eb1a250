"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864
vocab=256000.

Local (sliding-window 4096) / global alternating attention, attention
softcap 50, final-logit softcap 30, pre+post block RMSNorms, GeGLU MLP,
tied embeddings, head_dim=128 (decoupled from d_model/num_heads).
long_500k is SKIPPED: the global layers are full quadratic attention.
"""
from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    pattern_unit=(LayerKind.ATTN_LOCAL, LayerKind.ATTN),
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_block_norm=True,
    mlp_act="gelu",
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma2-27b-reduced",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    pattern_unit=(LayerKind.ATTN_LOCAL, LayerKind.ATTN),
    sliding_window=16,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_block_norm=True,
    mlp_act="gelu",
    tie_embeddings=True,
    q_chunk=16,
    kv_chunk=16,
)
