"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

llama-architecture GQA decoder (arXiv:2403.04652).
"""
from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    pattern_unit=(LayerKind.ATTN,),
)

REDUCED = ModelConfig(
    name="yi-9b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    pattern_unit=(LayerKind.ATTN,),
    q_chunk=16,
    kv_chunk=16,
)
