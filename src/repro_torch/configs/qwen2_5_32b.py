"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064.  GQA with QKV bias (qwen2 family trait).
"""
from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    pattern_unit=(LayerKind.ATTN,),
    qkv_bias=True,
    rope_theta=1e6,
)

REDUCED = ModelConfig(
    name="qwen2.5-32b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    pattern_unit=(LayerKind.ATTN,),
    qkv_bias=True,
    q_chunk=16,
    kv_chunk=16,
)
