"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.

M-RoPE (3-section temporal/height/width rotary), QKV bias.  The vision
frontend (dynamic-resolution ViT) is a STUB: input_specs() provides
pre-computed patch embeddings (B, S, d_model) and (B, S, 3) M-RoPE
position streams.  28 heads is not divisible by the 16-way model axis, so
the per-arch sharding rules replicate heads and take TP from d_ff/vocab.
"""
from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    pattern_unit=(LayerKind.ATTN,),
    qkv_bias=True,
    pos_embedding="mrope",
    rope_theta=1e6,
    frontend="vision_stub",
)

REDUCED = ModelConfig(
    name="qwen2-vl-7b-reduced",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    pattern_unit=(LayerKind.ATTN,),
    qkv_bias=True,
    pos_embedding="mrope",
    frontend="vision_stub",
    q_chunk=16,
    kv_chunk=16,
)
