"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768, head_dim=128.

REDUCED's head_dim of 8 runs on the CPU only: the flash kernel takes head
widths 16, 32, 64 and 128, and raises on the card for any other.
"""
from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    head_dim=128,
    pattern_unit=(LayerKind.ATTN,),
)

REDUCED = ModelConfig(
    name="mistral-large-123b-reduced",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=8,
    pattern_unit=(LayerKind.ATTN,),
    q_chunk=16,
    kv_chunk=16,
)
