"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32, i.e. MHA) d_ff=8192
vocab=2048 (EnCodec codebook size).

Decoder-only over EnCodec tokens: sinusoidal positions, plain GELU MLP.
The EnCodec tokenizer/delay-pattern frontend is a STUB: input_specs()
provides pre-computed frame embeddings (B, S, d_model).
"""
from repro_torch.models.config import LayerKind, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    pattern_unit=(LayerKind.ATTN,),
    pos_embedding="sinusoidal",
    mlp_act="gelu_mlp",
    frontend="audio_stub",
)

REDUCED = ModelConfig(
    name="musicgen-large-reduced",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    pattern_unit=(LayerKind.ATTN,),
    pos_embedding="sinusoidal",
    mlp_act="gelu_mlp",
    frontend="audio_stub",
    q_chunk=16,
    kv_chunk=16,
)
