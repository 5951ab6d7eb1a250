"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H d_ff(expert)=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, MLA kv_lora=512.

Layer 0 is dense (HF first_k_dense_replace=1, intermediate 10944); layers
1..26 are MLA + MoE.  Lite has no query compression (q_lora_rank=0).
"""
from repro_torch.models.config import LayerKind, MlaConfig, ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,                  # dense prefix layer (HF); experts use 1408
    vocab_size=102400,
    head_dim=192,                # nope 128 + rope 64
    prefix=(LayerKind.MLA,),
    pattern_unit=(LayerKind.MLA,),
    mla=MlaConfig(
        kv_lora_rank=512, q_lora_rank=0,
        rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    ),
    moe=MoeConfig(
        num_experts=64, top_k=6, d_expert=1408, num_shared=2, first_dense=1,
    ),
)

REDUCED = ModelConfig(
    name="deepseek-v2-lite-16b-reduced",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=24,
    prefix=(LayerKind.MLA,),
    pattern_unit=(LayerKind.MLA,),
    mla=MlaConfig(
        kv_lora_rank=32, q_lora_rank=0,
        rope_head_dim=8, nope_head_dim=16, v_head_dim=16,
    ),
    moe=MoeConfig(num_experts=8, top_k=2, d_expert=32, num_shared=2, first_dense=1),
    q_chunk=16,
    kv_chunk=16,
)
