"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff(expert)=1536
vocab=102400, MoE 160 routed top-6 + 2 shared, MLA kv_lora=512 q_lora=1536.

Layer 0 dense (HF intermediate 12288); layers 1..59 MLA + MoE.
"""
from repro_torch.models.config import LayerKind, MlaConfig, ModelConfig, MoeConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,                  # dense prefix layer (HF); experts use 1536
    vocab_size=102400,
    head_dim=192,                # nope 128 + rope 64
    prefix=(LayerKind.MLA,),
    pattern_unit=(LayerKind.MLA,),
    mla=MlaConfig(
        kv_lora_rank=512, q_lora_rank=1536,
        rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    ),
    moe=MoeConfig(
        num_experts=160, top_k=6, d_expert=1536, num_shared=2, first_dense=1,
    ),
)

REDUCED = ModelConfig(
    name="deepseek-v2-236b-reduced",
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
        kv_lora_rank=32, q_lora_rank=16,
        rope_head_dim=8, nope_head_dim=16, v_head_dim=16,
    ),
    moe=MoeConfig(num_experts=8, top_k=2, d_expert=32, num_shared=2, first_dense=1),
    q_chunk=16,
    kv_chunk=16,
)
