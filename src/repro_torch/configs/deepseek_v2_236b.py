"""DeepSeek-V2 236B (MoE, MLA) — arXiv:2405.04434 + HF config (hf tier).

60L d_model=5120, 128 heads MLA (kv_lora=512, q_lora=1536, nope/rope head
dims 128/64, v_head 128), vocab 102400; MoE: 160 routed experts top-6 +
2 shared, expert FFN 1536, first layer dense (d_ff 12288).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_head=192,  # qk nope+rope dim (128+64); v_head_dim=128
    d_ff=12288,  # dense (first_dense_layers) FFN
    vocab_size=102400,
    attn_kind="mla",
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, dtype="float32", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=48,
        q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
        v_head_dim=32, d_ff=128, vocab_size=256, n_experts=8, top_k=2,
        n_shared_experts=1, moe_d_ff=32, first_dense_layers=1, n_micro=1,
        q_chunk=32, kv_chunk=32, moe_impl="local", capacity_factor=8.0,
    )
