"""Moonlight-16B-A3B (kimi/moonshot MoE) — hf:moonshotai/Moonlight-16B-A3B.

48L d_model=2048, 16 heads (GQA kv=16), MoE 64 experts top-6 + 2 shared,
expert FFN 1408, first layer dense (d_ff 11264), vocab 163840.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    source="hf:moonshotai/Moonlight-16B-A3B",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=11264,
    vocab_size=163840,
    attn_kind="gqa",
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=5e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, dtype="float32", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256, n_experts=8, top_k=2, n_shared_experts=1,
        moe_d_ff=32, first_dense_layers=1, n_micro=1, q_chunk=32, kv_chunk=32,
        moe_impl="local", capacity_factor=8.0,
    )
