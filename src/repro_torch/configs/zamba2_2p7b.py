"""Zamba2-2.7B (hybrid: Mamba2 + shared attention blocks) — arXiv:2411.15242.

54 Mamba2 layers d_model=2560 (ssm_state=64, d_inner 5120, 80 heads of 64)
with one *shared* transformer block (32 heads, d_ff 10240) applied every 6
mamba layers; vocab 32000.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_head=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
    attn_every=6,
    rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, dtype="float32", n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=128, vocab_size=256, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
        attn_every=2, n_micro=1, q_chunk=32, kv_chunk=32,
    )
