"""StarCoder2-3B (dense, GQA, RoPE) — arXiv:2402.19173 (hf tier).

30L d_model=3072, 24 heads (GQA kv=2), d_ff=12288 (gelu), vocab 49152.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    source="arXiv:2402.19173; hf:bigcode/starcoder2-3b",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_head=128,
    d_ff=12288,
    vocab_size=49152,
    act="gelu",
    norm="layernorm",
    rope_theta=1e5,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, dtype="float32", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, n_micro=1, q_chunk=32, kv_chunk=32,
    )
