"""Phi3-medium-14B (dense, RoPE SwiGLU GQA) — arXiv:2404.14219 (unverified).

40L d_model=5120, 40 heads (GQA kv=10), d_ff=17920, vocab 100352.
Note: 40 heads / 10 kv heads are not divisible by the 16-way model axis —
the sharding rule engine replicates the head axis and shards d_ff/vocab
instead (see repro.sharding.rules).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    source="arXiv:2404.14219",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_head=128,
    d_ff=17920,
    vocab_size=100352,
    rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, dtype="float32", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, n_micro=1, q_chunk=32, kv_chunk=32,
    )
