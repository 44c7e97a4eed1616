"""Gemma3-1B (dense, 5:1 local:global sliding window) — hf:google/gemma-3-1b-pt.

26L d_model=1152, 4 heads (GQA kv=1, head_dim 256), d_ff=6912 (geglu),
vocab 262144; sliding window 512 with every 6th layer global; local rope
theta 10k, global 1M; tied embeddings.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_head=256,
    d_ff=6912,
    vocab_size=262144,
    act="geglu",
    tie_embeddings=True,
    window=512,
    global_every=6,
    rope_theta=1e4,
    rope_theta_global=1e6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, dtype="float32", n_layers=6, d_model=64, n_heads=2, n_kv_heads=1, d_head=32,
        d_ff=128, vocab_size=256, window=16, n_micro=1, q_chunk=32, kv_chunk=32,
    )
