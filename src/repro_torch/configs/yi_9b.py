"""Yi-9B (dense llama-arch GQA) — arXiv:2403.04652 (hf tier).

48L d_model=4096, 32 heads (GQA kv=4), d_ff=11008 (swiglu), vocab 64000.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    source="arXiv:2403.04652; hf:01-ai/Yi-9B",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, dtype="float32", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, n_micro=1, q_chunk=32, kv_chunk=32,
    )
