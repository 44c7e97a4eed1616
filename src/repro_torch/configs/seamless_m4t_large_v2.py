"""SeamlessM4T-large-v2 backbone (enc-dec) — arXiv:2308.11596 (hf tier).

24 encoder + 24 decoder layers, d_model=1024, 16 heads (kv=16), d_ff=8192,
vocab 256206.  The speech/text modality frontend is a STUB per the
assignment: input_specs() provides precomputed frame embeddings.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    source="arXiv:2308.11596; hf:facebook/seamless-m4t-v2-large",
    n_layers=24,
    n_dec_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_head=64,
    d_ff=8192,
    vocab_size=256206,
    act="gelu",
    norm="layernorm",
    frontend="frames",
    dec_ratio=4,
    rope_theta=1e4,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, dtype="float32", n_layers=2, n_dec_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_head=16, d_ff=128, vocab_size=256, n_micro=1,
        q_chunk=32, kv_chunk=32,
    )
