"""InternVL2-1B backbone (VLM: InternViT stub + InternLM2) — arXiv:2404.16821.

24L d_model=896, 14 heads (GQA kv=2), d_ff=4864, vocab 151655.  The InternViT
patch frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (n_patches=1024 for train/prefill shapes).
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_head=64,
    d_ff=4864,
    vocab_size=151655,
    frontend="patch",
    n_patches=1024,
    rope_theta=1e6,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, dtype="float32", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=128, vocab_size=256, n_patches=8, n_micro=1, q_chunk=32,
        kv_chunk=32,
    )
