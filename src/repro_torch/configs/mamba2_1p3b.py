"""Mamba2-1.3b (SSD, attention-free) — arXiv:2405.21060 (unverified tier).

48L d_model=2048, ssm_state=128, expand=2 (d_inner 4096, 64 heads of 64),
vocab 50280.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=2048,
    d_ff=0,
    vocab_size=50280,
    attn_kind="none",
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
    norm="rmsnorm",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, dtype="float32", n_layers=3, d_model=64, ssm_state=16, ssm_head_dim=16,
        vocab_size=256, ssm_chunk=16, n_micro=1,
    )
