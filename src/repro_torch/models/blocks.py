"""The transformer block of the dense family.

The port of ``tf_block_init`` / ``tf_block_apply`` of the JAX package's
``repro/models/blocks.py``: a pre-norm residual block, GQA then MLP.  The
reference scans stacked layer params with per-layer scalars riding along
(gemma3's window and rope theta); here the model loops over an
``nn.ModuleList`` and passes each layer's window and theta as plain
arguments.  MoE and cross attention wait for the slices that bring those
families.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import MLP, Norm, mlp_apply, norm_apply


class TransformerBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, ``mlp``: the reference's block pytree."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        self.ln1 = Norm(cfg.norm, cfg.d_model, device)
        self.ln2 = Norm(cfg.norm, cfg.d_model, device)
        self.attn = attn.GQA(cfg, device, dtype)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, device, dtype)


def tf_block_init(block: TransformerBlock, generator: torch.Generator) -> None:
    block.ln1.init()
    block.ln2.init()
    block.attn.init(generator)
    block.mlp.init(generator)


def tf_block_apply(
    params: TransformerBlock,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg,
    causal: bool = True,
    window: Optional[int] = None,
    rope_theta: Optional[float] = None,
) -> torch.Tensor:
    """Pre-norm residual block over a whole sequence.  The reference also
    returns an MoE aux loss, which is 0 for a dense block."""
    h = norm_apply(cfg.norm, params.ln1, x)
    x = x + attn.gqa_attention(params.attn, h, positions, cfg, causal=causal, window=window,
                               theta=rope_theta)
    h2 = norm_apply(cfg.norm, params.ln2, x)
    return x + mlp_apply(params.mlp, h2, cfg.act)
