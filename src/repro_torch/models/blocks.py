"""The transformer block of the dense and MoE families.

The port of ``tf_block_init`` / ``tf_block_apply`` of the JAX package's
``repro/models/blocks.py``: a pre-norm residual block, attention (GQA or
MLA, by ``cfg.attn_kind``) then an MLP or an MoE.  The reference scans
stacked layer params with per-layer scalars riding along (gemma3's window
and rope theta); here the model loops over an ``nn.ModuleList`` and passes
each layer's window and theta as plain arguments.  Cross attention waits
for the slice that brings the enc-dec family.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import MLP, Norm, mlp_apply, norm_apply
from repro_torch.models.moe import MoE, moe_apply


class TransformerBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, and ``mlp`` or ``moe``: the reference's
    block pytree."""

    def __init__(self, cfg, use_moe: bool = False, device=None, dtype=torch.float32):
        super().__init__()
        self.ln1 = Norm(cfg.norm, cfg.d_model, device)
        self.ln2 = Norm(cfg.norm, cfg.d_model, device)
        self.attn = (attn.MLA if cfg.attn_kind == "mla" else attn.GQA)(cfg, device, dtype)
        if use_moe:
            self.moe = MoE(cfg, device, dtype)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, device, dtype)


def tf_block_init(block: TransformerBlock, generator: torch.Generator) -> None:
    block.ln1.init()
    block.ln2.init()
    block.attn.init(generator)
    (block.moe if hasattr(block, "moe") else block.mlp).init(generator)


def tf_block_apply(
    params: TransformerBlock,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg,
    causal: bool = True,
    window: Optional[int] = None,
    rope_theta: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm residual block over a whole sequence; returns (x, the MoE
    aux loss, or 0 for an MLP block)."""
    h = norm_apply(cfg.norm, params.ln1, x)
    if cfg.attn_kind == "mla":
        a = attn.mla_attention(params.attn, h, positions, cfg, causal=causal)
    else:
        a = attn.gqa_attention(params.attn, h, positions, cfg, causal=causal, window=window,
                               theta=rope_theta)
    x = x + a
    h2 = norm_apply(cfg.norm, params.ln2, x)
    if hasattr(params, "moe"):
        f, aux = moe_apply(params.moe, h2, cfg)
    else:
        f, aux = mlp_apply(params.mlp, h2, cfg.act), torch.zeros((), device=x.device)
    return x + f, aux
