"""The transformer block of the dense, MoE and enc-dec families.

The port of ``tf_block_init`` / ``tf_block_apply`` of the JAX package's
``repro/models/blocks.py``: a pre-norm residual block, attention (GQA or
MLA, by ``cfg.attn_kind``), in a decoder block of the enc-dec family then
cross attention to the encoder's states (``cross=True``: ``ln_x`` and
``xattn``), then an MLP or an MoE.  The reference scans stacked layer
params with per-layer scalars riding along (gemma3's window and rope
theta); here the model loops over an ``nn.ModuleList`` and passes each
layer's window and theta as plain arguments.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import MLP, Norm, mlp_apply, norm_apply
from repro_torch.models.moe import MoE, moe_apply


class TransformerBlock(nn.Module):
    """``ln1``, ``attn``, ``ln2``, and ``mlp`` or ``moe``; with ``cross``
    also ``ln_x`` and ``xattn`` (GQA): the reference's block pytree."""

    def __init__(self, cfg, use_moe: bool = False, device=None, dtype=torch.float32,
                 cross: bool = False):
        super().__init__()
        self.ln1 = Norm(cfg.norm, cfg.d_model, device)
        self.ln2 = Norm(cfg.norm, cfg.d_model, device)
        self.attn = (attn.MLA if cfg.attn_kind == "mla" else attn.GQA)(cfg, device, dtype)
        if use_moe:
            self.moe = MoE(cfg, device, dtype)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, device, dtype)
        if cross:
            self.ln_x = Norm(cfg.norm, cfg.d_model, device)
            self.xattn = attn.GQA(cfg, device, dtype)


def tf_block_init(block: TransformerBlock, generator: torch.Generator) -> None:
    block.ln1.init()
    block.ln2.init()
    block.attn.init(generator)
    (block.moe if hasattr(block, "moe") else block.mlp).init(generator)
    if hasattr(block, "xattn"):
        block.ln_x.init()
        block.xattn.init(generator)


def tf_block_apply(
    params: TransformerBlock,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg,
    causal: bool = True,
    window: Optional[int] = None,
    rope_theta: Optional[float] = None,
    enc: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-norm residual block over a whole sequence; returns (x, the MoE
    aux loss, or 0 for an MLP block).  ``enc``: the encoder's states, which
    a cross block attends to after its self attention."""
    h = norm_apply(cfg.norm, params.ln1, x)
    if cfg.attn_kind == "mla":
        a = attn.mla_attention(params.attn, h, positions, cfg, causal=causal)
    else:
        a = attn.gqa_attention(params.attn, h, positions, cfg, causal=causal, window=window,
                               theta=rope_theta)
    x = x + a
    if enc is not None:
        x = x + attn.cross_attention(params.xattn, norm_apply(cfg.norm, params.ln_x, x), enc, cfg)
    h2 = norm_apply(cfg.norm, params.ln2, x)
    if hasattr(params, "moe"):
        f, aux = moe_apply(params.moe, h2, cfg)
    else:
        f, aux = mlp_apply(params.mlp, h2, cfg.act), torch.zeros((), device=x.device)
    return x + f, aux
