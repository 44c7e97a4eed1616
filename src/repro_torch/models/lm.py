"""Model assembly: ``CausalLM`` for the dense and MoE families.

The port of the dense and MoE parts of the JAX package's
``repro/models/lm.py``.  The model is an ``nn.Module`` holding its
parameters, so the reference's pure functions lose their ``params``
argument:

  CausalLM(cfg, device).init(generator) -> the model, initialised
  forward(batch)                 -> (logits f32 (B, S, V), summed MoE aux)
  init_cache(batch, seq)         -> GQA {"k", "v"}: (L, batch, seq, KH, D);
                                    MLA {"ckv", "krope"}: (L, batch, seq, KL | DR)
  prefill(batch)                 -> (last-position logits (B, V), cache)
  decode_step(cache, token, cur_len) -> (logits (B, V), cache)

The MoE family holds ``dense_layers`` (its first ``first_dense_layers``
blocks, with an MLP) and then ``layers`` (MoE blocks), as the reference
stacks them; the cache runs over both, split at ``first_dense_layers``.
Either family takes GQA or MLA attention by ``cfg.attn_kind``.

Depth is a Python loop over ``nn.ModuleList``s; gemma3's 5:1
local:global pattern is a per-layer window and rope theta
(``_gemma_scan_arrays``), passed to each layer as plain arguments.
``decode_step`` takes one position per row (``cur_len`` of shape (B,)),
writes each row's cache entries at its own position in place, and returns
the same cache dict.  Its MoE layers route each row's token on its own
(``moe_decode``), as the reference's ``vmap`` of a one-token step does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.core.compiled import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.blocks import TransformerBlock, tf_block_apply, tf_block_init
from repro_torch.models.common import (
    Embedding,
    Norm,
    _param,
    cdtype,
    dense_init,
    embed_tokens,
    matmul_f32,
    mlp_apply,
    norm_apply,
    unembed,
)
from repro_torch.models.moe import moe_apply, moe_decode

BIG_WINDOW = 1 << 30  # "no window" for gemma3's global layers

# The families a later slice of the port brings, each with the slice.
_LATER_FAMILIES = {
    "ssm": "the SSM family (mamba2) comes with Slice F3",
    "hybrid": "the hybrid family (zamba2) comes with Slice F4",
    "vlm": "the VLM family (internvl2, patch-embedding frontend) comes with Slice F5",
    "encdec": "the encoder-decoder family (seamless-m4t, cross attention) comes with Slice F6",
}


class CausalLM(nn.Module):
    """Decoder-only LM: embedding, ``n_layers`` pre-norm blocks (GQA or
    MLA; MLP, or MoE after the MoE family's first dense layers), final
    norm, tied or separate unembedding."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"{cfg.name}: family {cfg.family!r} is not ported yet: "
                f"{_LATER_FAMILIES.get(cfg.family, 'no slice brings it')}"
            )
        self.cfg = cfg
        self.device = resolve_device(device)  # the card unless the caller asks for the CPU
        dt = cdtype(cfg)
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, self.device, dt)
        self.final_norm = Norm(cfg.norm, cfg.d_model, self.device)
        if not cfg.tie_embeddings:
            self.unembed = _param((cfg.d_model, cfg.vocab_size), self.device, dt)
        fd = cfg.first_dense_layers if cfg.family == "moe" else 0
        if fd:
            self.dense_layers = nn.ModuleList(
                TransformerBlock(cfg, False, self.device, dt) for _ in range(fd)
            )
        self.layers = nn.ModuleList(
            TransformerBlock(cfg, cfg.family == "moe", self.device, dt)
            for _ in range(cfg.n_layers - fd)
        )
        # Every block in cache order: the dense stack, then the MoE stack.
        self.blocks: List[TransformerBlock] = [*(self.dense_layers if fd else ()), *self.layers]
        self.window_l, self.theta_l = self._gemma_scan_arrays()

    # ------------------------------------------------------------- params
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "CausalLM":
        """Random weights from ``generator`` (on the model's device):
        embeddings N(0, 0.02^2), matrices truncated-normal fan-in, norms
        ones (and zeros)."""
        self.embed.init(generator)
        self.final_norm.init()
        if not self.cfg.tie_embeddings:
            self.unembed.copy_(dense_init(self.unembed.shape, generator, device=self.device))
        for block in self.blocks:
            tf_block_init(block, generator)
        return self

    def _gemma_scan_arrays(self) -> Tuple[List[Optional[int]], List[float]]:
        """(window_l, theta_l) per layer: gemma3's 5:1 local:global pattern
        (every ``global_every``-th layer global, ``BIG_WINDOW`` and
        ``rope_theta_global``), else ``cfg.window`` and ``cfg.rope_theta``
        on every layer.  The reference's prefill and decode scan the MoE
        family's two stacks (``first_dense_layers`` > 0) without the
        per-layer arrays."""
        cfg = self.cfg
        two_stacks = cfg.family == "moe" and cfg.first_dense_layers > 0
        if not (cfg.global_every > 0 and cfg.window is not None) or two_stacks:
            return [cfg.window or None] * cfg.n_layers, [cfg.rope_theta] * cfg.n_layers
        win, theta = [], []
        for i in range(cfg.n_layers):
            is_global = (i + 1) % cfg.global_every == 0
            win.append(BIG_WINDOW if is_global else cfg.window)
            theta.append((cfg.rope_theta_global or cfg.rope_theta) if is_global else cfg.rope_theta)
        return win, theta

    # ----------------------------------------------------------- forward
    def _embed_inputs(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = embed_tokens(self.embed, tokens, self.cfg)
        return x, torch.arange(x.shape[1], device=self.device)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits: the reference's einsum with preferred_element_type f32."""
        if self.cfg.tie_embeddings:
            return unembed(self.embed, x)
        return matmul_f32(x, self.unembed.to(x.dtype))

    def forward(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits f32 (B, S, V), the MoE aux losses summed over layers).
        The reference's MoE forward passes its blocks no window and no
        per-layer theta (its prefill and decode do); the port does the
        same."""
        cfg = self.cfg
        moe = cfg.family == "moe"
        x, positions = self._embed_inputs(batch)
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, block in enumerate(self.blocks):
            x, aux = tf_block_apply(block, x, positions, cfg, causal=True,
                                    window=None if moe else self.window_l[i],
                                    rope_theta=None if moe else self.theta_l[i])
            aux_total = aux_total + aux
        x = norm_apply(cfg.norm, self.final_norm, x)
        return self._logits(x), aux_total

    # ------------------------------------------------------------- decode
    def cache_shapes(self, batch: int, seq: int) -> Dict[str, Tuple[int, ...]]:
        cfg = self.cfg
        if cfg.attn_kind == "mla":
            return {"ckv": (cfg.n_layers, batch, seq, cfg.kv_lora_rank),
                    "krope": (cfg.n_layers, batch, seq, cfg.qk_rope_dim)}
        shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.d_head)
        return {"k": shape, "v": shape}

    def init_cache(self, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        dt = cdtype(self.cfg)
        return {name: torch.zeros(shape, dtype=dt, device=self.device)
                for name, shape in self.cache_shapes(batch, seq).items()}

    def decode_step(
        self,
        cache: Dict[str, torch.Tensor],
        token: torch.Tensor,  # (B, 1)
        cur_len,  # (B,) or scalar: tokens already in each row's cache
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One serving step: append each row's token at its own position,
        attend, return (logits (B, V) f32, the cache, written in place)."""
        cfg = self.cfg
        token = torch.as_tensor(token, device=self.device)
        b = token.shape[0]
        cur = torch.as_tensor(cur_len, device=self.device).long().reshape(-1).expand(b)
        rows = torch.arange(b, device=self.device)
        positions = cur[:, None]  # (B, 1): each row ropes at its own position
        kv_len = cur + 1
        x = embed_tokens(self.embed, token, cfg)  # (B, 1, d)
        for i, block in enumerate(self.blocks):
            theta, window = self.theta_l[i], self.window_l[i]
            hn = norm_apply(cfg.norm, block.ln1, x)
            if cfg.attn_kind == "mla":
                ckv_new, krope_new = attn.mla_latent(block.attn, hn, positions, cfg)
                ckv_l, krope_l = cache["ckv"][i], cache["krope"][i]
                ckv_l[rows, cur] = ckv_new[:, 0]
                krope_l[rows, cur] = krope_new[:, 0]
                a = attn.mla_decode(block.attn, hn, ckv_l, krope_l, kv_len, cfg)
            else:
                k_new, v_new = attn.gqa_kv_for_cache(block.attn, hn, positions, cfg, theta)
                k_l, v_l = cache["k"][i], cache["v"][i]
                k_l[rows, cur] = k_new[:, 0]
                v_l[rows, cur] = v_new[:, 0]
                a = attn.gqa_decode(block.attn, hn, k_l, v_l, kv_len, cfg, window=window,
                                    theta=theta)
            x = x + a
            h2 = norm_apply(cfg.norm, block.ln2, x)
            if hasattr(block, "moe"):
                x = x + moe_decode(block.moe, h2, cfg)
            else:
                x = x + mlp_apply(block.mlp, h2, cfg.act)
        x = norm_apply(cfg.norm, self.final_norm, x)
        return self._logits(x)[:, 0, :], cache

    # ------------------------------------------------------------ prefill
    def prefill(self, batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full-sequence forward that also materialises the decode cache.

        Returns (last-position logits (B, V), the cache: the roped k and
        the v of every position, (L, B, S, KH, D) each, or MLA's latent
        ``ckv`` and ``krope``).  ``batch["last_pos"]`` picks the true prompt
        end of a right-padded prompt: causal attention keeps every position
        <= last_pos independent of the pad tail.  An MoE layer is not
        independent of it: the pad tokens route too, and the capacity is
        computed from the padded length, so once the exact-length prefill
        drops assignments the two differ (as in the reference)."""
        cfg = self.cfg
        x, positions = self._embed_inputs(batch)
        caches: Dict[str, List[torch.Tensor]] = {name: [] for name in self.cache_shapes(0, 0)}
        for i, block in enumerate(self.blocks):
            hn = norm_apply(cfg.norm, block.ln1, x)
            # One projection serves the attention and the cache: the
            # reference makes k and v (or the latent) twice, to the same
            # numbers.
            if cfg.attn_kind == "mla":
                latent = attn.mla_latent(block.attn, hn, positions, cfg)
                a = attn.mla_attention(block.attn, hn, positions, cfg, latent=latent)
                made = dict(zip(("ckv", "krope"), latent))
            else:
                q, k, v = attn.gqa_qkv(block.attn, hn, positions, cfg, self.theta_l[i])
                a = attn.gqa_attention(block.attn, hn, positions, cfg, causal=True,
                                       window=self.window_l[i], qkv=(q, k, v))
                made = {"k": k, "v": v}
            for name, t in made.items():
                caches[name].append(t)
            x = x + a
            h2 = norm_apply(cfg.norm, block.ln2, x)
            if hasattr(block, "moe"):
                x = x + moe_apply(block.moe, h2, cfg)[0]
            else:
                x = x + mlp_apply(block.mlp, h2, cfg.act)
        x = norm_apply(cfg.norm, self.final_norm, x)
        last = batch.get("last_pos")
        x_last = x[:, -1:, :] if last is None else x[:, int(last):int(last) + 1, :]
        return self._logits(x_last)[:, 0, :], {n: torch.stack(ts) for n, ts in caches.items()}


def build_model(cfg, device="cuda") -> CausalLM:
    """The model for ``cfg`` on ``device`` (the card by default; raises
    when there is none, as ``ExecutionConfig`` does), its parameters
    allocated but not initialised: call ``init(generator)`` or load
    weights.  Raises ``NotImplementedError`` naming the slice for a family
    the port does not serve yet."""
    return CausalLM(cfg, device)
