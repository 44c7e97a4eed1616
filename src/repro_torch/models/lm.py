"""Model assembly: ``CausalLM`` for the dense, MoE, SSM, hybrid and VLM
families.

The port of the decoder-only part of the JAX package's
``repro/models/lm.py``.  The model is an ``nn.Module`` holding its
parameters, so the reference's pure functions lose their ``params``
argument:

  CausalLM(cfg, device).init(generator) -> the model, initialised
  forward(batch)                 -> (logits f32 (B, S, V), summed MoE aux)
  cache_shapes(batch, seq)       -> name -> shape of each decode cache entry
  cache_dtypes()                 -> name -> its dtype
  init_cache(batch, seq)         -> the zero decode cache
  prefill(batch)                 -> (last-position logits (B, V), cache)
  decode_step(cache, token, cur_len) -> (logits (B, V), cache)

The families, and their decode caches (the slot on axis 1 of every entry):

* dense / vlm: ``layers``, pre-norm transformer blocks (GQA or MLA by
  ``cfg.attn_kind``, with an MLP); GQA ``{"k", "v"}`` (L, batch, seq, KH,
  D), MLA ``{"ckv", "krope"}`` (L, batch, seq, KL | DR).  A vlm batch may
  carry ``embeds`` (B, P, d), precomputed patch embeddings put in front of
  the token embeddings (positions run over the concatenation); the decode
  plan serves text prompts.
* moe: ``dense_layers`` (its first ``first_dense_layers`` blocks, with an
  MLP), then ``layers`` (MoE blocks), as the reference stacks them; the
  cache runs over both.
* ssm (mamba2): ``layers``, Mamba-2 mixers each inside a residual around
  its ``norm_in``; ``{"h": (L, batch, H, P, N) f32, "conv": (L, batch,
  K - 1, C)}``, a state of constant size whatever the prompt's length.
* hybrid (zamba2): ``n_layers / attn_every`` groups, each ``attn_every``
  Mamba-2 layers and then the one ``shared_attn`` block (a transformer
  block with an MLP, the same weights at every group);
  ``{"ssm.h", "ssm.conv"}`` over the Mamba-2 layers as above, and
  ``{"k", "v"}`` (groups, batch, seq, KH, D) of the shared block at each
  group.

Depth is a Python loop over ``nn.ModuleList``s; gemma3's 5:1
local:global pattern is a per-layer window and rope theta
(``_gemma_scan_arrays``), passed to each layer as plain arguments.
``decode_step`` takes one position per row (``cur_len`` of shape (B,)),
writes each row's cache entries at its own position in place (a
recurrent state in place too), and returns the same cache dict.  Its MoE
layers route each row's token on its own (``moe_decode``), as the
reference's ``vmap`` of a one-token step does.  The encoder-decoder
family (``EncDecLM``) waits for Slice F6.
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
from repro_torch.models.ssm import (
    Mamba2,
    mamba2_decode_step,
    mamba2_forward,
    mamba2_state_shapes,
)

BIG_WINDOW = 1 << 30  # "no window" for gemma3's global layers

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
# The families a later slice of the port brings, each with the slice.
_LATER_FAMILIES = {
    "encdec": "the encoder-decoder family (seamless-m4t, cross attention) comes with Slice F6",
}


class CausalLM(nn.Module):
    """Decoder-only LM: embedding, the family's stack (transformer blocks,
    Mamba-2 mixers, or groups of mixers around one shared block), final
    norm, tied or separate unembedding."""

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        if cfg.family not in FAMILIES:
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
        self.blocks: List[TransformerBlock] = []
        if cfg.family in ("ssm", "hybrid"):
            self.layers = nn.ModuleList(Mamba2(cfg, self.device, dt) for _ in range(cfg.n_layers))
            if cfg.family == "hybrid":
                if cfg.n_layers % cfg.attn_every:
                    raise ValueError(f"{cfg.name}: n_layers={cfg.n_layers} is not a multiple "
                                     f"of attn_every={cfg.attn_every}")
                self.shared_attn = TransformerBlock(cfg, False, self.device, dt)
        else:
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
            self.blocks = [*(self.dense_layers if fd else ()), *self.layers]
        self.window_l, self.theta_l = self._gemma_scan_arrays()

    # ------------------------------------------------------------- params
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "CausalLM":
        """Random weights from ``generator`` (on the model's device):
        embeddings N(0, 0.02^2), matrices truncated-normal fan-in, norms
        ones (and zeros); Mamba-2 mixers as ``Mamba2.init`` draws them."""
        self.embed.init(generator)
        self.final_norm.init()
        if not self.cfg.tie_embeddings:
            self.unembed.copy_(dense_init(self.unembed.shape, generator, device=self.device))
        for block in self.blocks:
            tf_block_init(block, generator)
        if self.cfg.family in ("ssm", "hybrid"):
            for layer in self.layers:
                layer.init(generator)
        if self.cfg.family == "hybrid":
            tf_block_init(self.shared_attn, generator)
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

    def _groups(self) -> List[List[Mamba2]]:
        """The hybrid family's groups of ``attn_every`` Mamba-2 layers."""
        per = self.cfg.attn_every
        return [list(self.layers[i:i + per]) for i in range(0, len(self.layers), per)]

    # ----------------------------------------------------------- forward
    def _embed_inputs(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x (B, S, d), positions (S,)): the token embeddings, after the
        frontend's ``embeds`` (cast to the compute dtype) when the config
        has a frontend and the batch carries them."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = embed_tokens(self.embed, tokens, self.cfg)
        if self.cfg.frontend is not None and batch.get("embeds") is not None:
            embeds = torch.as_tensor(batch["embeds"], device=self.device).to(x.dtype)
            x = torch.cat([embeds, x], dim=1)
        return x, torch.arange(x.shape[1], device=self.device)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits: the reference's einsum with preferred_element_type f32."""
        if self.cfg.tie_embeddings:
            return unembed(self.embed, x)
        return matmul_f32(x, self.unembed.to(x.dtype))

    def _mamba(self, layer: Mamba2, x: torch.Tensor, return_state: bool = False):
        """One Mamba-2 layer with its residual: x + mixer(norm_in(x))."""
        out = mamba2_forward(layer, norm_apply(self.cfg.norm, layer.norm_in, x), self.cfg,
                             return_state=return_state)
        if return_state:
            return x + out[0], out[1]
        return x + out

    def forward(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits f32 (B, S, V), the MoE aux losses summed over layers; 0
        for the other families).  The reference's MoE forward passes its
        blocks no window and no per-layer theta (its prefill and decode
        do); the port does the same."""
        cfg = self.cfg
        x, positions = self._embed_inputs(batch)
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        if cfg.family == "ssm":
            for layer in self.layers:
                x = self._mamba(layer, x)
        elif cfg.family == "hybrid":
            for group in self._groups():
                for layer in group:
                    x = self._mamba(layer, x)
                x, _ = tf_block_apply(self.shared_attn, x, positions, cfg, causal=True)
        else:
            moe = cfg.family == "moe"
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
        if cfg.family in ("ssm", "hybrid"):
            prefix = "ssm." if cfg.family == "hybrid" else ""
            shapes = {prefix + name: (cfg.n_layers, *shape)
                      for name, shape in mamba2_state_shapes(cfg, batch).items()}
            if cfg.family == "hybrid":
                kv = (cfg.n_layers // cfg.attn_every, batch, seq, cfg.n_kv_heads, cfg.d_head)
                shapes.update(k=kv, v=kv)
            return shapes
        if cfg.attn_kind == "mla":
            return {"ckv": (cfg.n_layers, batch, seq, cfg.kv_lora_rank),
                    "krope": (cfg.n_layers, batch, seq, cfg.qk_rope_dim)}
        shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.d_head)
        return {"k": shape, "v": shape}

    def cache_dtypes(self) -> Dict[str, torch.dtype]:
        """Each cache entry's dtype: the compute dtype, but f32 for a
        Mamba-2 state ``h``, which the reference carries in f32."""
        dt = cdtype(self.cfg)
        return {name: torch.float32 if name.split(".")[-1] == "h" else dt
                for name in self.cache_shapes(0, 0)}

    def init_cache(self, batch: int, seq: int) -> Dict[str, torch.Tensor]:
        dtypes = self.cache_dtypes()
        return {name: torch.zeros(shape, dtype=dtypes[name], device=self.device)
                for name, shape in self.cache_shapes(batch, seq).items()}

    def _decode_attn(self, block: TransformerBlock, x, k_l, v_l, rows, cur, theta=None,
                     window=None):
        """One transformer block's decode step, GQA: write each row's k and
        v at its own position ``cur`` into the layer's cache (in place),
        attend, MLP or MoE."""
        cfg = self.cfg
        positions = cur[:, None]  # (B, 1): each row ropes at its own position
        hn = norm_apply(cfg.norm, block.ln1, x)
        k_new, v_new = attn.gqa_kv_for_cache(block.attn, hn, positions, cfg, theta)
        k_l[rows, cur] = k_new[:, 0]
        v_l[rows, cur] = v_new[:, 0]
        x = x + attn.gqa_decode(block.attn, hn, k_l, v_l, cur + 1, cfg, window=window,
                                theta=theta)
        h2 = norm_apply(cfg.norm, block.ln2, x)
        if hasattr(block, "moe"):
            return x + moe_decode(block.moe, h2, cfg)
        return x + mlp_apply(block.mlp, h2, cfg.act)

    def decode_step(
        self,
        cache: Dict[str, torch.Tensor],
        token: torch.Tensor,  # (B, 1)
        cur_len,  # (B,) or scalar: tokens already in each row's cache
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One serving step: append each row's token at its own position
        (or fold it into each row's recurrent state), return (logits (B, V)
        f32, the cache, written in place)."""
        cfg = self.cfg
        token = torch.as_tensor(token, device=self.device)
        b = token.shape[0]
        cur = torch.as_tensor(cur_len, device=self.device).long().reshape(-1).expand(b)
        rows = torch.arange(b, device=self.device)
        x = embed_tokens(self.embed, token, cfg)  # (B, 1, d)
        if cfg.family in ("ssm", "hybrid"):
            pre = "ssm." if cfg.family == "hybrid" else ""
            h, conv = cache[pre + "h"], cache[pre + "conv"]
            for i, layer in enumerate(self.layers):
                hn = norm_apply(cfg.norm, layer.norm_in, x)
                x = x + mamba2_decode_step(layer, hn, {"h": h[i], "conv": conv[i]}, cfg)
                if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                    g = i // cfg.attn_every
                    x = self._decode_attn(self.shared_attn, x, cache["k"][g], cache["v"][g],
                                          rows, cur)
        else:
            for i, block in enumerate(self.blocks):
                theta, window = self.theta_l[i], self.window_l[i]
                if cfg.attn_kind != "mla":
                    x = self._decode_attn(block, x, cache["k"][i], cache["v"][i], rows, cur,
                                          theta, window)
                    continue
                hn = norm_apply(cfg.norm, block.ln1, x)
                ckv_new, krope_new = attn.mla_latent(block.attn, hn, cur[:, None], cfg)
                ckv_l, krope_l = cache["ckv"][i], cache["krope"][i]
                ckv_l[rows, cur] = ckv_new[:, 0]
                krope_l[rows, cur] = krope_new[:, 0]
                x = x + attn.mla_decode(block.attn, hn, ckv_l, krope_l, cur + 1, cfg)
                h2 = norm_apply(cfg.norm, block.ln2, x)
                if hasattr(block, "moe"):
                    x = x + moe_decode(block.moe, h2, cfg)
                else:
                    x = x + mlp_apply(block.mlp, h2, cfg.act)
        x = norm_apply(cfg.norm, self.final_norm, x)
        return self._logits(x)[:, 0, :], cache

    # ------------------------------------------------------------ prefill
    def _prefill_block(self, block: TransformerBlock, x, positions, theta=None, window=None):
        """One transformer block over the prompt: (x, the cache entries it
        makes).  One projection serves the attention and the cache: the
        reference makes k and v (or the latent) twice, to the same
        numbers."""
        cfg = self.cfg
        hn = norm_apply(cfg.norm, block.ln1, x)
        if cfg.attn_kind == "mla":
            latent = attn.mla_latent(block.attn, hn, positions, cfg)
            a = attn.mla_attention(block.attn, hn, positions, cfg, latent=latent)
            made = dict(zip(("ckv", "krope"), latent))
        else:
            q, k, v = attn.gqa_qkv(block.attn, hn, positions, cfg, theta)
            a = attn.gqa_attention(block.attn, hn, positions, cfg, causal=True, window=window,
                                   qkv=(q, k, v))
            made = {"k": k, "v": v}
        x = x + a
        h2 = norm_apply(cfg.norm, block.ln2, x)
        if hasattr(block, "moe"):
            return x + moe_apply(block.moe, h2, cfg)[0], made
        return x + mlp_apply(block.mlp, h2, cfg.act), made

    def prefill(self, batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full-sequence forward that also materialises the decode cache.

        Returns (last-position logits (B, V), the cache: the roped k and
        the v of every position, (L, B, S, KH, D) each, or MLA's latent
        ``ckv`` and ``krope``; a Mamba-2 stack's final states).
        ``batch["last_pos"]`` picks the true prompt end of a right-padded
        prompt: causal attention keeps every position <= last_pos
        independent of the pad tail.  An MoE layer is not independent of
        it: the pad tokens route too, and the capacity is computed from the
        padded length, so once the exact-length prefill drops assignments
        the two differ (as in the reference).  Nor is a recurrent state,
        which would fold the pad tokens in: the serving plan prefills the
        ssm and hybrid families at exact length."""
        cfg = self.cfg
        x, positions = self._embed_inputs(batch)
        caches: Dict[str, List[torch.Tensor]] = {name: [] for name in self.cache_shapes(0, 0)}
        if cfg.family in ("ssm", "hybrid"):
            pre = "ssm." if cfg.family == "hybrid" else ""
            for i, layer in enumerate(self.layers):
                x, state = self._mamba(layer, x, return_state=True)
                caches[pre + "h"].append(state["h"])
                caches[pre + "conv"].append(state["conv"])
                if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                    x, made = self._prefill_block(self.shared_attn, x, positions)
                    for name, t in made.items():
                        caches[name].append(t)
        else:
            for i, block in enumerate(self.blocks):
                x, made = self._prefill_block(block, x, positions, self.theta_l[i],
                                              self.window_l[i])
                for name, t in made.items():
                    caches[name].append(t)
        x = norm_apply(cfg.norm, self.final_norm, x)
        last = batch.get("last_pos")
        x_last = x[:, -1:, :] if last is None else x[:, int(last):int(last) + 1, :]
        return self._logits(x_last)[:, 0, :], {n: torch.stack(ts) for n, ts in caches.items()}


def build_model(cfg, device="cuda") -> CausalLM:
    """The model for ``cfg`` on ``device`` (the card by default; raises
    when there is none, as ``ExecutionConfig`` does), its parameters
    allocated but not initialised: call ``init(generator)`` or load
    weights.  Raises ``NotImplementedError`` naming the slice for a family
    the port does not serve yet (encdec, Slice F6)."""
    return CausalLM(cfg, device)
