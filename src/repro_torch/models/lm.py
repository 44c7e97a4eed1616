"""Model assembly: ``CausalLM`` for the dense, MoE, SSM, hybrid and VLM
families, ``EncDecLM`` for the encoder-decoder family, and their training
step.

The port of the JAX package's ``repro/models/lm.py``.  The model is an
``nn.Module`` holding its parameters, so the reference's serving
functions lose their ``params`` argument:

  CausalLM(cfg, device).init(generator) -> the model, initialised
  forward(batch, params=None)    -> (logits f32 (B, S, V), summed MoE aux)
  cache_shapes(batch, seq)       -> name -> shape of each decode cache entry
  cache_dtypes()                 -> name -> its dtype
  init_cache(batch, seq)         -> the zero decode cache
  prefill(batch)                 -> (last-position logits (B, V), cache)
  decode_step(cache, token, cur_len) -> (logits (B, V), cache)

and training keeps the reference's functional form over a tree of tensors
(``params()``: nested dicts under the parts of the reference's flat keys,
each stack's layers stacked on a leading axis, so a checkpoint of it
crosses between the packages):

  loss(params, batch)                     -> scalar f32
  make_train_step(optimizer, n_micro)     -> step(params, opt_state, batch)
                                             -> (params, opt_state, {"loss"})

``forward(batch, params)`` reads every weight from ``params`` through a
``ParamView`` (each stacked leaf unbound once, so its gradient is one
stack), with ``cfg.remat`` each layer under ``torch.utils.checkpoint``.
A model built with ``param_dtype=torch.float32`` holds the f32 masters the
reference trains; every use casts to the compute dtype.

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
* encdec (seamless-m4t, ``EncDecLM``): ``enc_layers`` (non-causal blocks
  over the source's frame embeddings ``enc_embeds`` (B, Senc, d)), then
  ``dec_layers`` (causal blocks, each with cross attention to the
  encoder's states); ``{"k", "v"}`` (Ld, batch, seq, KH, D) of the
  decoder's self attention and ``{"xk", "xv"}`` (Ld, batch, Senc, KH, D),
  the encoder's states projected once at prefill.  The decode plan
  refuses the family, as the reference's does: the model's functions
  serve it.

Depth is a Python loop over ``nn.ModuleList``s; gemma3's 5:1
local:global pattern is a per-layer window and rope theta
(``_gemma_scan_arrays``), passed to each layer as plain arguments.
``decode_step`` takes one position per row (``cur_len`` of shape (B,)),
writes each row's cache entries at its own position in place (a
recurrent state in place too), and returns the same cache dict.  Its MoE
layers route each row's token on its own (``moe_decode``), as the
reference's ``vmap`` of a one-token step does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
from repro_torch.optim.accumulation import microbatched_value_and_grad
from repro_torch.optim.adamw import apply_updates, tree_map

BIG_WINDOW = 1 << 30  # "no window" for gemma3's global layers

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
# The stacks the reference scans: each of its flat keys holds every layer
# of the stack on a leading axis.
STACKS = ("layers", "dense_layers", "enc_layers", "dec_layers")


def flat_key(name: str) -> Tuple[str, Optional[int]]:
    """A parameter's ``state_dict`` name -> (the reference's flat key, the
    layer its stacked array is cut at, or None)."""
    parts = name.split(".")
    if parts[0] in STACKS:
        return parts[0] + "/" + "/".join(parts[2:]), int(parts[1])
    return "/".join(parts), None


def model_device(device) -> torch.device:
    """The device a model is built on: ``"meta"`` for the dry run
    (``launch/dryrun.py``: shapes, dtypes and counts, nothing allocated,
    nothing initialised), else ``resolve_device``'s card or CPU."""
    if torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy in f32; labels == -1 are masked.
    ``cfg.sharded_xent`` is accepted and changes nothing: the reference's
    where/iota label pick serves vocab-sharded logits, and on one card it
    picks the same numbers as this gather."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.clamp_min(0)[..., None].long())[..., 0]
    mask = (labels >= 0).float()
    return ((logz - ll) * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


class ParamView:
    """A model read through a tree of tensors: an attribute that names one
    of the module's parameters gives the tree's tensor in its place, a
    submodule (or a list of them) gives its view, anything else the
    module's own attribute.  The model functions take it where they take
    the module."""

    __slots__ = ("_module", "_prefix", "_values", "_names")

    def __init__(self, module: nn.Module, prefix: str, values: Dict[str, torch.Tensor],
                 names: Dict[int, str]):
        self._module, self._prefix, self._values, self._names = module, prefix, values, names

    def __getattr__(self, name: str):
        key = self._prefix + name
        if key in self._values:
            return self._values[key]
        return self._wrap(getattr(self._module, name))

    def _wrap(self, v):
        if isinstance(v, (list, tuple, nn.ModuleList)):
            return [self._wrap(x) for x in v]
        if isinstance(v, nn.Module):
            prefix = self._names[id(v)]
            return ParamView(v, prefix + "." if prefix else "", self._values, self._names)
        return v


def _tree_get(tree: Dict, key: str) -> torch.Tensor:
    for part in key.split("/"):
        tree = tree[part]
    return tree


def _tree_put(tree: Dict, key: str, value: torch.Tensor) -> None:
    *parts, last = key.split("/")
    for part in parts:
        tree = tree.setdefault(part, {})
    tree[last] = value


def _mamba(layer: Mamba2, x: torch.Tensor, cfg, return_state: bool = False):
    """One Mamba-2 layer with its residual: x + mixer(norm_in(x))."""
    out = mamba2_forward(layer, norm_apply(cfg.norm, layer.norm_in, x), cfg,
                         return_state=return_state)
    if return_state:
        return x + out[0], out[1]
    return x + out


def _attn_step(cfg, block, x, k_l, v_l, rows, cur, theta=None, window=None) -> torch.Tensor:
    """A transformer block's self attention for one token a row, GQA, with
    its residual: each row's k and v written at its own position ``cur``
    into the layer's cache (in place), then attended."""
    hn = norm_apply(cfg.norm, block.ln1, x)
    k_new, v_new = attn.gqa_kv_for_cache(block.attn, hn, cur[:, None], cfg, theta)
    k_l[rows, cur] = k_new[:, 0]
    v_l[rows, cur] = v_new[:, 0]
    return x + attn.gqa_decode(block.attn, hn, k_l, v_l, cur + 1, cfg, window=window,
                               theta=theta)


def _ffn_step(cfg, block, x) -> torch.Tensor:
    """A block's MLP, or its MoE routing each row on its own, with the
    residual."""
    h2 = norm_apply(cfg.norm, block.ln2, x)
    if hasattr(block, "moe"):
        return x + moe_decode(block.moe, h2, cfg)
    return x + mlp_apply(block.mlp, h2, cfg.act)


def _decode_inputs(model, token, cur_len):
    """(token (B, 1), cur (B,) int64, rows (B,)) on the model's device."""
    token = torch.as_tensor(token, device=model.device)
    b = token.shape[0]
    cur = torch.as_tensor(cur_len, device=model.device).long().reshape(-1).expand(b)
    return token, cur, torch.arange(b, device=model.device)


class _LM(nn.Module):
    """What both model classes share: the tree of parameters, the view
    that reads one, the per-layer rematerialisation and the train step."""

    def params(self) -> Dict:
        """The reference's pytree of this model's weights: nested dicts
        under the parts of the flat keys, each stack's layers stacked on a
        leading axis.  New tensors, not attached to the module's."""
        tree, stacks = {}, {}
        for name, p in self.named_parameters():
            key, layer = flat_key(name)
            if layer is None:
                _tree_put(tree, key, p.detach().clone())
            else:
                stacks.setdefault(key, []).append(p.detach())
        for key, ts in stacks.items():
            _tree_put(tree, key, torch.stack(ts))
        return tree

    def bind(self, params: Dict) -> ParamView:
        """The model read through ``params`` (``params()``'s tree)."""
        values, unbound = {}, {}
        for name, _ in self.named_parameters():
            key, layer = flat_key(name)
            if layer is None:
                values[name] = _tree_get(params, key)
            else:
                if key not in unbound:
                    unbound[key] = torch.unbind(_tree_get(params, key))
                values[name] = unbound[key][layer]
        names = {id(m): n for n, m in self.named_modules()}
        return ParamView(self, "", values, names)

    def _view(self, params):
        """(the model read through ``params``, or the module itself; whether
        its layers recompute in the backward: ``cfg.remat`` while autograd
        records a graph of trainable weights)."""
        trains = params is not None or any(p.requires_grad for p in self.parameters())
        remat = bool(self.cfg.remat) and torch.is_grad_enabled() and trains
        return (self if params is None else self.bind(params)), remat

    @staticmethod
    def _layer(remat: bool, fn, *args, **kw):
        """``fn(*args, **kw)``, with ``remat`` inside ``torch.utils.checkpoint``
        (the reference's ``jax.checkpoint`` around each layer's body)."""
        if remat:
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)
        return fn(*args, **kw)

    def _cast_once(self) -> bool:
        return False

    def make_train_step(self, optimizer, n_micro: Optional[int] = None):
        """(params, opt_state, batch) -> (params, opt_state, {"loss": ...}).

        The loss and its gradients (summed in f32 over ``n_micro``
        microbatches, default ``cfg.n_micro``), then ``optimizer.update``
        and ``apply_updates``.  Functional: nothing given is written.  A
        mesh-free step constrains no gradients (``cfg.constrain_grads``);
        ``cfg.cast_params_once`` casts every f32 leaf to bf16 before the
        loss, as the reference does for ``CausalLM``."""
        n_micro = n_micro if n_micro is not None else self.cfg.n_micro
        loss_fn = self.loss
        if self._cast_once():
            def loss_fn(params, batch):
                return self.loss(tree_map(
                    lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 else p, params),
                    batch)

        vg = microbatched_value_and_grad(loss_fn, n_micro)

        def step(params, opt_state, batch):
            loss, grads = vg(params, batch)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            return apply_updates(params, updates), opt_state, {"loss": loss}

        return step


class CausalLM(_LM):
    """Decoder-only LM: embedding, the family's stack (transformer blocks,
    Mamba-2 mixers, or groups of mixers around one shared block), final
    norm, tied or separate unembedding."""

    def __init__(self, cfg, device="cuda", param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not a decoder-only family")
        self.cfg = cfg
        self.device = model_device(device)  # the card unless the caller asks for the CPU or meta
        dt = param_dtype or cdtype(cfg)
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

    def _groups(self, layers) -> List[List[Mamba2]]:
        """The hybrid family's groups of ``attn_every`` Mamba-2 layers."""
        per = self.cfg.attn_every
        return [list(layers[i:i + per]) for i in range(0, len(layers), per)]

    def _cast_once(self) -> bool:
        return self.cfg.cast_params_once

    # ----------------------------------------------------------- forward
    def _embed_inputs(self, batch: Dict, embed) -> Tuple[torch.Tensor, torch.Tensor]:
        """(x (B, S, d), positions (S,)): the token embeddings, after the
        frontend's ``embeds`` (cast to the compute dtype) when the config
        has a frontend and the batch carries them."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = embed_tokens(embed, tokens, self.cfg)
        if self.cfg.frontend is not None and batch.get("embeds") is not None:
            embeds = torch.as_tensor(batch["embeds"], device=self.device).to(x.dtype)
            x = torch.cat([embeds, x], dim=1)
        return x, torch.arange(x.shape[1], device=self.device)

    def _logits(self, x: torch.Tensor, p) -> torch.Tensor:
        """f32 logits: the reference's einsum with preferred_element_type f32."""
        if self.cfg.tie_embeddings:
            return unembed(p.embed, x)
        return matmul_f32(x, p.unembed.to(x.dtype))

    def forward(self, batch: Dict, params: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits f32 (B, S, V), the MoE aux losses summed over layers; 0
        for the other families), from the module's weights or from
        ``params`` (``params()``'s tree).  The reference's MoE forward
        passes its blocks no window and no per-layer theta (its prefill and
        decode do); the port does the same."""
        cfg = self.cfg
        p, remat = self._view(params)
        x, positions = self._embed_inputs(batch, p.embed)
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        if cfg.family == "ssm":
            for layer in p.layers:
                x = self._layer(remat, _mamba, layer, x, cfg)
        elif cfg.family == "hybrid":
            for group in self._groups(p.layers):
                for layer in group:
                    x = self._layer(remat, _mamba, layer, x, cfg)
                x, _ = self._layer(remat, tf_block_apply, p.shared_attn, x, positions, cfg,
                                   causal=True)
        else:
            moe = cfg.family == "moe"
            for i, block in enumerate(p.blocks):
                x, aux = self._layer(remat, tf_block_apply, block, x, positions, cfg, causal=True,
                                     window=None if moe else self.window_l[i],
                                     rope_theta=None if moe else self.theta_l[i])
                aux_total = aux_total + aux
        x = norm_apply(cfg.norm, p.final_norm, x)
        return self._logits(x, p), aux_total

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """The reference's ``loss``: next-token cross entropy over the
        text positions (a vlm batch's ``embeds`` are not scored), plus
        ``aux_loss_coef`` x the MoE aux loss."""
        cfg = self.cfg
        logits, aux = self.forward(batch, params)
        if cfg.frontend is not None and batch.get("embeds") is not None:
            logits = logits[:, batch["embeds"].shape[1]:, :]
        labels = torch.as_tensor(batch["labels"], device=self.device)
        return _xent(logits, labels) + cfg.aux_loss_coef * aux

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
        token, cur, rows = _decode_inputs(self, token, cur_len)
        x = embed_tokens(self.embed, token, cfg)  # (B, 1, d)
        if cfg.family in ("ssm", "hybrid"):
            pre = "ssm." if cfg.family == "hybrid" else ""
            h, conv = cache[pre + "h"], cache[pre + "conv"]
            for i, layer in enumerate(self.layers):
                hn = norm_apply(cfg.norm, layer.norm_in, x)
                x = x + mamba2_decode_step(layer, hn, {"h": h[i], "conv": conv[i]}, cfg)
                if cfg.family == "hybrid" and (i + 1) % cfg.attn_every == 0:
                    g = i // cfg.attn_every
                    x = _attn_step(cfg, self.shared_attn, x, cache["k"][g], cache["v"][g],
                                   rows, cur)
                    x = _ffn_step(cfg, self.shared_attn, x)
        else:
            for i, block in enumerate(self.blocks):
                if cfg.attn_kind != "mla":
                    x = _attn_step(cfg, block, x, cache["k"][i], cache["v"][i], rows, cur,
                                   self.theta_l[i], self.window_l[i])
                else:
                    hn = norm_apply(cfg.norm, block.ln1, x)
                    ckv_new, krope_new = attn.mla_latent(block.attn, hn, cur[:, None], cfg)
                    ckv_l, krope_l = cache["ckv"][i], cache["krope"][i]
                    ckv_l[rows, cur] = ckv_new[:, 0]
                    krope_l[rows, cur] = krope_new[:, 0]
                    x = x + attn.mla_decode(block.attn, hn, ckv_l, krope_l, cur + 1, cfg)
                x = _ffn_step(cfg, block, x)
        x = norm_apply(cfg.norm, self.final_norm, x)
        return self._logits(x, self)[:, 0, :], cache

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
        x, positions = self._embed_inputs(batch, self.embed)
        caches: Dict[str, List[torch.Tensor]] = {name: [] for name in self.cache_shapes(0, 0)}
        if cfg.family in ("ssm", "hybrid"):
            pre = "ssm." if cfg.family == "hybrid" else ""
            for i, layer in enumerate(self.layers):
                x, state = _mamba(layer, x, cfg, return_state=True)
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
        return self._logits(_last(x, batch), self)[:, 0, :], {
            n: torch.stack(ts) for n, ts in caches.items()}


def _last(x: torch.Tensor, batch: Dict) -> torch.Tensor:
    """x at the prompt's last position (B, 1, d): ``batch["last_pos"]``
    when a right-padded prompt gives it, else the last row."""
    last = batch.get("last_pos")
    return x[:, -1:, :] if last is None else x[:, int(last):int(last) + 1, :]


class EncDecLM(_LM):
    """Encoder-decoder (seamless-m4t): the encoder over the source's frame
    embeddings, the decoder over text with cross attention to the
    encoder's states, and a separate unembedding.

      encode(enc_embeds, params=None)  -> the encoder's states (B, Senc, d)
      forward(batch, params=None)      -> (logits f32 (B, S, V), 0)
      cache_shapes(batch, seq, enc_seq), cache_dtypes()
      init_cache(batch, seq, enc_seq)  -> the zero decode cache
      prefill(batch)                   -> (last-position logits (B, V), cache)
      decode_step(cache, token, cur_len) -> (logits (B, V), cache)

    A batch holds ``enc_embeds`` (B, Senc, d) and ``tokens`` (B, S), and
    ``labels`` to train."""

    def __init__(self, cfg, device="cuda", param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"{cfg.name}: family {cfg.family!r} is not the enc-dec family")
        self.cfg = cfg
        self.device = model_device(device)
        dt = param_dtype or cdtype(cfg)
        d = cfg.d_model
        self.embed = Embedding(cfg.vocab_size, d, self.device, dt)
        self.enc_layers = nn.ModuleList(
            TransformerBlock(cfg, False, self.device, dt) for _ in range(cfg.n_layers))
        self.dec_layers = nn.ModuleList(
            TransformerBlock(cfg, False, self.device, dt, cross=True)
            for _ in range(cfg.n_dec_layers))
        self.enc_norm = Norm(cfg.norm, d, self.device)
        self.final_norm = Norm(cfg.norm, d, self.device)
        self.unembed = _param((d, cfg.vocab_size), self.device, dt)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "EncDecLM":
        """``EncDecLM.init``'s distributions, as ``CausalLM.init`` draws
        them; a decoder block's ``xattn`` as its ``attn``."""
        self.embed.init(generator)
        self.enc_norm.init()
        self.final_norm.init()
        self.unembed.copy_(dense_init(self.unembed.shape, generator, device=self.device))
        for block in (*self.enc_layers, *self.dec_layers):
            tf_block_init(block, generator)
        return self

    # ----------------------------------------------------------- forward
    def _encode(self, p, remat: bool, enc_embeds) -> torch.Tensor:
        cfg = self.cfg
        x = torch.as_tensor(enc_embeds, device=self.device).to(cdtype(cfg))
        positions = torch.arange(x.shape[1], device=self.device)
        for block in p.enc_layers:
            x, _ = self._layer(remat, tf_block_apply, block, x, positions, cfg, causal=False)
        return norm_apply(cfg.norm, p.enc_norm, x)

    def encode(self, enc_embeds, params: Optional[Dict] = None) -> torch.Tensor:
        """The encoder: non-causal blocks over the frame embeddings (cast to
        the compute dtype), then ``enc_norm``."""
        return self._encode(*self._view(params), enc_embeds)

    def _tokens(self, batch, embed) -> Tuple[torch.Tensor, torch.Tensor]:
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        return embed_tokens(embed, tokens, self.cfg), torch.arange(tokens.shape[1],
                                                                   device=self.device)

    def forward(self, batch: Dict, params: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(logits f32 (B, S, V), 0): the decoder over ``tokens`` attending
        to ``encode(enc_embeds)``."""
        cfg = self.cfg
        p, remat = self._view(params)
        enc = self._encode(p, remat, batch["enc_embeds"])
        x, positions = self._tokens(batch, p.embed)
        for block in p.dec_layers:
            x, _ = self._layer(remat, tf_block_apply, block, x, positions, cfg, causal=True,
                               enc=enc)
        x = norm_apply(cfg.norm, p.final_norm, x)
        return (matmul_f32(x, p.unembed.to(x.dtype)),
                torch.zeros((), dtype=torch.float32, device=self.device))

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Next-token cross entropy of the decoder's logits."""
        logits, _ = self.forward(batch, params)
        labels = torch.as_tensor(batch["labels"], device=self.device)
        return _xent(logits, labels)

    # ------------------------------------------------------------- decode
    def cache_shapes(self, batch: int, seq: int, enc_seq: int) -> Dict[str, Tuple[int, ...]]:
        cfg = self.cfg
        kv = (cfg.n_dec_layers, batch, seq, cfg.n_kv_heads, cfg.d_head)
        xkv = (cfg.n_dec_layers, batch, enc_seq, cfg.n_kv_heads, cfg.d_head)
        return {"k": kv, "v": kv, "xk": xkv, "xv": xkv}

    def cache_dtypes(self) -> Dict[str, torch.dtype]:
        return {name: cdtype(self.cfg) for name in ("k", "v", "xk", "xv")}

    def init_cache(self, batch: int, seq: int, enc_seq: int) -> Dict[str, torch.Tensor]:
        dtypes = self.cache_dtypes()
        return {name: torch.zeros(shape, dtype=dtypes[name], device=self.device)
                for name, shape in self.cache_shapes(batch, seq, enc_seq).items()}

    def prefill(self, batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Encode the source, run the decoder over the prompt, and make
        every cache: the roped self-attention k/v of each position (Ld, B,
        S, KH, D) and each layer's cross k/v of the encoder's states (Ld,
        B, Senc, KH, D), one projection each serving the attention and the
        cache.  Returns (last-position logits (B, V), the cache);
        ``batch["last_pos"]`` picks the end of a right-padded prompt."""
        cfg = self.cfg
        enc = self._encode(self, False, batch["enc_embeds"])
        x, positions = self._tokens(batch, self.embed)
        caches: Dict[str, List[torch.Tensor]] = {name: [] for name in ("k", "v", "xk", "xv")}
        for block in self.dec_layers:
            hn = norm_apply(cfg.norm, block.ln1, x)
            q, k, v = attn.gqa_qkv(block.attn, hn, positions, cfg)
            x = x + attn.gqa_attention(block.attn, hn, positions, cfg, causal=True, qkv=(q, k, v))
            xk, xv = attn.cross_kv(block.xattn, enc)
            x = x + attn.cross_attention(block.xattn, norm_apply(cfg.norm, block.ln_x, x), enc,
                                         cfg, kv=(xk, xv))
            x = x + mlp_apply(block.mlp, norm_apply(cfg.norm, block.ln2, x), cfg.act)
            for name, t in zip(("k", "v", "xk", "xv"), (k, v, xk, xv)):
                caches[name].append(t)
        x = norm_apply(cfg.norm, self.final_norm, _last(x, batch))
        return (matmul_f32(x, self.unembed.to(x.dtype))[:, 0, :],
                {n: torch.stack(ts) for n, ts in caches.items()})

    def decode_step(
        self,
        cache: Dict[str, torch.Tensor],
        token: torch.Tensor,  # (B, 1)
        cur_len,  # (B,) or scalar: tokens already in each row's self-attention cache
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One step of the decoder: each row's token at its own position
        (its k/v written into the cache in place), cross attention over
        every position of the encoder's cached k/v; returns (logits (B, V)
        f32, the cache)."""
        cfg = self.cfg
        token, cur, rows = _decode_inputs(self, token, cur_len)
        x = embed_tokens(self.embed, token, cfg)
        for i, block in enumerate(self.dec_layers):
            x = _attn_step(cfg, block, x, cache["k"][i], cache["v"][i], rows, cur)
            x = x + attn.cross_decode(block.xattn, norm_apply(cfg.norm, block.ln_x, x),
                                      cache["xk"][i], cache["xv"][i], cfg)
            x = _ffn_step(cfg, block, x)
        x = norm_apply(cfg.norm, self.final_norm, x)
        return matmul_f32(x, self.unembed.to(x.dtype))[:, 0, :], cache


def build_model(cfg, device="cuda", param_dtype: Optional[torch.dtype] = None):
    """The model for ``cfg`` (``EncDecLM`` for the enc-dec family, else
    ``CausalLM``) on ``device`` (the card by default; raises when there is
    none, as ``ExecutionConfig`` does; ``"meta"`` for the dry run, whose
    weights have shapes and no values), its parameters allocated but not
    initialised: call ``init(generator)`` or load weights.  The weights are
    held in the compute dtype (serving), or in ``param_dtype`` (training:
    ``torch.float32``, the reference's masters), and then require
    gradients."""
    cls = EncDecLM if cfg.family == "encdec" else CausalLM
    model = cls(cfg, device, param_dtype)
    if param_dtype is not None:
        model.requires_grad_(True)
    return model
