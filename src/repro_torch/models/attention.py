"""Attention: GQA with a sliding window, chunked online softmax, decode.

The port of the GQA part of the JAX package's ``repro/models/attention.py``.
The prefill/forward path is the reference's online-softmax double loop over
(q_chunk, kv_chunk) tiles, so the (S x S) score matrix is never
materialised; decode is a single-token path over a preallocated,
length-masked cache.  Both are plain tensor operations that mirror the
reference's math: the two attention products keep their f32 accumulators
(``matmul_f32``), and p is cast to the compute dtype before the PV product,
as the reference casts it.

Decode takes one position per row: ``kv_len`` is a ``(B,)`` tensor (or a
scalar for every row), so a batch of decode slots at different lengths is
one call, each row roped, written and masked at its own length: what the
reference's ``vmap`` of its scalar-position step computes.

The reference's MLA (DeepSeek-V2) and cross attention (enc-dec) wait for
the slices that bring those families.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import _param, apply_rope, dense_init, matmul_f32

NEG_INF = -1e30


# ---------------------------------------------------------------- masking
def _mask_bias(
    q_pos: torch.Tensor,  # (..., qc) absolute positions of the q tile
    kv_pos: torch.Tensor,  # (kc,) absolute positions of the kv tile
    causal: bool,
    window: Optional[int],
    kv_len,  # None, or the valid length: an int, or a tensor broadcastable to q_pos[..., None]
) -> torch.Tensor:
    """Additive mask bias (..., qc, kc): 0 where attendable, NEG_INF elsewhere."""
    q = q_pos[..., :, None]
    ok = torch.ones(q_pos.shape + kv_pos.shape, dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= kv_pos <= q
    if window is not None:
        ok &= kv_pos > q - window
    if kv_len is not None:
        ok &= kv_pos < kv_len
    zero = torch.zeros((), dtype=torch.float32, device=q_pos.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


# ------------------------------------------------- chunked online-softmax
def chunked_attention(
    q: torch.Tensor,  # (B, Sq, KH, G, D)
    k: torch.Tensor,  # (B, Skv, KH, D)
    v: torch.Tensor,  # (B, Skv, KH, Dv)
    q_offset: int = 0,
    causal: bool = True,
    window: Optional[int] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-style attention; returns (B, Sq, KH, G, Dv).

    q_offset: absolute position of q[0].  Ragged tails are zero-padded to
    the chunk (the padded kv excluded by a length mask, padded q rows
    sliced off), as the reference pads them.
    """
    b, sq, kh, g, d = q.shape
    skv, dv = k.shape[1], v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    sq_p = -(-sq // qc) * qc
    skv_p = -(-skv // kc) * kc
    dev = q.device
    kv_len = skv if skv_p != skv else None
    if sq_p != sq:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, sq_p - sq))
    if skv_p != skv:
        k = F.pad(k, (0, 0, 0, 0, 0, skv_p - skv))
        v = F.pad(v, (0, 0, 0, 0, 0, skv_p - skv))
    nq, nk = sq_p // qc, skv_p // kc

    kt = k.permute(0, 2, 3, 1)  # (B, KH, D, Skv)
    vt = v.permute(0, 2, 1, 3)  # (B, KH, Skv, Dv)
    outs = []
    for qi in range(nq):
        qx = q[:, qi * qc:(qi + 1) * qc].permute(0, 2, 3, 1, 4)  # (B, KH, G, qc, D)
        qx = qx.reshape(b, kh, g * qc, d)
        q_pos = q_offset + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((b, kh, g, qc), NEG_INF, dtype=torch.float32, device=dev)
        lse = torch.zeros((b, kh, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kh, g, qc, dv), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kv_pos = ki * kc + torch.arange(kc, device=dev)
            s = matmul_f32(qx, kt[..., ki * kc:(ki + 1) * kc]).view(b, kh, g, qc, kc) * scale
            s = s + _mask_bias(q_pos, kv_pos, causal, window, kv_len)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            lse = lse * corr + p.sum(dim=-1)
            pv = matmul_f32(p.to(q.dtype).view(b, kh, g * qc, kc),
                            vt[:, :, ki * kc:(ki + 1) * kc]).view(b, kh, g, qc, dv)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(lse[..., None], 1e-30)  # (B, KH, G, qc, Dv)
        outs.append(out.permute(0, 3, 1, 2, 4))  # (B, qc, KH, G, Dv)
    return torch.cat(outs, dim=1)[:, :sq].to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, 1, KH, G, D)
    k_cache: torch.Tensor,  # (B, Smax, KH, D)
    v_cache: torch.Tensor,  # (B, Smax, KH, Dv)
    kv_len: Union[torch.Tensor, int],  # (B,) or scalar: valid prefix length
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token attention over a length-masked cache: (B, 1, KH, G, Dv).
    Row b's new token sits at position ``kv_len[b] - 1``."""
    b, _, kh, g, d = q.shape
    smax, dv = k_cache.shape[1], v_cache.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    kv_len = torch.as_tensor(kv_len, device=dev).reshape(-1, 1).expand(b, 1)  # (B, 1)
    kv_pos = torch.arange(smax, device=dev)
    s = matmul_f32(q.permute(0, 2, 3, 1, 4).reshape(b, kh, g, d),
                   k_cache.permute(0, 2, 3, 1)) * scale  # (B, KH, G, Smax)
    bias = _mask_bias(kv_len - 1, kv_pos, True, window, kv_len[..., None])  # (B, 1, Smax)
    s = s + bias[:, :, None, :]
    p = torch.softmax(s, dim=-1)
    out = matmul_f32(p.to(v_cache.dtype), v_cache.permute(0, 2, 1, 3))  # (B, KH, G, Dv)
    return out.reshape(b, 1, kh, g, dv).to(q.dtype)


# ---------------------------------------------------------------- GQA
def _h_eff(cfg) -> int:
    return getattr(cfg, "pad_heads_to", None) or cfg.n_heads


class GQA(nn.Module):
    """``wq`` (d, H, D), ``wk``/``wv`` (d, KH, D), ``wo`` (H, D, d); H is
    ``pad_heads_to`` when set."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        d, kh, dh = cfg.d_model, cfg.n_kv_heads, cfg.d_head
        he = _h_eff(cfg)
        if he % kh != 0:
            raise ValueError(
                f"pad_heads_to={he} must be a multiple of n_kv_heads={kh} "
                "(pad per kv group; archs like phi3 (40q/10kv) additionally "
                "need kv-head padding — see DESIGN.md perf levers)"
            )
        self.cfg = cfg
        self.wq = _param((d, he, dh), device, dtype)
        self.wk = _param((d, kh, dh), device, dtype)
        self.wv = _param((d, kh, dh), device, dtype)
        self.wo = _param((he, dh, d), device, dtype)

    def init(self, generator: torch.Generator) -> None:
        cfg = self.cfg
        d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        he = _h_eff(cfg)
        dev = self.wq.device
        wq = dense_init((d, he, dh), generator, device=dev)
        wk = dense_init((d, kh, dh), generator, device=dev)
        wv = dense_init((d, kh, dh), generator, device=dev)
        wo = dense_init((he, dh, d), generator, in_axis=0, device=dev)
        if he != h:
            # Zero-pad PER KV-GROUP: the (KH, G) blocked layout is kv-major,
            # so tail-padding the flat head axis would re-pair real heads
            # with the wrong kv head.  Padded heads' q columns are zero, and
            # their attention outputs meet zero wo rows.
            g = h // kh
            wq.view(d, kh, he // kh, dh)[:, :, g:, :] = 0.0
            wo.view(kh, he // kh, dh, d)[:, g:, :, :] = 0.0
        for p, t in ((self.wq, wq), (self.wk, wk), (self.wv, wv), (self.wo, wo)):
            p.copy_(t)


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk')."""
    d, h, k = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def gqa_qkv(params: GQA, x: torch.Tensor, positions, cfg, theta: Optional[float] = None,
            rope: bool = True):
    """Project to grouped q (B,S,KH,G,D) and k/v (B,S,KH,D).  ``theta``
    overrides ``cfg.rope_theta`` (gemma3's global layers)."""
    theta = cfg.rope_theta if theta is None else theta
    kh = cfg.n_kv_heads
    g = _h_eff(cfg) // kh
    q, k, v = _proj(x, params.wq), _proj(x, params.wk), _proj(x, params.wv)
    if rope:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    b, s = x.shape[:2]
    return q.reshape(b, s, kh, g, cfg.d_head), k, v


def gqa_out(params: GQA, attn: torch.Tensor, cfg) -> torch.Tensor:
    """attn (B,S,KH,G,Dv) -> (B,S,d)."""
    b, s = attn.shape[:2]
    he = _h_eff(cfg)
    a = attn.reshape(b, s, he * cfg.d_head)
    return torch.matmul(a, params.wo.to(attn.dtype).reshape(he * cfg.d_head, cfg.d_model))


def gqa_attention(
    params: GQA,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg,
    causal: bool = True,
    window: Optional[int] = None,
    theta: Optional[float] = None,
    qkv=None,
) -> torch.Tensor:
    """Self attention over a whole sequence.  ``qkv`` passes projections
    already made (prefill makes them once for attention and the cache).

    On one card the reference's padded head-group branch (the ``q_groups``
    rule over a model axis that neither KH nor KH*G divides) has a model
    axis of size 1, where it is the identity: no padding of G happens."""
    q, k, v = qkv if qkv is not None else gqa_qkv(params, x, positions, cfg, theta)
    out = chunked_attention(q, k, v, causal=causal, window=window,
                            q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return gqa_out(params, out, cfg)


def gqa_decode(
    params: GQA,
    x: torch.Tensor,  # (B, 1, d)
    cache_k: torch.Tensor,  # (B, Smax, KH, D): already holds this token
    cache_v: torch.Tensor,
    kv_len,  # (B,) or scalar
    cfg,
    window: Optional[int] = None,
    theta: Optional[float] = None,
) -> torch.Tensor:
    """The new token's attention output.  Only q is projected: k and v of
    this token were made by ``gqa_kv_for_cache`` and written already."""
    theta = cfg.rope_theta if theta is None else theta
    b = x.shape[0]
    kv_len = torch.as_tensor(kv_len, device=x.device).reshape(-1).expand(b)
    q = apply_rope(_proj(x, params.wq), (kv_len - 1)[:, None], theta)
    q = q.reshape(b, 1, cfg.n_kv_heads, _h_eff(cfg) // cfg.n_kv_heads, cfg.d_head)
    out = decode_attention(q, cache_k, cache_v, kv_len, window=window)
    return gqa_out(params, out, cfg)


def gqa_kv_for_cache(params: GQA, x: torch.Tensor, positions, cfg, theta: Optional[float] = None):
    """k/v (with rope) for cache insertion, shapes (B,S,KH,D)."""
    theta = cfg.rope_theta if theta is None else theta
    k = apply_rope(_proj(x, params.wk), positions, theta)
    return k, _proj(x, params.wv)
