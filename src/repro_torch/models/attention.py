"""Attention: GQA with a sliding window, MLA (DeepSeek-V2), cross attention,
chunked online softmax, decode.

The port of the JAX package's ``repro/models/attention.py``.
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

MLA keeps a latent cache: ``c_kv`` (kv_lora_rank lanes, rmsnormed) and
one shared roped ``k_rope`` a token, 512 + 64 lanes at DeepSeek-V2's
widths where per-head k and v would take 128 x (192 + 128).  The
prefill/forward path expands the latent to per-head k/v and runs the
chunked attention; the decode step absorbs ``k_up`` into q and ``v_up``
into the output, so it reads only the latent cache.

Cross attention (the enc-dec family) is a GQA projection of the decoder's
states against the encoder's, full (no causal mask) and without rope; its
decode step reads the encoder's k/v, projected once at prefill.
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import Norm, _param, apply_rope, dense_init, matmul_f32, rmsnorm

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
    if isinstance(kv_len, int):  # filled on the device: no host copy, so a graph captures it
        kv_len = torch.full((b, 1), kv_len, dtype=torch.long, device=dev)
    else:
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


def cross_attention(params: GQA, x: torch.Tensor, enc: torch.Tensor, cfg,
                    kv=None) -> torch.Tensor:
    """Encoder-decoder cross attention: q from the decoder's ``x`` (B, S,
    d), k/v from the encoder's ``enc`` (B, Senc, d), full, no rope on
    either.  ``kv`` passes ``cross_kv(params, enc)`` already made (prefill
    makes it once for the attention and the cache)."""
    b, s = x.shape[:2]
    kh = cfg.n_kv_heads
    q = _proj(x, params.wq).reshape(b, s, kh, cfg.n_heads // kh, cfg.d_head)
    k, v = kv if kv is not None else cross_kv(params, enc)
    out = chunked_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    return gqa_out(params, out, cfg)


def cross_kv(params: GQA, enc: torch.Tensor):
    """The encoder's k and v (B, Senc, KH, D) for the decode cache."""
    return _proj(enc, params.wk), _proj(enc, params.wv)


def cross_decode(params: GQA, x: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                 cfg) -> torch.Tensor:
    """One token a row against the encoder's cached k/v (every position)."""
    b = x.shape[0]
    kh = cfg.n_kv_heads
    q = _proj(x, params.wq).reshape(b, 1, kh, _h_eff(cfg) // kh, cfg.d_head)
    return gqa_out(params, decode_attention(q, xk, xv, xk.shape[1]), cfg)


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


# ---------------------------------------------------------------- MLA
class MLA(nn.Module):
    """``kv_down`` (d, KL + DR), ``kv_norm`` (KL), ``k_up`` (KL, H, DN),
    ``v_up`` (KL, H, DV), ``wo`` (H, DV, d), and the q branch:
    ``q_down`` (d, QL), ``q_norm`` (QL), ``q_up`` (QL, H, DN + DR) when
    ``q_lora_rank > 0``, else ``wq`` (d, H, DN + DR)."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dvh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        self.cfg = cfg
        self.kv_down = _param((d, kl + dr), device, dtype)
        self.kv_norm = Norm("rmsnorm", kl, device)
        self.k_up = _param((kl, h, dn), device, dtype)
        self.v_up = _param((kl, h, dvh), device, dtype)
        self.wo = _param((h, dvh, d), device, dtype)
        if ql > 0:
            self.q_down = _param((d, ql), device, dtype)
            self.q_norm = Norm("rmsnorm", ql, device)
            self.q_up = _param((ql, h, dn + dr), device, dtype)
        else:
            self.wq = _param((d, h, dn + dr), device, dtype)

    def init(self, generator: torch.Generator) -> None:
        """``mla_init``'s distributions: truncated-normal fan-in on axis 0
        of every matrix, norms at one."""
        self.kv_norm.init()
        mats = [self.kv_down, self.k_up, self.v_up, self.wo]
        if self.cfg.q_lora_rank > 0:
            self.q_norm.init()
            mats += [self.q_down, self.q_up]
        else:
            mats.append(self.wq)
        for p in mats:
            p.copy_(dense_init(p.shape, generator, device=p.device))


def _mla_q(params: MLA, x: torch.Tensor, positions, cfg):
    """(q_nope (B,S,H,DN), roped q_rope (B,S,H,DR))."""
    dn = cfg.qk_nope_dim
    if cfg.q_lora_rank > 0:
        ql = rmsnorm(params.q_norm, torch.matmul(x, params.q_down.to(x.dtype)))
        q = _proj(ql, params.q_up)
    else:
        q = _proj(x, params.wq)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def mla_latent(params: MLA, x: torch.Tensor, positions, cfg):
    """c_kv (B,S,KL) + the roped shared k_rope (B,S,DR): the decode cache."""
    kl = cfg.kv_lora_rank
    kv = torch.matmul(x, params.kv_down.to(x.dtype))
    c_kv = rmsnorm(params.kv_norm, kv[..., :kl])
    k_rope = apply_rope(kv[..., kl:][..., None, :], positions, cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def mla_attention(params: MLA, x: torch.Tensor, positions, cfg, causal: bool = True,
                  latent=None) -> torch.Tensor:
    """Train/prefill path: expand the latent to per-head k/v, chunked
    attention at scale 1/sqrt(DN + DR).  ``latent`` passes ``mla_latent``'s
    pair already made (prefill makes it once for attention and the cache)."""
    b, s = x.shape[:2]
    h = cfg.n_heads
    dn, dr, dvh = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(params, x, positions, cfg)
    c_kv, k_rope = latent if latent is not None else mla_latent(params, x, positions, cfg)
    k = torch.cat([_proj(c_kv, params.k_up), k_rope[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    v = _proj(c_kv, params.v_up)
    q = torch.cat([q_nope, q_rope], dim=-1).reshape(b, s, h, 1, dn + dr)  # KH = H, G = 1
    out = chunked_attention(q, k, v, causal=causal, q_chunk=cfg.q_chunk,
                            kv_chunk=cfg.kv_chunk, scale=1.0 / math.sqrt(dn + dr))
    return torch.matmul(out.reshape(b, s, h * dvh), params.wo.to(x.dtype).reshape(h * dvh, -1))


def mla_decode(
    params: MLA,
    x: torch.Tensor,  # (B, 1, d)
    cache_ckv: torch.Tensor,  # (B, Smax, KL): already holds this token
    cache_krope: torch.Tensor,  # (B, Smax, DR)
    kv_len,  # (B,) or scalar
    cfg,
) -> torch.Tensor:
    """Absorbed-latent decode, one position a row: ``k_up`` folds into q
    and ``v_up`` into the output, so the step reads the latent cache alone.
    Scores and the latent output accumulate in f32; p is cast to the
    compute dtype before its product, as the reference casts it."""
    dt = x.dtype
    b = x.shape[0]
    h, dn, dr, kl = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    smax = cache_ckv.shape[1]
    kv_len = torch.as_tensor(kv_len, device=x.device).reshape(-1).expand(b)
    positions = (kv_len - 1)[:, None]  # (B, 1)
    q_nope, q_rope = _mla_q(params, x, positions, cfg)  # (B,1,H,DN), (B,1,H,DR)
    q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, params.k_up.to(dt))  # (B,1,H,KL)
    s_lat = matmul_f32(q_lat.reshape(b, h, kl), cache_ckv.transpose(1, 2))  # (B,H,Smax)
    s_rope = matmul_f32(q_rope.reshape(b, h, dr), cache_krope.transpose(1, 2))
    s = (s_lat + s_rope) / math.sqrt(dn + dr)
    kv_pos = torch.arange(smax, device=x.device)
    bias = _mask_bias(positions, kv_pos, True, None, kv_len[:, None, None])  # (B,1,Smax)
    p = torch.softmax(s + bias, dim=-1)
    out_lat = matmul_f32(p.to(dt), cache_ckv).to(dt)  # (B,H,KL)
    out = torch.einsum("bhr,rhk->bhk", out_lat, params.v_up.to(dt))  # (B,H,DV)
    return torch.matmul(out.reshape(b, 1, -1), params.wo.to(dt).reshape(-1, cfg.d_model))
