"""Mixture-of-Experts (DeepSeek-V2 / Moonlight style) on one card.

The port of the JAX package's ``repro/models/moe.py``.  Routing is a top-k
softmax with capacity-based token dropping (GShard); the dispatch is
sort-free scatter/gather: each (token, k) assignment takes a slot in its
expert's capacity buffer by a cumulative count over the assignments in
token-major order, and assignments past the capacity are dropped.

The reference has three schemes (``cfg.moe_impl``): ``local``, and two
over a model axis of a mesh (``psum``, ``a2a``).  It runs ``local``
whenever there is no mesh, and one card has none, so every ``moe_impl``
runs the ``local`` scheme here: the published configs say ``psum`` and are
served as they are.

Two semantics decide which assignments survive, and the port keeps both
bit for bit:

* **slot order**: slots are counted over the flattened (token, k)
  assignments in token-major order, and the capacity is recomputed from
  the token count of each call (``_capacity``);
* **ties in top-k**: ``jax.lax.top_k`` takes the lower expert index on a
  tie, while ``torch.topk`` promises no order on the card.  bf16 router
  logits over 64-160 experts do tie, so ``_topk`` takes the first k of a
  stable descending sort, which keeps the lower index first.

``moe_decode`` is the decode step's path: S slots of one token each.  The
reference ``vmap``s a one-token step over its slots, so each slot is its
own call with T = 1 and a capacity of 8 >= k: nothing drops.  The port
routes each token to its k experts with no capacity buffer, and gathers
those experts' weights for one batched product, so a step reads the
routed experts and not all E of them.  Prefill and ``forward`` keep the
reference's capacity buffers and drops (``moe_apply``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import _param, dense_init


# ------------------------------------------------------------------ params
class SharedExperts(nn.Module):
    """``gate``/``up`` (d, n_shared x f) and ``down`` (n_shared x f, d):
    the always-on experts, one SwiGLU MLP of their summed width."""

    def __init__(self, d: int, fs: int, device=None, dtype=torch.float32):
        super().__init__()
        self.gate = _param((d, fs), device, dtype)
        self.up = _param((d, fs), device, dtype)
        self.down = _param((fs, d), device, dtype)


class MoE(nn.Module):
    """``router`` (d, E), ``gate``/``up`` (E, d, f), ``down`` (E, f, d) and,
    with ``n_shared_experts > 0``, ``shared``: the reference's pytree."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        self.router = _param((d, e), device, dtype)
        self.gate = _param((e, d, f), device, dtype)
        self.up = _param((e, d, f), device, dtype)
        self.down = _param((e, f, d), device, dtype)
        self.shared = (SharedExperts(d, cfg.n_shared_experts * f, device, dtype)
                       if cfg.n_shared_experts > 0 else None)

    def init(self, generator: torch.Generator) -> None:
        """``moe_init``'s distributions: truncated-normal fan-in on axis 0,
        but on axis 1 (f) for ``down``."""
        for p, in_axis in ((self.router, 0), (self.gate, 0), (self.up, 0), (self.down, 1)):
            p.copy_(dense_init(p.shape, generator, in_axis=in_axis, device=p.device))
        if self.shared is not None:
            for p in (self.shared.gate, self.shared.up, self.shared.down):
                p.copy_(dense_init(p.shape, generator, device=p.device))


# ------------------------------------------------------------------ router
def _topk(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, descending,
    the lower index first on a tie."""
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    return top_p[..., :k], top_i[..., :k]


def _route(logits: torch.Tensor, k: int):
    """(T, E) logits -> (all probabilities (T, E) f32, the top k of them
    renormalised (T, k), their expert ids (T, k) int64)."""
    probs = torch.softmax(logits.float(), dim=-1)
    top_p, top_i = _topk(probs, k)
    # Renormalise the selected probabilities (DeepSeek convention).
    return probs, top_p / torch.clamp_min(top_p.sum(dim=-1, keepdim=True), 1e-9), top_i


def router_topk(logits: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(T, E) -> probs (T, k), idx (T, k) int64, the aux load-balance loss."""
    probs, top_p, top_i = _route(logits, k)
    # Load-balance aux (Switch): E * sum_e f_e * P_e.
    e = logits.shape[-1]
    me = probs.mean(dim=0)
    fe = F.one_hot(top_i, e).float().sum(dim=1).mean(dim=0)
    return top_p, top_i, e * (me * fe).sum()


def _slots(e_flat: torch.Tensor, n_experts: int, capacity: int):
    """Slot index of each assignment within its expert's capacity buffer,
    and whether it fits."""
    oh = F.one_hot(e_flat, n_experts)  # (A, E)
    slot = (oh.cumsum(dim=0) - 1).gather(1, e_flat[:, None])[:, 0]
    return slot, slot < capacity


def _capacity(tokens: int, k: int, n_experts: int, cf: float) -> int:
    c = int(math.ceil(tokens * k / n_experts * cf))
    return max(8, -(-c // 8) * 8)  # rounded up to 8, as the reference tiles for the TPU


# ---------------------------------------------------------------- dispatch
def _bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum('ecd,edf->ecf')."""
    return torch.bmm(a, b.to(a.dtype))


def _dispatch_compute(
    x: torch.Tensor,  # (T, d)
    probs: torch.Tensor,  # (T, k)
    idx: torch.Tensor,  # (T, k) global expert ids in [e_lo, e_lo + E_loc)
    gate_w: torch.Tensor,  # (E_loc, d, f)
    up_w: torch.Tensor,
    down_w: torch.Tensor,  # (E_loc, f, d)
    e_lo: int,
    capacity: int,
) -> torch.Tensor:
    """Capacity-buffer dispatch -> batched expert GEMM -> weighted combine.

    Assignments routed outside [e_lo, e_lo + E_loc) are dropped (another
    shard's, in the reference's psum scheme).  A dropped assignment adds
    nothing to the buffer: it writes zeros, into a spare slot past the
    capacity that no product reads, so every write is to a slot of its own
    or to the spare and no accumulation is needed."""
    t, k = idx.shape
    e_loc = gate_w.shape[0]
    d = x.shape[-1]
    tok = torch.arange(t, device=x.device).repeat_interleave(k)  # (A,)
    e_local = idx.reshape(-1) - e_lo
    in_range = (e_local >= 0) & (e_local < e_loc)
    e_clip = e_local.clamp(0, e_loc - 1)
    # Out-of-range assignments go to an overflow bucket (id e_loc), so they
    # take no real expert's capacity.
    slot, fits = _slots(torch.where(in_range, e_clip, e_loc), e_loc + 1, capacity)
    kept = fits & in_range
    keep = kept.to(x.dtype)
    slot = slot.clamp(0, capacity - 1)

    buf = torch.zeros((e_loc, capacity + 1, d), dtype=x.dtype, device=x.device)
    buf[e_clip, torch.where(kept, slot, capacity)] = x[tok] * keep[:, None]
    buf = buf[:, :capacity]

    h = F.silu(_bmm(buf, gate_w)) * _bmm(buf, up_w)
    out_buf = _bmm(h, down_w)  # (E_loc, C, d)

    gathered = out_buf[e_clip, slot] * keep[:, None]  # (A, d)
    weighted = gathered * probs.reshape(-1)[:, None].to(x.dtype)
    return weighted.reshape(t, k, d).sum(dim=1)


def _shared_expert(p: SharedExperts, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    g = F.silu(torch.matmul(x, p.gate.to(dt)))
    u = torch.matmul(x, p.up.to(dt))
    return torch.matmul(g * u, p.down.to(dt))


# ------------------------------------------------------------------- apply
def moe_apply(params: MoE, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss scalar): the reference's
    ``local`` scheme, with capacity for the B x S tokens of the call."""
    b, s, d = x.shape
    shared = _shared_expert(params.shared, x) if params.shared is not None else 0.0
    xt = x.reshape(-1, d)
    logits = torch.matmul(xt, params.router.to(x.dtype))
    probs, idx, aux = router_topk(logits, cfg.top_k)
    cap = _capacity(xt.shape[0], cfg.top_k, cfg.n_experts, cfg.capacity_factor)
    out = _dispatch_compute(xt, probs, idx, params.gate, params.up, params.down, 0, cap)
    return out.reshape(b, s, d) + shared, aux


def moe_decode(params: MoE, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (S, 1, d), one token a slot -> (S, 1, d): each token through its
    k routed experts and the shared ones, no capacity, no slot touching
    another's routing.  Equals the reference's ``moe_apply`` called once
    a slot (T = 1, capacity 8 >= k).  The routed experts' weights are
    gathered for one batched product each (S x k x 3 x d x f elements
    copied and read a layer); nothing here reads back to the host."""
    s, one, d = x.shape
    dt = x.dtype
    k = cfg.top_k
    shared = _shared_expert(params.shared, x) if params.shared is not None else 0.0
    xt = x.reshape(-1, d)
    _, probs, idx = _route(torch.matmul(xt, params.router.to(dt)), k)
    e = idx.reshape(-1)  # (T k,)
    xr = xt.repeat_interleave(k, dim=0)[:, None, :]  # (T k, 1, d)
    h = F.silu(_bmm(xr, params.gate[e])) * _bmm(xr, params.up[e])
    out = _bmm(h, params.down[e])[:, 0, :]  # (T k, d)
    weighted = out * probs.reshape(-1)[:, None].to(dt)
    return weighted.reshape(-1, k, d).sum(dim=1).reshape(s, one, d) + shared
