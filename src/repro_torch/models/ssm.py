"""Mamba-2 (SSD, state-space duality): the chunked prefill and the decode
recurrence.

The port of the JAX package's ``repro/models/ssm.py``.  The SSD algorithm
(Dao & Gu, arXiv:2405.21060) computes the selective-SSM recurrence as
block matrices: within a chunk of Q steps the output is a masked,
decay-weighted quadratic form, and across chunks a small (H, P, N) state
is carried by a linear recurrence, here a Python loop over the chunks.
Decode is the dual recurrent view: a constant-memory state update a token.

Numerics follow the reference's: the projections and the causal conv run
in the compute dtype; dt, the log decays and the carried states in f32;
each product that the reference gives ``preferred_element_type=f32``
accumulates in f32 (``matmul_f32``), its operands rounded to the compute
dtype where the reference casts them.  ``A_log`` and ``dt_bias`` stay f32
in every compute dtype, as the reference adds and exponentiates them in
f32.  The groups' B and C are computed once a group and broadcast to its
heads, where the reference repeats them to every head first: the same
products and sums.

One departure: the decode conv history.  The reference keeps the last
``k - 1`` raw conv inputs of the prompt (``xbc_raw[:, -(k - 1):]``); a
prompt shorter than ``k - 1`` leaves fewer rows, which the serving
plan's cache padding then grows with zeros AFTER the real inputs, where
the causal conv needs them before.  Here the history is cut from the
conv's own left-padded input, so it always holds ``k - 1`` rows, the
zeros first, and a 1- or 2-token prompt decodes as ``forward`` does.

``mamba2_decode_step`` writes the state it is given in place and never
reads a value back to the host, so a decode step captures in a CUDA
graph.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import Norm, _param, dense_init, matmul_f32, rmsnorm


def _dims(cfg) -> Tuple[int, int, int, int, int]:
    """(d_inner, heads, head dim, groups, state size)."""
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state


# ------------------------------------------------------------------ params
class Mamba2(nn.Module):
    """``mamba2_init``'s parameters under their names: ``wz``/``wx``
    (d, d_in), ``wB``/``wC`` (d, G*N), ``wdt`` (d, H), ``conv_w`` (K, C)
    and ``conv_b`` (C,) over the C = d_in + 2*G*N conv channels,
    ``A_log``/``D``/``dt_bias`` (H,), ``norm`` (d_in) and ``norm_in``
    (d) RMSNorm scales, ``out`` (d_in, d)."""

    def __init__(self, cfg, device=None, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        d_in, h, _, g, n = _dims(cfg)
        c = d_in + 2 * g * n
        self.wz = _param((d, d_in), device, dtype)
        self.wx = _param((d, d_in), device, dtype)
        self.wB = _param((d, g * n), device, dtype)
        self.wC = _param((d, g * n), device, dtype)
        self.wdt = _param((d, h), device, dtype)
        self.conv_w = _param((cfg.ssm_conv, c), device, dtype)
        self.conv_b = _param((c,), device, dtype)
        self.A_log = _param((h,), device, torch.float32)
        self.D = _param((h,), device, dtype)
        self.dt_bias = _param((h,), device, torch.float32)
        self.norm = Norm("rmsnorm", d_in, device)
        self.norm_in = Norm("rmsnorm", d, device)
        self.out = _param((d_in, d), device, dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """``mamba2_init``'s distributions: truncated-normal fan-in on the
        matrices, conv taps N(0, 0.1^2), A = exp(A_log) uniform in [1, 16],
        dt = softplus(dt_bias) log-uniform in [1e-3, 1e-1], D and the norms
        ones."""
        dev = self.wz.device
        for p in (self.wz, self.wx, self.wB, self.wC, self.wdt, self.out):
            p.copy_(dense_init(p.shape, generator, device=dev))
        conv = torch.empty(self.conv_w.shape, device=dev)
        self.conv_w.copy_(0.1 * conv.normal_(generator=generator))
        self.conv_b.zero_()
        h = self.A_log.shape[0]
        a = torch.empty(h, device=dev).uniform_(1.0, 16.0, generator=generator)
        self.A_log.copy_(torch.log(a))
        self.D.fill_(1.0)
        u = torch.empty(h, device=dev).uniform_(math.log(1e-3), math.log(1e-1),
                                                generator=generator)
        self.dt_bias.copy_(torch.log(torch.expm1(torch.exp(u))))
        self.norm.init()
        self.norm_in.init()


# ----------------------------------------------------------------- helpers
def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with taps (K, C): the
    reference's sum of shifted products, in its order."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, :s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out + b


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., Q) log decays -> (..., Q, Q) lower-triangular cumulative
    segment sums (the sum over (j, i]), -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, -math.inf)


def _group_heads(t: torch.Tensor, g: int) -> torch.Tensor:
    """(..., H, X, Y) -> (..., G, H/G * X, Y): each group's heads stacked
    on the row axis (heads are group-major, as ``jnp.repeat`` lays them)."""
    *lead, h, x, y = t.shape
    return t.reshape(*lead, g, (h // g) * x, y)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P): dt-scaled inputs
    a: torch.Tensor,  # (B, S, H): per-step log decay (A * dt, <= 0)
    bmat: torch.Tensor,  # (B, S, G, N)
    cmat: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # (B, H, P, N) initial state
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B, S, H, P) in x's dtype, the final state (B, H, P, N)
    f32).  G must divide H."""
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    dt = x.dtype
    # Pad a ragged tail with identity steps: x = B = C = 0 and a = 0 (decay
    # 1) leave the state untouched, so the final state is exact; the padded
    # rows of y are cut off.
    s_real = s
    if s % chunk:
        pad = -s % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        s += pad
    nc, rep = s // chunk, h // g

    xb = x.reshape(b, nc, chunk, h, p)
    ab = a.reshape(b, nc, chunk, h).float()
    bg = bmat.reshape(b, nc, chunk, g, n).permute(0, 1, 3, 2, 4)  # (B, nc, G, Q, N)
    cg = cmat.reshape(b, nc, chunk, g, n).permute(0, 1, 3, 2, 4)
    a_cum = torch.cumsum(ab, dim=2)  # (B, nc, Q, H)

    # Intra-chunk (diagonal block) term: C B^T a group, masked by the decay
    # matrix of each head, then against that head's inputs.
    lmat = torch.exp(_segsum(ab.movedim(-1, -2)))  # (B, nc, H, Q, Q)
    scores = matmul_f32(cg, bg.transpose(-1, -2))  # (B, nc, G, Q, Q)
    scores = scores[:, :, :, None].expand(b, nc, g, rep, chunk, chunk).reshape(
        b, nc, h, chunk, chunk)
    x_hqp = xb.permute(0, 1, 3, 2, 4)  # (B, nc, H, Q, P)
    y_diag = matmul_f32((scores * lmat).to(dt), x_hqp)  # (B, nc, H, Q, P) f32

    # Chunk-final states: sum_s exp(A_cum_end - A_cum_s) B_s x_s, the three
    # factors multiplied in f32.
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)  # (B, nc, Q, H)
    xd = x_hqp.float() * decay_to_end.to(dt).float().movedim(-1, -2)[..., None]
    states = torch.matmul(_group_heads(xd.transpose(-1, -2), g), bg.float())
    states = states.reshape(b, nc, h, p, n)
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (B, nc, H)

    # The carry: the state entering each chunk, then the final one.
    hcur = (h0.float() if h0 is not None
            else torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)  # (B, nc, H, P, N)

    # Inter-chunk (off-diagonal) term: y += C_t exp(A_cum_t) h_chunk_start.
    hp = _group_heads(h_prev.to(dt), g).reshape(b, nc, g, rep, p, n)
    hp = hp.permute(0, 1, 2, 5, 3, 4).reshape(b, nc, g, n, rep * p)
    y_off = matmul_f32(cg, hp).reshape(b, nc, g, chunk, rep, p)
    y_off = y_off.permute(0, 1, 3, 2, 4, 5).reshape(b, nc, chunk, h, p)
    y_off = y_off * torch.exp(a_cum).to(dt).float()[..., None]
    y = (y_diag.permute(0, 1, 3, 2, 4) + y_off).to(dt).reshape(b, s, h, p)
    return y[:, :s_real], hcur


def _project(params: Mamba2, x: torch.Tensor):
    """(z, the raw conv input xBC, dt_raw): the five input projections."""
    dt = x.dtype
    z = torch.matmul(x, params.wz.to(dt))
    xbc = torch.cat([torch.matmul(x, params.wx.to(dt)), torch.matmul(x, params.wB.to(dt)),
                     torch.matmul(x, params.wC.to(dt))], dim=-1)
    return z, xbc, torch.matmul(x, params.wdt.to(dt))


def _gated_out(params: Mamba2, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The gated RMSNorm and the output projection."""
    return torch.matmul(rmsnorm(params.norm, y * F.silu(z)), params.out.to(y.dtype))


# ------------------------------------------------------------------- block
def mamba2_forward(
    params: Mamba2,
    x: torch.Tensor,  # (B, S, d)
    cfg,
    h0: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """The Mamba-2 mixer: projections -> causal conv -> SSD -> gated norm
    -> output projection.  With ``return_state`` also the decode state:
    ``{"h": (B, H, P, N) f32, "conv": (B, K - 1, C)}``, the conv history
    left-padded with zeros for a prompt shorter than K - 1."""
    dt_ = x.dtype
    b, s, _ = x.shape
    d_in, h, p, g, n = _dims(cfg)
    k = params.conv_w.shape[0]
    z, xbc_raw, dt_raw = _project(params, x)
    xbc = F.silu(_causal_conv(xbc_raw, params.conv_w.to(dt_), params.conv_b.to(dt_)))
    xi = xbc[..., :d_in].reshape(b, s, h, p)
    bm = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    cm = xbc[..., d_in + g * n:].reshape(b, s, g, n)

    dt = F.softplus(dt_raw.float() + params.dt_bias)  # (B, S, H)
    a = -torch.exp(params.A_log) * dt  # log decay <= 0
    x_scaled = (xi.float() * dt[..., None]).to(dt_)
    y, h_last = ssd_chunked(x_scaled, a, bm, cm, min(cfg.ssm_chunk, s), h0=h0)
    y = y + params.D.to(dt_)[:, None] * xi
    out = _gated_out(params, y.reshape(b, s, d_in), z)
    if not return_state:
        return out
    hist = F.pad(xbc_raw[:, max(s - (k - 1), 0):], (0, 0, max(k - 1 - s, 0), 0))
    return out, {"h": h_last, "conv": hist}


def mamba2_decode_step(
    params: Mamba2,
    x: torch.Tensor,  # (B, 1, d)
    state: Dict[str, torch.Tensor],  # {"h": (B, H, P, N) f32, "conv": (B, K - 1, C)}
    cfg,
) -> torch.Tensor:
    """One token's recurrent update, constant memory in the context
    length: returns the mixer's output (B, 1, d) and writes the new state
    into ``state``'s tensors in place."""
    dt_ = x.dtype
    b = x.shape[0]
    d_in, h, p, g, n = _dims(cfg)
    z, xbc, dt_raw = (t[:, 0] for t in _project(params, x))
    conv_hist = torch.cat([state["conv"], xbc[:, None, :]], dim=1)  # (B, K, C)
    conv_out = (conv_hist * params.conv_w.to(dt_)).sum(dim=1) + params.conv_b.to(dt_)
    xbc_act = F.silu(conv_out)
    xi = xbc_act[:, :d_in].reshape(b, h, p)
    bm = xbc_act[:, d_in:d_in + g * n].reshape(b, g, 1, n).expand(b, g, h // g, n)
    cm = xbc_act[:, d_in + g * n:].reshape(b, g, 1, n).expand(b, g, h // g, n)
    bm, cm = bm.reshape(b, h, n), cm.reshape(b, h, n)

    dt = F.softplus(dt_raw.float() + params.dt_bias)  # (B, H)
    decay = torch.exp(-torch.exp(params.A_log) * dt)
    h_new = (state["h"] * decay[..., None, None]
             + (dt[..., None] * xi.float())[..., None] * bm.float()[:, :, None, :])
    state["h"].copy_(h_new)
    state["conv"].copy_(conv_hist[:, 1:])
    y = torch.matmul(h_new.to(dt_), cm[..., None])[..., 0]  # (B, H, P)
    y = y + params.D.to(dt_)[:, None] * xi
    return _gated_out(params, y.reshape(b, d_in), z)[:, None, :]


def mamba2_state_shapes(cfg, batch: int) -> Dict[str, Tuple[int, ...]]:
    d_in, h, p, g, n = _dims(cfg)
    return {"h": (batch, h, p, n), "conv": (batch, cfg.ssm_conv - 1, d_in + 2 * g * n)}


def mamba2_init_state(cfg, batch: int, dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """A zero decode state: ``h`` in f32, the conv history in ``dtype``."""
    shapes = mamba2_state_shapes(cfg, batch)
    return {"h": torch.zeros(shapes["h"], dtype=torch.float32, device=device),
            "conv": torch.zeros(shapes["conv"], dtype=dtype, device=device)}
