"""Shared model primitives: norms, embeddings, MLPs, RoPE, init helpers.

The port of the JAX package's ``repro/models/common.py``.  Conventions:

* parameters live in ``nn.Module``s as ``nn.Parameter``s, with the
  reference's names and shapes (``wq`` is ``(d_model, heads, d_head)``,
  ``mlp.down`` is ``(d_ff, d_model)``), so a flat checkpoint key of the
  reference names one parameter here (``checkpoint/convert.py``);
* the reference keeps f32 parameters and casts each to the compute dtype at
  its use, and so does every function here (``w.to(x.dtype)``).  A
  serving model holds the one compute-dtype copy (bf16 for the published
  configs), made once at load, where that cast returns the same tensor:
  the numbers are the reference's and a decode step reads half the
  bytes.  A training model holds f32 parameters (``build_model(...,
  param_dtype=torch.float32)``), so autograd gives the reference's
  gradients: the cast's backward widens the bf16 cotangent, and a weight
  used more than once sums its gradients in f32.  Norm scales and biases
  stay f32 in both, as the reference's norms multiply by them in f32;
* initialisers draw from an explicit ``torch.Generator`` on the
  parameter's device: the reference's distributions, not its bits;
* the serving paths run under ``torch.inference_mode()``; nothing here
  records a graph of its own accord.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def cdtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def cast(x: torch.Tensor, cfg) -> torch.Tensor:
    return x.to(cdtype(cfg))


# ------------------------------------------------------- f32 accumulators
def _product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 accumulator of ``a @ b`` for compute-dtype operands: on the
    card ``torch.mm``/``torch.bmm`` with ``out_dtype=torch.float32``
    (cuBLAS writes its f32 accumulator; the operands stay bf16 and are read
    once), on the CPU the product of the operands widened to f32 (exact: a
    bf16 value is an f32 value, and their products are exact in f32).  The
    dry run's ``meta`` tensors take the card's path, so it counts the
    card's bytes."""
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float())
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    lead = a.shape[:-2]
    out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                    out_dtype=torch.float32)
    return out.reshape(*lead, *out.shape[-2:])


def _matmul_f32_grads(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                      need_a: bool = True, need_b: bool = True):
    """The f32 products of ``matmul_f32``'s backward before their rounding:
    (g @ b^T, a^T @ g) in f32 from the f32 cotangent ``g``, a 2-D ``b``'s
    summed over every leading dim of ``a``; None where not needed."""
    ga = gb = None
    if need_a:
        ga = torch.matmul(g, b.float().transpose(-1, -2))
    if need_b:
        if b.dim() == 2:
            gb = torch.matmul(a.reshape(-1, a.shape[-1]).float().T,
                              g.reshape(-1, g.shape[-1]))
        else:
            gb = torch.matmul(a.float().transpose(-1, -2), g)
    return ga, gb


class _MatmulF32(torch.autograd.Function):
    """``_product_f32`` with the reference's transposes as its backward:
    JAX's transpose of a ``dot_general`` with ``preferred_element_type=
    f32`` multiplies the f32 cotangent by the other operand in f32 and
    rounds the result to the input's dtype.  The same code runs on both
    devices (``aten::mm`` with ``out_dtype`` has no derivative of its
    own)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga, gb = _matmul_f32_grads(a, b, g, *ctx.needs_input_grad[:2])
        return (None if ga is None else ga.to(a.dtype),
                None if gb is None else gb.to(b.dtype))


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the f32 accumulator returned unrounded: the
    reference's ``preferred_element_type=jnp.float32`` on compute-dtype
    operands (a bf16 ``torch.matmul`` rounds its output to bf16).  f32
    operands take ``torch.matmul``; others ``_MatmulF32``, differentiable
    on both devices.  ``b`` is 2-D, or has ``a``'s leading dims."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    return _MatmulF32.apply(a, b)


# ------------------------------------------------------------------- init
def dense_init(shape, generator: torch.Generator, in_axis: int = 0, device=None,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1/fan_in) cut at +-2 sigma."""
    std = 1.0 / math.sqrt(shape[in_axis])
    t = torch.empty(shape, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def embed_init(shape, generator: torch.Generator, device=None,
               dtype=torch.float32) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(generator=generator)
    return (t * 0.02).to(dtype)


def _param(shape, device, dtype) -> nn.Parameter:
    """An uninitialised parameter; ``init`` fills it."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


# ------------------------------------------------------------------- norms
class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``), f32 params."""

    def __init__(self, kind: str, d: int, device=None):
        super().__init__()
        self.kind = kind
        self.scale = _param((d,), device, torch.float32)
        if kind != "rmsnorm":
            self.bias = _param((d,), device, torch.float32)

    def init(self) -> None:
        self.scale.fill_(1.0)
        if self.kind != "rmsnorm":
            self.bias.zero_()


def rmsnorm(params: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale in f32, cast back to x's dtype.
    ``torch.rms_norm`` makes the f32 ``x * rsqrt(mean(x^2) + eps)``: its
    kernel reduces each row on its own, so a row's result does not depend
    on how many rows are normalised together.  A ``torch.mean`` over the
    last axis picks its threads by the number of rows, and one decode slot
    and four then round apart."""
    x32 = x.float()
    out = torch.rms_norm(x32, (x.shape[-1],), eps=eps) * params.scale
    return out.to(x.dtype)


def layernorm(params: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps) * params.scale + params.bias
    return out.to(x.dtype)


def norm_apply(kind: str, params: Norm, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


# --------------------------------------------------------------- embedding
class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, device=None, dtype=torch.float32):
        super().__init__()
        self.table = _param((vocab, d), device, dtype)

    def init(self, generator: torch.Generator) -> None:
        self.table.copy_(embed_init(self.table.shape, generator, self.table.device))


def embed_tokens(params: Embedding, tokens: torch.Tensor, cfg) -> torch.Tensor:
    return cast(params.table[tokens], cfg)


def unembed(params: Embedding, x: torch.Tensor) -> torch.Tensor:
    """Logits = x @ table^T, f32 accumulation."""
    return matmul_f32(x, params.table.to(x.dtype).T)


# --------------------------------------------------------------------- MLP
class MLP(nn.Module):
    """``gate``/``up`` (d, d_ff) and ``down`` (d_ff, d) for the gated
    activations; ``up`` and ``down`` alone for gelu."""

    def __init__(self, d: int, d_ff: int, act: str, device=None, dtype=torch.float32):
        super().__init__()
        self.act = act
        self.down = _param((d_ff, d), device, dtype)
        if act in ("swiglu", "geglu"):
            self.gate = _param((d, d_ff), device, dtype)
        self.up = _param((d, d_ff), device, dtype)

    def init(self, generator: torch.Generator) -> None:
        for p in ([self.gate] if self.act in ("swiglu", "geglu") else []) + [self.up, self.down]:
            p.copy_(dense_init(p.shape, generator, device=p.device))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(params: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    dt = x.dtype
    if act in ("swiglu", "geglu"):
        g = torch.matmul(x, params.gate.to(dt))
        u = torch.matmul(x, params.up.to(dt))
        g = F.silu(g) if act == "swiglu" else gelu(g)
        h = g * u
    else:
        h = gelu(torch.matmul(x, params.up.to(dt)))
    return torch.matmul(h, params.down.to(dt))


# -------------------------------------------------------------------- RoPE
def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, H, D) with D even; positions broadcastable to (..., S):
    (S,) for a sequence, (B, 1) for one token per row at its own position.
    Split-half rotation, angles in f32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)  # (D/2,)
    ang = positions[..., None].float() * freqs  # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)

