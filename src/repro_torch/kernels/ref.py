"""Plain PyTorch versions of the kernels in this package.

Each function is the semantic ground truth of one Hopper kernel
(``masked_matmul.py`` / ``hcu_softmax.py`` / ``bcpnn_update.py`` /
``bcpnn_phase.py`` / ``bf_round.py``) and the path their wrappers take for
tensors that lie on the CPU.  They repeat the arithmetic of
``repro/kernels/ref.py`` operation for operation, in f32.  Traces stored in
bf16 (the quantized state tier) are upcast before any arithmetic, as the
TPU kernels do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-8


def hcu_softmax(s: torch.Tensor, n_hcu: int, n_mcu: int) -> torch.Tensor:
    """Softmax within each hypercolumn: s (..., n_hcu*n_mcu)."""
    blocked = s.reshape(*s.shape[:-1], n_hcu, n_mcu)
    e = torch.exp(blocked - blocked.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).reshape(s.shape)


def bcpnn_update(
    ai: torch.Tensor,
    aj: torch.Tensor,
    ci: torch.Tensor,
    cj: torch.Tensor,
    cij: torch.Tensor,
    lam: float,
    k_b: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    state_mantissa: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alg.1 L11-16: EWMA marginals then Bayesian weights/bias.

    With ``state_mantissa`` the new traces are RNE-rounded to that mantissa
    width and w/bias derive from the rounded traces (the kernels' epilogue,
    ``repro/kernels/bcpnn_update.py:110-113``).  Returns (ci', cj', cij', w,
    bias), all f32.
    """
    b = ai.shape[0]
    one_m = 1.0 - lam
    mi = ai.mean(dim=0)
    mj = aj.mean(dim=0)
    mij = (ai.T @ aj) / b
    ci_n = one_m * ci.float() + lam * mi
    cj_n = one_m * cj.float() + lam * mj
    cij_n = one_m * cij.float() + lam * mij
    if state_mantissa is not None:
        ci_n = bf_round(ci_n, state_mantissa)
        cj_n = bf_round(cj_n, state_mantissa)
        cij_n = bf_round(cij_n, state_mantissa)
    log_cj = torch.log(torch.clamp_min(cj_n, EPS))
    w = (
        torch.log(torch.clamp_min(cij_n, EPS))
        - torch.log(torch.clamp_min(ci_n, EPS))[:, None]
        - log_cj[None, :]
    )
    if mask is not None:
        w = w * mask
    return ci_n, cj_n, cij_n, w, k_b * log_cj


def bcpnn_phase(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    ci: torch.Tensor,
    cj: torch.Tensor,
    cij: torch.Tensor,
    lam: float,
    n_hcu: int,
    n_mcu: int,
    k_b: float = 1.0,
    gain: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    state_mantissa: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """One whole BCPNN training batch (Alg.1 L8-16): forward support, gain,
    per-HCU softmax, then the update cycle with its rounding epilogue.

    Returns (aj, ci', cj', cij', w', bias'), all f32.
    """
    s = masked_matmul(x, w, b, mask=mask)
    if gain != 1.0:
        s = s * gain
    aj = hcu_softmax(s, n_hcu, n_mcu)
    return (aj,) + bcpnn_update(
        x, aj, ci, cj, cij, lam, k_b=k_b, mask=mask, state_mantissa=state_mantissa
    )


def masked_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """s = x @ (w*mask) + b in f32 (Alg.1 L8 with L16 fused)."""
    weff = w * mask if mask is not None else w
    s = x @ weff
    return s + b if b is not None else s


def bf_round(x: torch.Tensor, mantissa_bits: int) -> torch.Tensor:
    """Round-to-nearest-even truncation of the f32 mantissa to
    ``mantissa_bits`` (sign and 8-bit exponent kept); 23 is the identity and
    7 is bfloat16.  A carry may propagate into the exponent, so a finite
    value past the largest one of the format becomes inf; non-finite values
    pass through.

    The bit arithmetic runs in int64 on the int32 view, since PyTorch's
    CPU ``uint32`` arithmetic is incomplete.
    """
    if not (1 <= mantissa_bits <= 23):
        raise ValueError(f"mantissa_bits must be in [1,23], got {mantissa_bits}")
    x32 = x.to(torch.float32)
    if mantissa_bits == 23:
        return x32.clone()
    shift = 23 - mantissa_bits
    full = 0xFFFFFFFF
    u = x32.view(torch.int32).to(torch.int64) & full
    bias = (1 << (shift - 1)) - 1
    lsb = (u >> shift) & 1
    rounded = (u + bias + lsb) & (full ^ ((1 << shift) - 1))
    rounded = torch.where(rounded >= 1 << 31, rounded - (1 << 32), rounded)
    out = rounded.to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x32), out, x32)
