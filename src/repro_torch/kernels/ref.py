"""Plain PyTorch versions of the kernels in this package.

Each function is the semantic ground truth of one Hopper kernel
(``masked_matmul.py`` / ``hcu_softmax.py`` / ``bcpnn_update.py``) and the
path their wrappers take for tensors that lie on the CPU.  They repeat the
arithmetic of ``repro/kernels/ref.py`` operation for operation, in f32.
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alg.1 L11-16: EWMA marginals then Bayesian weights/bias.

    Returns (ci', cj', cij', w, bias).
    """
    b = ai.shape[0]
    one_m = 1.0 - lam
    mi = ai.mean(dim=0)
    mj = aj.mean(dim=0)
    mij = (ai.T @ aj) / b
    ci_n = one_m * ci + lam * mi
    cj_n = one_m * cj + lam * mj
    cij_n = one_m * cij + lam * mij
    log_cj = torch.log(torch.clamp_min(cj_n, EPS))
    w = (
        torch.log(torch.clamp_min(cij_n, EPS))
        - torch.log(torch.clamp_min(ci_n, EPS))[:, None]
        - log_cj[None, :]
    )
    if mask is not None:
        w = w * mask
    return ci_n, cj_n, cij_n, w, k_b * log_cj


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
