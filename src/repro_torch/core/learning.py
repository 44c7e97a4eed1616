"""BCPNN learning rule: EWMA probability marginals -> weights/biases.

The plain formulation of the paper's Algorithm 1 inner loop (lines 8-16).
The layers reach the Hopper kernels through ``repro_torch.kernels.ops``;
these functions are the module-level reference they are tested against.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.units import UnitLayout

# Probability floor: marginals are clamped at EPS before logs.
EPS = 1e-8


class MarginalState(NamedTuple):
    """EWMA marginal estimates between a pre-layer (i) and post-layer (j).

    ci:  (n_pre,)        P(x_i)   estimate
    cj:  (n_post,)       P(y_j)   estimate
    cij: (n_pre, n_post) P(x_i, y_j) estimate
    """

    ci: torch.Tensor
    cj: torch.Tensor
    cij: torch.Tensor

    @property
    def n_pre(self) -> int:
        return self.ci.shape[0]

    def to(self, device) -> "MarginalState":
        """This state with every trace on ``device`` (dtypes kept)."""
        return MarginalState(self.ci.to(device), self.cj.to(device), self.cij.to(device))

    @property
    def n_post(self) -> int:
        return self.cj.shape[0]


def init_marginals(
    n_pre: int,
    n_post: int,
    pre_layout: Optional[UnitLayout] = None,
    post_layout: Optional[UnitLayout] = None,
    generator: Optional[torch.Generator] = None,
    jitter: float = 0.0,
    device=None,
) -> MarginalState:
    """Marginals at the uniform-independence prior (weights exactly zero).

    A multiplicative log-normal ``jitter`` on cij, drawn from ``generator``,
    breaks the symmetry of unsupervised layers (weights start at
    ~N(0, jitter^2)); supervised readouts need none.
    """
    pi = 1.0 / (pre_layout.n_mcu if pre_layout is not None else n_pre)
    pj = 1.0 / (post_layout.n_mcu if post_layout is not None else n_post)
    kw = dict(dtype=torch.float32, device=device)
    ci = torch.full((n_pre,), pi, **kw)
    cj = torch.full((n_post,), pj, **kw)
    cij = torch.full((n_pre, n_post), pi * pj, **kw)
    if generator is not None and jitter > 0.0:
        eta = jitter * torch.randn(
            (n_pre, n_post), generator=generator, dtype=torch.float32,
            device=generator.device,
        )
        cij = cij * torch.exp(eta.to(cij.device))
    return MarginalState(ci=ci, cj=cj, cij=cij)


def full_f32_matmul(
    a: torch.Tensor, b: torch.Tensor, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``a @ b`` in full f32 (into ``out`` when given), as the reference's
    products run (``preferred_element_type=float32``).  Raises while TF32
    or a lower matmul precision is switched on
    (``torch.backends.cuda.matmul.allow_tf32``,
    ``torch.set_float32_matmul_precision``): such a product would be a
    different function, about 1e-3 off."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "this product runs in full f32: switch TF32 off "
            "(torch.set_float32_matmul_precision('highest'))"
        )
    return torch.matmul(a, b, out=out)


def batch_means(ai: torch.Tensor, aj: torch.Tensor):
    """Per-batch means (mi, mj, mij) with mij = ai^T aj / B."""
    return ai.mean(dim=0), aj.mean(dim=0), (ai.T @ aj) / ai.shape[0]


def update_marginals(
    state: MarginalState,
    mi: torch.Tensor,
    mj: torch.Tensor,
    mij: torch.Tensor,
    lam: float,
) -> MarginalState:
    """EWMA marginal update (Alg.1 L11-13), given batch means."""
    one_m = 1.0 - lam
    return MarginalState(
        ci=one_m * state.ci + lam * mi,
        cj=one_m * state.cj + lam * mj,
        cij=one_m * state.cij + lam * mij,
    )


def weights_from_marginals(state: MarginalState, k_b: float = 1.0):
    """w_ij = log(cij / (ci cj)), b_j = k_b log(cj), all clamped at EPS."""
    log_ci = torch.log(torch.clamp_min(state.ci, EPS))
    log_cj = torch.log(torch.clamp_min(state.cj, EPS))
    log_cij = torch.log(torch.clamp_min(state.cij, EPS))
    w = log_cij - log_ci[:, None] - log_cj[None, :]
    return w, k_b * log_cj


def learning_cycle(
    state: MarginalState,
    ai: torch.Tensor,
    aj: torch.Tensor,
    lam: float,
    k_b: float = 1.0,
    mask: Optional[torch.Tensor] = None,
):
    """One inner learning cycle (Alg.1 L11-16): returns (new_state, w, b)."""
    new_state = update_marginals(state, *batch_means(ai, aj), lam)
    w, b = weights_from_marginals(new_state, k_b)
    if mask is not None:
        w = w * mask
    return new_state, w, b


def hcu_softmax(s: torch.Tensor, layout: UnitLayout) -> torch.Tensor:
    """Softmax computed independently within each HCU (Alg.1 L9)."""
    return layout.flat(torch.softmax(layout.blocked(s), dim=-1))


def forward(
    ai: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    layout: UnitLayout,
    mask: Optional[torch.Tensor] = None,
    gain: float = 1.0,
) -> torch.Tensor:
    """Alg.1 L8-9: s = ai @ (w o mask) + b, times ``gain`` (the softmax
    inverse temperature), then softmax per HCU."""
    if mask is not None:
        w = w * mask
    s = ai @ w + b
    if gain != 1.0:
        s = s * gain
    return hcu_softmax(s, layout)
