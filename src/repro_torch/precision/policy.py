"""Reduced-precision BCPNN datapath and the quantized state tier.

The paper's FPGA study varies every floating-point operator.  The
reference (``repro/precision/policy.py``) emulates that datapath by
rounding (RNE) to the target format at every algebraic stage boundary of
Alg. 1, and this module does the same stage for stage:

    support   s   = q(q(x) @ q(w o mask) + q(b)), then q(s * gain)
    softmax   a_j = q(softmax_HCU(s))
    means     m_* = q(<a>)                 (q(a_i)^T q(a_j) / B for C_ij)
    EWMA      C_* = q((1-lam) C + lam m)
    weights   w   = q(log C_ij - log C_i - log C_j), masked
    bias      b   = q(k_B log C_j)

``PrecisionPolicy(fmt, state_format)`` names the datapath format ``fmt``
and, orthogonally, the storage format of the MarginalState traces (the
state tier: traces rounded between batches, stored in bf16 where that is
exact).  Arithmetic always runs in f32.  Each ``q`` is one ``bf_round``
launch on the card; the forward runs through the ``masked_matmul`` and
``hcu_softmax`` kernels on rounded operands.  The a_i^T a_j product and the
elementwise stages are plain PyTorch, as they are plain jnp outside any
Pallas kernel in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.learning import EPS, MarginalState, full_f32_matmul
from repro_torch.core.units import UnitLayout
from repro_torch.kernels import ops
from repro_torch.precision.formats import BFFormat, get_format, round_to, state_spec


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Datapath format ``fmt`` and the orthogonal storage tier
    ``state_format``.  ``PrecisionPolicy.named("fp32", state_format="bf16")``
    is the pure state tier: full-precision arithmetic, bf16 traces."""

    fmt: BFFormat
    state_format: Optional[BFFormat] = None

    @classmethod
    def named(cls, name: str, state_format=None) -> "PrecisionPolicy":
        if isinstance(state_format, str):
            state_format = get_format(state_format)
        return cls(fmt=get_format(name), state_format=state_format)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to the datapath format, as f32."""
        return round_to(x, self.fmt)

    @property
    def has_state_tier(self) -> bool:
        return self.state_format is not None and not self.state_format.is_identity

    def q_state(self, x: torch.Tensor) -> torch.Tensor:
        """Round and cast one tensor into the state storage tier (identity
        when no state tier is set)."""
        mant, dtype = state_spec(self.state_format)
        if mant is None:
            return x
        y = round_to(x.to(torch.float32), self.state_format)
        return y.to(dtype) if dtype is not None else y


def quantized_support(
    ai: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    policy: PrecisionPolicy,
    mask: Optional[torch.Tensor] = None,
    gain: float = 1.0,
) -> torch.Tensor:
    """Alg.1 L8 with every stage rounded: ``q(q(ai) @ q(w o mask) + q(b))``,
    then ``q(s * gain)`` when gain is not 1.

    ``q(w o mask)`` equals ``q(w) o mask`` bit for bit for a 0/1 mask (RNE
    maps +-0 to +-0), so the mask goes into ``masked_matmul`` with the
    rounded weights and no masked copy of w is written."""
    q = policy.q
    s = q(ops.masked_matmul(q(ai), q(w), q(b), mask=mask))
    if gain != 1.0:
        s = q(s * gain)
    return s


def quantized_forward(
    ai: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    layout: UnitLayout,
    policy: PrecisionPolicy,
    mask: Optional[torch.Tensor] = None,
    gain: float = 1.0,
) -> torch.Tensor:
    """Alg.1 L8-9 with every stage rounded to ``policy.fmt``: the support
    (:func:`quantized_support`), then ``q`` of the per-HCU softmax."""
    s = quantized_support(ai, w, b, policy, mask=mask, gain=gain)
    return policy.q(ops.hcu_softmax(s, n_hcu=layout.n_hcu, n_mcu=layout.n_mcu))


def quantized_learning_cycle(
    state: MarginalState,
    ai: torch.Tensor,
    aj: torch.Tensor,
    lam: float,
    policy: PrecisionPolicy,
    k_b: float = 1.0,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[MarginalState, torch.Tensor, torch.Tensor]:
    """Alg.1 L10-16 with every stage rounded to ``policy.fmt``: returns
    (new MarginalState, w, bias).  With a state tier the new traces then go
    through :func:`state_quantized_cycle` and w/bias are rounded again."""
    q = policy.q
    ai_q, aj_q = q(ai), q(aj)
    mi = q(ai_q.mean(dim=0))
    mj = q(aj_q.mean(dim=0))
    mij = q(full_f32_matmul(ai_q.T, aj_q) / ai.shape[0])
    one_m = 1.0 - lam
    # Traces may be stored in bf16 (the state tier): the EWMA runs in f32.
    ci = q(one_m * state.ci.to(torch.float32) + lam * mi)
    cj = q(one_m * state.cj.to(torch.float32) + lam * mj)
    cij = q(one_m * state.cij.to(torch.float32) + lam * mij)
    new_state = MarginalState(ci=ci, cj=cj, cij=cij)
    w = q(
        torch.log(torch.clamp_min(cij, EPS))
        - torch.log(torch.clamp_min(ci, EPS))[:, None]
        - torch.log(torch.clamp_min(cj, EPS))[None, :]
    )
    if mask is not None:
        w = w * mask
    bias = q(k_b * torch.log(torch.clamp_min(cj, EPS)))
    if policy.has_state_tier:
        new_state, w, bias = state_quantized_cycle(new_state, policy, k_b=k_b, mask=mask)
        w, bias = q(w), q(bias)
    return new_state, w, bias


def state_quantized_cycle(
    state: MarginalState,
    policy: PrecisionPolicy,
    k_b: float = 1.0,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[MarginalState, torch.Tensor, torch.Tensor]:
    """Round a freshly updated MarginalState into the policy's state tier
    and derive w/bias from the *rounded* traces: the plain mirror of the
    kernels' rounding epilogue.  Without a state tier only w/bias are
    derived."""
    if not policy.has_state_tier:
        w, bias = _weights_from(state, k_b, mask)
        return state, w, bias
    fmt = policy.state_format

    def rq(t):
        return round_to(t.to(torch.float32), fmt)

    ci, cj, cij = rq(state.ci), rq(state.cj), rq(state.cij)
    w, bias = _weights_from(MarginalState(ci=ci, cj=cj, cij=cij), k_b, mask)
    _, dtype = state_spec(fmt)
    if dtype is not None:
        ci, cj, cij = ci.to(dtype), cj.to(dtype), cij.to(dtype)
    return MarginalState(ci=ci, cj=cj, cij=cij), w, bias


def _weights_from(
    state: MarginalState, k_b: float, mask: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    ci = state.ci.to(torch.float32)
    cj = state.cj.to(torch.float32)
    cij = state.cij.to(torch.float32)
    w = (
        torch.log(torch.clamp_min(cij, EPS))
        - torch.log(torch.clamp_min(ci, EPS))[:, None]
        - torch.log(torch.clamp_min(cj, EPS))[None, :]
    )
    if mask is not None:
        w = w * mask
    return w, k_b * torch.log(torch.clamp_min(cj, EPS))


def quantize_marginals(state: MarginalState, policy: Optional[PrecisionPolicy]) -> MarginalState:
    """A MarginalState rounded and cast into the policy's storage tier
    (unchanged without one); ``compile()`` applies it to the initial state,
    so every epoch starts in the storage dtype."""
    if policy is None or not policy.has_state_tier:
        return state
    return MarginalState(
        ci=policy.q_state(state.ci),
        cj=policy.q_state(state.cj),
        cij=policy.q_state(state.cij),
    )
