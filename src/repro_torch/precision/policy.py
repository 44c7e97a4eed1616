"""The quantized state tier of the reduced-precision datapath.

``PrecisionPolicy(fmt, state_format)`` names the datapath format ``fmt``
and the storage format of the MarginalState traces.  The port carries the
state tier: traces rounded to ``state_format`` between batches (in the
kernels' epilogues), stored in bf16 where that is exact, with all
arithmetic in f32.  The reduced *datapath* (``fmt`` other than fp32: every
algebraic stage rounded, the reference's ``quantized_forward`` /
``quantized_learning_cycle``) is not ported yet; a policy with one is
refused where a network is configured (``ExecutionConfig``,
``BCPNNLayerSpec``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.learning import EPS, MarginalState
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
