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
exact).  Arithmetic always runs in f32.  Every ``q`` of the datapath is
taken inside the kernel that makes the value, in the kernels' datapath
modes: the support in ``masked_matmul`` (``round_mantissa=``, the gain
too), the softmax in ``hcu_softmax``, and the whole learning cycle, state
tier included, in one ``bcpnn_update`` launch (``datapath_mantissa=``).
So a hidden batch on the card is three launches, and no rounded copy of a
stage is written.  On the CPU each mode's plain version is the staged
composition above, one ``bf_round`` a stage.  ``PrecisionPolicy.q`` and
the state tier's rounding of the initial traces (:func:`quantize_marginals`)
stay ``bf_round`` launches.  What a layer calls (the support, the
forward, the learning cycle, and :func:`quantize_marginals` at compile)
takes ``use_kernels`` (None: the device decides; False: the plain
versions, on the card too), as ``repro_torch.kernels.ops`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.learning import EPS, MarginalState
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

    def q_state(self, x: torch.Tensor, use_kernels: Optional[bool] = None) -> torch.Tensor:
        """Round and cast one tensor into the state storage tier (identity
        when no state tier is set)."""
        mant, dtype = state_spec(self.state_format)
        if mant is None:
            return x
        y = round_to(x.to(torch.float32), self.state_format, use_kernels)
        return y.to(dtype) if dtype is not None else y


def quantized_support(
    ai: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    policy: PrecisionPolicy,
    mask: Optional[torch.Tensor] = None,
    gain: float = 1.0,
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """Alg.1 L8 with every stage rounded: ``q(q(ai) @ q(w o mask) + q(b))``,
    then ``q(s * gain)`` when gain is not 1: one ``masked_matmul`` in its
    rounding mode.

    ``q(w o mask)`` equals ``q(w) o mask`` bit for bit for a 0/1 mask (RNE
    maps +-0 to +-0), so the kernel rounds the staged weights and then
    applies the mask, and no masked copy of w is written."""
    return ops.masked_matmul(
        _f32(ai), w, b, mask=mask, round_mantissa=policy.fmt.mantissa_bits, gain=gain,
        use_kernels=use_kernels,
    )


def quantized_forward(
    ai: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    layout: UnitLayout,
    policy: PrecisionPolicy,
    mask: Optional[torch.Tensor] = None,
    gain: float = 1.0,
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """Alg.1 L8-9 with every stage rounded to ``policy.fmt``: the support
    (:func:`quantized_support`), then ``q`` of the per-HCU softmax, rounded
    in ``hcu_softmax``'s store."""
    s = quantized_support(ai, w, b, policy, mask=mask, gain=gain, use_kernels=use_kernels)
    return ops.hcu_softmax(
        s, n_hcu=layout.n_hcu, n_mcu=layout.n_mcu, round_mantissa=policy.fmt.mantissa_bits,
        use_kernels=use_kernels,
    )


def quantized_learning_cycle(
    state: MarginalState,
    ai: torch.Tensor,
    aj: torch.Tensor,
    lam: float,
    policy: PrecisionPolicy,
    k_b: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    use_kernels: Optional[bool] = None,
) -> Tuple[MarginalState, torch.Tensor, torch.Tensor]:
    """Alg.1 L10-16 with every stage rounded to ``policy.fmt``: returns
    (new MarginalState, w, bias).  The means are ``q(<q(a)>)`` (``q(a_i)^T
    q(a_j) / B`` for C_ij), each trace ``q((1-lam) C + lam m)``, ``w =
    q(log C_ij - log C_i - log C_j)`` masked and ``bias = q(k_B log C_j)``.
    With a state tier the new traces are then rounded into it and w/bias
    derived from them and rounded again, as :func:`state_quantized_cycle`
    does.  One ``bcpnn_update`` launch in its datapath mode; traces stored
    in bf16 are read as they are, and the EWMA runs in f32."""
    return ops.bcpnn_update(
        state, _f32(ai), _f32(aj), lam, k_b=k_b, mask=mask,
        state_format=policy.state_format if policy.has_state_tier else None,
        datapath_mantissa=policy.fmt.mantissa_bits, use_kernels=use_kernels,
    )


def _f32(t: torch.Tensor) -> torch.Tensor:
    """An activation as the kernels take it, contiguous f32 (the reference's
    ``astype``); the tensor itself when it already is."""
    return t.to(torch.float32).contiguous()


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


def quantize_marginals(
    state: MarginalState, policy: Optional[PrecisionPolicy], use_kernels: Optional[bool] = None
) -> MarginalState:
    """A MarginalState rounded and cast into the policy's storage tier
    (unchanged without one); ``compile()`` applies it to the initial state,
    so every epoch starts in the storage dtype."""
    if policy is None or not policy.has_state_tier:
        return state
    return MarginalState(
        ci=policy.q_state(state.ci, use_kernels),
        cj=policy.q_state(state.cj, use_kernels),
        cij=policy.q_state(state.cij, use_kernels),
    )
