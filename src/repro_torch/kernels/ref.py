"""Plain PyTorch versions of the kernels in this package.

Each function is the semantic ground truth of one Hopper kernel
(``masked_matmul.py`` / ``hcu_softmax.py`` / ``bcpnn_update.py`` /
``bcpnn_phase.py`` / ``bf_round.py``; ``bcpnn_update_means`` is the
reduced-means mode of ``bcpnn_update``) and the path their wrappers take for
tensors that lie on the CPU.  They repeat the arithmetic of
``repro/kernels/ref.py`` operation for operation, in f32.  Traces stored in
bf16 (the quantized state tier) are upcast before any arithmetic, as the
TPU kernels do.  The reduced datapath's modes of the forward pair and of
the update (``round_mantissa=`` / ``datapath_mantissa=``) are the staged
compositions of ``repro/precision/policy.py``, every stage one
:func:`bf_round`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

EPS = 1e-8


def hcu_softmax(
    s: torch.Tensor, n_hcu: int, n_mcu: int, round_mantissa: Optional[int] = None
) -> torch.Tensor:
    """Softmax within each hypercolumn: s (..., n_hcu*n_mcu); with
    ``round_mantissa``, each output rounded to that mantissa."""
    blocked = s.reshape(*s.shape[:-1], n_hcu, n_mcu)
    e = torch.exp(blocked - blocked.amax(dim=-1, keepdim=True))
    a = (e / e.sum(dim=-1, keepdim=True)).reshape(s.shape)
    return a if round_mantissa is None else bf_round(a, round_mantissa)


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
    datapath_mantissa: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Alg.1 L11-16: EWMA marginals then Bayesian weights/bias.

    With ``state_mantissa`` the new traces are RNE-rounded to that mantissa
    width and w/bias derive from the rounded traces (the kernels' epilogue,
    ``repro/kernels/bcpnn_update.py:110-113``).  With ``datapath_mantissa``
    it is the reduced datapath's cycle (``repro/precision/policy.py:103-142``
    then ``:state_quantized_cycle``): q, the rounding to that mantissa, of
    a_i and a_j, of each mean, of each EWMA before the state tier's
    rounding, and of w and the bias.  The a_i^T a_j product runs in full
    f32.  Returns (ci', cj', cij', w, bias), all f32.
    """
    from repro_torch.core.learning import full_f32_matmul

    def q(t):
        return t if datapath_mantissa is None else bf_round(t, datapath_mantissa)

    ai, aj = q(ai), q(aj)
    one_m = 1.0 - lam
    mi = q(ai.mean(dim=0))
    mj = q(aj.mean(dim=0))
    mij = q(full_f32_matmul(ai.T, aj) / ai.shape[0])
    ci_n = q(one_m * ci.float() + lam * mi)
    cj_n = q(one_m * cj.float() + lam * mj)
    cij_n = q(one_m * cij.float() + lam * mij)
    if state_mantissa is not None:
        ci_n = bf_round(ci_n, state_mantissa)
        cj_n = bf_round(cj_n, state_mantissa)
        cij_n = bf_round(cij_n, state_mantissa)
    log_cj = torch.log(torch.clamp_min(cj_n, EPS))
    w = q(
        torch.log(torch.clamp_min(cij_n, EPS))
        - torch.log(torch.clamp_min(ci_n, EPS))[:, None]
        - log_cj[None, :]
    )
    if mask is not None:
        w = w * mask
    return ci_n, cj_n, cij_n, w, q(k_b * log_cj)


def bcpnn_update_means(
    mi: torch.Tensor,
    mj: torch.Tensor,
    mij: torch.Tensor,
    ci: torch.Tensor,
    cj: torch.Tensor,
    cij: torch.Tensor,
    lam: float,
    k_b: float = 1.0,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reduced-means mode: the EWMA of the three traces from batch
    means already all-reduced over the ranks, then w and bias from their
    logs (``update_marginals`` + ``weights_from_marginals`` + mask of
    ``repro/core/learning.py``, as ``repro/core/distributed.py:
    dp_learning_cycle`` runs them).  Returns (ci', cj', cij', w, bias), f32."""
    one_m = 1.0 - lam
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
    round_mantissa: Optional[int] = None,
    gain: float = 1.0,
) -> torch.Tensor:
    """s = x @ (w*mask) + b in f32 (Alg.1 L8 with L16 fused).  With
    ``round_mantissa`` the datapath's support ``q(q(x) @ q(w*mask) + q(b))``
    (``q(w) * mask``, equal bit for bit for a 0/1 mask), then ``q(s *
    gain)`` when the gain is not 1."""
    if round_mantissa is not None:
        def q(t):
            return bf_round(t, round_mantissa)

        s = q(masked_matmul(q(x), q(w), None if b is None else q(b), mask))
        return q(s * gain) if gain != 1.0 else s
    weff = w * mask if mask is not None else w
    s = x @ weff
    return s + b if b is not None else s


def unit_mask(hcu_mask: torch.Tensor, pre_mcu: int, post_mcu: int) -> torch.Tensor:
    """The (n_pre_hcu, n_post_hcu) mask per hypercolumn pair expanded to
    the (F, H) unit mask: each entry repeated over the pre HCU's
    ``pre_mcu`` rows and the post HCU's ``post_mcu`` columns."""
    return hcu_mask.repeat_interleave(pre_mcu, dim=0).repeat_interleave(post_mcu, dim=1)


def kept_lists(hcu_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kept lists of ``masked_matmul``'s gathered variant: ``kept``
    (n_post_hcu, n_pre_hcu) int32, row h the input HCUs i with
    ``hcu_mask[i, h] != 0`` in ascending order, then zeros (the kernel
    leaves the tail unwritten), and ``counts`` (n_post_hcu,) int32."""
    on = (hcu_mask != 0).T
    counts = on.sum(dim=1, dtype=torch.int32)
    order = torch.sort((~on).to(torch.int8), dim=1, stable=True).indices.to(torch.int32)
    head = torch.arange(on.shape[1], device=on.device)[None, :] < counts[:, None]
    return torch.where(head, order, torch.zeros_like(order)), counts


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
