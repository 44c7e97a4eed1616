"""The kernel layer the rest of the package calls (``core.layers``).

Dispatch goes by the device of the input tensors and the caller's
``use_kernels``: CPU tensors take each kernel's plain version (``ref.py``)
whatever it says; CUDA tensors launch the hand-written Hopper kernel when
it is None (the default: the device decides) or True, and run the plain
version on the card when it is False, an explicit choice that is never
made for the caller.  Anything else raises; there is no fallback.
``bcpnn_phase`` exists only as a kernel on the card, so it takes no
``use_kernels``.

``state_format`` (None, a format name or a ``BFFormat``) selects the
quantized state tier: the new traces come back rounded to the format's
mantissa, in bf16 when that is exact.  ``round_mantissa`` (the forward
pair) and ``datapath_mantissa`` (the update) select the reduced datapath's
modes, every stage rounded inside the kernel that makes it.
:func:`bcpnn_update_means` is the update's reduced-means mode, the
learning cycle of the data-parallel trainer (``core/distributed.py``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import bcpnn_phase as _pk
from repro_torch.kernels import bcpnn_update as _bk
from repro_torch.kernels import bf_round as _bfk
from repro_torch.kernels import hcu_softmax as _sk
from repro_torch.kernels import masked_matmul as _mk

KERNELS = {
    "masked_matmul": _mk, "hcu_softmax": _sk, "bcpnn_update": _bk,
    "bcpnn_phase": _pk, "bf_round": _bfk,
}
# The kernels with a datapath mode: launch_counts() also counts their
# launches in it under "<kernel>.datapath".
DATAPATH_MODES = ("masked_matmul", "hcu_softmax", "bcpnn_update")


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launches`
    (every mode), under ``"<kernel>.datapath"`` those of them in the
    datapath mode, under ``"bcpnn_update.means"`` the update's launches
    in its reduced-means mode, and under ``"masked_matmul.gathered"``
    ``masked_matmul``'s launches of its gathered variant."""
    counts = {name: mod.launches for name, mod in KERNELS.items()}
    counts.update({f"{name}.datapath": KERNELS[name].datapath_launches for name in DATAPATH_MODES})
    counts["bcpnn_update.means"] = _bk.means_launches
    counts["masked_matmul.gathered"] = _mk.gathered_launches
    return counts


def reset_launches() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
    for name in DATAPATH_MODES:
        KERNELS[name].datapath_launches = 0
    _bk.means_launches = 0
    _mk.gathered_launches = 0


def _state_spec(state_format) -> Tuple[Optional[int], Optional[torch.dtype]]:
    """Resolve a ``state_format`` (None | name | BFFormat) into the kernels'
    (mantissa_bits, storage_dtype) pair."""
    if state_format is None:
        return None, None
    from repro_torch.precision.formats import get_format, state_spec

    fmt = get_format(state_format) if isinstance(state_format, str) else state_format
    return state_spec(fmt)


def hcu_softmax(
    s: torch.Tensor, n_hcu: int, n_mcu: int, round_mantissa: Optional[int] = None,
    use_kernels: Optional[bool] = None,
) -> torch.Tensor:
    """``round_mantissa``: the datapath's softmax stage, rounded at the store."""
    return _sk.hcu_softmax(
        s, n_hcu, n_mcu, round_mantissa=round_mantissa, plain=use_kernels is False
    )


def masked_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    mask: Optional[torch.Tensor] = None,
    round_mantissa: Optional[int] = None,
    gain: float = 1.0,
    use_kernels: Optional[bool] = None,
    hcu_mask: Optional[torch.Tensor] = None,
    pre_mcu: Optional[int] = None,
    post_mcu: Optional[int] = None,
    fan_in: Optional[int] = None,
) -> torch.Tensor:
    """``mask=None`` reaches the kernel as a null pointer: no ones matrix.
    ``round_mantissa``: the datapath's support stage, every operand, the
    sum and then the sum times ``gain`` rounded inside the kernel.
    ``hcu_mask`` (per hypercolumn pair, with the two layouts' minicolumns
    ``pre_mcu`` / ``post_mcu``; ``fan_in`` guides the plan) in place of
    ``mask``: the gathered variant, only where :func:`masked_matmul_gathers`
    says so (elsewhere it raises, and the caller passes the expanded
    ``mask=``)."""
    return _mk.masked_matmul(
        x, w, b, mask=mask, round_mantissa=round_mantissa, gain=gain,
        plain=use_kernels is False, hcu_mask=hcu_mask, pre_mcu=pre_mcu, post_mcu=post_mcu,
        fan_in=fan_in,
    )


def masked_matmul_gathers(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    hcu_mask: torch.Tensor,
    pre_mcu: int,
    post_mcu: int,
    fan_in: Optional[int] = None,
    use_kernels: Optional[bool] = None,
) -> bool:
    """Whether :func:`masked_matmul` with these ``hcu_mask=`` arguments
    launches the gathered variant (never on the CPU)."""
    return _mk.gathers(x, w, b, hcu_mask, pre_mcu, post_mcu, fan_in, plain=use_kernels is False)


def bf_round(
    x: torch.Tensor, mantissa_bits: int, use_kernels: Optional[bool] = None
) -> torch.Tensor:
    return _bfk.bf_round(x, mantissa_bits, plain=use_kernels is False)


def bcpnn_update(
    marginals,
    ai: torch.Tensor,
    aj: torch.Tensor,
    lam: float,
    k_b: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    state_format=None,
    datapath_mantissa: Optional[int] = None,
    use_kernels: Optional[bool] = None,
):
    """Full Alg.1 L11-16 cycle: returns (new MarginalState, w, b), matching
    ``learning.learning_cycle``.  The vector EWMAs, the bias and, with
    ``state_format``, the rounding run inside the kernel beside the C_ij
    outer product.  With ``datapath_mantissa`` it is the reduced datapath's
    cycle, every stage rounded, in the same one launch."""
    from repro_torch.core.learning import MarginalState

    mant, sdtype = _state_spec(state_format)
    ci, cj, cij, w, bias = _bk.bcpnn_update(
        ai, aj, marginals.ci, marginals.cj, marginals.cij, lam, k_b=k_b, mask=mask,
        state_mantissa=mant, state_dtype=sdtype, datapath_mantissa=datapath_mantissa,
        plain=use_kernels is False,
    )
    return MarginalState(ci=ci, cj=cj, cij=cij), w, bias


def bcpnn_update_means(
    marginals,
    mi: torch.Tensor,
    mj: torch.Tensor,
    mij: torch.Tensor,
    lam: float,
    k_b: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    use_kernels: Optional[bool] = None,
):
    """The update's reduced-means mode: the EWMA and the weights from batch
    means already all-reduced over the ranks (the paper's MPI backend), one
    launch.  Returns (new MarginalState, w, b); f32 traces only."""
    from repro_torch.core.learning import MarginalState

    ci, cj, cij, w, bias = _bk.bcpnn_update_means(
        mi, mj, mij, marginals.ci, marginals.cj, marginals.cij, lam, k_b=k_b, mask=mask,
        plain=use_kernels is False,
    )
    return MarginalState(ci=ci, cj=cj, cij=cij), w, bias


def bcpnn_phase(
    marginals,
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    layout,
    lam: float,
    k_b: float = 1.0,
    gain: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    n_cycles: int = 1,
    state_format=None,
):
    """One whole BCPNN training batch (Alg.1 L8-16) in one launch: forward
    support, gain, per-HCU softmax, batch means, EWMA marginals and the
    weight/bias epilogue.  ``layout`` is the post UnitLayout.  Extra
    learning cycles (``n_cycles > 1``) reuse the first cycle's activations
    through :func:`bcpnn_update`, as the unfused path does.  Returns
    (new MarginalState, w', b', aj)."""
    from repro_torch.core.learning import MarginalState

    mant, sdtype = _state_spec(state_format)
    aj, ci, cj, cij, w_n, bias = _pk.bcpnn_phase(
        x, w, b, marginals.ci, marginals.cj, marginals.cij, lam,
        layout.n_hcu, layout.n_mcu, k_b=k_b, gain=gain, mask=mask,
        state_mantissa=mant, state_dtype=sdtype,
    )
    state = MarginalState(ci=ci, cj=cj, cij=cij)
    for _ in range(n_cycles - 1):
        state, w_n, bias = bcpnn_update(
            state, x, aj, lam, k_b=k_b, mask=mask, state_format=state_format
        )
    return state, w_n, bias, aj
