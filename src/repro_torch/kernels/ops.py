"""The kernel layer the rest of the package calls (``core.layers``).

Dispatch goes by the device of the input tensors: CPU tensors take each
kernel's plain version (``ref.py``), CUDA tensors launch the hand-written
Hopper kernel, and anything else raises.  There is no fallback and no
``use_kernels`` flag: on the card the kernels are the path.

``state_format`` (the quantized state tier) arrives with the precision
slice; until then it raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import bcpnn_update as _bk
from repro_torch.kernels import hcu_softmax as _sk
from repro_torch.kernels import masked_matmul as _mk

KERNELS = {"masked_matmul": _mk, "hcu_softmax": _sk, "bcpnn_update": _bk}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launches`."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launches() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def hcu_softmax(s: torch.Tensor, n_hcu: int, n_mcu: int) -> torch.Tensor:
    return _sk.hcu_softmax(s, n_hcu, n_mcu)


def masked_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``mask=None`` reaches the kernel as a null pointer: no ones matrix."""
    return _mk.masked_matmul(x, w, b, mask=mask)


def bcpnn_update(
    marginals,
    ai: torch.Tensor,
    aj: torch.Tensor,
    lam: float,
    k_b: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    state_format=None,
):
    """Full Alg.1 L11-16 cycle: returns (new MarginalState, w, b), matching
    ``learning.learning_cycle``.  The vector EWMAs and the bias run inside
    the kernel beside the C_ij outer product."""
    from repro_torch.core.learning import MarginalState

    if state_format is not None:
        raise NotImplementedError(
            f"state_format={state_format!r}: the quantized state tier is not ported yet"
        )
    ci, cj, cij, w, bias = _bk.bcpnn_update(
        ai, aj, marginals.ci, marginals.cj, marginals.cij, lam, k_b=k_b, mask=mask
    )
    return MarginalState(ci=ci, cj=cj, cij=cij), w, bias
