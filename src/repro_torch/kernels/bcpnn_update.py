"""Hopper kernel for the BCPNN marginal + weight update (Alg.1 L11-16).

Replaces the TPU kernel ``repro/kernels/bcpnn_update.py:bcpnn_update_fused``
(``pl.pallas_call`` at line 192) with ``state_mantissa=None``.  Source:
``csrc/bcpnn_update.cu``.

Bound on an H100: at the MNIST hidden layer (B=128, F=1568, H=3000) the
update reads C_ij and the mask and writes C_ij' and w, about 78 MB, against
1.2 GFLOP of outer product: it is bound by bytes (~23 µs at 3.35 TB/s).
Design: the TPU kernel carries sums across its sequential grid; here one
block per (F tile, H tile) loops over the whole batch instead, accumulating
a_iᵀa_j in registers and the column sums of its own a_i and a_j slices in
the same pass, so the means need no cross-block reduction and no atomics
and every output element is written exactly once.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches since the last reset (see ops.reset_launches)

_ARGTYPES = (
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
    + [ctypes.c_void_p]
)
_fn = None


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
    """ai (B, F), aj (B, H), ci (F,), cj (H,), cij and mask (F, H) ->
    (ci', cj', cij', w, bias), all fresh f32 tensors.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches, _fn
    if _build.on_cpu("bcpnn_update", ai, aj, ci, cj, cij, mask):
        return ref.bcpnn_update(ai, aj, ci, cj, cij, lam, k_b=k_b, mask=mask)
    bsz, f = ai.shape
    h = aj.shape[1]
    if (
        aj.shape[0] != bsz or ci.shape != (f,) or cj.shape != (h,)
        or cij.shape != (f, h) or (mask is not None and mask.shape != (f, h))
    ):
        raise ValueError(
            f"bcpnn_update: shapes do not agree: ai {tuple(ai.shape)}, "
            f"aj {tuple(aj.shape)}, ci {tuple(ci.shape)}, cj {tuple(cj.shape)}, "
            f"cij {tuple(cij.shape)}, mask {None if mask is None else tuple(mask.shape)}"
        )
    if _fn is None:
        _fn = _build.function("bcpnn_update", "bcpnn_update_f32", _ARGTYPES)
    ci_n = torch.empty_like(ci)
    cj_n = torch.empty_like(cj)
    cij_n = torch.empty_like(cij)
    w = torch.empty_like(cij)
    bias = torch.empty_like(cj)
    _build.launch(
        "bcpnn_update", _fn, ai.device,
        ai.data_ptr(), aj.data_ptr(), ci.data_ptr(), cj.data_ptr(),
        cij.data_ptr(), None if mask is None else mask.data_ptr(),
        ci_n.data_ptr(), cj_n.data_ptr(), cij_n.data_ptr(), w.data_ptr(),
        bias.data_ptr(), bsz, f, h, float(lam), 1.0 - float(lam), float(k_b),
    )
    launches += 1
    return ci_n, cj_n, cij_n, w, bias
