"""Hopper kernel for the BCPNN marginal + weight update (Alg.1 L11-16).

Replaces the TPU kernel ``repro/kernels/bcpnn_update.py:bcpnn_update_fused``
(``pl.pallas_call`` at line 192), with its optional rounding epilogue (the
quantized state tier: traces RNE-rounded to ``state_mantissa`` bits and
w/bias derived from the rounded traces, ``csrc/rne_round.cuh``).  Source:
``csrc/bcpnn_update.cu``.  The traces are read in their storage dtype (f32
or bf16) and written straight in ``state_dtype``, so the bf16 tier costs no
cast pass over C_ij.

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
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]
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
    state_mantissa: Optional[int] = None,
    state_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """ai (B, F), aj (B, H), ci (F,), cj (H,), cij and mask (F, H) ->
    (ci', cj', cij', w, bias), all fresh tensors.

    The traces ci/cj/cij share one dtype, f32 or bf16.  With
    ``state_mantissa`` the new traces are rounded to that many mantissa
    bits; they come back in ``state_dtype`` (None: f32), which may be bf16
    only for a mantissa of at most 7.  w and bias are f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches, _fn
    out_dtype = check_state(ci, cj, cij, state_mantissa, state_dtype)
    state = _build.STATE
    f32 = _build.F32
    if _build.on_cpu(
        "bcpnn_update", ai, aj, ci, cj, cij, mask, dtypes=(f32, f32, state, state, state, f32)
    ):
        ci_n, cj_n, cij_n, w, bias = ref.bcpnn_update(
            ai, aj, ci, cj, cij, lam, k_b=k_b, mask=mask, state_mantissa=state_mantissa
        )
        return ci_n.to(out_dtype), cj_n.to(out_dtype), cij_n.to(out_dtype), w, bias
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
    ci_n = torch.empty(ci.shape, dtype=out_dtype, device=ci.device)
    cj_n = torch.empty(cj.shape, dtype=out_dtype, device=cj.device)
    cij_n = torch.empty(cij.shape, dtype=out_dtype, device=cij.device)
    w = torch.empty(cij.shape, dtype=torch.float32, device=cij.device)
    bias = torch.empty(cj.shape, dtype=torch.float32, device=cj.device)
    _build.launch(
        "bcpnn_update", _fn, ai.device,
        ai.data_ptr(), aj.data_ptr(), ci.data_ptr(), cj.data_ptr(),
        cij.data_ptr(), None if mask is None else mask.data_ptr(),
        ci_n.data_ptr(), cj_n.data_ptr(), cij_n.data_ptr(), w.data_ptr(),
        bias.data_ptr(), bsz, f, h, float(lam), 1.0 - float(lam), float(k_b),
        int(state_mantissa or 0), int(ci.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16),
    )
    launches += 1
    return ci_n, cj_n, cij_n, w, bias


def check_state(ci, cj, cij, state_mantissa, state_dtype) -> torch.dtype:
    """The dtype the new traces are written in; raises on traces of mixed
    dtypes, a mantissa outside [1, 22], or a bf16 output that would not be
    exact (mantissa above 7 or none)."""
    if not (ci.dtype == cj.dtype == cij.dtype):
        raise ValueError(
            f"traces of mixed dtypes: ci {ci.dtype}, cj {cj.dtype}, cij {cij.dtype}"
        )
    if state_mantissa is not None and not (1 <= state_mantissa <= 22):
        raise ValueError(f"state_mantissa must be in [1, 22] or None, got {state_mantissa}")
    out = torch.float32 if state_dtype is None else state_dtype
    if out == torch.bfloat16 and (state_mantissa is None or state_mantissa > 7):
        raise ValueError(
            f"bf16 traces need a state_mantissa of at most 7, got {state_mantissa}"
        )
    if out not in _build.STATE:
        raise ValueError(f"state_dtype {state_dtype} is neither float32 nor bfloat16")
    return out
