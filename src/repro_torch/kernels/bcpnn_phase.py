"""Hopper kernel for one whole BCPNN hidden training batch (Alg.1 L8-16).

Replaces the TPU kernel ``repro/kernels/bcpnn_phase.py:bcpnn_phase_fused``
(``pl.pallas_call`` at line 265; its ``hcu_block_h`` tiling at line 53).
Source: ``csrc/bcpnn_phase.cu``.

Forward support, gain, per-hypercolumn softmax and the whole update cycle
(rounding epilogue and bf16 state included) run in one launch, so s and a_j
never make a round trip through device memory between kernels and the host
enqueues one launch per batch instead of three kernels and the gain.
Bound on an H100: at the MNIST hidden layer (B=128, F=1568, H=3000) the two
products are 2.41 GFLOP of f32 FMA (~0.036 ms at 67 TFLOP/s) against ~96 MB
of bytes with f32 state (~75 MB with bf16), so operations.  Design: a
cluster of up to 8 CTAs per group of whole hypercolumns splits F; the
partial supports are summed through distributed shared memory in rank
order, each CTA applies the softmax to its share of rows, and a_j stays in
shared memory for the update (see the source's header).  The TPU kernel's
grid order and fake-hypercolumn padding existed only for bitwise parity
between two Pallas paths; the port is held at a stated tolerance instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.bcpnn_update import check_state

launches = 0  # kernel launches since the last reset (see ops.reset_launches)

_ARGTYPES = (
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
    + [ctypes.c_int] * 3 + [ctypes.c_void_p]
)
_fn = None


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
    state_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, ...]:
    """x (B, F), w and mask (F, H), b (H,), traces ci (F,), cj (H,),
    cij (F, H) with H = n_hcu * n_mcu -> (aj, ci', cj', cij', w', bias').

    The traces share one dtype, f32 or bf16; the new ones are rounded to
    ``state_mantissa`` bits when it is set and come back in ``state_dtype``
    (None: f32; bf16 only for a mantissa of at most 7).  aj, w' and bias'
    are f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches, _fn
    out_dtype = check_state(ci, cj, cij, state_mantissa, state_dtype)
    state = _build.STATE
    f32 = _build.F32
    if _build.on_cpu(
        "bcpnn_phase", x, w, b, ci, cj, cij, mask,
        dtypes=(f32, f32, f32, state, state, state, f32),
    ):
        aj, ci_n, cj_n, cij_n, w_n, bias = ref.bcpnn_phase(
            x, w, b, ci, cj, cij, lam, n_hcu, n_mcu, k_b=k_b, gain=gain, mask=mask,
            state_mantissa=state_mantissa,
        )
        return aj, ci_n.to(out_dtype), cj_n.to(out_dtype), cij_n.to(out_dtype), w_n, bias
    bsz, f = x.shape
    h = n_hcu * n_mcu
    if (
        w.shape != (f, h) or b.shape != (h,) or ci.shape != (f,) or cj.shape != (h,)
        or cij.shape != (f, h) or (mask is not None and mask.shape != (f, h))
    ):
        raise ValueError(
            f"bcpnn_phase: shapes do not agree with x {tuple(x.shape)} and layout "
            f"({n_hcu},{n_mcu}): w {tuple(w.shape)}, b {tuple(b.shape)}, "
            f"ci {tuple(ci.shape)}, cj {tuple(cj.shape)}, cij {tuple(cij.shape)}, "
            f"mask {None if mask is None else tuple(mask.shape)}"
        )
    if _fn is None:
        _fn = _build.function("bcpnn_phase", "bcpnn_phase_f32", _ARGTYPES)
    dev = x.device
    aj = torch.empty((bsz, h), dtype=torch.float32, device=dev)
    ci_n = torch.empty(ci.shape, dtype=out_dtype, device=dev)
    cj_n = torch.empty(cj.shape, dtype=out_dtype, device=dev)
    cij_n = torch.empty(cij.shape, dtype=out_dtype, device=dev)
    w_n = torch.empty((f, h), dtype=torch.float32, device=dev)
    bias = torch.empty((h,), dtype=torch.float32, device=dev)
    _build.launch(
        "bcpnn_phase", _fn, dev,
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if mask is None else mask.data_ptr(),
        ci.data_ptr(), cj.data_ptr(), cij.data_ptr(), aj.data_ptr(),
        ci_n.data_ptr(), cj_n.data_ptr(), cij_n.data_ptr(), w_n.data_ptr(), bias.data_ptr(),
        bsz, f, n_hcu, n_mcu, float(lam), 1.0 - float(lam), float(k_b), float(gain),
        int(state_mantissa or 0), int(ci.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16),
    )
    launches += 1
    return aj, ci_n, cj_n, cij_n, w_n, bias
