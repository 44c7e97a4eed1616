"""Hopper kernel for the forward support s = x @ (w ∘ mask) + b.

Replaces the TPU kernel ``repro/kernels/masked_matmul.py:masked_matmul``
(``pl.pallas_call`` at line 80).  Source: ``csrc/masked_matmul.cu``.

Bound on an H100: at the MNIST hidden layer (B=128, F=1568, H=3000) the
product is 1.2 GFLOP of f32 FMA against about 40 MB of x, w, mask, b and s,
so it is bound by operations (f32 runs outside the tensor cores, whose
TF32 would be ~1e-3 off the f32 reference).  Design: a tiled SIMT GEMM with
a 4x4 register micro-tile per thread; the mask is multiplied into each w
tile while it is staged in shared memory, so w ∘ mask never reaches device
memory, which was the point of the TPU kernel too.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches since the last reset (see ops.reset_launches)

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_fn = None


def masked_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x (M, K) @ (w (K, N) ∘ mask (K, N)) + b (N,) -> (M, N) f32.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches, _fn
    if _build.on_cpu("masked_matmul", x, w, b, mask):
        return ref.masked_matmul(x, w, b, mask)
    m, k = x.shape
    if w.shape[0] != k or (mask is not None and mask.shape != w.shape):
        raise ValueError(
            f"masked_matmul: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"mask {None if mask is None else tuple(mask.shape)} do not chain"
        )
    n = w.shape[1]
    if b is not None and b.shape != (n,):
        raise ValueError(f"masked_matmul: bias {tuple(b.shape)} != ({n},)")
    if _fn is None:
        _fn = _build.function("masked_matmul", "masked_matmul_f32", _ARGTYPES)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _build.launch(
        "masked_matmul", _fn, x.device,
        x.data_ptr(), w.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if b is None else b.data_ptr(),
        out.data_ptr(), m, k, n,
    )
    launches += 1
    return out
