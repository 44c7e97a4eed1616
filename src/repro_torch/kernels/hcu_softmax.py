"""Hopper kernel for the softmax within each hypercolumn.

Replaces the TPU kernel ``repro/kernels/hcu_softmax.py:hcu_softmax``
(``pl.pallas_call`` at line 62).  Source: ``csrc/hcu_softmax.cu``.

Bound on an H100: a read and a write of s, a few flops per element, so it
is bound by bytes (about 3 MB at B=128, H=3000).  Design: the paper's own
CUDA one, one warp per (row, HCU) with ``__shfl_xor_sync`` reductions for
the max and the sum, reading each hypercolumn into registers once
(coalesced 4-byte loads), one ``expf`` per element and one write.
The TPU kernel's -inf padding of the MCU axis to 128 lanes is not needed.
The rounding mode (``round_mantissa=``) is the reduced datapath's softmax
stage: each output RNE-rounded at its store, no extra bytes.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches since the last reset (see ops.reset_launches)
datapath_launches = 0  # ... of them in the rounding mode

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_fn = None


def hcu_softmax(
    s: torch.Tensor, n_hcu: int, n_mcu: int, round_mantissa: Optional[int] = None,
    plain: bool = False,
) -> torch.Tensor:
    """s (B, n_hcu*n_mcu) -> per-HCU softmax activations, same shape; with
    ``round_mantissa`` each RNE-rounded to that many mantissa bits.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    unless ``plain`` asks for the plain version on the card.
    """
    global launches, datapath_launches, _fn
    if s.ndim != 2 or s.shape[-1] != n_hcu * n_mcu:
        raise ValueError(f"hcu_softmax: bad shape {tuple(s.shape)} for layout ({n_hcu},{n_mcu})")
    if round_mantissa is not None and not (1 <= round_mantissa <= 23):
        raise ValueError(f"round_mantissa must be in [1, 23] or None, got {round_mantissa}")
    if _build.use_plain("hcu_softmax", s, plain=plain):
        return ref.hcu_softmax(s, n_hcu, n_mcu, round_mantissa=round_mantissa)
    if _fn is None:
        _fn = _build.function("hcu_softmax", "hcu_softmax_f32", _ARGTYPES)
    out = torch.empty_like(s)
    if s.numel() == 0:
        return out
    _build.launch(
        "hcu_softmax", _fn, s.device, s.data_ptr(), out.data_ptr(),
        s.shape[0], n_hcu, n_mcu, int(round_mantissa or 0),
    )
    launches += 1
    if round_mantissa is not None:
        datapath_launches += 1
    return out
