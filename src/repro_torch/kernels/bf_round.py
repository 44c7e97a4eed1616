"""Hopper kernel for RNE rounding of the f32 mantissa to m bits.

Replaces the TPU kernel ``repro/kernels/bf_round.py:bf_round``
(``pl.pallas_call`` at line 63).  Source: ``csrc/bf_round.cu``; the
rounding (``rne_round``) lives in ``csrc/rne_round.cuh``, shared with the
state tier's epilogues of ``bcpnn_update.cu`` and ``bcpnn_phase.cu`` and
with the reduced datapath's modes of ``masked_matmul.cu``,
``hcu_softmax.cu`` and ``bcpnn_update.cu``, which round each datapath
stage where it is made.  This kernel serves the state tier's rounding of
the initial traces (``precision.policy.quantize_marginals``) and
``PrecisionPolicy.q``.

Bound on an H100: one read and one write of every element, so bytes (at
C_ij's 4,704,000 f32 of the MNIST hidden layer, 37.6 MB: ~0.011 ms at
3.35 TB/s).  Design: one full wave of blocks in a grid-stride loop, each
thread with two 16-byte loads in flight before its stores, streaming
cache hints, scalar tails; no padding to the TPU's (rows, 128) tiles.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches since the last reset (see ops.reset_launches)

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_fn = None


def bf_round(x: torch.Tensor, mantissa_bits: int, plain: bool = False) -> torch.Tensor:
    """``x`` rounded to ``mantissa_bits`` of mantissa, as a fresh f32 tensor
    of the same shape.  ``mantissa_bits == 23`` is an f32 copy without a
    launch; values outside [1, 23] raise.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    unless ``plain`` asks for the plain version on the card.
    """
    global launches, _fn
    if not (1 <= mantissa_bits <= 23):
        raise ValueError(f"mantissa_bits must be in [1,23], got {mantissa_bits}")
    if _build.use_plain("bf_round", x, plain=plain):
        return ref.bf_round(x, mantissa_bits)
    if mantissa_bits == 23:
        return x.clone()
    if _fn is None:
        _fn = _build.function("bf_round", "bf_round_f32", _ARGTYPES)
    out = torch.empty_like(x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _build.launch(
        "bf_round", _fn, x.device, x.data_ptr(), out.data_ptr(), x.numel(),
        int(mantissa_bits), sms,
    )
    launches += 1
    return out
