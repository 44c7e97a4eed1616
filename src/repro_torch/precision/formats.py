"""Variable-precision bfloat formats (the paper's FPGA FloPoCo study).

A BF<n> format keeps the f32 sign and 8-bit exponent and n-9 bits of
mantissa: BF16 (7 bits) is bfloat16, BF14/BF15 are below it, BF20/24/28
above.  A format serves two tiers (``repro_torch.precision.policy``): the
reduced *datapath*, every algebraic stage of Alg. 1 rounded (RNE) to it,
and the *state tier*, MarginalState traces rounded to it between batches.
:func:`round_to` runs in the ``bf_round`` kernel on the card and in its
plain version on the CPU; the datapath's stages round inside the kernels
that make them (``precision/policy.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BFFormat:
    name: str
    total_bits: int

    @property
    def mantissa_bits(self) -> int:
        # sign(1) + exponent(8) + mantissa
        return self.total_bits - 9

    @property
    def is_identity(self) -> bool:
        return self.mantissa_bits >= 23


FORMATS: Dict[str, BFFormat] = {
    f.name: f
    for f in [
        BFFormat("bf14", 14),
        BFFormat("bf15", 15),
        BFFormat("bf16", 16),
        BFFormat("bf20", 20),
        BFFormat("bf24", 24),
        BFFormat("bf28", 28),
        BFFormat("fp32", 32),
    ]
}


def get_format(name: str) -> BFFormat:
    try:
        return FORMATS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown format {name!r}; have {sorted(FORMATS)}") from None


def state_spec(fmt: Optional[BFFormat]) -> Tuple[Optional[int], Optional[torch.dtype]]:
    """(mantissa_bits, storage_dtype) for keeping persistent state in ``fmt``.

    Traces are rounded to ``mantissa_bits`` in the kernels' epilogues and
    stored as ``torch.bfloat16`` when the rounded values are exact there
    (mantissa <= 7: bf14/bf15/bf16, half the bytes of f32); otherwise the
    dtype is ``None``, meaning f32 storage with the low mantissa bits zeroed.
    Identity formats (and ``None``) return ``(None, None)``.
    """
    if fmt is None or fmt.is_identity:
        return None, None
    mant = fmt.mantissa_bits
    return mant, (torch.bfloat16 if mant <= 7 else None)


def round_to(x: torch.Tensor, fmt: BFFormat, use_kernels: Optional[bool] = None) -> torch.Tensor:
    """``x`` rounded (RNE) to the format's mantissa width, as f32.  CPU
    tensors take the plain version, CUDA tensors the ``bf_round`` kernel
    (its plain version with ``use_kernels=False``, see ``kernels.ops``).

    ``x`` is cast to a contiguous f32 tensor first, as the reference's
    ``astype`` does: datapath operands include bf16 traces and views."""
    if fmt.is_identity:
        return x.to(torch.float32)
    from repro_torch.kernels import ops

    return ops.bf_round(x.to(torch.float32).contiguous(), fmt.mantissa_bits, use_kernels)
