"""Hopper kernel for the forward support s = x @ (w ∘ mask) + b.

Replaces the TPU kernel ``repro/kernels/masked_matmul.py:masked_matmul``
(``pl.pallas_call`` at line 80).  Source: ``csrc/masked_matmul.cu``.

Bound on an H100: at the MNIST hidden layer (M=128, K=1568, N=3000) the
product is 1.2 GFLOP of f32 FMA against about 38 MB, so it is bound by
operations (f32 runs outside the tensor cores, whose TF32 would be ~1e-3
off the f32 reference); the readout (N=10) is bound by the bytes of x.
Design: register-tiled SIMT FMA fed by a ring of 16-byte ``cp.async``
stages, the mask multiplied into each staged w tile, and K split over a
thread-block cluster whose partial tiles are summed in rank order through
distributed shared memory (see the note at the head of the source).  The
launch plan (tile configuration, cluster size, K slice) is the pure
function :func:`plan`.

The rounding mode (``round_mantissa=``) is the reduced datapath's support
stage, ``q(q(q(x) @ q(w ∘ mask) + q(b)) * gain)`` with ``q`` the RNE
rounding to that many mantissa bits (``repro/precision/policy.py:94-97``):
each staged operand element is rounded where it lands in shared memory,
and the bias, the sum and the gain in the store, after a split-K
cluster's sum, so the mode moves the f32 product's bytes.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches since the last reset (see ops.reset_launches)
datapath_launches = 0  # ... of them in the rounding mode


@dataclass(frozen=True)
class TileConfig:
    index: int  # the C entry point's ``config`` argument
    bm: int
    bn: int
    bk: int


# The tile configurations of ``csrc/masked_matmul.cu``: 128x64 tiles for
# outputs wider than NARROW_MAX_N, 64x16 tiles for the narrower ones.
CONFIGS: Dict[str, TileConfig] = {
    "wide": TileConfig(0, 128, 64, 16),
    "narrow": TileConfig(1, 64, 16, 32),
}
NARROW_MAX_N = 16  # N up to this takes the narrow tile
MAX_CLUSTER = 8    # the portable thread-block cluster size
# The plan's cost model, in multiply-adds per output element of a tile: a
# CTA's fixed cost (filling the ring, the epilogue) and the extra cost of a
# split tile (the partial tile through shared memory and the cluster sum).
CTA_COST_K = 64
SPLIT_COST_K = 32


@dataclass(frozen=True)
class Plan:
    config: str
    cl: int      # CTAs of a cluster, one K slice each
    kslice: int  # K elements per slice, a multiple of the tile's BK
    tiles_m: int
    tiles_n: int

    @property
    def ctas(self) -> int:
        return self.tiles_m * self.tiles_n * self.cl


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def kslice_for(k: int, cl: int, bk: int) -> int:
    """K elements per slice when ``cl`` CTAs split K: ceil(K / CL) rounded
    up to a multiple of the tile's depth ``bk`` (at least one stage)."""
    return max(1, _cdiv(_cdiv(k, cl), bk)) * bk


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, n_sm: int) -> Plan:
    """The launch plan for an (m, k) @ (k, n) product on ``n_sm`` SMs.

    N up to 16 takes the narrow tile, anything wider the wide one.  For
    each cluster size CL (1..8) the K slice is rounded up to the tile's BK
    and CL shrunk until every slice is non-empty.  The
    cost of a candidate is the number of CTAs each SM runs (the grid in
    waves of ``n_sm``) times the cost of one CTA: its padded multiply-adds
    plus :data:`CTA_COST_K` (and :data:`SPLIT_COST_K` when K is split)
    per element of its tile.  Among the candidates that put at least
    ``n_sm`` CTAs on the card, when any does, the cheapest wins, ties going
    to the smaller CL.
    """
    if min(m, n) <= 0 or k < 0 or n_sm <= 0:
        raise ValueError(f"masked_matmul.plan: bad shape ({m}, {k}, {n}) or n_sm {n_sm}")
    name = "narrow" if n <= NARROW_MAX_N else "wide"
    cfg = CONFIGS[name]
    tiles_m, tiles_n = _cdiv(m, cfg.bm), _cdiv(n, cfg.bn)
    candidates = []
    for cl in range(1, MAX_CLUSTER + 1):
        kslice = kslice_for(k, cl, cfg.bk)
        if max(1, _cdiv(k, kslice)) != cl:
            continue  # the same plan as a smaller CL, or an empty slice
        p = Plan(name, cl, kslice, tiles_m, tiles_n)
        per_cta = kslice + CTA_COST_K + (SPLIT_COST_K if cl > 1 else 0)
        cost = _cdiv(p.ctas, n_sm) * cfg.bm * cfg.bn * per_cta
        candidates.append((p.ctas < n_sm, cost, cl, p))
    return min(candidates, key=lambda c: c[:3])[-1]


_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_void_p]
)
_fn = None
_n_sm: Dict[int, int] = {}


def n_sm(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _n_sm:
        _n_sm[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _n_sm[index]


def masked_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    round_mantissa: Optional[int] = None,
    gain: float = 1.0,
    plain: bool = False,
) -> torch.Tensor:
    """x (M, K) @ (w (K, N) ∘ mask (K, N)) + b (N,) -> (M, N) f32; with
    ``round_mantissa`` the datapath's support, every stage rounded and the
    result times ``gain`` rounded again.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    unless ``plain`` asks for the plain version on the card.
    """
    if round_mantissa is None and gain != 1.0:  # the f32 product leaves the gain to its caller
        raise ValueError(f"gain={gain} needs the rounding mode (round_mantissa=)")
    if round_mantissa is not None and not (1 <= round_mantissa <= 23):
        raise ValueError(f"round_mantissa must be in [1, 23] or None, got {round_mantissa}")
    if _build.use_plain("masked_matmul", x, w, b, mask, plain=plain):
        return ref.masked_matmul(x, w, b, mask, round_mantissa=round_mantissa, gain=gain)
    m, k = x.shape
    if w.shape[0] != k or (mask is not None and mask.shape != w.shape):
        raise ValueError(
            f"masked_matmul: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"mask {None if mask is None else tuple(mask.shape)} do not chain"
        )
    n = w.shape[1]
    if b is not None and b.shape != (n,):
        raise ValueError(f"masked_matmul: bias {tuple(b.shape)} != ({n},)")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    p = _build.planned("masked_matmul.plan", plan, m, k, n, n_sm(x.device))
    return launch_planned(x, w, b, mask, out, p,
                          round_mantissa=round_mantissa, gain=gain)


def launch_planned(x, w, b, mask, out, p: Plan, round_mantissa: Optional[int] = None,
                   gain: float = 1.0) -> torch.Tensor:
    """Launch the kernel with the plan ``p`` into ``out``; the wrapper's
    checks are the caller's."""
    global launches, datapath_launches, _fn
    if _fn is None:
        _fn = _build.function("masked_matmul", "masked_matmul_f32", _ARGTYPES)
    m, k = x.shape
    _build.launch(
        "masked_matmul", _fn, x.device,
        x.data_ptr(), w.data_ptr(),
        None if mask is None else mask.data_ptr(),
        None if b is None else b.data_ptr(),
        out.data_ptr(), m, k, w.shape[1], CONFIGS[p.config].index, p.cl, p.kslice,
        int(round_mantissa or 0), float(gain),
    )
    launches += 1
    if round_mantissa is not None:
        datapath_launches += 1
    return out
