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

The gathered variant (``hcu_mask=``) takes the receptive-field mask per
hypercolumn pair, (n_pre_hcu, n_post_hcu), in place of the unit mask: each
hidden HCU's output columns are summed over the kept input units alone,
read through that HCU's kept list (built on the device once per mask
object by a small kernel, :func:`kept_lists`).  At the STL-10 width the
mask keeps 3.7% of K, and the dense tiles multiply the rest by zero.
:func:`plan` chooses the gathered or the dense kernel from the shapes
(rows, K, N, the kept units of a hidden HCU, its minicolumns), and
:func:`gathers` says which one a product takes; on the dense choice, and on
the CPU, the caller expands the mask to units and passes ``mask=``.

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
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

launches = 0  # kernel launches since the last reset (see ops.reset_launches)
datapath_launches = 0  # ... of them in the rounding mode
gathered_launches = 0  # ... of them of the gathered variant


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
# The gathered variant's tile (``Gathered`` in the source, which has a C
# entry point of its own, so no config index): 64 rows x 160 columns of one
# hidden HCU, a stage of 16 kept input units.  Its columns start at the
# HCU's first column rounded down to a multiple of 4.
GATHERED = TileConfig(-1, 64, 160, 16)
GATHER_ALIGN = 3  # columns a gathered tile may start before its HCU
# The plan's cost model, in multiply-adds per output element of a tile: a
# CTA's fixed cost (filling the ring, the epilogue) and the extra cost of a
# split tile (the partial tile through shared memory and the cluster sum).
CTA_COST_K = 64
SPLIT_COST_K = 32
# The gathered tile's cost model, from the rows tools/masked_matmul_plans.py
# measured on an H100 (PERF.md §6): an SM runs GATHER_RESIDENT of its
# CTAs side by side, and fewer leave its pipes idle, so an SM's time is that
# of at least GATHER_RESIDENT CTAs; and its time per modelled multiply-add
# is GATHER_RATE times the dense tiles' (1.03-1.4 in those rows: the x
# gather reads a 32-byte sector for 8 bytes it uses).
GATHER_RESIDENT = 3
GATHER_RATE = 1.3


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


def _candidates(name: str, cfg: TileConfig, m_tiles: int, n_tiles: int, k: int, n_sm: int,
                resident: int = 1, rate: float = 1.0):
    """(fills less than the card, cost, CL, plan) for each cluster size that
    gives a plan of its own: the K slice rounded up to the tile's BK and CL
    shrunk until every slice is non-empty.  The cost is the number of CTAs
    each SM runs (the grid in waves of ``n_sm``), at least ``resident``,
    times the cost of one CTA: its padded multiply-adds plus
    :data:`CTA_COST_K` (and :data:`SPLIT_COST_K` when K is split) per
    element of its tile, times ``rate``."""
    out = []
    for cl in range(1, MAX_CLUSTER + 1):
        kslice = kslice_for(k, cl, cfg.bk)
        if max(1, _cdiv(k, kslice)) != cl:
            continue  # the same plan as a smaller CL, or an empty slice
        p = Plan(name, cl, kslice, m_tiles, n_tiles)
        per_cta = kslice + CTA_COST_K + (SPLIT_COST_K if cl > 1 else 0)
        cost = max(_cdiv(p.ctas, n_sm), resident) * cfg.bm * cfg.bn * per_cta * rate
        out.append((p.ctas < n_sm, cost, cl, p))
    return out


def gathered_tiles_n(n_hcu: int, n_mcu: int) -> int:
    """Column tiles of the gathered grid: each hidden HCU's columns, from
    its first one rounded down to a multiple of 4, in tiles of BN."""
    return n_hcu * _cdiv(n_mcu + GATHER_ALIGN, GATHERED.bn)


@functools.lru_cache(maxsize=None)
def plan(m: int, k: int, n: int, n_sm: int, kept: Optional[int] = None,
         n_mcu: Optional[int] = None) -> Plan:
    """The launch plan for an (m, k) @ (k, n) product on ``n_sm`` SMs.

    N up to 16 takes the narrow tile, anything wider the wide one.  Given
    the kept input units of each hidden HCU (``kept``) and its minicolumns
    (``n_mcu``), the product goes through a mask per hypercolumn pair, and
    the gathered tile is a candidate too, over ``kept`` instead of K; its
    cost carries :data:`GATHER_RESIDENT` and :data:`GATHER_RATE`.  Each
    tile's candidates are those of :func:`_candidates`; among the
    candidates that put at least ``n_sm`` CTAs on the card, when any does,
    the cheapest wins, ties going to the smaller CL and then to the dense
    tile.
    """
    if min(m, n) <= 0 or k < 0 or n_sm <= 0:
        raise ValueError(f"masked_matmul.plan: bad shape ({m}, {k}, {n}) or n_sm {n_sm}")
    name = "narrow" if n <= NARROW_MAX_N else "wide"
    cfg = CONFIGS[name]
    candidates = _candidates(name, cfg, _cdiv(m, cfg.bm), _cdiv(n, cfg.bn), k, n_sm)
    if kept is not None:
        if n_mcu is None or n_mcu <= 0 or n % n_mcu or not 0 <= kept <= k:
            raise ValueError(f"masked_matmul.plan: kept {kept} of K {k}, or N {n} not in "
                             f"HCUs of {n_mcu}")
        candidates += _candidates("gathered", GATHERED, _cdiv(m, GATHERED.bm),
                                  gathered_tiles_n(n // n_mcu, n_mcu), kept, n_sm,
                                  GATHER_RESIDENT, GATHER_RATE)
    return min(candidates, key=lambda c: (*c[:3], c[3].config == "gathered"))[-1]


_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float] + [ctypes.c_void_p]
)
_GATHERED_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_LISTS_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
_fn = None
_gathered_fn = None
_lists_fn = None
_n_sm: Dict[int, int] = {}
# Kept lists by the identity of their HCU mask: id -> (weak reference, the
# mask's version when built, kept, counts).  An entry leaves with its mask.
_kept: Dict[int, tuple] = {}


def n_sm(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _n_sm:
        _n_sm[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _n_sm[index]


def _forget(key: int, mask_ref: weakref.ref) -> None:
    entry = _kept.get(key)
    if entry is not None and entry[0] is mask_ref:
        _kept.pop(key, None)


def kept_lists(hcu_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gathered variant's kept lists of a CUDA ``hcu_mask`` (n_pre_hcu,
    n_post_hcu): ``kept`` (n_post_hcu, n_pre_hcu) int32, whose row h starts
    with the input HCUs that hidden HCU h keeps, ascending, and ``counts``
    (n_post_hcu,) int32 (:func:`ref.kept_lists` is the plain version).

    One launch of the list-building kernel on the mask's first use, with no host
    synchronisation; the lists are then kept as long as that mask object
    lives, and built again only if it was changed in place.  States are
    never changed in place, so each rewiring's new mask builds one list.
    """
    global _lists_fn
    key = id(hcu_mask)
    entry = _kept.get(key)
    if entry is not None and entry[0]() is hcu_mask and entry[1] == hcu_mask._version:
        return entry[2], entry[3]
    if _lists_fn is None:
        _lists_fn = _build.function("masked_matmul", "masked_matmul_kept_lists", _LISTS_ARGTYPES)
    n_pre, n_post = hcu_mask.shape
    kept = torch.empty((n_post, n_pre), dtype=torch.int32, device=hcu_mask.device)
    counts = torch.empty((n_post,), dtype=torch.int32, device=hcu_mask.device)
    _build.launch("masked_matmul kept lists", _lists_fn, hcu_mask.device, hcu_mask.data_ptr(),
                  n_pre, n_post, kept.data_ptr(), counts.data_ptr())
    _kept[key] = (weakref.ref(hcu_mask, functools.partial(_forget, key)), hcu_mask._version,
                  kept, counts)
    return kept, counts


def _gathered_key(x, w, hcu_mask, pre_mcu: int, post_mcu: int,
                  fan_in: Optional[int]) -> Tuple[int, ...]:
    """The :func:`plan` arguments of an ``hcu_mask=`` product on the card;
    ``fan_in`` (the kept input HCUs of a hidden HCU, all of them if None)
    only guides the plan: the kernel reads the true counts."""
    m, k = x.shape
    n = w.shape[1]
    n_pre, n_post = hcu_mask.shape
    if w.shape[0] != k or k != n_pre * pre_mcu or n != n_post * post_mcu:
        raise ValueError(
            f"masked_matmul: x {tuple(x.shape)}, w {tuple(w.shape)}, hcu_mask "
            f"{tuple(hcu_mask.shape)} with {pre_mcu} / {post_mcu} minicolumns do not chain"
        )
    kept = (n_pre if fan_in is None else min(fan_in, n_pre)) * pre_mcu
    return m, k, n, n_sm(x.device), kept, post_mcu


def gathers(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], hcu_mask: torch.Tensor,
    pre_mcu: int, post_mcu: int, fan_in: Optional[int] = None, plain: bool = False,
) -> bool:
    """Whether :func:`masked_matmul` with ``hcu_mask=`` launches the
    gathered kernel for these inputs: CUDA tensors, the kernel not declined
    (``plain``), rows to compute, and the plan's choice for the shapes."""
    if _build.use_plain("masked_matmul", x, w, b, hcu_mask, plain=plain) or x.shape[0] == 0:
        return False
    return plan(*_gathered_key(x, w, hcu_mask, pre_mcu, post_mcu, fan_in)).config == "gathered"


def masked_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    round_mantissa: Optional[int] = None,
    gain: float = 1.0,
    plain: bool = False,
    hcu_mask: Optional[torch.Tensor] = None,
    pre_mcu: Optional[int] = None,
    post_mcu: Optional[int] = None,
    fan_in: Optional[int] = None,
) -> torch.Tensor:
    """x (M, K) @ (w (K, N) ∘ mask (K, N)) + b (N,) -> (M, N) f32; with
    ``round_mantissa`` the datapath's support, every stage rounded and the
    result times ``gain`` rounded again.

    ``hcu_mask`` (n_pre_hcu, n_post_hcu) of 0/1, with the minicolumns of the
    two layouts (``pre_mcu``, ``post_mcu``), stands for the unit mask it
    expands to (it excludes ``mask`` and the rounding mode) and launches the
    gathered kernel; it raises where :func:`gathers` says no (the CPU,
    ``plain``, no rows, a dense plan), where the caller passes the expanded
    mask instead.  ``fan_in`` guides the plan (:func:`_gathered_key`).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    unless ``plain`` asks for the plain version on the card.
    """
    if round_mantissa is None and gain != 1.0:  # the f32 product leaves the gain to its caller
        raise ValueError(f"gain={gain} needs the rounding mode (round_mantissa=)")
    if hcu_mask is not None:
        if mask is not None or round_mantissa is not None:
            raise ValueError("masked_matmul: hcu_mask= excludes mask= and round_mantissa=")
        if pre_mcu is None or post_mcu is None:
            raise ValueError("masked_matmul: hcu_mask= needs pre_mcu= and post_mcu=")
        if _build.use_plain("masked_matmul", x, w, b, hcu_mask, plain=plain) or x.shape[0] == 0:
            raise ValueError("masked_matmul: hcu_mask= launches the gathered kernel, on CUDA "
                             "tensors with rows; pass the expanded mask= instead")
        key = _gathered_key(x, w, hcu_mask, pre_mcu, post_mcu, fan_in)
        p = _build.planned("masked_matmul.plan", plan, *key)
        if p.config != "gathered":
            raise ValueError(f"masked_matmul: the plan for {key[:3]} is the {p.config} kernel; "
                             "pass the expanded mask= instead")
        if b is not None and b.shape != (w.shape[1],):
            raise ValueError(f"masked_matmul: bias {tuple(b.shape)} != ({w.shape[1]},)")
        out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
        return launch_gathered(x, w, b, hcu_mask, pre_mcu, post_mcu, out, p)
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


def launch_gathered(x, w, b, hcu_mask, pre_mcu: int, post_mcu: int, out, p: Plan) -> torch.Tensor:
    """Launch the gathered kernel with the plan ``p`` (its CL) into ``out``,
    through the kept lists of ``hcu_mask`` (:func:`kept_lists`); the
    wrapper's checks are the caller's."""
    global launches, gathered_launches, _gathered_fn
    if _gathered_fn is None:
        _gathered_fn = _build.function("masked_matmul", "masked_matmul_gathered_f32",
                                       _GATHERED_ARGTYPES)
    kept, counts = kept_lists(hcu_mask)
    n_pre, n_post = hcu_mask.shape
    _build.launch(
        "masked_matmul", _gathered_fn, x.device,
        x.data_ptr(), w.data_ptr(), kept.data_ptr(), counts.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(),
        x.shape[0], n_pre, pre_mcu, n_post, post_mcu, p.cl,
    )
    launches += 1
    gathered_launches += 1
    return out
