"""Hopper kernel for the BCPNN marginal + weight update (Alg.1 L11-16).

Replaces the TPU kernel ``repro/kernels/bcpnn_update.py:bcpnn_update_fused``
(``pl.pallas_call`` at line 192), with its optional rounding epilogue (the
quantized state tier: traces RNE-rounded to ``state_mantissa`` bits and
w/bias derived from the rounded traces, ``csrc/rne_round.cuh``).  Source:
``csrc/bcpnn_update.cu``; the update tile it shares with ``bcpnn_phase``
(the register product over the batch and the epilogue) is
``csrc/bcpnn_tile.cuh``.  The traces are read in their storage dtype (f32
or bf16) and written straight in ``state_dtype``, so the bf16 tier costs no
cast pass over C_ij.

Bound on an H100: at the MNIST hidden layer (B=128, F=1568, H=3000) the
update reads C_ij and the mask and writes C_ij' and w, about 78 MB, against
1.2 GFLOP of outer product: it is bound by bytes (~23 µs at 3.35 TB/s).
The readout (F=3000, H=10) is bound by the bytes of a_i (~0.6 µs).

Design: one CTA per (F tile, H tile) loops over the batch (the contraction
axis) through a ring of 16-byte ``cp.async`` stages, keeps a 4x8 (wide) or
2x4 (narrow) register micro-tile of a_iᵀa_j and takes the column sums behind
c_i' and c_j' from the same stages, so the means need no cross-block
reduction and no atomics; the epilogue makes 16-byte loads and stores.  The
wide tile (64x64) is small so that five CTAs share an SM and one CTA's
epilogue streams while others multiply.  The narrow tile (H <= 16) splits
the batch over a thread-block cluster whose partial tiles are summed in
rank order through distributed shared memory, so the readout fills the
card.  Every output element is written once; the launch plan is the pure
function :func:`plan`.

The datapath mode (``datapath_mantissa=``) is the reduced datapath's whole
learning cycle in this one launch (``repro/precision/policy.py:103-142``,
then the state tier's rounding): a_i and a_j rounded where they are staged,
each mean rounded after the (cluster's) batch sum, each EWMA rounded before
the state tier's rounding, w and the bias rounded.  It moves the bytes of
the f32 update.

The reduced-means mode (:func:`bcpnn_update_means`, C entry
``bcpnn_update_means_f32``) is the update of the paper's MPI backend: the
batch means arrive already all-reduced over the ranks
(``repro_torch.core.distributed.dp_learning_cycle``), and one launch runs
the EWMA of the three traces and the weights from their logs, the
product's sum replaced by the mean in the same ``trace`` and ``epilogue4``.
It is elementwise and bound by bytes: at the MNIST hidden layer it reads
m_ij, C_ij and the mask and writes C_ij' and w, 20 bytes an element, about
94 MB (0.028 ms at 3.35 TB/s).  Its tiling is the pure function
:func:`means_plan`.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.masked_matmul import MAX_CLUSTER, _cdiv, n_sm

launches = 0  # kernel launches since the last reset (see ops.reset_launches)
datapath_launches = 0  # ... of them in the datapath mode
means_launches = 0  # ... of them in the reduced-means mode


@dataclass(frozen=True)
class TileConfig:
    index: int  # the C entry point's ``config`` argument
    tf: int     # F rows of a tile
    th: int     # H columns of a tile
    bk: int     # batch rows of a stage


# The tile configurations of ``csrc/bcpnn_update.cu``: 64x64 tiles for
# outputs wider than NARROW_MAX_H, 64x16 tiles for the narrower ones.
CONFIGS: Dict[str, TileConfig] = {
    "wide": TileConfig(0, 64, 64, 16),
    "narrow": TileConfig(1, 64, 16, 16),
}
NARROW_MAX_H = 16  # H up to this takes the narrow tile
# The plan's cost model, in multiply-adds per output element of a tile (as
# masked_matmul.plan's): a CTA's fixed cost (the epilogue, the ring's fill)
# and the extra cost of a split batch (the partial tile and the cluster sum).
CTA_COST_B = 64
SPLIT_COST_B = 32


@dataclass(frozen=True)
class Plan:
    config: str
    cl: int       # CTAs of a cluster, one batch slice each
    bslice: int   # batch rows per slice, a multiple of the tile's BK
    tiles_f: int
    tiles_h: int

    @property
    def ctas(self) -> int:
        return self.tiles_f * self.tiles_h * self.cl


def bslice_for(b: int, cl: int, bk: int) -> int:
    """Batch rows per slice when ``cl`` CTAs split the batch: ceil(B / CL)
    rounded up to a multiple of the stage depth ``bk``."""
    return max(1, _cdiv(_cdiv(b, cl), bk)) * bk


@functools.lru_cache(maxsize=None)
def plan(b: int, f: int, h: int, n_sm: int) -> Plan:
    """The launch plan for an update of batch ``b`` over an (f, h) tile
    grid on ``n_sm`` SMs.

    H up to 16 takes the narrow tile, anything wider the wide one.  For
    each cluster size CL (1..8) the batch slice is rounded up to the
    tile's BK and CL shrunk until every slice is non-empty.  The cost of a
    candidate is the grid in waves of ``n_sm`` CTAs times one CTA's padded
    multiply-adds plus :data:`CTA_COST_B` (and :data:`SPLIT_COST_B` when
    the batch is split) per element of its tile.  Among the candidates
    that put at least ``n_sm`` CTAs on the card, when any does, the
    cheapest wins, ties going to the smaller CL.
    """
    if min(b, f, h) <= 0 or n_sm <= 0:
        raise ValueError(f"bcpnn_update.plan: bad shape ({b}, {f}, {h}) or n_sm {n_sm}")
    name = "narrow" if h <= NARROW_MAX_H else "wide"
    cfg = CONFIGS[name]
    tiles_f, tiles_h = _cdiv(f, cfg.tf), _cdiv(h, cfg.th)
    candidates = []
    for cl in range(1, MAX_CLUSTER + 1):
        bslice = bslice_for(b, cl, cfg.bk)
        if _cdiv(b, bslice) != cl:
            continue  # the same plan as a smaller CL, or an empty slice
        p = Plan(name, cl, bslice, tiles_f, tiles_h)
        per_cta = bslice + CTA_COST_B + (SPLIT_COST_B if cl > 1 else 0)
        cost = _cdiv(p.ctas, n_sm) * cfg.tf * cfg.th * per_cta
        candidates.append((p.ctas < n_sm, cost, cl, p))
    return min(candidates, key=lambda c: c[:3])[-1]


_ARGTYPES = (
    [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_float] * 3
    + [ctypes.c_int] * 7 + [ctypes.c_void_p]
)
_fn = None
_MEANS_ARGTYPES = (
    [ctypes.c_void_p] * 12 + [ctypes.c_int] * 2 + [ctypes.c_float] * 3
    + [ctypes.c_int] * 2 + [ctypes.c_void_p]
)
_means_fn = None
MEANS_MAX_TH = 1024  # columns of a reduced-means tile (csrc/bcpnn_update.cu)
MEANS_MAX_TR = 1024  # rows of a tile
MEANS_RUNS = 1024    # runs of four elements a CTA of 256 threads takes at most


@dataclass(frozen=True)
class MeansPlan:
    th: int       # columns of a tile, a multiple of 4
    tr: int       # rows of a tile
    tiles_f: int
    tiles_h: int

    @property
    def ctas(self) -> int:
        return self.tiles_f * self.tiles_h


@functools.lru_cache(maxsize=None)
def means_plan(f: int, h: int, n_sm: int) -> MeansPlan:
    """The tiling of a reduced-means update of (f, h) on ``n_sm`` SMs:
    the columns in the fewest tiles of at most :data:`MEANS_MAX_TH`,
    balanced and rounded up to a multiple of 4; rows per tile so that a CTA
    takes at most :data:`MEANS_RUNS` runs of four elements, and fewer where
    that leaves under two CTAs an SM."""
    if min(f, h) <= 0 or n_sm <= 0:
        raise ValueError(f"bcpnn_update.means_plan: bad shape ({f}, {h}) or n_sm {n_sm}")
    tiles_h = _cdiv(h, MEANS_MAX_TH)
    th = 4 * _cdiv(_cdiv(h, tiles_h), 4)
    runs = th // 4
    tr = max(1, min(MEANS_RUNS // runs, MEANS_MAX_TR, _cdiv(f * tiles_h, 2 * n_sm)))
    return MeansPlan(th, tr, _cdiv(f, tr), _cdiv(h, th))


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
    datapath_mantissa: Optional[int] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """ai (B, F), aj (B, H), ci (F,), cj (H,), cij and mask (F, H) ->
    (ci', cj', cij', w, bias), all fresh tensors.

    The traces ci/cj/cij share one dtype, f32 or bf16.  With
    ``state_mantissa`` the new traces are rounded to that many mantissa
    bits; they come back in ``state_dtype`` (None: f32), which may be bf16
    only for a mantissa of at most 7.  w and bias are f32.  With
    ``datapath_mantissa`` every stage of the cycle is rounded to that many
    bits first (the datapath mode).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    unless ``plain`` asks for the plain version on the card.
    """
    out_dtype = check_state(ci, cj, cij, state_mantissa, state_dtype)
    if datapath_mantissa is not None and not (1 <= datapath_mantissa <= 23):
        raise ValueError(
            f"datapath_mantissa must be in [1, 23] or None, got {datapath_mantissa}"
        )
    state = _build.STATE
    f32 = _build.F32
    if _build.use_plain(
        "bcpnn_update", ai, aj, ci, cj, cij, mask, dtypes=(f32, f32, state, state, state, f32),
        plain=plain,
    ):
        ci_n, cj_n, cij_n, w, bias = ref.bcpnn_update(
            ai, aj, ci, cj, cij, lam, k_b=k_b, mask=mask, state_mantissa=state_mantissa,
            datapath_mantissa=datapath_mantissa,
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
    return launch_planned(
        ai, aj, ci, cj, cij, lam, k_b, mask, state_mantissa, out_dtype,
        _build.planned("bcpnn_update.plan", plan, bsz, f, h, n_sm(ai.device)),
        datapath_mantissa=datapath_mantissa,
    )


def launch_planned(ai, aj, ci, cj, cij, lam, k_b, mask, state_mantissa, out_dtype,
                   p: Plan, datapath_mantissa: Optional[int] = None):
    """Launch the kernel with the plan ``p``; the wrapper's checks are the
    caller's.  Returns (ci', cj', cij', w, bias)."""
    global launches, datapath_launches, _fn
    if _fn is None:
        _fn = _build.function("bcpnn_update", "bcpnn_update_f32", _ARGTYPES)
    bsz = ai.shape[0]
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
        bias.data_ptr(), bsz, ai.shape[1], aj.shape[1], float(lam), 1.0 - float(lam), float(k_b),
        int(state_mantissa or 0), int(ci.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), int(datapath_mantissa or 0),
        CONFIGS[p.config].index, p.cl, p.bslice,
    )
    launches += 1
    if datapath_mantissa is not None:
        datapath_launches += 1
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


def bcpnn_update_means(
    mi: torch.Tensor,
    mj: torch.Tensor,
    mij: torch.Tensor,
    ci: torch.Tensor,
    cj: torch.Tensor,
    cij: torch.Tensor,
    lam: float,
    k_b: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reduced-means mode: mi (F,), mj (H,), mij (F, H) are batch
    means already all-reduced over the ranks; ci (F,), cj (H,), cij and
    mask (F, H) the old f32 traces and the mask -> (ci', cj', cij', w,
    bias), all fresh f32 tensors.

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    unless ``plain`` asks for the plain version on the card.
    """
    global launches, means_launches, _means_fn
    if _build.use_plain("bcpnn_update.means", mi, mj, mij, ci, cj, cij, mask, plain=plain):
        return ref.bcpnn_update_means(mi, mj, mij, ci, cj, cij, lam, k_b=k_b, mask=mask)
    f, h = mij.shape
    if (
        mi.shape != (f,) or mj.shape != (h,) or ci.shape != (f,) or cj.shape != (h,)
        or cij.shape != (f, h) or (mask is not None and mask.shape != (f, h))
    ):
        raise ValueError(
            f"bcpnn_update_means: shapes do not agree: mi {tuple(mi.shape)}, "
            f"mj {tuple(mj.shape)}, mij {tuple(mij.shape)}, ci {tuple(ci.shape)}, "
            f"cj {tuple(cj.shape)}, cij {tuple(cij.shape)}, "
            f"mask {None if mask is None else tuple(mask.shape)}"
        )
    if _means_fn is None:
        _means_fn = _build.function("bcpnn_update", "bcpnn_update_means_f32", _MEANS_ARGTYPES)
    p = _build.planned("bcpnn_update.means_plan", means_plan, f, h, n_sm(mij.device))
    ci_n, cj_n, bias = torch.empty_like(ci), torch.empty_like(cj), torch.empty_like(cj)
    cij_n, w = torch.empty_like(cij), torch.empty_like(cij)
    _build.launch(
        "bcpnn_update.means", _means_fn, mij.device,
        mi.data_ptr(), mj.data_ptr(), mij.data_ptr(), ci.data_ptr(), cj.data_ptr(),
        cij.data_ptr(), None if mask is None else mask.data_ptr(), ci_n.data_ptr(),
        cj_n.data_ptr(), cij_n.data_ptr(), w.data_ptr(), bias.data_ptr(), f, h,
        float(lam), 1.0 - float(lam), float(k_b), p.th, p.tr,
    )
    launches += 1
    means_launches += 1
    return ci_n, cj_n, cij_n, w, bias
