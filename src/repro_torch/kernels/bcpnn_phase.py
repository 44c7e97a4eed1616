"""Hopper kernel for one whole BCPNN hidden training batch (Alg.1 L8-16).

Replaces the TPU kernel ``repro/kernels/bcpnn_phase.py:bcpnn_phase_fused``
(``pl.pallas_call`` at line 265; its ``hcu_block_h`` tiling at line 53).
Source: ``csrc/bcpnn_phase.cu``.

Forward support, gain, per-hypercolumn softmax and the whole update cycle
(rounding epilogue and bf16 state included) run in one launch, so s and a_j
never make a round trip through device memory between kernels and the host
enqueues one launch per batch instead of three kernels and the gain.

Bound on an H100: at the MNIST hidden layer (B=128, F=1568, H=3000) the
two products are 2.41 GFLOP of f32 FMA (~0.036 ms at 67 TFLOP/s) against
~96 MB of bytes with f32 state (~75 MB with bf16), so operations.

Design: a cluster of up to 8 CTAs per group of whole hypercolumns splits F
(:func:`plan`); the forward is ``masked_matmul``'s staging and 8x8 register
tile on a 128 x 104 tile that fits a 100-unit hypercolumn; the partial
supports are summed through distributed shared memory in rank order and
each CTA applies the softmax to its share of rows; the update stages a_j
back from L2 and runs ``csrc/bcpnn_tile.cuh``'s tile (the code of
``bcpnn_update``) on 64-row tiles, each tile's epilogue spread over the
next tile's product stages.  The profiling variant (:func:`profile`) stamps
each phase; ``tools/bcpnn_phase_profile.py`` prints where the time goes.
The TPU kernel's grid order and fake-hypercolumn padding existed only for
bitwise parity between two Pallas paths; the port is held at a stated
tolerance instead.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.bcpnn_update import check_state
from repro_torch.kernels.masked_matmul import MAX_CLUSTER, _cdiv

launches = 0  # kernel launches since the last reset (see ops.reset_launches)

# The tiles of ``csrc/bcpnn_phase.cu``: the forward's TM batch rows by TN
# columns (the group's), stages of BK rows of F.
TM, TN, BK = 128, 104, 16
# The phases the profiling variant times, in the order of its columns
# (``Phase`` in the source); "sums" is c_i', c_j' and the bias.
PHASES = ("forward", "softmax", "sums", "update_product", "epilogue")


@dataclass(frozen=True)
class Plan:
    g: int       # hypercolumns of a group (one cluster)
    cl: int      # CTAs of a cluster, one F slice each
    fslice: int  # F rows per slice, a multiple of BK
    groups: int

    @property
    def ctas(self) -> int:
        return self.groups * self.cl


def fslice_for(f: int, cl: int) -> int:
    """F rows per slice when ``cl`` CTAs split F: ceil(F / CL) rounded up
    to a multiple of BK."""
    return max(1, _cdiv(_cdiv(f, cl), BK)) * BK


@functools.lru_cache(maxsize=None)
def plan(b: int, f: int, n_hcu: int, n_mcu: int) -> Plan:
    """The launch plan of one hidden batch: G whole hypercolumns per group,
    as many as fit in one tile's TN columns (at least one), and the
    largest cluster of CL <= 8 CTAs that splits F into non-empty slices of
    at least half a tile's rows (CL = 1 when none does)."""
    if min(b, f, n_hcu, n_mcu) <= 0:
        raise ValueError(f"bcpnn_phase.plan: bad shape ({b}, {f}, {n_hcu}x{n_mcu})")
    g = max(1, min(n_hcu, TN // n_mcu))
    cl = MAX_CLUSTER
    while cl > 1 and not (
        _cdiv(f, fslice_for(f, cl)) == cl and fslice_for(f, cl) >= TM // 2
    ):
        cl -= 1
    return Plan(g, cl, fslice_for(f, cl), _cdiv(n_hcu, g))


_ARGTYPES = (
    [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
    + [ctypes.c_int] * 6 + [ctypes.c_void_p]
)
_fn = None
_profile_fn = None


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
    global launches
    out_dtype = check_state(ci, cj, cij, state_mantissa, state_dtype)
    state = _build.STATE
    f32 = _build.F32
    if _build.use_plain(
        "bcpnn_phase", x, w, b, ci, cj, cij, mask,
        dtypes=(f32, f32, f32, state, state, state, f32),
    ):
        aj, ci_n, cj_n, cij_n, w_n, bias = ref.bcpnn_phase(
            x, w, b, ci, cj, cij, lam, n_hcu, n_mcu, k_b=k_b, gain=gain, mask=mask,
            state_mantissa=state_mantissa,
        )
        return aj, ci_n.to(out_dtype), cj_n.to(out_dtype), cij_n.to(out_dtype), w_n, bias
    outs = _launch(x, w, b, ci, cj, cij, lam, n_hcu, n_mcu, k_b, gain, mask,
                   state_mantissa, out_dtype, None)
    launches += 1
    return outs


def profile(
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
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Run the kernel's profiling variant (CUDA tensors only): the outputs
    of :func:`bcpnn_phase` and an int64 tensor with one row per CTA: its
    ``%globaltimer`` start and end stamps (ns) and the ns it spent in each
    of :data:`PHASES`.  The variant puts a barrier at every phase boundary;
    it is a tool's, never the main path's, and is not counted in
    :data:`launches`."""
    out_dtype = check_state(ci, cj, cij, state_mantissa, state_dtype)
    if _build.use_plain(
        "bcpnn_phase", x, w, b, ci, cj, cij, mask,
        dtypes=(_build.F32,) * 3 + (_build.STATE,) * 3 + (_build.F32,),
    ):
        raise ValueError("bcpnn_phase.profile: the profiling variant runs on a card only")
    p = plan(x.shape[0], x.shape[1], n_hcu, n_mcu)
    prof = torch.zeros((p.ctas, 2 + len(PHASES)), dtype=torch.int64, device=x.device)
    outs = _launch(x, w, b, ci, cj, cij, lam, n_hcu, n_mcu, k_b, gain, mask,
                   state_mantissa, out_dtype, prof)
    return outs, prof


def _launch(x, w, b, ci, cj, cij, lam, n_hcu, n_mcu, k_b, gain, mask, state_mantissa,
            out_dtype, prof):
    global _fn, _profile_fn
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
    if prof is None:
        if _fn is None:
            _fn = _build.function("bcpnn_phase", "bcpnn_phase_f32", _ARGTYPES)
        fn, extra = _fn, ()
    else:
        if _profile_fn is None:
            argtypes = _ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_void_p]
            _profile_fn = _build.function("bcpnn_phase", "bcpnn_phase_f32_profile", argtypes)
        fn, extra = _profile_fn, (prof.data_ptr(),)
    p = _build.planned("bcpnn_phase.plan", plan, bsz, f, n_hcu, n_mcu)
    dev = x.device
    aj = torch.empty((bsz, h), dtype=torch.float32, device=dev)
    ci_n = torch.empty(ci.shape, dtype=out_dtype, device=dev)
    cj_n = torch.empty(cj.shape, dtype=out_dtype, device=dev)
    cij_n = torch.empty(cij.shape, dtype=out_dtype, device=dev)
    w_n = torch.empty((f, h), dtype=torch.float32, device=dev)
    bias = torch.empty((h,), dtype=torch.float32, device=dev)
    _build.launch(
        "bcpnn_phase", fn, dev,
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        None if mask is None else mask.data_ptr(),
        ci.data_ptr(), cj.data_ptr(), cij.data_ptr(), aj.data_ptr(),
        ci_n.data_ptr(), cj_n.data_ptr(), cij_n.data_ptr(), w_n.data_ptr(), bias.data_ptr(),
        bsz, f, n_hcu, n_mcu, float(lam), 1.0 - float(lam), float(k_b), float(gain),
        int(state_mantissa or 0), int(ci.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), p.g, p.cl, p.fslice, *extra,
    )
    return aj, ci_n, cj_n, cij_n, w_n, bias
