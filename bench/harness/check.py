"""The comparison that decides ``correct``: what the program produced against
the plain reference (``bench/reference/bcpnn.py``), number by number.

Listing 1's hidden layer is a competitive (soft winner-take-all) learner:
two f32 runs that differ only in the order of their sums part within a few
dozen batches, so no reference can follow a whole fit from the seed.  The
reference therefore starts each stage from the program's own state before
it, as copied while the program trained, and works the stage out again:

* ``init_gap``: the initial state, drawn from the seed on both sides
  (exact: the largest absolute difference over every tensor);
* ``hidden_err``: chosen hidden training batches, a rewiring batch among
  them, from the program's state before each (the rewiring, the forward and
  the learning cycle): per tensor, the norm of (program - reference) over
  the tensor's scale, its largest change in the reference over the batches
  compared (or the median tensor's scale, where larger), worst tensor and
  batch; a tensor the batches leave unmoved (its scale under a thousandth of
  the median's) is left out;
* ``mask_cols``: hidden hypercolumns whose rewiring there disagrees with the
  reference's, other than by a near-tie of the mutual information;
* ``readout_err``: the readout phase (the projection of the training split
  through the trained hidden layer and the supervised epoch), from the
  program's hidden layer and readout before it, measured as ``hidden_err``;
* ``answer_gap``: every answer the program gave (a test row's class, from
  ``evaluate``'s scores, or a served row's class), by how far the
  reference's score of that class lies below the reference's best.
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable

import torch

from bench.reference import bcpnn as ref

UNMOVED = 1e-3  # a tensor whose change is under this share of the median's
TIE_RTOL = 1e-5  # mutual informations this close are a near-tie


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t, dtype=torch.float64))


def init_gap(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    return max(float((prog[k].to(want[k].device) - want[k]).abs().max()) for k in want)


def gaps(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
         before: Dict[str, torch.Tensor], keys: Iterable[str]):
    """Per tensor, the norm of (program - reference) after a step and the
    norm of the reference's change over the step."""
    keys = list(keys)
    dev = want[keys[0]].device
    diff = {k: _norm(prog[k].to(dev) - want[k]) for k in keys}
    change = {k: _norm(want[k] - before[k].to(dev)) for k in keys}
    return diff, change


def worst_ratio(steps) -> float:
    """The largest gap of ``steps`` (a list of :func:`gaps` pairs), each over
    its tensor's scale: the tensor's largest change over the steps compared,
    or the median tensor's scale where that is larger.  A tensor whose scale
    is under a thousandth of the median's (one the steps leave unmoved, up
    to rounding) is left out."""
    if not steps:
        return 0.0
    keys = list(steps[0][1])
    scale = {k: max(change[k] for _, change in steps) for k in keys}
    median = statistics.median(scale.values())
    return max((diff[k] / max(scale[k], median) for diff, _ in steps for k in keys
                if scale[k] >= UNMOVED * median), default=0.0)


def change_err(prog, want, before, keys) -> float:
    """:func:`worst_ratio` of one step."""
    return worst_ratio([gaps(prog, want, before, keys)])


def mask_cols(before: torch.Tensor, prog: torch.Tensor, want: torch.Tensor,
              mi: torch.Tensor) -> int:
    """Hidden HCUs whose rewiring differs from the reference's beyond a
    near-tie (of the swap test, the weakest active or the strongest silent
    input HCU), by the reference's mutual information ``mi``."""
    bad = 0
    dev = want.device
    before, prog = before.to(dev), prog.to(dev)
    for c in torch.nonzero((prog != want).any(0)).flatten().tolist():
        col, act = mi[:, c], before[:, c] > 0.5
        worst, best = float(col[act].min()), float(col[~act].max())
        tol = TIE_RTOL * max(abs(worst), abs(best))
        removed = torch.nonzero(act & (prog[:, c] < 0.5)).flatten()
        added = torch.nonzero(~act & (prog[:, c] > 0.5)).flatten()
        if removed.numel() != added.numel() or removed.numel() > 1:
            bad += 1  # not one swap: the fan-in moved
            continue
        swapped_ref = bool((want[:, c] != before[:, c]).any())
        ok = swapped_ref == bool(removed.numel()) or abs(best - worst) <= tol
        if removed.numel():
            ok = ok and abs(float(col[removed[0]]) - worst) <= tol
            ok = ok and abs(float(col[added[0]]) - best) <= tol
        bad += not ok
    return bad


def answer_gaps(want_scores: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    """Per answer (a row of ``classes``, (answers, rows) or (rows,)), the
    largest gap over its rows between the reference's best score and its
    score of the class given."""
    classes = classes.to(want_scores.device).long().reshape(-1, want_scores.shape[0])
    best = want_scores.max(dim=1).values
    got = torch.gather(want_scores.expand(classes.shape[0], -1, -1), 2,
                       classes[..., None])[..., 0]
    return (best[None, :] - got).max(dim=1).values


def answer_gap(want_scores: torch.Tensor, classes: torch.Tensor) -> float:
    return float(answer_gaps(want_scores, classes).max())


def hidden_step_numbers(net: Dict, before: Dict, after: Dict, step: int,
                        xb: torch.Tensor):
    """The :func:`gaps` and ``mask_cols`` of the ``step``-th hidden batch."""
    dev = xb.device
    b = {k: v.to(dev) for k, v in before.items()}
    with ref.matmul_precision(False):
        want = ref.hidden_step(net, b, step, xb)
        mi = ref.mutual_information(b, net["hidden_mcu"])
    return (gaps(after, want, b, ("ci", "cj", "cij", "w", "b")),
            mask_cols(b["hcu_mask"], after["hcu_mask"], want["hcu_mask"], mi))


def readout_numbers(net: Dict, hidden: Dict, before: Dict, after: Dict, x, y, order,
                    batch: int, chunk: int):
    """The :func:`gaps` of one readout phase."""
    dev = x.device
    h = {k: v.to(dev) for k, v in hidden.items()}
    b = {k: v.to(dev) for k, v in before.items()}
    with ref.matmul_precision(False):
        codes = ref.hidden_codes(net, h, x, chunk)
        want = ref.readout_epoch(net, b, codes, y, order, batch)
    return gaps(after, want, b, ("ci", "cj", "cij", "w", "b"))


def reference_scores(net: Dict, hidden: Dict, readout: Dict, x, chunk: int,
                     tf32: bool = False) -> torch.Tensor:
    dev = x.device
    h = {k: v.to(dev) for k, v in hidden.items()}
    r = {k: v.to(dev) for k, v in readout.items()}
    with ref.matmul_precision(tf32):
        return ref.scores(net, r, ref.hidden_codes(net, h, x, chunk))
