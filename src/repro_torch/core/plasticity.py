"""Structural plasticity: mutual-information-driven rewiring.

Connections are at (input-HCU, hidden-HCU) granularity.  Every N batches
each hidden HCU scores every input HCU by the mutual information of their
units, then swaps its weakest active input for its strongest silent one if
the silent one scores strictly higher (fixed fan-in).  The mask is stored
per HCU pair and expanded to units for the weights (Alg.1 L16).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.learning import EPS, MarginalState
from repro_torch.core.units import UnitLayout
from repro_torch.kernels import ref


class PlasticityState(NamedTuple):
    """hcu_mask: (n_pre_hcu, n_post_hcu) float {0,1} — receptive fields."""

    hcu_mask: torch.Tensor

    def unit_mask(self, pre: UnitLayout, post: UnitLayout) -> torch.Tensor:
        """Expand the HCU-granular mask to unit granularity for w."""
        return ref.unit_mask(self.hcu_mask, pre.n_mcu, post.n_mcu)


def init_random_mask(
    generator: torch.Generator, pre: UnitLayout, post: UnitLayout, fan_in: int
) -> PlasticityState:
    """Random receptive fields: each hidden HCU gets `fan_in` distinct
    active input HCUs, drawn from ``generator`` (on its device)."""
    if not (0 < fan_in <= pre.n_hcu):
        raise ValueError(f"fan_in={fan_in} out of range (1..{pre.n_hcu})")
    cols = torch.stack([
        torch.randperm(pre.n_hcu, generator=generator, device=generator.device)
        < fan_in
        for _ in range(post.n_hcu)
    ])  # (n_post_hcu, n_pre_hcu)
    return PlasticityState(hcu_mask=cols.T.to(torch.float32).contiguous())


def mi_scores(
    state: MarginalState, pre: UnitLayout, post: UnitLayout
) -> torch.Tensor:
    """MI(I,H) = sum_{i in I, j in H} cij log(cij / (ci cj)) for every
    (input HCU, hidden HCU) pair; shape (n_pre_hcu, n_post_hcu)."""
    ci = torch.clamp_min(state.ci, EPS)
    cj = torch.clamp_min(state.cj, EPS)
    cij = torch.clamp_min(state.cij, EPS)
    pointwise = cij * (torch.log(cij) - torch.log(ci)[:, None] - torch.log(cj)[None, :])
    blocked = pointwise.reshape(pre.n_hcu, pre.n_mcu, post.n_hcu, post.n_mcu)
    return blocked.sum(dim=(1, 3))


def update_mask(
    plast: PlasticityState,
    marginals: MarginalState,
    pre: UnitLayout,
    post: UnitLayout,
    n_swaps: int = 1,
) -> PlasticityState:
    """Greedy rewiring step (Alg.1 L4-6), all hidden HCUs at once.

    ``argmin``/``argmax`` return the first index among ties, as ``jnp``'s
    do, so both packages pick the same connection.  Fan-in is preserved.
    """
    scores = mi_scores(marginals, pre, post)  # (n_pre_hcu, n_post_hcu)
    mask = plast.hcu_mask
    cols = torch.arange(mask.shape[1], device=mask.device)
    for _ in range(n_swaps):
        active = mask > 0.5
        worst_active = torch.where(active, scores, torch.inf).argmin(dim=0)
        best_silent = torch.where(active, -torch.inf, scores).argmax(dim=0)
        do_swap = (
            (scores[best_silent, cols] > scores[worst_active, cols])
            & active.any(dim=0)
            & (~active).any(dim=0)
        )
        mask = mask.clone()
        mask[worst_active, cols] = torch.where(do_swap, 0.0, mask[worst_active, cols])
        mask[best_silent, cols] = torch.where(do_swap, 1.0, mask[best_silent, cols])
    return PlasticityState(hcu_mask=mask)


def fan_in(plast: PlasticityState) -> torch.Tensor:
    """Active incoming connections per hidden HCU (invariant under updates)."""
    return plast.hcu_mask.sum(dim=0)


def full_mask(pre: UnitLayout, post: UnitLayout, device=None) -> PlasticityState:
    """All-active mask (a plain dense BCPNN layer)."""
    return PlasticityState(
        hcu_mask=torch.ones((pre.n_hcu, post.n_hcu), dtype=torch.float32, device=device)
    )
