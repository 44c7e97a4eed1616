"""Gradient accumulation over microbatches.

The port of ``repro/optim/accumulation.py``: the batch is split on axis 0
into ``n_micro`` microbatches, run one after another, their losses summed
and their gradients summed in f32 in microbatch order, and both sums
scaled by ``1 / n_micro``, so the activations held scale with the
microbatch.  The gradients come from ``torch.autograd.grad`` over detached
copies of the params' leaves (the same storage): nothing given is written.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.optim.adamw import tree_flatten, tree_map


def value_and_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad``: fn(params, batch) -> (loss, grads in the
    params' structure and dtypes); a leaf the loss does not reach gets
    zeros."""

    def fn(params, batch):
        leaves, rebuild = tree_flatten(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss = loss_fn(rebuild(live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), rebuild([torch.zeros_like(p) if g is None else g
                                       for g, p in zip(grads, live)])

    return fn


def microbatched_value_and_grad(loss_fn: Callable, n_micro: int) -> Callable:
    """fn(params, batch) -> (mean loss, mean grads in f32) over ``n_micro``
    microbatches of ``batch`` (a tree whose leaves share a leading batch
    axis divisible by ``n_micro``); ``value_and_grad`` when n_micro <= 1."""
    vg = value_and_grad(loss_fn)
    if n_micro <= 1:
        return vg

    def split(x, i):
        # The reference's reshape to (n_micro, rows, ...): a leading axis
        # that n_micro does not divide is refused, not cut short.
        if x.shape[0] % n_micro:
            raise ValueError(f"a batch axis of {x.shape[0]} rows does not split "
                             f"into n_micro={n_micro} microbatches")
        rows = x.shape[0] // n_micro
        return x[i * rows:(i + 1) * rows]

    def fn(params, batch):
        loss_sum, grad_sum, rebuild = 0.0, None, None
        for i in range(n_micro):
            micro = tree_map(lambda x, i=i: split(x, i), batch)
            loss, grads = vg(params, micro)
            leaves, rebuild = tree_flatten(grads)
            leaves = [g.to(torch.float32) for g in leaves]
            grad_sum = leaves if grad_sum is None else [a + g for a, g in zip(grad_sum, leaves)]
            loss_sum = loss_sum + loss
        inv = 1.0 / n_micro
        return loss_sum * inv, rebuild([g * inv for g in grad_sum])

    return fn
