"""AdamW over trees of tensors (dicts, lists and tuples of tensors).

The optax-style interface of the reference (``repro/optim/adamw.py``):
``init(params) -> state``, ``update(grads, state, params) -> (updates,
state)``, and :func:`apply_updates` adds the updates to the params.  The
arithmetic runs in the reference's order: the step counts in int32 and the
bias corrections take it as f32, ``eps`` is added after the square root,
and the weight decay is decoupled (``u - lr * wd * p``).  Moments are f32
whatever the params' dtype.  Everything stays on the params' device, so an
update never waits for the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Tuple, Union

import numpy as np
import torch

Schedule = Callable[[torch.Tensor], Any]


def tree_flatten(tree) -> Tuple[List[torch.Tensor], Callable[[List[Any]], Any]]:
    """The tensor leaves of ``tree`` (dicts in key order, lists, tuples,
    NamedTuples) and a function that rebuilds the structure from a list of
    new leaves."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [tree_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(leaves) for leaves, _ in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, sub), n in zip(parts, sizes):
            out.append(sub(leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)

    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of ``rest`` (same structure)."""
    leaves, rebuild = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return rebuild([fn(*args) for args in zip(leaves, *others)])


def learning_rate_at(lr: Union[float, Schedule], step: torch.Tensor):
    """The learning rate at ``step``: a schedule's value (a tensor), or the
    constant rounded to f32 as the reference's ``jnp.asarray(lr, float32)``,
    kept a Python float so that no update copies it to the device."""
    if callable(lr):
        return lr(step)
    return float(np.float32(lr))


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any  # first moments, the params' structure
    nu: Any  # second moments


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Decoupled weight decay Adam (Loshchilov & Hutter)."""

    learning_rate: Union[float, Schedule] = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params) -> AdamWState:
        leaves, _ = tree_flatten(params)
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            mu=tree_map(zeros, params),
            nu=tree_map(zeros, params),
        )

    def update(self, grads, state: AdamWState, params):
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        lr = learning_rate_at(self.learning_rate, step)
        # Bias-corrected moments, the corrections from the step as f32.
        c1 = 1.0 - torch.pow(b1, step.to(torch.float32))
        c2 = 1.0 - torch.pow(b2, step.to(torch.float32))
        # lr * wd, taken in f32 as the reference takes it.
        lr_wd = (
            lr * self.weight_decay if isinstance(lr, torch.Tensor)
            else float(np.float32(lr) * np.float32(self.weight_decay))
        )

        def upd(g, m, v, p):
            g32 = g.to(torch.float32)
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * torch.square(g32)
            mhat = m / c1
            vhat = v / c2
            u = -lr * (mhat / (torch.sqrt(vhat) + self.eps))
            if self.weight_decay:
                u = u - lr_wd * p.to(torch.float32)
            return u.to(p.dtype), m, v

        flat_g, rebuild = tree_flatten(grads)
        out = [
            upd(*args) for args in zip(
                flat_g, tree_flatten(state.mu)[0], tree_flatten(state.nu)[0],
                tree_flatten(params)[0],
            )
        ]
        updates, mu, nu = (rebuild([o[i] for o in out]) for i in range(3))
        return updates, AdamWState(step=step, mu=mu, nu=nu)


def apply_updates(params, updates):
    """``params + updates``, leaf by leaf, in the params' dtype."""
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
