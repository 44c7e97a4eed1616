"""Device-resident epoch engine: one loop over a stacked epoch.

JAX's engine runs each epoch as one jitted ``lax.scan``; here the epoch is a
Python loop whose per-batch work is a few kernel launches on the device's
stream, so the host only enqueues and never waits inside an epoch.

* :func:`stack_epoch` gathers a shuffled epoch into a ``(n_batches, B, ...)``
  tensor on the device: one host->device copy per epoch for host data, an
  on-device ``index_select`` for data already on the device;
* the ``*_epoch_fn`` builders run the per-batch transition over the stack,
  recomputing the frozen layers below (the parity reference): the hidden
  Hebbian phase, the BCPNN readout phase and the hybrid SGD readout phase
  each get one;
* the ``*_epoch_cached_fn`` builders take inputs already projected through
  the frozen prefix by the activation store, so the loop holds no frozen
  forward at all.

The epoch driver (shuffle, stack, thread states through phases) lives in
:class:`repro_torch.runtime.plans.ScanPlan`.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.optim import apply_updates, tree_flatten


def _as_index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(idx, dtype=np.int64), device=device)


def stack_epoch(
    arr,
    idx: np.ndarray,
    batch_size: int,
    device: torch.device,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Gather a shuffled epoch and reshape to ``(n_batches, B, ...)`` on
    ``device``.  ``idx`` must be trimmed to a multiple of ``batch_size``.

    ``arr`` is a numpy array, a host tensor, or a tensor on ``device``.
    With ``out`` (a buffer of the stacked shape on ``device``) the epoch is
    written into it instead of a fresh allocation.
    """
    n = idx.shape[0]
    if n % batch_size != 0:
        raise ValueError(f"epoch of {n} samples is not a multiple of B={batch_size}")
    shape = (n // batch_size, batch_size, *arr.shape[1:])
    if isinstance(arr, torch.Tensor) and arr.device == device:
        sel = _as_index(idx, device)
        if out is not None:
            return torch.index_select(arr, 0, sel, out=out.view(n, *arr.shape[1:])).view(shape)
        return torch.index_select(arr, 0, sel).view(shape)
    if isinstance(arr, torch.Tensor):  # host-resident (e.g. a spilled cache level)
        host = torch.index_select(arr, 0, _as_index(idx, arr.device))
    else:
        host = torch.from_numpy(np.ascontiguousarray(arr[idx]))
    host = host.view(shape)
    if out is not None:
        return out.copy_(host)
    return host.to(device)


def gather_batch(arr, sel: np.ndarray, device: torch.device) -> torch.Tensor:
    """One batch gather for the per-batch reference loop."""
    if isinstance(arr, torch.Tensor):
        return torch.index_select(arr, 0, _as_index(sel, arr.device)).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr[sel])).to(device)


def rows_to(arr, start: int, stop: int, device: torch.device) -> torch.Tensor:
    """Rows ``start:stop`` of a numpy array or tensor, on ``device``."""
    part = arr[start:stop]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(device)


def forward_stack(layers: Sequence[Any]) -> Callable:
    """``(states, xb) -> xb`` through a frozen layer stack: the one frozen
    forward loop, shared by the epoch loops, BatchPlan and the store."""
    def fwd(states, xb):
        for layer, state in zip(layers, states):
            xb = layer.forward(state, xb)
        return xb

    return fwd


def hidden_epoch_fn(layer, below_layers: Sequence[Any]) -> Callable:
    """``(state, below_states, xs) -> state`` for one Hebbian epoch over the
    stacked raw input ``xs`` (n_batches, B, F)."""
    below = forward_stack(below_layers)

    def epoch(state, below_states, xs):
        for xb in xs:
            state = layer.train_batch(state, below(below_states, xb))[0]
        return state

    return epoch


def readout_epoch_fn(layer, hidden_layers: Sequence[Any]) -> Callable:
    """``(state, hidden_states, xs, ys) -> state`` for one supervised BCPNN
    readout epoch (post-activations clamped to one-hot labels)."""
    below = forward_stack(hidden_layers)

    def epoch(state, hidden_states, xs, ys):
        for xb, yb in zip(xs, ys):
            state = layer.train_batch(state, below(hidden_states, xb), yb)[0]
        return state

    return epoch


def hidden_epoch_cached_fn(layer) -> Callable:
    """``(state, xs) -> state``: one Hebbian epoch on pre-projected inputs."""
    def epoch(state, xs):
        for xb in xs:
            state = layer.train_batch(state, xb)[0]
        return state

    return epoch


def readout_epoch_cached_fn(layer) -> Callable:
    """``(state, hs, ys) -> state``: one readout epoch on pre-projected codes."""
    def epoch(state, hs, ys):
        for hb, yb in zip(hs, ys):
            state = layer.train_batch(state, hb, yb)[0]
        return state

    return epoch


def sgd_step(opt, loss_fn: Callable) -> Callable:
    """``(params, opt_state, hb, yb) -> (params, opt_state, loss)``: one step
    of the hybrid readout, the gradients taken by autograd on the head's
    tensors, then the optimizer's update added to the params (new tensors;
    the old params are left as they were)."""
    def step(params, opt_state, hb, yb):
        leaves, rebuild = tree_flatten(params)
        with torch.enable_grad():
            live = [t.detach().requires_grad_(True) for t in leaves]
            loss = loss_fn(rebuild(live), hb, yb)
            grads = torch.autograd.grad(loss, live)
        updates, opt_state = opt.update(rebuild(list(grads)), opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()

    return step


def sgd_epoch_fn(opt, hidden_layers: Sequence[Any], loss_fn: Callable) -> Callable:
    """``(params, opt_state, hidden_states, xs, ys) -> (params, opt_state,
    loss)`` for one hybrid-readout epoch over the raw input; ``loss`` is
    the last batch's."""
    below = forward_stack(hidden_layers)
    step = sgd_step(opt, loss_fn)

    def epoch(params, opt_state, hidden_states, xs, ys):
        loss = torch.zeros((), device=xs.device)
        for xb, yb in zip(xs, ys):
            params, opt_state, loss = step(params, opt_state, below(hidden_states, xb), yb)
        return params, opt_state, loss

    return epoch


def sgd_epoch_cached_fn(opt, loss_fn: Callable) -> Callable:
    """``(params, opt_state, hs, ys) -> (params, opt_state, loss)``: one
    hybrid-readout epoch on pre-projected hidden codes."""
    step = sgd_step(opt, loss_fn)

    def epoch(params, opt_state, hs, ys):
        loss = torch.zeros((), device=hs.device)
        for hb, yb in zip(hs, ys):
            params, opt_state, loss = step(params, opt_state, hb, yb)
        return params, opt_state, loss

    return epoch
