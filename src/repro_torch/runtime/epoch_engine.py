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
  forward at all;
* under a data-parallel trainer (``repro_torch.core.distributed``) each
  builder takes the trainer's step (``step_fn``) and each rank stacks only
  its rows of every global batch (:func:`epoch_sharding`);
* each hidden and BCPNN readout batch is a ``layer.step`` span on the
  active tracer (:mod:`repro_torch.runtime.trace`), if there is one.

The epoch driver (shuffle, stack, thread states through phases) lives in
:class:`repro_torch.runtime.plans.ScanPlan`.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.optim import apply_updates, tree_flatten
from repro_torch.runtime import trace


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


def epoch_sharding(trainer, idx: np.ndarray, batch_size: int):
    """This rank's rows of a shuffled epoch under ``trainer``: of every
    global batch of ``batch_size`` rows in ``idx``, the contiguous share
    ``trainer.rows`` names, in batch order.  Returns ``(local idx, local
    batch size)``; without a trainer, ``(idx, batch_size)``.  A batch size
    that the batch ranks do not divide raises ``ValueError``."""
    if trainer is None:
        return idx, batch_size
    rows = trainer.rows(batch_size)
    local = np.asarray(idx).reshape(-1, batch_size)[:, rows]
    return np.ascontiguousarray(local).reshape(-1), rows.stop - rows.start


def forward_stack(layers: Sequence[Any]) -> Callable:
    """``(states, xb) -> xb`` through a frozen layer stack: the one frozen
    forward loop, shared by the epoch loops, BatchPlan and the store."""
    def fwd(states, xb):
        for layer, state in zip(layers, states):
            xb = layer.forward(state, xb)
        return xb

    return fwd


def _traced_step(step: Callable, index: Optional[int]) -> Callable:
    """``step`` as a ``layer.step`` span of layer ``index`` on the active
    tracer; its second argument is the batch."""
    def traced(state, xb, *rest):
        tracer = trace.active()
        if tracer is None:
            return step(state, xb, *rest)
        with tracer.span("layer.step", layer=index, rows=xb.shape[0]):
            return step(state, xb, *rest)

    return traced


def _hidden_step(layer, step_fn: Optional[Callable], index: Optional[int]) -> Callable:
    """The per-batch ``(state, xb) -> state`` of a hidden layer: ``layer``'s
    ``train_batch`` (looked up per batch) unless a trainer's ``step_fn``."""
    return _traced_step(
        step_fn if step_fn is not None else (lambda s, xb: layer.train_batch(s, xb)[0]), index)


def _readout_step(layer, step_fn: Optional[Callable], index: Optional[int]) -> Callable:
    """The readout's ``(state, hb, yb) -> state``, as :func:`_hidden_step`."""
    return _traced_step(
        step_fn if step_fn is not None else (lambda s, hb, yb: layer.train_batch(s, hb, yb)[0]),
        index)


def hidden_epoch_fn(layer, below_layers: Sequence[Any], step_fn: Optional[Callable] = None,
                    index: Optional[int] = None) -> Callable:
    """``(state, below_states, xs) -> state`` for one Hebbian epoch over the
    stacked raw input ``xs`` (n_batches, B, F); ``step_fn`` (a trainer's)
    replaces the layer's ``train_batch``; ``index`` (the layer's place in
    the network) tags its ``layer.step`` spans."""
    below = forward_stack(below_layers)
    step = _hidden_step(layer, step_fn, index)

    def epoch(state, below_states, xs):
        for xb in xs:
            state = step(state, below(below_states, xb))
        return state

    return epoch


def readout_epoch_fn(layer, hidden_layers: Sequence[Any], step_fn: Optional[Callable] = None,
                     index: Optional[int] = None) -> Callable:
    """``(state, hidden_states, xs, ys) -> state`` for one supervised BCPNN
    readout epoch (post-activations clamped to one-hot labels)."""
    below = forward_stack(hidden_layers)
    step = _readout_step(layer, step_fn, index)

    def epoch(state, hidden_states, xs, ys):
        for xb, yb in zip(xs, ys):
            state = step(state, below(hidden_states, xb), yb)
        return state

    return epoch


def hidden_epoch_cached_fn(layer, step_fn: Optional[Callable] = None,
                           index: Optional[int] = None) -> Callable:
    """``(state, xs) -> state``: one Hebbian epoch on pre-projected inputs."""
    step = _hidden_step(layer, step_fn, index)

    def epoch(state, xs):
        for xb in xs:
            state = step(state, xb)
        return state

    return epoch


def readout_epoch_cached_fn(layer, step_fn: Optional[Callable] = None,
                            index: Optional[int] = None) -> Callable:
    """``(state, hs, ys) -> state``: one readout epoch on pre-projected codes."""
    step = _readout_step(layer, step_fn, index)

    def epoch(state, hs, ys):
        for hb, yb in zip(hs, ys):
            state = step(state, hb, yb)
        return state

    return epoch


def sgd_step(opt, loss_fn: Callable, reduce_grads: Optional[Callable] = None) -> Callable:
    """``(params, opt_state, hb, yb) -> (params, opt_state, loss)``: one step
    of the hybrid readout, the gradients taken by autograd on the head's
    tensors (and averaged over the ranks by ``reduce_grads``, a trainer's
    ``average_grads``), then the optimizer's update added to the params
    (new tensors; the old params are left as they were)."""
    def step(params, opt_state, hb, yb):
        leaves, rebuild = tree_flatten(params)
        with torch.enable_grad():
            live = [t.detach().requires_grad_(True) for t in leaves]
            loss = loss_fn(rebuild(live), hb, yb)
            grads = torch.autograd.grad(loss, live)
        if reduce_grads is not None:
            grads = reduce_grads(grads)
        updates, opt_state = opt.update(rebuild(list(grads)), opt_state, params)
        return apply_updates(params, updates), opt_state, loss.detach()

    return step


def sgd_epoch_fn(opt, hidden_layers: Sequence[Any], loss_fn: Callable,
                 reduce_grads: Optional[Callable] = None) -> Callable:
    """``(params, opt_state, hidden_states, xs, ys) -> (params, opt_state,
    loss)`` for one hybrid-readout epoch over the raw input; ``loss`` is
    the last batch's."""
    below = forward_stack(hidden_layers)
    step = sgd_step(opt, loss_fn, reduce_grads)

    def epoch(params, opt_state, hidden_states, xs, ys):
        loss = torch.zeros((), device=xs.device)
        for xb, yb in zip(xs, ys):
            params, opt_state, loss = step(params, opt_state, below(hidden_states, xb), yb)
        return params, opt_state, loss

    return epoch


def sgd_epoch_cached_fn(opt, loss_fn: Callable, reduce_grads: Optional[Callable] = None
                        ) -> Callable:
    """``(params, opt_state, hs, ys) -> (params, opt_state, loss)``: one
    hybrid-readout epoch on pre-projected hidden codes."""
    step = sgd_step(opt, loss_fn, reduce_grads)

    def epoch(params, opt_state, hs, ys):
        loss = torch.zeros((), device=hs.device)
        for hb, yb in zip(hs, ys):
            params, opt_state, loss = step(params, opt_state, hb, yb)
        return params, opt_state, loss

    return epoch
