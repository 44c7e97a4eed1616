"""ExecutionPlan strategies: how a compiled network's epochs execute.

* :class:`ScanPlan` ("scan", the default): each epoch is gathered once into
  a device-resident ``(n_batches, B, F)`` stack and looped over
  (:mod:`repro_torch.runtime.epoch_engine`).  With ``donate`` the stack
  buffer of one epoch is reused by the next, the counterpart of JAX's
  donated epoch buffers.
* :class:`BatchPlan` ("batch"): the per-batch reference loop, one gather and
  one host->device copy per batch.  ScanPlan is tested against it.

Epoch-runner calling convention (host-side data in, new state out):

    hidden_epoch(li)(state, below_states, x, idx, batch_size) -> state
    readout_epoch()(state, hidden_states, x, y, idx, batch_size) -> state
    hidden_epoch_cached(li)(state, xk, idx, batch_size) -> state
    readout_epoch_cached()(state, hk, y, idx, batch_size) -> state
    sgd_epoch(opt, loss_fn)(params, opt_state, hidden_states, x, y, idx,
                            batch_size) -> (params, opt_state, last_loss)
    sgd_epoch_cached(opt, loss_fn)(params, opt_state, hk, y, idx,
                                   batch_size) -> (params, opt_state, last_loss)

``x``/``y`` are the full datasets (numpy) or cached levels (tensors);
``idx`` is the already length-trimmed shuffled index vector of the epoch.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.runtime.epoch_engine import (
    forward_stack,
    gather_batch,
    hidden_epoch_cached_fn,
    hidden_epoch_fn,
    readout_epoch_cached_fn,
    readout_epoch_fn,
    sgd_epoch_cached_fn,
    sgd_epoch_fn,
    sgd_step,
    stack_epoch,
)


class ExecutionPlan:
    """Base strategy: owns the bound layers and the target device."""

    name: str = "?"

    def __init__(self, layers: Sequence[Any], device: torch.device, donate: bool = True):
        from repro_torch.core.layers import DenseLayer, StructuralPlasticityLayer

        self.layers: List[Any] = list(layers)
        self.device = torch.device(device)
        self.donate = donate
        self._plastic_cls = StructuralPlasticityLayer
        self._dense_cls = DenseLayer

    @property
    def hidden_layers(self) -> List[Any]:
        return [la for la in self.layers if isinstance(la, self._plastic_cls)]

    @property
    def readout_layer(self) -> Optional[Any]:
        last = self.layers[-1] if self.layers else None
        return last if isinstance(last, self._dense_cls) else None

    # Fused runners recompute the frozen stack inside the epoch (x is the raw
    # dataset); cached runners take the layer's own pre-projected input.
    def hidden_epoch(self, li: int) -> Callable:
        raise NotImplementedError

    def readout_epoch(self) -> Callable:
        raise NotImplementedError

    def hidden_epoch_cached(self, li: int) -> Callable:
        raise NotImplementedError

    def readout_epoch_cached(self) -> Callable:
        raise NotImplementedError

    def sgd_epoch(self, opt, loss_fn: Callable) -> Callable:
        raise NotImplementedError

    def sgd_epoch_cached(self, opt, loss_fn: Callable) -> Callable:
        raise NotImplementedError


class ScanPlan(ExecutionPlan):
    """Device-resident epochs: stack once, loop on the device's stream."""

    name = "scan"

    def __init__(self, layers, device, donate: bool = True):
        super().__init__(layers, device, donate)
        self._buffers: Dict[str, torch.Tensor] = {}  # role -> reused epoch stack

    def _stack(self, arr, idx, batch_size, role: str) -> torch.Tensor:
        if not self.donate:
            return stack_epoch(arr, idx, batch_size, self.device)
        shape = (idx.shape[0] // batch_size, batch_size, *arr.shape[1:])
        dtype = arr.dtype if isinstance(arr, torch.Tensor) else torch.from_numpy(arr[:0]).dtype
        buf = self._buffers.get(role)
        if buf is None or buf.shape != shape or buf.dtype != dtype:
            buf = torch.empty(shape, dtype=dtype, device=self.device)
            self._buffers[role] = buf
        return stack_epoch(arr, idx, batch_size, self.device, out=buf)

    def hidden_epoch(self, li: int) -> Callable:
        epoch_fn = hidden_epoch_fn(self.hidden_layers[li], self.layers[:li])

        def run(state, below_states, x, idx, batch_size):
            return epoch_fn(state, below_states, self._stack(x, idx, batch_size, "x"))

        return run

    def readout_epoch(self) -> Callable:
        epoch_fn = readout_epoch_fn(self.readout_layer, self.layers[:-1])

        def run(state, hidden_states, x, y, idx, batch_size):
            xs = self._stack(x, idx, batch_size, "x")
            ys = self._stack(y, idx, batch_size, "y")
            return epoch_fn(state, hidden_states, xs, ys)

        return run

    def hidden_epoch_cached(self, li: int) -> Callable:
        epoch_fn = hidden_epoch_cached_fn(self.hidden_layers[li])

        def run(state, xk, idx, batch_size):
            return epoch_fn(state, self._stack(xk, idx, batch_size, "x"))

        return run

    def readout_epoch_cached(self) -> Callable:
        epoch_fn = readout_epoch_cached_fn(self.readout_layer)

        def run(state, hk, y, idx, batch_size):
            hs = self._stack(hk, idx, batch_size, "x")
            ys = self._stack(y, idx, batch_size, "y")
            return epoch_fn(state, hs, ys)

        return run

    def sgd_epoch(self, opt, loss_fn: Callable) -> Callable:
        epoch_fn = sgd_epoch_fn(opt, self.hidden_layers, loss_fn)

        def run(params, opt_state, hidden_states, x, y, idx, batch_size):
            xs = self._stack(x, idx, batch_size, "x")
            ys = self._stack(y, idx, batch_size, "y")
            return epoch_fn(params, opt_state, hidden_states, xs, ys)

        return run

    def sgd_epoch_cached(self, opt, loss_fn: Callable) -> Callable:
        epoch_fn = sgd_epoch_cached_fn(opt, loss_fn)

        def run(params, opt_state, hk, y, idx, batch_size):
            hs = self._stack(hk, idx, batch_size, "x")
            ys = self._stack(y, idx, batch_size, "y")
            return epoch_fn(params, opt_state, hs, ys)

        return run


class BatchPlan(ExecutionPlan):
    """Per-batch reference loop: one gather and one copy per batch."""

    name = "batch"

    def _batches(self, arrs, idx, batch_size):
        for b in range(0, idx.shape[0], batch_size):
            sel = idx[b : b + batch_size]
            yield [gather_batch(a, sel, self.device) for a in arrs]

    def hidden_epoch(self, li: int) -> Callable:
        layer = self.hidden_layers[li]
        below = forward_stack(self.layers[:li])

        def run(state, below_states, x, idx, batch_size):
            for (xb,) in self._batches([x], idx, batch_size):
                state = layer.train_batch(state, below(below_states, xb))[0]
            return state

        return run

    def readout_epoch(self) -> Callable:
        layer = self.readout_layer
        below = forward_stack(self.layers[:-1])

        def run(state, hidden_states, x, y, idx, batch_size):
            for xb, yb in self._batches([x, y], idx, batch_size):
                state = layer.train_batch(state, below(hidden_states, xb), yb)[0]
            return state

        return run

    def hidden_epoch_cached(self, li: int) -> Callable:
        layer = self.hidden_layers[li]

        def run(state, xk, idx, batch_size):
            for (xb,) in self._batches([xk], idx, batch_size):
                state = layer.train_batch(state, xb)[0]
            return state

        return run

    def readout_epoch_cached(self) -> Callable:
        layer = self.readout_layer

        def run(state, hk, y, idx, batch_size):
            for hb, yb in self._batches([hk, y], idx, batch_size):
                state = layer.train_batch(state, hb, yb)[0]
            return state

        return run

    def sgd_epoch(self, opt, loss_fn: Callable) -> Callable:
        below = forward_stack(self.hidden_layers)
        step = sgd_step(opt, loss_fn)

        def run(params, opt_state, hidden_states, x, y, idx, batch_size):
            loss = torch.zeros((), device=self.device)
            for xb, yb in self._batches([x, y], idx, batch_size):
                params, opt_state, loss = step(params, opt_state, below(hidden_states, xb), yb)
            return params, opt_state, loss

        return run

    def sgd_epoch_cached(self, opt, loss_fn: Callable) -> Callable:
        step = sgd_step(opt, loss_fn)

        def run(params, opt_state, hk, y, idx, batch_size):
            loss = torch.zeros((), device=self.device)
            for hb, yb in self._batches([hk, y], idx, batch_size):
                params, opt_state, loss = step(params, opt_state, hb, yb)
            return params, opt_state, loss

        return run


PLANS = {ScanPlan.name: ScanPlan, BatchPlan.name: BatchPlan}


def make_plan(engine: str, layers: Sequence[Any], device, donate: bool = True) -> ExecutionPlan:
    try:
        cls = PLANS[engine]
    except KeyError:
        raise ValueError(
            f"Unknown engine {engine!r} (want one of {sorted(PLANS)})"
        ) from None
    return cls(layers, device, donate=donate)
