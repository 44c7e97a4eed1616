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

Both plans build each epoch (or step) callable once and keep it in
:attr:`ExecutionPlan.callables` (the reference's ``jitted``), so repeated
``fit``/``partial_fit`` calls reuse them.  With ``strict`` each callable is
a signature-counting :class:`~repro_torch.analysis.strict.Counted` that
the network's recompile sentinel watches, and each dispatch runs under
:func:`~repro_torch.analysis.strict.dispatch_guard`: the epoch stack (or
the batch) is staged on the device first, since a blocking host-to-device
copy synchronises, and the guard then refuses any host sync and any input
off the device.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.analysis.strict import counted, dispatch_guard
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
    """Base strategy: owns the bound layers, the target device and the
    registry of the callables it builds."""

    name: str = "?"

    def __init__(self, layers: Sequence[Any], device: torch.device, donate: bool = True,
                 strict: bool = False):
        from repro_torch.core.layers import DenseLayer, StructuralPlasticityLayer

        self.layers: List[Any] = list(layers)
        self.device = torch.device(device)
        self.donate = donate
        self.strict = strict
        # name -> epoch/step callable, for the strict-mode recompile
        # sentinel: every callable this plan builds registers here.
        self.callables: Dict[str, Callable] = {}
        self._runners: Dict[Any, Callable] = {}  # cached epoch runners
        self._plastic_cls = StructuralPlasticityLayer
        self._dense_cls = DenseLayer

    @property
    def hidden_layers(self) -> List[Any]:
        return [la for la in self.layers if isinstance(la, self._plastic_cls)]

    @property
    def readout_layer(self) -> Optional[Any]:
        last = self.layers[-1] if self.layers else None
        return last if isinstance(last, self._dense_cls) else None

    def cache_sizes(self) -> Dict[str, int]:
        """``name -> signatures met`` for every registered callable (strict
        mode counts them; the reference's ``jit_cache_sizes``)."""
        return {
            name: fn._cache_size()
            for name, fn in self.callables.items()
            if hasattr(fn, "_cache_size")
        }

    def _register(self, name: str, fn: Callable) -> Callable:
        fn = counted(fn, self.strict)
        self.callables[name] = fn
        return fn

    def _runner(self, key, build: Callable) -> Callable:
        run = self._runners.get(key)
        if run is None:
            run = self._runners[key] = build()
        return run

    def _guard(self, **leaves):
        return dispatch_guard(self.strict, self.device, leaves)

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

    def __init__(self, layers, device, donate: bool = True, strict: bool = False):
        super().__init__(layers, device, donate, strict)
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
        def build():
            epoch_fn = self._register(
                f"hidden_epoch[{li}]", hidden_epoch_fn(self.hidden_layers[li], self.layers[:li])
            )

            def run(state, below_states, x, idx, batch_size):
                xs = self._stack(x, idx, batch_size, "x")
                with self._guard(state=state, below_states=below_states, xs=xs):
                    return epoch_fn(state, below_states, xs)

            return run

        return self._runner(("hidden", li), build)

    def readout_epoch(self) -> Callable:
        def build():
            epoch_fn = self._register(
                "readout_epoch", readout_epoch_fn(self.readout_layer, self.layers[:-1])
            )

            def run(state, hidden_states, x, y, idx, batch_size):
                xs = self._stack(x, idx, batch_size, "x")
                ys = self._stack(y, idx, batch_size, "y")
                with self._guard(state=state, hidden_states=hidden_states, xs=xs, ys=ys):
                    return epoch_fn(state, hidden_states, xs, ys)

            return run

        return self._runner("readout", build)

    def hidden_epoch_cached(self, li: int) -> Callable:
        def build():
            epoch_fn = self._register(
                f"hidden_epoch_cached[{li}]", hidden_epoch_cached_fn(self.hidden_layers[li])
            )

            def run(state, xk, idx, batch_size):
                xs = self._stack(xk, idx, batch_size, "x")
                with self._guard(state=state, xs=xs):
                    return epoch_fn(state, xs)

            return run

        return self._runner(("hidden_cached", li), build)

    def readout_epoch_cached(self) -> Callable:
        def build():
            epoch_fn = self._register(
                "readout_epoch_cached", readout_epoch_cached_fn(self.readout_layer)
            )

            def run(state, hk, y, idx, batch_size):
                hs = self._stack(hk, idx, batch_size, "x")
                ys = self._stack(y, idx, batch_size, "y")
                with self._guard(state=state, hs=hs, ys=ys):
                    return epoch_fn(state, hs, ys)

            return run

        return self._runner("readout_cached", build)

    # The SGD runners are cached by the compiled network per (width, lr).
    def sgd_epoch(self, opt, loss_fn: Callable) -> Callable:
        epoch_fn = self._register("sgd_epoch", sgd_epoch_fn(opt, self.hidden_layers, loss_fn))

        def run(params, opt_state, hidden_states, x, y, idx, batch_size):
            xs = self._stack(x, idx, batch_size, "x")
            ys = self._stack(y, idx, batch_size, "y")
            with self._guard(params=params, opt_state=opt_state, hidden_states=hidden_states,
                             xs=xs, ys=ys):
                return epoch_fn(params, opt_state, hidden_states, xs, ys)

        return run

    def sgd_epoch_cached(self, opt, loss_fn: Callable) -> Callable:
        epoch_fn = self._register("sgd_epoch_cached", sgd_epoch_cached_fn(opt, loss_fn))

        def run(params, opt_state, hk, y, idx, batch_size):
            hs = self._stack(hk, idx, batch_size, "x")
            ys = self._stack(y, idx, batch_size, "y")
            with self._guard(params=params, opt_state=opt_state, hs=hs, ys=ys):
                return epoch_fn(params, opt_state, hs, ys)

        return run


class BatchPlan(ExecutionPlan):
    """Per-batch reference loop: one gather and one copy per batch, each
    staged before that batch's guarded step."""

    name = "batch"

    def _batches(self, arrs, idx, batch_size):
        for b in range(0, idx.shape[0], batch_size):
            sel = idx[b : b + batch_size]
            yield [gather_batch(a, sel, self.device) for a in arrs]

    def _below_fn(self, upto: int) -> Callable:
        return self._register(f"below[{upto}]", forward_stack(self.layers[:upto]))

    def hidden_epoch(self, li: int) -> Callable:
        def build():
            layer = self.hidden_layers[li]
            step = self._register(f"hidden_step[{li}]", lambda s, xb: layer.train_batch(s, xb)[0])
            below = self._below_fn(li)

            def run(state, below_states, x, idx, batch_size):
                for (xb,) in self._batches([x], idx, batch_size):
                    with self._guard(state=state, below_states=below_states, xb=xb):
                        state = step(state, below(below_states, xb))
                return state

            return run

        return self._runner(("hidden", li), build)

    def readout_epoch(self) -> Callable:
        def build():
            layer = self.readout_layer
            step = self._register("readout_step", lambda s, hb, yb: layer.train_batch(s, hb, yb)[0])
            below = self._below_fn(len(self.layers) - 1)

            def run(state, hidden_states, x, y, idx, batch_size):
                for xb, yb in self._batches([x, y], idx, batch_size):
                    with self._guard(state=state, hidden_states=hidden_states, xb=xb, yb=yb):
                        state = step(state, below(hidden_states, xb), yb)
                return state

            return run

        return self._runner("readout", build)

    def hidden_epoch_cached(self, li: int) -> Callable:
        def build():
            layer = self.hidden_layers[li]
            step = self._register(
                f"hidden_step_cached[{li}]", lambda s, xb: layer.train_batch(s, xb)[0]
            )

            def run(state, xk, idx, batch_size):
                for (xb,) in self._batches([xk], idx, batch_size):
                    with self._guard(state=state, xb=xb):
                        state = step(state, xb)
                return state

            return run

        return self._runner(("hidden_cached", li), build)

    def readout_epoch_cached(self) -> Callable:
        def build():
            layer = self.readout_layer
            step = self._register(
                "readout_step_cached", lambda s, hb, yb: layer.train_batch(s, hb, yb)[0]
            )

            def run(state, hk, y, idx, batch_size):
                for hb, yb in self._batches([hk, y], idx, batch_size):
                    with self._guard(state=state, hb=hb, yb=yb):
                        state = step(state, hb, yb)
                return state

            return run

        return self._runner("readout_cached", build)

    def sgd_epoch(self, opt, loss_fn: Callable) -> Callable:
        below = self._below_fn(len(self.hidden_layers))
        step = self._register("sgd_step", sgd_step(opt, loss_fn))

        def run(params, opt_state, hidden_states, x, y, idx, batch_size):
            loss = torch.zeros((), device=self.device)
            for xb, yb in self._batches([x, y], idx, batch_size):
                with self._guard(params=params, opt_state=opt_state,
                                 hidden_states=hidden_states, xb=xb, yb=yb):
                    params, opt_state, loss = step(params, opt_state, below(hidden_states, xb), yb)
            return params, opt_state, loss

        return run

    def sgd_epoch_cached(self, opt, loss_fn: Callable) -> Callable:
        step = self._register("sgd_step_cached", sgd_step(opt, loss_fn))

        def run(params, opt_state, hk, y, idx, batch_size):
            loss = torch.zeros((), device=self.device)
            for hb, yb in self._batches([hk, y], idx, batch_size):
                with self._guard(params=params, opt_state=opt_state, hb=hb, yb=yb):
                    params, opt_state, loss = step(params, opt_state, hb, yb)
            return params, opt_state, loss

        return run


PLANS = {ScanPlan.name: ScanPlan, BatchPlan.name: BatchPlan}


def make_plan(engine: str, layers: Sequence[Any], device, donate: bool = True,
              strict: bool = False) -> ExecutionPlan:
    try:
        cls = PLANS[engine]
    except KeyError:
        raise ValueError(
            f"Unknown engine {engine!r} (want one of {sorted(PLANS)})"
        ) from None
    return cls(layers, device, donate=donate, strict=strict)
