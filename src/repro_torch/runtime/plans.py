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

``trainer.decorate(plan)`` (a ``repro_torch.core.distributed``
``DataParallelTrainer``, bound by ``ExecutionConfig(trainer=...)``) swaps
every per-batch transition for the trainer's step and makes each rank
stack only its rows of every global batch (``epoch_sharding``); the phase
program places each trained layer's state with :meth:`place_state` before
its epochs and gathers it with :meth:`gather_state` after them.

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
    _hidden_step,
    _readout_step,
    epoch_sharding,
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
    """Base strategy: owns the bound layers, the target device, the
    optional trainer decoration and the registry of the callables it
    builds."""

    name: str = "?"

    def __init__(self, layers: Sequence[Any], device: torch.device, donate: bool = True,
                 strict: bool = False):
        from repro_torch.core.layers import DenseLayer, StructuralPlasticityLayer

        self.layers: List[Any] = list(layers)
        self.device = torch.device(device)
        self.donate = donate
        self.strict = strict
        self.trainer = None
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

    # ----------------------------------------------------------- decoration
    def bind_trainer(self, trainer) -> "ExecutionPlan":
        """Called by ``DataParallelTrainer.decorate``; must precede every
        runner and step this plan builds (they close over the trainer)."""
        if self._runners or self.callables:
            raise RuntimeError("cannot bind a trainer to a plan that already compiled steps")
        self.trainer = trainer
        return self

    def place_state(self, layer, state):
        """The state a phase's epochs train: this rank's part under a
        trainer (its hypercolumns of a hidden layer), else ``state``."""
        return state if self.trainer is None else self.trainer.place_state(layer, state)

    def gather_state(self, layer, state):
        """The global state after a phase's epochs (:meth:`place_state`'s
        inverse)."""
        return state if self.trainer is None else self.trainer.gather_state(layer, state)

    def _step_fn(self, layer) -> Optional[Callable]:
        """The trainer's per-batch step for ``layer`` (this rank's part),
        or None for the layer's own ``train_batch``."""
        if self.trainer is None:
            return None
        if isinstance(layer, self._plastic_cls):
            return self.trainer.hidden_step(layer)
        return self.trainer.readout_step(layer)

    def _reduce_grads(self) -> Optional[Callable]:
        return None if self.trainer is None else self.trainer.average_grads

    def _rows(self, idx, batch_size):
        """This rank's rows of the epoch and their batch size."""
        return epoch_sharding(self.trainer, idx, batch_size)

    def hidden_step(self, li: int) -> Callable:
        """The registered per-batch ``(state, xb) -> state`` of hidden layer
        ``li`` (the trainer's under a trainer): BatchPlan's transition and
        the single-step surface."""
        name = f"hidden_step[{li}]"
        if name not in self.callables:
            layer = self.hidden_layers[li]
            self._register(name, _hidden_step(layer, self._step_fn(layer), li))
        return self.callables[name]

    def readout_step(self) -> Callable:
        """The registered per-batch ``(state, hb, yb) -> state`` of the
        readout (the trainer's under a trainer)."""
        name = "readout_step"
        if name not in self.callables:
            layer = self.readout_layer
            self._register(name, _readout_step(layer, self._step_fn(layer),
                                                len(self.layers) - 1))
        return self.callables[name]

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
        idx, batch_size = self._rows(idx, batch_size)
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
            layer = self.hidden_layers[li]
            epoch_fn = self._register(
                f"hidden_epoch[{li}]",
                hidden_epoch_fn(layer, self.layers[:li], self._step_fn(layer), li),
            )

            def run(state, below_states, x, idx, batch_size):
                xs = self._stack(x, idx, batch_size, "x")
                with self._guard(state=state, below_states=below_states, xs=xs):
                    return epoch_fn(state, below_states, xs)

            return run

        return self._runner(("hidden", li), build)

    def readout_epoch(self) -> Callable:
        def build():
            layer = self.readout_layer
            epoch_fn = self._register(
                "readout_epoch", readout_epoch_fn(layer, self.layers[:-1], self._step_fn(layer),
                                                  len(self.layers) - 1)
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
            layer = self.hidden_layers[li]
            epoch_fn = self._register(
                f"hidden_epoch_cached[{li}]",
                hidden_epoch_cached_fn(layer, self._step_fn(layer), li)
            )

            def run(state, xk, idx, batch_size):
                xs = self._stack(xk, idx, batch_size, "x")
                with self._guard(state=state, xs=xs):
                    return epoch_fn(state, xs)

            return run

        return self._runner(("hidden_cached", li), build)

    def readout_epoch_cached(self) -> Callable:
        def build():
            layer = self.readout_layer
            epoch_fn = self._register(
                "readout_epoch_cached",
                readout_epoch_cached_fn(layer, self._step_fn(layer), len(self.layers) - 1)
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
        epoch_fn = self._register(
            "sgd_epoch", sgd_epoch_fn(opt, self.hidden_layers, loss_fn, self._reduce_grads()))

        def run(params, opt_state, hidden_states, x, y, idx, batch_size):
            xs = self._stack(x, idx, batch_size, "x")
            ys = self._stack(y, idx, batch_size, "y")
            with self._guard(params=params, opt_state=opt_state, hidden_states=hidden_states,
                             xs=xs, ys=ys):
                return epoch_fn(params, opt_state, hidden_states, xs, ys)

        return run

    def sgd_epoch_cached(self, opt, loss_fn: Callable) -> Callable:
        epoch_fn = self._register(
            "sgd_epoch_cached", sgd_epoch_cached_fn(opt, loss_fn, self._reduce_grads()))

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
        idx, batch_size = self._rows(idx, batch_size)
        for b in range(0, idx.shape[0], batch_size):
            sel = idx[b : b + batch_size]
            yield [gather_batch(a, sel, self.device) for a in arrs]

    def _below_fn(self, upto: int) -> Callable:
        return self._register(f"below[{upto}]", forward_stack(self.layers[:upto]))

    def hidden_epoch(self, li: int) -> Callable:
        def build():
            step = self.hidden_step(li)
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
            step = self.readout_step()
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
            step = self.hidden_step(li)

            def run(state, xk, idx, batch_size):
                for (xb,) in self._batches([xk], idx, batch_size):
                    with self._guard(state=state, xb=xb):
                        state = step(state, xb)
                return state

            return run

        return self._runner(("hidden_cached", li), build)

    def readout_epoch_cached(self) -> Callable:
        def build():
            step = self.readout_step()

            def run(state, hk, y, idx, batch_size):
                for hb, yb in self._batches([hk, y], idx, batch_size):
                    with self._guard(state=state, hb=hb, yb=yb):
                        state = step(state, hb, yb)
                return state

            return run

        return self._runner("readout_cached", build)

    def sgd_epoch(self, opt, loss_fn: Callable) -> Callable:
        below = self._below_fn(len(self.hidden_layers))
        step = self._register("sgd_step", sgd_step(opt, loss_fn, self._reduce_grads()))

        def run(params, opt_state, hidden_states, x, y, idx, batch_size):
            loss = torch.zeros((), device=self.device)
            for xb, yb in self._batches([x, y], idx, batch_size):
                with self._guard(params=params, opt_state=opt_state,
                                 hidden_states=hidden_states, xb=xb, yb=yb):
                    params, opt_state, loss = step(params, opt_state, below(hidden_states, xb), yb)
            return params, opt_state, loss

        return run

    def sgd_epoch_cached(self, opt, loss_fn: Callable) -> Callable:
        step = self._register("sgd_step_cached", sgd_step(opt, loss_fn, self._reduce_grads()))

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
