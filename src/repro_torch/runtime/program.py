"""Phase programs: training as an explicit, inspectable schedule.

``CompiledNetwork.fit``/``partial_fit`` compile their arguments into a
:class:`TrainProgram`, an ordered tuple of :class:`HiddenPhase`,
:class:`BcpnnReadoutPhase` and :class:`SgdReadoutPhase`, and one driver
(:func:`run_program`) executes it.  Each phase boundary is where a layer
freezes, so the driver projects the dataset once through the newly frozen
prefix (the activation store) and every epoch of the phase gathers from
that level.  Every epoch's history entry splits its wall time into the
host's enqueue span (``host_s``) and the wait for the device at the one
synchronisation that ends the epoch (``device_wait_s``); with an active
tracer (``ExecutionConfig(trace=...)`` or ``compiled.tracing()``) each
entry is also a ``train.<phase>`` span on it, the parent of the epoch's
``layer.step`` spans or of the projection's ``store.project``.  With
``ExecutionConfig(strict=True)`` the state is checked finite
(:func:`check_finite`) after every epoch, after that synchronisation and
outside every dispatch guard.  Under a data-parallel
trainer the trained layer's state is placed (this rank's part) before its
phase's epochs and gathered after them, and the training set's levels are
projected by the batch ranks together.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.runtime import trace


@dataclasses.dataclass(frozen=True)
class HiddenPhase:
    """Unsupervised Hebbian epochs for hidden layer ``li`` (greedy stage)."""

    li: int
    epochs: int


@dataclasses.dataclass(frozen=True)
class BcpnnReadoutPhase:
    """Supervised BCPNN DenseLayer readout on frozen hidden codes."""

    epochs: int


@dataclasses.dataclass(frozen=True)
class SgdReadoutPhase:
    """Hybrid AdamW cross-entropy readout on frozen hidden codes.

    ``reset=False`` resumes the stored head and optimizer moments
    (partial_fit's streamed readout).  ``epochs=0`` still initializes the
    head, as the reference does.
    """

    epochs: int
    lr: float = 1e-3
    reset: bool = True


Phase = Union[HiddenPhase, BcpnnReadoutPhase, SgdReadoutPhase]


@dataclasses.dataclass(frozen=True)
class TrainProgram:
    """An ordered, immutable training schedule."""

    phases: Tuple[Phase, ...]

    def describe(self) -> str:
        """One line, e.g. ``hidden0 x20 -> readout(bcpnn) x10``."""
        parts = []
        for p in self.phases:
            if isinstance(p, HiddenPhase):
                parts.append(f"hidden{p.li} x{p.epochs}")
            elif isinstance(p, BcpnnReadoutPhase):
                parts.append(f"readout(bcpnn) x{p.epochs}")
            else:
                parts.append(f"readout(sgd,lr={p.lr:g}) x{p.epochs}")
        return " -> ".join(parts) if parts else "(empty)"


READOUTS = ("bcpnn", "sgd")


def compile_program(
    n_hidden: int,
    epochs_hidden: Union[int, Sequence[int]],
    epochs_readout: int,
    readout: str = "bcpnn",
    readout_lr: float = 1e-3,
    reset_readout: bool = True,
) -> TrainProgram:
    """Compile fit/partial_fit arguments into a :class:`TrainProgram`.

    ``epochs_hidden`` is one epoch count for every hidden layer or a
    per-layer schedule.  ``readout="sgd"`` appends a
    :class:`SgdReadoutPhase` even at ``epochs_readout=0`` (the head is
    still initialized).
    """
    if readout not in READOUTS:
        raise ValueError(f"Unknown readout {readout!r} (want one of {READOUTS})")
    if isinstance(epochs_hidden, (int, np.integer)):
        schedule = [int(epochs_hidden)] * n_hidden
    else:
        schedule = [int(e) for e in epochs_hidden]
        if len(schedule) != n_hidden:
            raise ValueError(
                f"epochs_hidden schedule has {len(schedule)} entries for "
                f"{n_hidden} hidden layers"
            )
    if any(e < 0 for e in schedule) or epochs_readout < 0:
        raise ValueError("epoch counts must be non-negative")
    phases: List[Phase] = [HiddenPhase(li, e) for li, e in enumerate(schedule) if e > 0]
    if readout == "bcpnn":
        if epochs_readout > 0:
            phases.append(BcpnnReadoutPhase(epochs_readout))
    else:
        phases.append(SgdReadoutPhase(epochs_readout, lr=readout_lr, reset=reset_readout))
    return TrainProgram(tuple(phases))


class ProgramResult(NamedTuple):
    """What the driver learned beyond the layer states it published."""

    sgd_params: Optional[dict]
    sgd_ran: bool
    bcpnn_trained: bool


def run_program(
    net, program: TrainProgram, x, y, n: int, n_total: int, batch_size: int,
    shuffle: bool, verbose: bool, history: List[dict],
) -> ProgramResult:
    """Execute ``program`` against a CompiledNetwork, publishing each layer's
    state onto ``net.state`` as its phase completes; the readout head's
    bookkeeping is returned for the caller to finish."""
    sgd_params, sgd_ran, bcpnn_trained = None, False, False
    for phase in program.phases:
        if isinstance(phase, HiddenPhase):
            _run_hidden_phase(net, phase, x, n, n_total, batch_size, shuffle, verbose, history)
        elif isinstance(phase, BcpnnReadoutPhase):
            bcpnn_trained |= _run_bcpnn_phase(
                net, phase, x, y, n, n_total, batch_size, shuffle, verbose, history
            )
        else:
            sgd_params = _run_sgd_phase(
                net, phase, x, y, n, n_total, batch_size, shuffle, verbose, history
            )
            sgd_ran = True
    return ProgramResult(sgd_params, sgd_ran, bcpnn_trained)


@contextlib.contextmanager
def _timed(history: List[dict], entry: dict, net):
    """Time the block as one history entry, its wall time split into the
    host-side enqueue span (``host_s``) and the device wait at the one
    synchronisation that ends it (``device_wait_s``); ``seconds`` is the
    total.  With an active tracer the block is also a ``train.<phase>``
    span carrying the entry's fields but ``phase`` and ``seconds``."""
    tracer = trace.active()
    span = (contextlib.nullcontext({}) if tracer is None
            else tracer.span(f"train.{entry['phase']}"))
    with span as attrs:
        t0 = time.perf_counter()
        yield
        t1 = time.perf_counter()
        if net.device.type == "cuda":
            # torchlint: allow[TL001] reason=the one sync per phase boundary; it splits host_s from device_wait_s, outside every guard
            torch.cuda.synchronize(net.device)
        t2 = time.perf_counter()
        entry["host_s"] = t1 - t0
        entry["device_wait_s"] = t2 - t1
        entry["seconds"] = t2 - t0
        history.append(entry)
        attrs.update((k, v) for k, v in entry.items() if k not in ("phase", "seconds"))


def check_finite(net, tree, where: str) -> None:
    """Strict mode's finite guard: raise NonFiniteError naming the first
    non-finite leaf of ``tree`` and ``where``, when the network was
    compiled with ``ExecutionConfig(strict=True)``; a no-op otherwise.
    The check reads one scalar back, so call it outside every guard."""
    if net._finite_check is not None:
        net._finite_check(tree, where=where)


def _phase_input(net, level: int, states, x, batch_size, history):
    """The cached level-k projection (project-once), or None on the fused path."""
    store = net.activations
    if store is None:
        return None
    if level == 0:
        return x
    with _timed(history, {"phase": "project", "level": level}, net):
        return store.level(level, states, x, chunk=batch_size, collective=True)


def _run_hidden_phase(net, phase, x, n, n_total, batch_size, shuffle, verbose, history) -> None:
    li = phase.li
    states = list(net.state.layers)
    layer = net.hidden_layers[li]
    state = net.plan.place_state(layer, states[li])
    xk = _phase_input(net, li, states, x, batch_size, history)
    if xk is not None:
        run_epoch = net.plan.hidden_epoch_cached(li)
        step = lambda st, idx: run_epoch(st, xk, idx, batch_size)  # noqa: E731
    else:
        run_epoch = net.plan.hidden_epoch(li)
        below = states[:li]
        step = lambda st, idx: run_epoch(st, below, x, idx, batch_size)  # noqa: E731
    for epoch in range(phase.epochs):
        with _timed(history, {"phase": f"hidden{li}", "epoch": epoch}, net):
            state = step(state, net._epoch_indices(n, n_total, shuffle))
        check_finite(net, state, f"hidden layer {li}, epoch {epoch}")
        if verbose:
            print(f"[fit/{net.plan.name}] hidden layer {li} epoch {epoch + 1}/{phase.epochs}")
    states[li] = net.plan.gather_state(layer, state)
    net.state = net.state._replace(layers=tuple(states))


def _run_bcpnn_phase(net, phase, x, y, n, n_total, batch_size, shuffle, verbose, history) -> bool:
    if net.readout_layer is None:
        return False
    li = len(net.layers) - 1
    states = list(net.state.layers)
    state = net.plan.place_state(net.readout_layer, states[li])
    hk = _phase_input(net, li, states, x, batch_size, history)
    if hk is not None:
        run_epoch = net.plan.readout_epoch_cached()
        step = lambda st, idx: run_epoch(st, hk, y, idx, batch_size)  # noqa: E731
    else:
        run_epoch = net.plan.readout_epoch()
        hidden_states = states[:li]
        step = lambda st, idx: run_epoch(st, hidden_states, x, y, idx, batch_size)  # noqa: E731
    for epoch in range(phase.epochs):
        with _timed(history, {"phase": "readout", "epoch": epoch}, net):
            state = step(state, net._epoch_indices(n, n_total, shuffle))
        check_finite(net, state, f"bcpnn readout epoch {epoch}")
        if verbose:
            print(f"[fit/{net.plan.name}] readout epoch {epoch + 1}/{phase.epochs}")
    states[li] = net.plan.gather_state(net.readout_layer, state)
    net.state = net.state._replace(layers=tuple(states))
    return True


def _run_sgd_phase(net, phase, x, y, n, n_total, batch_size, shuffle, verbose, history) -> dict:
    params, opt_state, run_epoch = net._sgd_setup(y, phase.lr, phase.reset)
    states = list(net.state.layers)
    n_hidden = len(net.hidden_layers)
    hk = _phase_input(net, n_hidden, states, x, batch_size, history)
    if hk is not None:
        step = lambda p, s, idx: run_epoch(p, s, hk, y, idx, batch_size)  # noqa: E731
    else:
        hidden_states = states[:n_hidden]
        step = lambda p, s, idx: run_epoch(p, s, hidden_states, x, y, idx, batch_size)  # noqa: E731
    for epoch in range(phase.epochs):
        with _timed(history, {"phase": "sgd_readout", "epoch": epoch}, net):
            params, opt_state, loss = step(params, opt_state,
                                           net._epoch_indices(n, n_total, shuffle))
        check_finite(net, params, f"sgd readout epoch {epoch}")
        if verbose:
            print(f"[fit/{net.plan.name}] sgd readout epoch {epoch + 1}/{phase.epochs} "
                  f"loss={float(loss):.4f}")
    net._sgd_opt_state = opt_state
    return params


__all__ = [
    "HiddenPhase",
    "BcpnnReadoutPhase",
    "SgdReadoutPhase",
    "TrainProgram",
    "ProgramResult",
    "READOUTS",
    "check_finite",
    "compile_program",
    "run_program",
]
