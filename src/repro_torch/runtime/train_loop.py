"""Fault-tolerant training loop.

The port of ``repro/runtime/train_loop.py``, every behaviour kept:

* **resume**: a run whose checkpoint directory holds a checkpoint starts
  from the latest one;
* **checkpoint/restart**: checkpoints every ``ckpt_every`` steps
  (``AsyncCheckpointer``: a host copy, then a write on a thread); on any
  failure of a step the loop restores the latest checkpoint and replays
  from there, or, with none on disk yet, from a copy of the state it
  started from (the live tensors may already be ahead);
* **a failure budget for each step**: a step that fails more than
  ``max_retries`` times is a hard fault, and its exception is raised;
* **stragglers**: each step's wall time feeds an EMA; a step slower than
  ``straggler_factor`` x the EMA is counted and reported to
  ``on_straggler(step, dt, ema)``;
* **history**: the metrics of rolled-back steps are dropped, so it stays
  monotonic in ``step``; each step's metrics are read to the host once,
  all together (one device sync a step).

``batch_fn(step)`` must give the same batch for the same step, so a
replay consumes exactly the batches the first pass did.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.optim.adamw import tree_map


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    ckpt_retain: int = 3
    max_retries: int = 3
    straggler_factor: float = 3.0
    ema_alpha: float = 0.1
    log_every: int = 10


@dataclasses.dataclass
class TrainLoopResult:
    steps_done: int
    restarts: int
    straggler_events: int
    metrics: List[Dict[str, float]]
    mean_step_s: float


def _copy_tree(tree):
    return tree_map(lambda a: a.clone() if isinstance(a, torch.Tensor) else a, tree)


def _host_metrics(metrics: Dict[str, Any]) -> Dict[str, float]:
    """The step's metrics as Python floats, the tensors read in one copy."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: float(v) for k, v in metrics.items() if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].detach().reshape(()).to(torch.float64) for k in keys])
        out.update(zip(keys, vals.tolist()))
    return {k: out[k] for k in metrics}


def train_loop(
    step_fn: Callable,  # (params, opt_state, batch) -> (params, opt_state, metrics)
    params: Any,
    opt_state: Any,
    batch_fn: Callable[[int], Any],  # step -> batch (deterministic replay)
    cfg: TrainLoopConfig,
    on_straggler: Optional[Callable[[int, float, float], None]] = None,
    fail_injector: Optional[Callable[[int], None]] = None,
) -> TrainLoopResult:
    """Run to ``cfg.total_steps`` with checkpoint/restart and straggler
    telemetry.  ``fail_injector(step)`` may raise to simulate a node's
    failure (tests)."""
    # Imported here: the checkpoint package imports the core, which imports
    # this package.
    from repro_torch.checkpoint.store import (
        AsyncCheckpointer,
        latest_checkpoint,
        restore_checkpoint,
    )

    ckpt = AsyncCheckpointer(cfg.ckpt_dir, cfg.ckpt_retain) if cfg.ckpt_dir else None
    start_step = 0
    if cfg.ckpt_dir:
        latest = latest_checkpoint(cfg.ckpt_dir)
        if latest is not None:
            start_step, path = latest
            state = restore_checkpoint(path, {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]

    # The true step-``start_step`` state: a failure before the first
    # checkpoint lands replays from here, not from the live tensors.
    initial_snapshot = _copy_tree({"params": params, "opt": opt_state})

    metrics_hist: List[Dict[str, float]] = []
    restarts = 0
    straggler_events = 0
    ema: Optional[float] = None
    fail_counts: Dict[int, int] = {}
    step = start_step
    t_total0 = time.perf_counter()
    steps_timed = 0

    while step < cfg.total_steps:
        batch = batch_fn(step)
        t0 = time.perf_counter()
        try:
            if fail_injector is not None:
                fail_injector(step)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            metrics = _host_metrics(metrics)
        except Exception:
            restarts += 1
            fail_counts[step] = fail_counts.get(step, 0) + 1
            if fail_counts[step] > cfg.max_retries or not cfg.ckpt_dir:
                if ckpt:
                    ckpt.wait()
                raise
            latest = latest_checkpoint(cfg.ckpt_dir)
            if latest is not None:
                ckpt_step, path = latest
                state = restore_checkpoint(path, {"params": params, "opt": opt_state})
                step = ckpt_step
            else:
                state = _copy_tree(initial_snapshot)
                step = start_step
            params, opt_state = state["params"], state["opt"]
            metrics_hist = [m for m in metrics_hist if m["step"] < step]
            continue

        dt = time.perf_counter() - t0
        steps_timed += 1
        if ema is not None and dt > cfg.straggler_factor * ema:
            straggler_events += 1
            if on_straggler is not None:
                on_straggler(step, dt, ema)
        ema = dt if ema is None else (1 - cfg.ema_alpha) * ema + cfg.ema_alpha * dt

        metrics["step"] = step
        metrics["step_time_s"] = dt
        metrics_hist.append(metrics)
        step += 1

        if ckpt and (step % cfg.ckpt_every == 0 or step == cfg.total_steps):
            ckpt.save(step, {"params": params, "opt": opt_state})

    if ckpt:
        ckpt.wait()
    wall = time.perf_counter() - t_total0
    return TrainLoopResult(
        steps_done=step - start_step,
        restarts=restarts,
        straggler_events=straggler_events,
        metrics=metrics_hist,
        mean_step_s=wall / max(steps_timed, 1),
    )
