"""Continual-learning serving tier: online Hebbian updates under live traffic.

The port of the JAX package's ``repro/runtime/continual.py``.  BCPNN's
differentiator over backprop serving stacks is that learning is a cheap,
*local*, streaming update: the same ``train_batch`` the phase programs run
offline can interleave with inference on the serving thread, because there
is no global backward pass to schedule around.  :class:`ContinualPlan`
(``ServiceConfig(continual=ContinualConfig(...))``) extends the batched
classification plan with a ``learn()`` capability driven by labeled
:class:`Feedback` requests.

The lifecycle, per feedback sample:

1. **Prequential evaluation**: predict *first* with the feedback tenant's
   view of the network (base layers + that tenant's adapter), record
   correct/confidence into the telemetry
   :class:`~repro_torch.runtime.metrics.DriftWindow`, then learn.
   Evaluation therefore never sees a sample the adapter already trained
   on.  The score row is read back to the host for every sample.
2. **Micro-batching**: samples accumulate host-side per tenant; every
   ``update_batch``-th sample triggers ONE Hebbian ``train_batch`` of the
   adapted layer on the micro-batch (through the frozen prefix
   ``forward_stack`` of the layers below it).  Only full micro-batches
   train.  A per-interval ``update_budget`` bounds how much any tenant can
   move its adapter between merges; excess micro-batches are shed and
   counted.
3. **Adapter merge**: every ``merge_every`` applied updates, the per-tenant
   adapters (``clone()``s of the designated layer's ``LayerState``) merge
   into the shared base state: marginal traces are averaged under a
   pluggable weighting (:data:`MERGE_STRATEGIES`; the default ``"trace"``
   weights the base by the batches it has absorbed and each adapter by the
   updates it applied), weights/biases are *recomputed* from the merged
   marginals (``weights_from_marginals``), and the base's
   structural-plasticity mask is re-applied (``unit_mask``).  The merged
   traces are f32 whatever the traces' storage dtype, as the reference's
   weighted average promotes bf16 traces to f32.  The step counter and its
   host mirror both advance by the updates merged.  Adoption publishes a
   new ``NetworkState`` and eagerly fires ``ActivationStore.
   invalidate_above(layer)`` so cached levels above the learned layer never
   go stale (nor pin dead device bytes).  The merge launches no kernel.
4. **Safety loop**: each merge snapshots base+adapters through the
   checkpoint manifest (``snapshot_dir``) and becomes a *candidate*: the
   drift window restarts and must refill healthily (accuracy within
   ``drift_threshold`` of the last-good baseline) before the merge is
   confirmed.  A degraded window raises the typed :class:`DriftDetected`
   on the telemetry surface and, when a candidate is pending, rolls the
   base and every adapter back to the last-good snapshot.  All in-flight
   futures resolve across a rollback: shed/rolled-back feedback still gets
   its ack; only *future* work is refused (the Router's shed-on-drift).

Thread model: one consumer (the async engine's executor thread, or the
caller on the sync drain path) runs ``learn``/``predict``; device work is
staged lock-free and bookkeeping commits under the plan lock, so stat
readers on other threads never see torn state and the non-reentrant plan
lock is never held across a launch.  Give each continual engine its own
``CompiledNetwork``: a merge or a rollback swaps ``compiled.state``, so
another engine over the same network would serve, and train its adapters
from, a base it did not choose.

Strict mode (``ServiceConfig(strict=True)``): the tenant-view forward,
the frozen-prefix projection, the Hebbian update and each merge run
under the dispatch guard, their rows staged on the device first; the
recompile sentinel watches ``continual_update``, ``continual_view``,
``continual_prefix`` and one ``continual_merge[n]`` per contributor count
beside the batched plan's callables (:meth:`ContinualPlan._strict_registry`);
each update and merge is checked finite.  As the reference does, a strict
plan predicts one zero row at bind time, so the head meets its row-sized
signature before the sentinel's first baseline.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.strict import counted, dispatch_guard, finite_checker
from repro_torch.core.layers import DenseLayer, LayerState
from repro_torch.core.learning import MarginalState, weights_from_marginals
from repro_torch.runtime.epoch_engine import forward_stack
from repro_torch.runtime.metrics import ServiceMetrics
from repro_torch.runtime.program import check_finite
from repro_torch.runtime.service import SERVE_PLANS, BatchedPlan, ServiceConfig
from repro_torch.runtime.trace import DriftDetected as DriftDetectedEvent
from repro_torch.runtime.trace import MergeApplied, RollbackApplied


# ------------------------------------------------------------------ errors
class DriftDetected(RuntimeError):
    """The serving accuracy window degraded past the configured threshold
    against the last-good baseline.  Raised by :meth:`ContinualPlan.
    check_drift` and used by the Router to shed work from drifting engines;
    the plan's internal safety loop converts it into a rollback instead of
    letting it escape a ``learn()`` call."""

    def __init__(self, baseline_accuracy: float, accuracy: float,
                 samples: int, threshold: float):
        self.baseline_accuracy = baseline_accuracy
        self.accuracy = accuracy
        self.samples = samples
        self.threshold = threshold
        super().__init__(
            f"drift detected: window accuracy {accuracy:.3f} over "
            f"{samples} samples vs baseline {baseline_accuracy:.3f} "
            f"(threshold {threshold:.3f})"
        )


# ----------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class ContinualConfig:
    """Everything about *how* a served network keeps learning.

    layer:           which layer's ``LayerState`` the per-tenant adapters
                     fork (absolute index into ``compiled.layers``; negative
                     indexes from the end, so the default ``-1`` adapts the
                     readout of a pure-BCPNN stack or the top hidden layer).
    update_batch:    feedback micro-batch size: one ``train_batch`` per
                     ``update_batch`` buffered samples.
    update_budget:   max applied updates per tenant per merge interval;
                     excess micro-batches are shed (``updates_shed``).
    merge_every:     applied updates (across tenants) between adapter->base
                     merges.
    merge_strategy:  key into :data:`MERGE_STRATEGIES`: how base and
                     adapter marginals are weighted at merge.
    drift_window:    ring size of the prequential accuracy/confidence
                     window.
    drift_min_samples: observations before the window may freeze a baseline,
                     confirm a merge candidate, or signal drift.
    drift_threshold: accuracy drop (baseline - current) that counts as
                     drift.
    rollback:        roll a pending merge back when the post-merge window
                     drifts (False: detect + count only).
    snapshot_dir:    checkpoint directory for base+adapter manifests written
                     at every merge (None: in-memory last-good only).
    snapshot_retain: manifests kept in ``snapshot_dir``.
    """

    layer: int = -1
    update_batch: int = 8
    update_budget: int = 32
    merge_every: int = 4
    merge_strategy: str = "trace"
    drift_window: int = 64
    drift_min_samples: int = 16
    drift_threshold: float = 0.25
    rollback: bool = True
    snapshot_dir: Optional[str] = None
    snapshot_retain: int = 3

    def __post_init__(self):
        for name in ("update_batch", "update_budget", "merge_every",
                     "drift_window", "drift_min_samples", "snapshot_retain"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.drift_min_samples > self.drift_window:
            raise ValueError(
                f"drift_min_samples ({self.drift_min_samples}) must be <= "
                f"drift_window ({self.drift_window})"
            )
        if self.drift_threshold <= 0:
            raise ValueError(
                f"drift_threshold must be > 0, got {self.drift_threshold}"
            )
        if self.merge_strategy not in MERGE_STRATEGIES:
            raise ValueError(
                f"Unknown merge_strategy {self.merge_strategy!r} "
                f"(want one of {sorted(MERGE_STRATEGIES)})"
            )


@dataclasses.dataclass
class Feedback:
    """One labeled feedback sample.  Submitting this to a continual service
    (instead of a plain input row) routes it to ``learn()``: prequential
    drift evaluation, then accumulation into ``tenant``'s adapter."""

    x: Any  # (features,) input row
    y: int  # class label
    tenant: str = "default"
    # Fabric trace id, stamped by the Router/engine front door when tracing
    # is on; correlates this sample's learn/merge spans and journal events.
    trace_id: Optional[int] = None


# -------------------------------------------------------- merge strategies
def _trace_weights(base_weight: float, applied: List[int]) -> List[float]:
    """Trace-weighted average: the base counts the train batches it has
    absorbed (so a long-lived base is hard to displace), each adapter counts
    the updates it applied this interval."""
    return [max(base_weight, 1.0)] + [float(a) for a in applied]


def _mean_weights(base_weight: float, applied: List[int]) -> List[float]:
    """Uniform average of base and every contributing adapter."""
    return [1.0] * (1 + len(applied))


def _replace_weights(base_weight: float, applied: List[int]) -> List[float]:
    """Adapters displace the base outright (update-count weighted among
    themselves): the aggressive end of the spectrum, and the deterministic
    single-tenant case (merged state == adapter state, bit-exact)."""
    return [0.0] + [float(a) for a in applied]


# name -> (base_weight, per-adapter applied counts) -> per-contributor weights
MERGE_STRATEGIES: Dict[str, Callable[[float, List[int]], List[float]]] = {
    "trace": _trace_weights,
    "mean": _mean_weights,
    "replace": _replace_weights,
}


def merge_states(spec, states: Tuple[LayerState, ...], weights: List[float],
                 step_inc: int) -> LayerState:
    """Fold ``states`` (the base first, then the contributing adapters)
    into one LayerState: the ``weights``-weighted average of each marginal
    trace, computed in f32 (bf16 traces are widened), then w and b
    recomputed from the merged traces and the base's plasticity mask
    re-applied; the step counter and its host mirror advance by
    ``step_inc``."""
    wsum = float(np.sum(np.asarray(weights, np.float32)))

    def average(leaves):
        acc = None
        for wk, leaf in zip(weights, leaves):
            term = float(wk) * leaf.float()
            acc = term if acc is None else acc + term
        return acc / wsum

    merged = MarginalState(*(average(leaves) for leaves in zip(*(s.marginals for s in states))))
    w, b = weights_from_marginals(merged, spec.k_b)
    base = states[0]
    if base.plast is not None:
        w = w * base.plast.unit_mask(spec.pre, spec.post)
    return LayerState(merged, w, b, base.plast, base.step + step_inc,
                      host_step=base.host_step + step_inc)


# ---------------------------------------------------------------- adapters
@dataclasses.dataclass
class _Adapter:
    """One tenant's fork of the adapted layer plus its host-side buffers."""

    state: LayerState
    buf_x: List[np.ndarray] = dataclasses.field(default_factory=list)
    buf_y: List[int] = dataclasses.field(default_factory=list)
    applied: int = 0  # updates applied since the last merge/rollback
    shed: int = 0  # micro-batches shed by the budget (lifetime)


# -------------------------------------------------------------------- plan
class ContinualPlan(BatchedPlan):
    """Batched BCPNN serving that keeps learning from labeled feedback.

    Inference (``predict``/``infer``) is inherited unchanged from
    :class:`BatchedPlan`; with ``continual`` disabled nothing here runs.
    ``learn()`` adds the online tier described in the module docstring.
    """

    name = "continual"

    def __init__(self, compiled, config: ServiceConfig,
                 metrics: Optional[ServiceMetrics] = None):
        super().__init__(compiled, config, metrics)
        cc = config.continual if config.continual is not None else ContinualConfig()
        self.cc = cc
        n_layers = len(compiled.layers)
        li = cc.layer if cc.layer >= 0 else n_layers + cc.layer
        if not 0 <= li < n_layers:
            raise ValueError(
                f"ContinualConfig.layer={cc.layer} out of range for "
                f"{n_layers} layers"
            )
        self._li = li
        self._layer = compiled.layers[li]
        self._supervised = isinstance(self._layer, DenseLayer)
        if (self._supervised and li == n_layers - 1
                and compiled.state.readout is not None):
            raise ValueError(
                "the hybrid SGD readout overrides the DenseLayer readout at "
                "inference; adapt a hidden layer instead"
            )
        strict = config.strict
        layer = self._layer
        if self._supervised:
            self._update = counted(lambda s, xk, yb: layer.train_batch(s, xk, yb)[0], strict)
        else:
            self._update = counted(lambda s, xk: layer.train_batch(s, xk)[0], strict)
        # The frozen prefix maps feedback rows to the adapted layer's input
        # code: below-li layers never change in this tier, so the prefix
        # states are always the live base states.
        self._prefix = counted(forward_stack(compiled.layers[:li]), strict) if li > 0 else None
        # Tenant view: the full stack with the adapter substituted at li, a
        # private callable, so the compiled network's own forward keeps its
        # strict baseline.  (core.compiled imports this package's modules,
        # so not at the top.)
        from repro_torch.core.compiled import build_forward

        self._view_fwd = counted(build_forward(compiled.layers), strict)
        self._merge_cells: Dict[int, Callable] = {}  # contributors -> merge
        self._finite_check = finite_checker() if strict else None
        # --- host-side bookkeeping (commits under the plan lock) ---------
        self._adapters: Dict[str, _Adapter] = {}
        base_state = compiled.state.layers[li]
        # The host mirror of the step counter seeds the merge weighting
        # (the trace-weighted average's base mass): no device read.
        self._base_weight = float(base_state.host_step)
        self._applied_since_merge = 0
        self._merge_seq = 0
        self._drifting = False
        # (base LayerState, {tenant: adapter LayerState}, base_weight) of
        # the last configuration that measured healthy: the rollback unit.
        self._last_good: Tuple[LayerState, Dict[str, LayerState], float] = (
            base_state, {}, self._base_weight,
        )
        self._pending: Optional[
            Tuple[LayerState, Dict[str, LayerState], float]
        ] = None
        self.metrics.configure_drift(
            cc.drift_window, cc.drift_min_samples, cc.drift_threshold
        )
        if strict:
            # The per-item surface runs the head at the one-row bucket,
            # while a preceding fit or evaluate ran it at their chunk
            # sizes: meet that signature now, before the sentinel's first
            # baseline, as the reference warms its row-shaped traces.
            pre = compiled.layers[0].spec.pre
            self._scores(np.zeros((config.bucket_for(1), pre.n_units), np.float32))

    # ----------------------------------------------------------- lifecycle
    def learn(self, fb: Feedback) -> Dict[str, Any]:
        """One feedback sample: evaluate prequentially, buffer, maybe apply
        a micro-batch update, maybe merge, run the drift safety loop.
        Always returns an ack dict: feedback futures resolve even across a
        rollback."""
        if not isinstance(fb, Feedback):
            raise TypeError(f"learn() wants a Feedback, got {type(fb).__name__}")
        x = np.asarray(fb.x, np.float32)
        if x.ndim != 1:
            raise ValueError(f"Feedback.x must be one row, got shape {x.shape}")
        ad = self._adapter(fb.tenant)
        tid = fb.trace_id
        correct, confidence = self._observe(ad, x, int(fb.y))
        # The safety loop runs on the PRE-merge window, before this sample
        # can trigger an update or merge: a merge resets the window, so
        # baseline freezing and candidate confirm/rollback must happen
        # while the window still measures the state that produced it.
        rolled_back = self._drift_step(tenant=fb.tenant, trace_id=tid)
        ad.buf_x.append(x)
        ad.buf_y.append(int(fb.y))
        applied = shed = False
        if len(ad.buf_x) >= self.cc.update_batch:
            if ad.applied >= self.cc.update_budget:
                shed = True
                ad.buf_x, ad.buf_y = [], []
                ad.shed += 1
                self.metrics.updates_shed.inc()
            else:
                self._apply_update(ad, tenant=fb.tenant, trace_id=tid)
                applied = True
        merged = False
        if self._applied_since_merge >= self.cc.merge_every:
            self._merge(tenant=fb.tenant, trace_id=tid)
            merged = True
        self._strict_check("learn")
        return {
            "tenant": fb.tenant,
            "correct": correct,
            "confidence": confidence,
            "applied": applied,
            "shed": shed,
            "merged": merged,
            "rolled_back": rolled_back,
        }

    def infer(self, sample) -> torch.Tensor:
        """Single-row class scores on the compiled device (the async
        engine's per-item path)."""
        return self.predict(sample)[0]

    # ------------------------------------------------------------ internals
    def _adapter(self, tenant: str) -> _Adapter:
        ad = self._adapters.get(tenant)
        if ad is None:
            ad = _Adapter(state=self.compiled.state.layers[self._li].clone())
            with self._lock:
                self._adapters[tenant] = ad
        return ad

    def _view_states(self, ad: _Adapter) -> Tuple[Any, ...]:
        states = list(self.compiled.state.layers)
        states[self._li] = ad.state
        return tuple(states)

    def _observe(self, ad: _Adapter, x: np.ndarray, y: int
                 ) -> Tuple[bool, float]:
        """Prequential drift observation through the tenant's view."""
        xd = torch.from_numpy(x[None, :]).to(self.device)
        states, readout = self._view_states(ad), self.compiled.state.readout
        with dispatch_guard(self.config.strict, self.device,
                            {"states": states, "readout": readout, "x": xd}):
            scores = self._view_fwd(states, readout, xd)
        # torchlint: allow[TL001] reason=prequential evaluation reads one score row per feedback sample, outside the guard
        row = scores[0].cpu().numpy()
        pred = int(np.argmax(row))
        z = np.exp(row - row.max())
        confidence = float(z.max() / z.sum())
        correct = pred == y
        self.metrics.drift.observe(correct, confidence)
        return correct, confidence

    def _apply_update(self, ad: _Adapter, tenant: Optional[str] = None,
                      trace_id: Optional[int] = None) -> None:
        """One Hebbian micro-batch step on the tenant's adapter."""
        t0 = time.perf_counter()
        xb = np.stack(ad.buf_x)
        yb = ad.buf_y
        ad.buf_x, ad.buf_y = [], []
        xd = torch.from_numpy(xb).to(self.device)
        yd = torch.tensor(yb, dtype=torch.int32, device=self.device) if self._supervised else None
        prefix_states = tuple(self.compiled.state.layers[: self._li])
        with dispatch_guard(self.config.strict, self.device,
                            {"state": ad.state, "prefix": prefix_states, "x": xd, "y": yd}):
            xk = xd if self._prefix is None else self._prefix(prefix_states, xd)
            if self._supervised:
                new_state = self._update(ad.state, xk, yd)
            else:
                new_state = self._update(ad.state, xk)
        check_finite(self, new_state, f"continual update (layer {self._li})")
        with self._lock:
            ad.state = new_state
            ad.applied += 1
            self._applied_since_merge += 1
        self.metrics.online_updates.inc()
        t1 = time.perf_counter()
        self.metrics.update_s.observe(t1 - t0)
        if self.tracer is not None and trace_id is not None:
            self.tracer.record(
                trace_id, "plan.update", t0, t1,
                tenant=tenant, batch=int(xb.shape[0]),
            )

    def _merge(self, tenant: Optional[str] = None,
               trace_id: Optional[int] = None) -> None:
        """Fold every contributing adapter into the base, snapshot, adopt,
        re-fork.  The merged state is a *candidate* until the drift window
        refills healthily.  A merge landing while an earlier candidate is
        still unconfirmed supersedes it (last-good then lags several
        merges and a rollback reverts all of them), so size
        ``drift_min_samples <= merge_every * update_batch`` when per-merge
        confirmation is wanted."""
        t0 = time.perf_counter()
        contributors = [
            (name, ad)
            for name, ad in sorted(self._adapters.items())
            if ad.applied > 0
        ]
        if not contributors:
            with self._lock:
                self._applied_since_merge = 0
            return
        applied = [ad.applied for _, ad in contributors]
        strategy = MERGE_STRATEGIES[self.cc.merge_strategy]
        base_state = self.compiled.state.layers[self._li]
        states = (base_state,) + tuple(ad.state for _, ad in contributors)
        merge = self._merge_cells.get(len(states))
        if merge is None:
            spec = self._layer.spec
            merge = counted(lambda st, w, inc: merge_states(spec, st, w, inc), self.config.strict)
            with self._lock:
                self._merge_cells[len(states)] = merge
        with dispatch_guard(self.config.strict, self.device, {"states": states}):
            merged = merge(states, strategy(self._base_weight, applied), sum(applied))
        check_finite(self, merged, "continual merge")
        forks = {name: merged.clone() for name, _ in contributors}
        with self._lock:
            self._merge_seq += 1
            self._base_weight += float(sum(applied))
            self._applied_since_merge = 0
            self._pending = (merged, dict(forks), self._base_weight)
            seq = self._merge_seq
            for name, ad in self._adapters.items():
                f = forks.get(name)
                ad.state = f if f is not None else merged.clone()
                ad.applied = 0
        self._adopt(merged)
        if self.cc.snapshot_dir is not None:
            from repro_torch.checkpoint.network import save_network

            save_network(
                self.cc.snapshot_dir, seq, self.compiled.state,
                retain=self.cc.snapshot_retain,
                adapters={name: ad.state for name, ad in
                          sorted(self._adapters.items())},
                adapter_layer=self._li,
            )
        self.metrics.merges.inc()
        if self.tracer is not None:
            t1 = time.perf_counter()
            if trace_id is not None:
                self.tracer.record(
                    trace_id, "plan.merge", t0, t1,
                    tenant=tenant, contributors=len(contributors),
                )
            self.tracer.emit(
                MergeApplied(
                    merges=seq,
                    strategy=self.cc.merge_strategy,
                    trace_id=trace_id,
                    tenant=tenant,
                )
            )
        # The post-merge window measures the candidate from scratch; the
        # baseline stays frozen at the last-good window.
        self.metrics.drift.reset_current()

    def _adopt(self, li_state: LayerState) -> None:
        """Publish a new state for the adapted layer and eagerly invalidate
        every cached activation level above it."""
        with self._lock:
            layers = list(self.compiled.state.layers)
            layers[self._li] = li_state
            self.compiled.state = self.compiled.state._replace(layers=tuple(layers))
        store = self.compiled.activations
        if store is not None:
            store.invalidate_above(self._li)

    def _drift_step(self, tenant: Optional[str] = None,
                    trace_id: Optional[int] = None) -> bool:
        """The safety loop: freeze the first baseline, confirm a healthy
        merge candidate, or detect drift and roll a pending merge back.
        Returns True when a rollback happened."""
        dw = self.metrics.drift
        if dw.baseline_samples == 0:
            if dw.samples >= dw.min_samples:
                dw.freeze_baseline()
            return False
        if dw.samples < dw.min_samples:
            return False
        try:
            self.check_drift()
        except DriftDetected as exc:
            with self._lock:
                first = not self._drifting
                self._drifting = True
                pending = self._pending
            if first:
                self.metrics.drift_events.inc()
                if self.tracer is not None:
                    self.tracer.emit(
                        DriftDetectedEvent(
                            accuracy=exc.accuracy,
                            baseline_accuracy=exc.baseline_accuracy,
                            samples=exc.samples,
                            trace_id=trace_id,
                            tenant=tenant,
                        )
                    )
            if pending is not None and self.cc.rollback:
                self._rollback(tenant=tenant, trace_id=trace_id)
                return True
            return False
        with self._lock:
            self._drifting = False
            pending, self._pending = self._pending, None
            if pending is not None:
                self._last_good = pending
        if pending is not None:
            # The candidate measured healthy: its window becomes the new
            # baseline.
            dw.freeze_baseline()
        return False

    def check_drift(self) -> None:
        """Raise :class:`DriftDetected` when the current window degraded
        past the threshold against the baseline; no-op otherwise."""
        dw = self.metrics.drift
        if dw.drifted():
            snap = dw.snapshot()
            raise DriftDetected(
                baseline_accuracy=snap["baseline_accuracy"],
                accuracy=snap["accuracy"],
                samples=snap["samples"],
                threshold=dw.threshold,
            )

    def _rollback(self, tenant: Optional[str] = None,
                  trace_id: Optional[int] = None) -> None:
        """Restore base + every adapter to the last-good configuration."""
        with self._lock:
            base, adapters, base_weight = self._last_good
            self._pending = None
            self._drifting = False
            self._base_weight = base_weight
            self._applied_since_merge = 0
            for name, ad in self._adapters.items():
                ad.state = adapters.get(name, base).clone()
                ad.applied = 0
                ad.buf_x, ad.buf_y = [], []
        self._adopt(base)
        self.metrics.rollbacks.inc()
        if self.tracer is not None:
            self.tracer.emit(
                RollbackApplied(
                    rollbacks=self.metrics.rollbacks.value,
                    trace_id=trace_id,
                    tenant=tenant,
                )
            )
        self.metrics.drift.reset_current()

    # ------------------------------------------------------------- surfaces
    def _strict_registry(self) -> Dict[str, Any]:
        reg = super()._strict_registry()
        reg["continual_update"] = self._update
        reg["continual_view"] = self._view_fwd
        if self._prefix is not None:
            reg["continual_prefix"] = self._prefix
        with self._lock:
            cells = dict(self._merge_cells)
        for n, fn in cells.items():
            reg[f"continual_merge[{n}]"] = fn
        return reg

    @property
    def drifting(self) -> bool:
        """True while the current window reads degraded: the Router's
        shed-on-drift signal."""
        with self._lock:
            return self._drifting

    @property
    def stats(self) -> Dict[str, Any]:
        out = BatchedPlan.stats.fget(self)
        with self._lock:
            out.update({
                "tenants": sorted(self._adapters),
                "applied_since_merge": self._applied_since_merge,
                "merges": self._merge_seq,
                "drifting": self._drifting,
            })
        return out

    def close(self) -> None:
        """Partial (sub-``update_batch``) buffers are deliberately dropped:
        only full micro-batches ever train, which keeps online and offline
        replay of the same rows identical."""
        with self._lock:
            for ad in self._adapters.values():
                ad.buf_x, ad.buf_y = [], []


# Register with the serving-plan registry: ``ServiceConfig(plan="continual")``
# and the ``continual=`` shorthand both resolve here.
SERVE_PLANS[ContinualPlan.name] = ContinualPlan


__all__ = [
    "ContinualConfig",
    "ContinualPlan",
    "DriftDetected",
    "Feedback",
    "MERGE_STRATEGIES",
    "merge_states",
]
