"""Serving telemetry: monotonic counters, gauges, percentile histograms.

A copy of the JAX package's ``repro/runtime/metrics.py`` (it is pure numpy
and threading).  The serving subsystem (sync ``InferenceService`` drains,
the :mod:`repro_torch.runtime.engine` async loops, and the
:mod:`repro_torch.runtime.router` fleet scheduler) records where every
request's wall-time goes (queue wait, prefill, per-token decode,
micro-batch execution, online updates, end to end) into one
:class:`ServiceMetrics` bundle shared by the plan, the service front door
and the engine; ``service.stats["telemetry"]`` (and the
``launch/serve.py`` command line) surfaces the snapshot, and the Router
reads per-engine ``queue_wait_s`` percentiles to pick the least-loaded
engine.

Design constraints, in order:

* **Cheap on the hot path.**  ``observe()`` is an append into a fixed-size
  ring plus two scalar updates under a lock — no sorting, no allocation
  growth.  Percentiles are computed only when a snapshot is asked for.
* **Thread-safe.**  Async submitters hammer ``Counter.inc`` and the engine
  thread records latencies concurrently; every instrument takes a lock.
* **Consistent snapshots.**  All instruments of one bundle share the
  bundle's re-entrant lock, so :meth:`ServiceMetrics.snapshot` reads every
  counter and histogram inside ONE critical section — a reader comparing
  ``submitted`` against ``completed`` never sees a torn read where events
  landed between field reads.  Standalone instruments default to a private lock.
* **Bounded memory.**  Histograms keep the last ``window`` observations
  (default 2048); ``count``/``sum`` stay exact over the full lifetime, so
  throughput math never loses events while percentile estimates track
  *recent* behavior — which is what a latency SLO wants anyway.

Percentiles use numpy's default linear interpolation over the retained
window, so ``Histogram.percentile(p)`` equals ``np.percentile(window, p)``
exactly (asserted in tests).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np


class Counter:
    """A monotonic event counter.

    ``lock`` lets a bundle (:class:`ServiceMetrics`, :class:`RouterMetrics`)
    share ONE re-entrant lock across its instruments so bundle snapshots are
    point-in-time consistent; standalone counters default to a private lock.
    """

    _TORCHLINT_LOCKS = ("_lock",)  # TL004: the lock may arrive as a parameter

    def __init__(self, lock: Optional[Any] = None) -> None:
        self._lock = lock if lock is not None else threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"Counter.inc must be monotonic, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """A point-in-time value (queue depth, active slots)."""

    _TORCHLINT_LOCKS = ("_lock",)  # TL004: the lock may arrive as a parameter

    def __init__(self, lock: Optional[Any] = None) -> None:
        self._lock = lock if lock is not None else threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, dv: float) -> None:
        with self._lock:
            self._value += float(dv)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Windowed latency histogram with exact-over-window percentiles.

    The last ``window`` observations live in a preallocated ring;
    ``count``/``sum``/``max`` are exact over every observation ever made.
    """

    _TORCHLINT_LOCKS = ("_lock",)  # TL004: the lock may arrive as a parameter

    def __init__(self, window: int = 2048, lock: Optional[Any] = None) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self._lock = lock if lock is not None else threading.Lock()
        self._ring = np.empty(window, np.float64)
        self._window = window
        # Ring bookkeeping is decoupled from the lifetime count: merge()
        # folds another histogram's window in without claiming its whole
        # lifetime happened here, so `filled slots` cannot be derived from
        # `_n` alone.
        self._pos = 0  # next write slot
        self._len = 0  # filled slots (<= window)
        self._n = 0  # lifetime observation count
        self._sum = 0.0
        self._max = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._ring[self._pos] = v
            self._pos = (self._pos + 1) % self._window
            if self._len < self._window:
                self._len += 1
            self._n += 1
            self._sum += v
            if v > self._max:
                self._max = v

    def _window_values(self) -> np.ndarray:
        return self._ring[: self._len].copy()

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold ``other``'s retained window and lifetime totals into this
        histogram (RouterMetrics uses this to expose fabric-wide latency
        quantiles across per-engine bundles).

        Both locks are taken, ordered by ``id()`` so two threads merging
        opposite directions cannot deadlock; instruments sharing one
        bundle lock (re-entrant) acquire it once.  When the combined
        windows exceed this histogram's capacity the most recent slice
        (``other``'s window is treated as newer) is kept — size the
        destination window to the sum of the sources for exact
        concatenated-window percentiles.
        """
        if other is self:
            raise ValueError("cannot merge a Histogram into itself")
        if self._lock is other._lock:
            with self._lock:
                self._merge_from_locked(other)
            return self
        first, second = (
            (self, other) if id(self._lock) < id(other._lock)
            else (other, self)
        )
        with first._lock:
            with second._lock:
                self._merge_from_locked(other)
        return self

    def _merge_from_locked(self, other: "Histogram") -> None:
        # Caller holds both locks.  Oldest-first order within each source
        # window, self's (older) values ahead of other's.
        mine = np.concatenate(
            (self._ring[self._pos: self._len], self._ring[: self._pos])
        ) if self._len == self._window else self._ring[: self._len]
        theirs = np.concatenate(
            (other._ring[other._pos: other._len], other._ring[: other._pos])
        ) if other._len == other._window else other._ring[: other._len]
        combined = np.concatenate((mine, theirs))[-self._window:]
        self._ring[: combined.size] = combined
        self._len = int(combined.size)
        self._pos = self._len % self._window
        self._n += other._n
        self._sum += other._sum
        if other._max > self._max:
            self._max = other._max

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, p: float) -> float:
        """``np.percentile`` (linear interpolation) over the retained
        window; 0.0 before any observation."""
        with self._lock:
            vals = self._window_values()
        if vals.size == 0:
            return 0.0
        return float(np.percentile(vals, p))

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            vals = self._window_values()
            n, s, mx = self._n, self._sum, self._max
        if vals.size == 0:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p95": 0.0,
                    "p99": 0.0, "max": 0.0}
        p50, p95, p99 = (float(x) for x in np.percentile(vals, (50, 95, 99)))
        return {
            "count": n,
            "mean": s / n,
            "p50": p50,
            "p95": p95,
            "p99": p99,
            "max": mx,
        }


class DriftWindow:
    """Windowed accuracy/confidence tracker for online-learning drift checks.

    The continual tier (:mod:`repro_torch.runtime.continual`) evaluates every
    feedback sample *prequentially* — predict first, then learn — and records
    whether the prediction was correct plus its confidence here.  Two views
    exist side by side:

    * the **current window**: a fixed-size ring of the most recent
      observations since the last reset (resets happen on merge adoption and
      on rollback, so the window always measures the *currently served*
      state);
    * the **baseline**: the frozen summary of the last window that was
      measured against a known-good state (frozen on first fill and
      re-frozen when a merge candidate is confirmed healthy).

    ``drifted()`` is the one decision surface: the current window has at
    least ``min_samples`` observations AND its accuracy fell more than
    ``threshold`` below the baseline's.  The continual plan turns a True
    here into a typed ``DriftDetected`` plus (if a merge is pending
    confirmation) an automatic rollback.

    Like every instrument in this module the lock arrives via the
    constructor so one bundle snapshot is point-in-time consistent.
    """

    _TORCHLINT_LOCKS = ("_lock",)  # TL004: the lock may arrive as a parameter

    def __init__(
        self,
        window: int = 64,
        min_samples: int = 16,
        threshold: float = 0.2,
        lock: Optional[Any] = None,
    ) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not 1 <= min_samples <= window:
            raise ValueError(
                f"min_samples must be in [1, window={window}], got {min_samples}"
            )
        if threshold <= 0:
            raise ValueError(f"threshold must be > 0, got {threshold}")
        self._lock = lock if lock is not None else threading.Lock()
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.threshold = float(threshold)
        self._acc = np.zeros(window, np.float64)
        self._conf = np.zeros(window, np.float64)
        self._n = 0  # observations since the last reset
        # Frozen (accuracy, confidence-mean, samples) of the last-good window.
        self._baseline: Optional[Tuple[float, float, int]] = None

    def observe(self, correct: bool, confidence: float) -> None:
        with self._lock:
            i = self._n % self.window
            self._acc[i] = 1.0 if correct else 0.0
            self._conf[i] = float(confidence)
            self._n += 1

    def _current_locked(self) -> Tuple[float, float, int]:
        m = min(self._n, self.window)
        if m == 0:
            return 0.0, 0.0, 0
        return float(self._acc[:m].mean()), float(self._conf[:m].mean()), m

    @property
    def samples(self) -> int:
        with self._lock:
            return min(self._n, self.window)

    @property
    def baseline_samples(self) -> int:
        with self._lock:
            return 0 if self._baseline is None else self._baseline[2]

    def freeze_baseline(self) -> None:
        """Adopt the current window as the known-good baseline and reset the
        current window (the next observations measure a *new* state)."""
        with self._lock:
            self._baseline = self._current_locked()
            self._n = 0

    def reset_current(self) -> None:
        """Discard the current window, keep the baseline (rollback path,
        merge adoption: the served state just changed)."""
        with self._lock:
            self._n = 0

    def drifted(self) -> bool:
        with self._lock:
            if self._baseline is None or self._baseline[2] == 0:
                return False
            acc, _conf, m = self._current_locked()
            if m < self.min_samples:
                return False
            return (self._baseline[0] - acc) > self.threshold

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            acc, conf, m = self._current_locked()
            base = self._baseline
            vals = self._conf[: min(self._n, self.window)]
            p50, p95 = (
                (float(x) for x in np.percentile(vals, (50, 95)))
                if m
                else (0.0, 0.0)
            )
        out: Dict[str, Any] = {
            "samples": m,
            "accuracy": acc,
            "confidence": conf,
            "confidence_p50": p50,
            "confidence_p95": p95,
            "baseline_accuracy": 0.0 if base is None else base[0],
            "baseline_confidence": 0.0 if base is None else base[1],
            "baseline_samples": 0 if base is None else base[2],
        }
        out["drift"] = (
            out["baseline_accuracy"] - acc if base is not None and m else 0.0
        )
        out["drifted"] = self.drifted()
        return out


class ServiceMetrics:
    """The per-service telemetry bundle, shared by plan + service + engine.

    Counters
      ``submitted`` / ``completed`` / ``rejected``: request lifecycle.
    Gauges
      ``queue_depth``: items waiting (sync queue + engine inbox).
    Histograms (seconds)
      ``queue_wait_s``:  submit -> admission (decode) / batch formation
                         (batched) / claim (streaming, continual) / drain
                         start (sync path).
      ``prefill_s``:     per-request prompt prefill (decode plans).
      ``decode_step_s``: one fused decode step == one token per active
                         request (inter-token latency).
      ``batch_s``:       one padded micro-batch forward (batched plans).
      ``e2e_s``:         submit -> completion, the caller-visible latency.
      ``update_s``:      one online Hebbian micro-batch update (continual
                         plans only; empty otherwise).

    The online-learning tier adds its lifecycle counters (``online_updates``
    applied, ``updates_shed`` by budget, ``merges``, ``rollbacks``,
    ``drift_events``) and a :class:`DriftWindow` under the same bundle lock;
    all stay zero/empty unless a :class:`~repro_torch.runtime.continual.
    ContinualPlan` is serving.

    Every instrument shares the bundle's ONE re-entrant lock, so
    :meth:`snapshot` is a single lock acquisition and the returned dict is a
    consistent point-in-time view; the Router's scheduling reads (per-engine
    ``queue_wait_s`` p95 vs ``completed`` counts) rely on this.
    """

    HISTOGRAMS: Sequence[str] = (
        "queue_wait_s", "prefill_s", "decode_step_s", "batch_s", "e2e_s",
        "update_s",
    )
    ONLINE_COUNTERS: Sequence[str] = (
        "online_updates", "updates_shed", "merges", "rollbacks",
        "drift_events",
    )

    _TORCHLINT_LOCKS = ("_lock",)  # TL004: the lock may arrive as a parameter

    def __init__(self, window: int = 2048) -> None:
        self._lock = threading.RLock()
        self.submitted = Counter(lock=self._lock)
        self.completed = Counter(lock=self._lock)
        self.rejected = Counter(lock=self._lock)
        self.queue_depth = Gauge(lock=self._lock)
        for name in self.HISTOGRAMS:
            setattr(self, name, Histogram(window, lock=self._lock))
        for name in self.ONLINE_COUNTERS:
            setattr(self, name, Counter(lock=self._lock))
        self.drift = DriftWindow(lock=self._lock)

    def hist(self, name: str) -> Histogram:
        return getattr(self, name)

    def configure_drift(
        self, window: int, min_samples: int, threshold: float
    ) -> DriftWindow:
        """Replace the drift window with one sized by a ``ContinualConfig``
        (the default instance exists so ``snapshot()`` is shape-stable even
        on plans that never learn)."""
        with self._lock:
            self.drift = DriftWindow(
                window=window, min_samples=min_samples, threshold=threshold,
                lock=self._lock,
            )
            return self.drift

    def snapshot(self) -> Dict[str, Any]:
        """A consistent point-in-time view: counters AND histogram
        percentiles read under one acquisition of the bundle lock (the
        instruments' nested acquisitions are re-entrant), so no event can
        land between the ``submitted`` read and the ``completed`` read."""
        with self._lock:
            out: Dict[str, Any] = {
                "submitted": self.submitted.value,
                "completed": self.completed.value,
                "rejected": self.rejected.value,
                "queue_depth": self.queue_depth.value,
            }
            for name in self.HISTOGRAMS:
                out[name] = self.hist(name).snapshot()
            for name in self.ONLINE_COUNTERS:
                out[name] = getattr(self, name).value
            out["drift"] = self.drift.snapshot()
        return out


class TenantMetrics:
    """Per-tenant request-lifecycle counters for the Router.

    ``submitted``/``completed`` bracket the happy path; the shed counters
    split rejections by cause (the Router never FIFO-blind-drops):
    ``shed_queue_full`` (bounced off the tenant's bounded queue),
    ``shed_deadline`` (expired before dispatch), ``shed_drift`` (refused
    because the target continual engine's drift window reads degraded),
    ``requeued`` (bounced off a crashed engine and put back), ``failed``
    (dispatch errors surfaced on the future).  ``sched_wait_s`` is router-queue wait: submit -> hand-off into
    an engine inbox; ``e2e_s`` is submit -> result on the caller's future
    (the per-tenant SLO view, spanning redispatches across restarts).
    """

    COUNTERS: Sequence[str] = (
        "submitted", "completed", "shed_queue_full", "shed_deadline",
        "shed_drift", "requeued", "failed",
    )
    HISTOGRAMS: Sequence[str] = ("sched_wait_s", "e2e_s")

    def __init__(self, lock: Any, window: int = 1024) -> None:
        for name in self.COUNTERS:
            setattr(self, name, Counter(lock=lock))
        self.queue_depth = Gauge(lock=lock)
        for name in self.HISTOGRAMS:
            setattr(self, name, Histogram(window, lock=lock))

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            name: getattr(self, name).value for name in self.COUNTERS
        }
        out["queue_depth"] = self.queue_depth.value
        for name in self.HISTOGRAMS:
            out[name] = getattr(self, name).snapshot()
        return out


class RouterMetrics:
    """The Router's roll-up: per-tenant counters, per-engine bundles,
    fleet-level lifecycle counters.

    Tenant bundles share THIS object's re-entrant lock (one acquisition
    snapshots every tenant consistently); each engine keeps its own
    :class:`ServiceMetrics` bundle — registered here so the roll-up
    :meth:`snapshot` carries the whole fabric.
    """

    def __init__(self, window: int = 1024) -> None:
        self._lock = threading.RLock()
        self._window = window
        self._tenants: Dict[str, TenantMetrics] = {}
        self._engines: Dict[str, ServiceMetrics] = {}
        self.dispatched = Counter(lock=self._lock)
        self.restarts = Counter(lock=self._lock)

    def tenant(self, name: str) -> TenantMetrics:
        """The (auto-created) bundle for one tenant."""
        with self._lock:
            tm = self._tenants.get(name)
            if tm is None:
                tm = TenantMetrics(self._lock, self._window)
                self._tenants[name] = tm
            return tm

    def register_engine(self, name: str,
                        metrics: Optional[ServiceMetrics] = None
                        ) -> ServiceMetrics:
        """Register (or create) the per-engine bundle under ``name``.
        Re-registering a name keeps the existing bundle unless a new one is
        passed — a hot-restarted engine inherits its predecessor's
        histograms, so scheduling signal survives the restart."""
        with self._lock:
            if metrics is not None:
                self._engines[name] = metrics
            elif name not in self._engines:
                self._engines[name] = ServiceMetrics()
            return self._engines[name]

    @property
    def tenants(self) -> Dict[str, TenantMetrics]:
        with self._lock:
            return dict(self._tenants)

    @property
    def engines(self) -> Dict[str, ServiceMetrics]:
        with self._lock:
            return dict(self._engines)

    def fleet_histograms(self) -> Dict[str, Histogram]:
        """Fabric-wide latency quantiles: per-engine windows merged into
        fresh histograms sized to hold every engine's full window, so the
        merged percentiles equal ``np.percentile`` over the concatenated
        windows (no truncation)."""
        with self._lock:
            engines = list(self._engines.values())
        out: Dict[str, Histogram] = {}
        for name in ServiceMetrics.HISTOGRAMS:
            capacity = max(
                1, sum(sm.hist(name)._window for sm in engines)
            )
            merged = Histogram(window=capacity)
            for sm in engines:
                merged.merge(sm.hist(name))
            out[name] = merged
        return out

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {
                "dispatched": self.dispatched.value,
                "restarts": self.restarts.value,
                "tenants": {
                    name: tm.snapshot() for name, tm in self._tenants.items()
                },
            }
            engines = dict(self._engines)
        # Engine bundles own separate locks: snapshot each consistently
        # OUTSIDE the router-metrics lock (no nested foreign acquisition).
        out["engines"] = {name: sm.snapshot() for name, sm in engines.items()}
        # The fabric-wide roll-up (merged per-engine windows).  Engines keep
        # recording between the per-engine snapshots above and this merge;
        # the roll-up is its own consistent view, not a re-sum of theirs.
        out["fleet"] = {
            name: h.snapshot() for name, h in self.fleet_histograms().items()
        }
        return out


def format_latency_line(snapshot: Dict[str, Any], *names: str) -> str:
    """One CLI-friendly line: ``queue_wait p50=1.2ms p95=3.4ms p99=5.6ms``
    per requested histogram.  Explicitly requested names render
    **shape-stably** — a zero-observation histogram shows ``p50=0.00ms ...``
    instead of vanishing, so fleet roll-ups that print one line per engine
    stay column-aligned even for a just-restarted engine that has not
    dispatched yet.  The no-names form (render "whatever has data") keeps
    skipping empties.  When the snapshot carries online-learning activity
    (any continual-tier counter nonzero), a trailing ``online updates=..
    merges=.. rollbacks=.. drift=..`` segment is appended; frozen-serving
    snapshots render exactly as before."""
    explicit = bool(names)
    parts = []
    for name in names or ServiceMetrics.HISTOGRAMS:
        h = snapshot.get(name)
        if h is None or (not explicit and not h.get("count")):
            continue
        label = name[:-2] if name.endswith("_s") else name
        parts.append(
            f"{label} p50={h['p50'] * 1e3:.2f}ms p95={h['p95'] * 1e3:.2f}ms "
            f"p99={h['p99'] * 1e3:.2f}ms"
        )
    online = []
    for key, label in (
        ("online_updates", "updates"),
        ("updates_shed", "shed"),
        ("merges", "merges"),
        ("rollbacks", "rollbacks"),
        ("drift_events", "drift"),
    ):
        v = snapshot.get(key)
        if v:
            online.append(f"{label}={v}")
    if online:
        parts.append("online " + " ".join(online))
    return " | ".join(parts) if parts else "no latency samples"


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "DriftWindow",
    "ServiceMetrics",
    "TenantMetrics",
    "RouterMetrics",
    "format_latency_line",
]
