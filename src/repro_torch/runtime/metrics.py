"""Serving telemetry: monotonic counters, gauges, percentile histograms.

A copy of the JAX package's ``repro/runtime/metrics.py`` (it is pure numpy
and threading).  The serving subsystem (sync ``InferenceService`` drains
and the :mod:`repro_torch.runtime.engine` async loops) records where every
request's wall-time goes (queue wait, micro-batch execution, end to end)
into one :class:`ServiceMetrics` bundle shared by the plan, the service
front door and the engine; ``service.stats["telemetry"]`` surfaces the
snapshot.  The reference's decode, continual and router instruments (the
drift window, the per-tenant and router roll-ups, the latency line) come
with the slices that port those tiers.

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
from typing import Any, Dict, Optional, Sequence

import numpy as np


class Counter:
    """A monotonic event counter.

    ``lock`` lets a bundle (:class:`ServiceMetrics`)
    share ONE re-entrant lock across its instruments so bundle snapshots are
    point-in-time consistent; standalone counters default to a private lock.
    """


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
        histogram (the reference's router exposes fabric-wide latency
        quantiles across per-engine bundles with it).

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


class ServiceMetrics:
    """The per-service telemetry bundle, shared by plan + service + engine.

    Counters
      ``submitted`` / ``completed`` / ``rejected``: request lifecycle.
    Gauges
      ``queue_depth``: items waiting (sync queue + engine inbox).
    Histograms (seconds)
      ``queue_wait_s``:  submit -> batch formation (batched) / drain start
                         (sync path).
      ``batch_s``:       one padded micro-batch forward (batched plans).
      ``e2e_s``:         submit -> completion, the caller-visible latency.

    The reference's bundle also holds the decode plan's histograms and the
    continual tier's counters and drift window; they come with those
    slices.  Every instrument shares the bundle's ONE re-entrant lock, so
    :meth:`snapshot` is a single lock acquisition and the returned dict is a
    consistent point-in-time view.
    """

    HISTOGRAMS: Sequence[str] = ("queue_wait_s", "batch_s", "e2e_s")

    def __init__(self, window: int = 2048) -> None:
        self._lock = threading.RLock()
        self.submitted = Counter(lock=self._lock)
        self.completed = Counter(lock=self._lock)
        self.rejected = Counter(lock=self._lock)
        self.queue_depth = Gauge(lock=self._lock)
        for name in self.HISTOGRAMS:
            setattr(self, name, Histogram(window, lock=self._lock))

    def hist(self, name: str) -> Histogram:
        return getattr(self, name)

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
        return out


__all__ = ["Counter", "Gauge", "Histogram", "ServiceMetrics"]
