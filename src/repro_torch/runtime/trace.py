"""Request tracing + structured event journal (the observability spine).

The JAX package's ``repro/runtime/trace.py``, extended; the port records
the router's, the engine's, the decode plan's (``plan.prefill``,
``plan.decode_step``) and the continual plan's spans, strict mode's
:class:`RecompileRebaseline` event, and the Listing 1 path's spans and
counters below.

The Listing 1 path (fit, evaluate, predict) traces on the **active**
tracer: one context variable, read by :func:`active` and set for a block
by :func:`activate` (both live in :mod:`repro_torch.trace_context`).
``CompiledNetwork`` makes its own tracer active for the length of
``fit``, ``partial_fit``, ``predict`` and ``evaluate``
(``ExecutionConfig(trace=)`` builds one for the network's life,
``compiled.tracing()`` attaches one for a window).  Each site reads the
variable once and tests it for None; with no tracer that is all it does.
Spans opened with :meth:`Tracer.span` nest: each records the ``seq`` of
the enclosing open span as its ``parent`` and inherits its trace id.

===================== ======= ==============================================
name                  kind    where, attrs
===================== ======= ==============================================
``fit``               span    ``CompiledNetwork.fit``; rows, batch_size
``train.<phase>``     span    each epoch and phase-boundary projection
                              (``runtime/program.py``); the history entry's
                              ``host_s``, ``device_wait_s``, epoch / level
``layer.step``        span    each training batch of a hidden or BCPNN
                              readout epoch; layer (index), rows
``layer.rewire``      span    a rewiring batch's ``maybe_update_mask``;
                              host_step
``layer.rewires``     counter one per rewiring
``layer.unit_mask``   span    each expansion of a hidden layer's HCU mask to
                              units (every forward and training batch);
                              bytes (F x H x 4)
``layer.unit_mask_    counter the bytes those expansions wrote
bytes``
``store.project``     span    one activation-store projection of a level;
                              j, k, rows, chunks, bytes, spilled
``predict``           span    ``CompiledNetwork.predict``, a new trace id a
                              call, ended before any read back; rows,
                              chunks, store
``predict.chunk``     span    one chunk's staging and dispatch; rows
``evaluate``          span    ``CompiledNetwork.evaluate``; rows, batch_size
``evaluate.readback`` span    its ``argmax().cpu()``
===================== ======= ==============================================

While ``torch.profiler`` records, each :meth:`Tracer.span` also opens a
``torch.profiler.record_function`` of its name, so the span lands in the
profiler's trace as a ``user_annotation`` on the profiler's clock, beside
the kernels it launched.  The ring keeps ``time.perf_counter`` stamps.

Aggregate p95s (``repro_torch.runtime.metrics``) tell you the fabric is slow;
they cannot tell you WHERE one request spent its time.  This module adds
the per-request view:

* A :class:`Tracer` owns a ring of **spans** — ``(trace_id, name,
  t_start, t_end, attrs)`` tuples recorded at every hop a request takes
  (Router sched-wait, engine inbox, micro-batch aggregation, the batch,
  prefill, per-token decode, continual learn/update/merge, end to end,
  training phases).  One ``trace_id``, minted at the fabric front door
  (the Router's or the engine's ``submit``) and threaded through
  ``Request``/``Feedback`` and the dispatch seams, reconstructs the full
  path.  Spans export as Chrome
  ``trace_event`` JSON — load the file in
  Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.
* An :class:`EventJournal` records typed operational **events**
  (:class:`EngineRestart`, :class:`DriftDetected`, :class:`MergeApplied`,
  :class:`RollbackApplied`, :class:`RecompileRebaseline`,
  :class:`DeadlineShed`, :class:`TenantShed`)
  in a bounded deque with an optional JSONL sink, each carrying the
  correlating trace_id / tenant / engine slot.

Hot-path discipline:

* Span recording is **lock-free under the GIL**: the ring hands out slot
  indices with ``itertools.count()`` (its ``next`` is a single
  C-implemented atomic op) and each slot holds one immutable tuple, so
  concurrent writers never block each other and readers never see a torn
  record — at worst they miss the very newest slots.  A span claims its
  slot's ``seq`` when it opens (so a child can name its parent) and
  stores its tuple there when it closes.
* Everything is **off by default and zero-cost when off**: no tracer
  object exists unless a :class:`TraceConfig` is supplied, and every
  instrumentation site guards on ``tracer is not None`` — disabled runs
  execute the exact same arithmetic (tracing only observes timings, so
  results are bit-identical either way).
* The journal (cold path: restarts, drift, sheds) takes a plain lock;
  all its mutation happens under it.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import sys
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

from repro_torch.runtime.metrics import Counter
from repro_torch.trace_context import OPEN, activate, active

__all__ = [
    "TraceConfig", "Tracer", "SpanRecord", "EventJournal", "build_tracer", "active", "activate",
    "EngineRestart", "DriftDetected", "MergeApplied", "RollbackApplied",
    "RecompileRebaseline", "DeadlineShed", "TenantShed",
]


# --------------------------------------------------------------------------
# Configuration.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Tracing knobs.  Handed to ``ServiceConfig(trace=)``,
    ``RouterConfig(trace=)`` or ``ExecutionConfig(trace=)``; absence of a
    config (the default) means no tracer is ever constructed."""

    enabled: bool = True
    ring_size: int = 8192        # span slots retained (newest win)
    journal_size: int = 1024     # journal events retained
    journal_path: Optional[str] = None   # JSONL sink (append) for events

    def __post_init__(self):
        if self.ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {self.ring_size}")
        if self.journal_size < 1:
            raise ValueError(
                f"journal_size must be >= 1, got {self.journal_size}"
            )


def build_tracer(config: Optional["TraceConfig"]) -> Optional["Tracer"]:
    """The one gate every integration point uses: a Tracer exists iff a
    config was supplied AND it is enabled."""
    if config is None or not config.enabled:
        return None
    return Tracer(config)


# --------------------------------------------------------------------------
# Spans.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One hop of one request (reader-side view of a ring slot)."""

    seq: int                 # global record order (monotone per tracer)
    trace_id: int            # correlates hops of one request; 0 = training
    name: str                # e.g. "router.sched", "engine.inbox"
    t_start: float           # time.perf_counter() seconds
    t_end: float
    attrs: Dict[str, Any]    # tenant / engine / batch rows / epoch / ...
    parent: Optional[int] = None  # seq of the enclosing Tracer.span, if any

    @property
    def duration_s(self) -> float:
        return self.t_end - self.t_start


class _SpanRing:
    """Fixed-size overwrite-oldest span store, lock-free under the GIL.

    ``next(self._seq)`` is atomic (C-implemented), so two threads never
    claim the same slot; each slot write is a single list ``__setitem__``
    of an immutable tuple, so a reader sees either the old record or the
    new one — never a torn mix.  Deliberately owns NO lock.
    """

    __slots__ = ("_slots", "_size", "_seq")

    def __init__(self, size: int):
        self._slots: List[Optional[Tuple]] = [None] * size
        self._size = size
        self._seq = itertools.count()

    def claim(self) -> int:
        """The next ``seq`` (an open span claims its slot this way)."""
        return next(self._seq)

    def store(self, seq: int, trace_id: int, name: str, t_start: float,
              t_end: float, attrs: Dict[str, Any],
              parent: Optional[int] = None) -> None:
        self._slots[seq % self._size] = (seq, trace_id, name, t_start,
                                         t_end, attrs, parent)

    def record(self, trace_id: int, name: str, t_start: float, t_end: float,
               attrs: Dict[str, Any]) -> None:
        self.store(next(self._seq), trace_id, name, t_start, t_end, attrs)

    def snapshot(self) -> List[SpanRecord]:
        """Retained spans in record order (approximate under concurrent
        writes: a slot may be overwritten mid-scan — each record itself is
        still intact)."""
        rows = [s for s in list(self._slots) if s is not None]
        rows.sort(key=lambda r: r[0])
        return [SpanRecord(*r) for r in rows]


def _profiler_annotation(name: str) -> Optional[Any]:
    """An entered ``torch.profiler.record_function(name)`` while the
    profiler records, else None.  torch is looked up, not imported, so this
    module stays stdlib only: no profiler can record before torch loads."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    annotation = torch.profiler.record_function(name)
    annotation.__enter__()
    return annotation


class _Span:
    """One open :meth:`Tracer.span`; ``with`` yields its attrs dict, which
    the block may extend (the record is stored when the block ends)."""

    __slots__ = ("tracer", "name", "trace_id", "attrs", "seq", "parent", "t_start",
                 "_token", "_annotation")

    def __init__(self, tracer: "Tracer", name: str, trace_id: Optional[int],
                 attrs: Dict[str, Any]):
        self.tracer, self.name, self.trace_id, self.attrs = tracer, name, trace_id, attrs

    def __enter__(self) -> Dict[str, Any]:
        outer = OPEN.get()
        self.parent = None
        if outer is not None and outer.tracer is self.tracer:
            self.parent = outer.seq
            if self.trace_id is None:
                self.trace_id = outer.trace_id
        elif self.trace_id is None:
            self.trace_id = Tracer.TRAIN_TRACE_ID
        self.seq = self.tracer._ring.claim()
        self._token = OPEN.set(self)
        self._annotation = _profiler_annotation(self.name)
        self.t_start = time.perf_counter()
        return self.attrs

    def __exit__(self, *exc) -> None:
        t_end = time.perf_counter()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        OPEN.reset(self._token)
        self.tracer._ring.store(self.seq, self.trace_id, self.name, self.t_start, t_end,
                                self.attrs, self.parent)


# --------------------------------------------------------------------------
# Journal events.  Each is a frozen dataclass with a `kind` discriminator;
# fields default to None so emitters fill in only what they know.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class EngineRestart:
    """Router hot-restarted an engine slot from its plan factory."""

    kind = "engine_restart"
    engine: Optional[str] = None
    restarts: Optional[int] = None      # cumulative for this slot
    leftover: Optional[int] = None      # undone items re-enqueued
    trace_id: Optional[int] = None
    tenant: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DriftDetected:
    """Continual plan's prequential window crossed the drift threshold.
    (The journal event — distinct from the ``repro_torch.runtime.continual``
    exception of the same name, which is what ``submit()`` raises.)"""

    kind = "drift_detected"
    accuracy: Optional[float] = None
    baseline_accuracy: Optional[float] = None
    samples: Optional[int] = None
    trace_id: Optional[int] = None
    tenant: Optional[str] = None
    engine: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class MergeApplied:
    """Continual plan folded buffered online updates into serving state."""

    kind = "merge_applied"
    merges: Optional[int] = None        # cumulative merge count
    strategy: Optional[str] = None
    trace_id: Optional[int] = None
    tenant: Optional[str] = None
    engine: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class RollbackApplied:
    """Continual plan restored the last pre-merge snapshot after drift."""

    kind = "rollback_applied"
    rollbacks: Optional[int] = None
    trace_id: Optional[int] = None
    tenant: Optional[str] = None
    engine: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class RecompileRebaseline:
    """Strict-mode RecompileSentinel adopted new cache sizes (an
    intentional change, e.g. reconfiguring a service)."""

    kind = "recompile_rebaseline"
    sizes: Optional[Dict[str, int]] = None
    trace_id: Optional[int] = None
    tenant: Optional[str] = None
    engine: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DeadlineShed:
    """Router shed a request whose deadline expired (DOA or in-queue)."""

    kind = "deadline_shed"
    waited_s: Optional[float] = None
    trace_id: Optional[int] = None
    tenant: Optional[str] = None
    engine: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class TenantShed:
    """Router rejected a submit: the tenant's queue was at capacity (or
    the tenant was shed wholesale, e.g. drift with shed_on_drift)."""

    kind = "tenant_shed"
    depth: Optional[int] = None
    reason: Optional[str] = None        # "queue_full" | "drift"
    trace_id: Optional[int] = None
    tenant: Optional[str] = None
    engine: Optional[str] = None


class EventJournal:
    """Bounded, thread-safe journal of typed operational events with an
    optional append-only JSONL sink.  Cold path — a plain lock is fine."""


    def __init__(self, size: int = 1024, path: Optional[str] = None):
        self._lock = threading.Lock()
        # rows: (seq, ts_wall, t_perf, event) — both clocks stamped so the
        # chrome export can place events on the perf_counter span timeline.
        self._events: Deque[Tuple[int, float, float, Any]] = deque(maxlen=size)
        self._seq = 0
        self._file = open(path, "a", encoding="utf-8") if path else None

    def emit(self, event: Any) -> int:
        """Record ``event`` (a frozen dataclass with a ``kind``); returns
        its journal sequence number."""
        ts = time.time()
        t_perf = time.perf_counter()
        with self._lock:
            seq = self._seq
            self._seq += 1
            self._events.append((seq, ts, t_perf, event))
            if self._file is not None:
                row = {"seq": seq, "ts": ts,
                       "kind": getattr(event, "kind", type(event).__name__)}
                row.update(dataclasses.asdict(event))
                self._file.write(json.dumps(row, default=str) + "\n")
                self._file.flush()
        return seq

    def events(self, kind: Optional[str] = None) -> List[Tuple[int, float, Any]]:
        """Retained ``(seq, ts, event)`` rows (``ts`` is wall-clock),
        optionally filtered by the event's ``kind`` discriminator."""
        return [(seq, ts, ev) for seq, ts, _, ev in self._rows(kind)]

    def _rows(self, kind: Optional[str] = None) -> List[Tuple[int, float, float, Any]]:
        with self._lock:
            rows = list(self._events)
        if kind is not None:
            rows = [r for r in rows
                    if getattr(r[3], "kind", None) == kind]
        return rows

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


# --------------------------------------------------------------------------
# The tracer.
# --------------------------------------------------------------------------
class Tracer:
    """Span ring + event journal + trace-id mint for one serving fabric
    (or one training run).  Share ONE tracer across the Router, its
    engines, and their plans so a request's hops land in one place.

    Owns no lock: ``new_trace``/``record`` ride atomic ``itertools.count``
    ops and single slot stores; the journal locks internally.
    """

    TRAIN_TRACE_ID = 0   # spans of the training loop share this id

    def __init__(self, config: Optional[TraceConfig] = None):
        self.config = config if config is not None else TraceConfig()
        self._ring = _SpanRing(self.config.ring_size)
        self._ids = itertools.count(1)
        self._counters: Dict[str, Counter] = {}
        self.journal = EventJournal(self.config.journal_size,
                                    self.config.journal_path)

    # ------------------------------------------------------------ hot path
    def new_trace(self) -> int:
        """Mint a trace id (atomic; ids are unique per tracer)."""
        return next(self._ids)

    def record(self, trace_id: int, name: str, t_start: float,
               t_end: float, **attrs: Any) -> None:
        """Record one span.  ``t_start``/``t_end`` are
        ``time.perf_counter()`` stamps taken by the caller."""
        self._ring.record(trace_id, name, t_start, t_end, attrs)

    def span(self, name: str, trace_id: Optional[int] = None, **attrs: Any) -> _Span:
        """A span around a ``with`` block: its start, end and ``parent``
        (the enclosing open span of this tracer), on the enclosing span's
        trace id unless ``trace_id`` is given (the training trace id at the
        top).  While ``torch.profiler`` records, the block is also a
        ``record_function`` of ``name``."""
        return _Span(self, name, trace_id, attrs)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        counter = self._counters.get(name)
        if counter is None:
            counter = self._counters.setdefault(name, Counter())
        counter.inc(n)

    def emit(self, event: Any) -> int:
        """Journal a typed operational event."""
        return self.journal.emit(event)

    # ----------------------------------------------------------- cold path
    def spans(self, name: Optional[str] = None) -> List[SpanRecord]:
        """Retained spans (record order), optionally filtered by name."""
        rows = self._ring.snapshot()
        if name is not None:
            rows = [r for r in rows if r.name == name]
        return rows

    def trace(self, trace_id: int) -> List[SpanRecord]:
        """All retained spans of one request, ordered by start time."""
        rows = [r for r in self._ring.snapshot() if r.trace_id == trace_id]
        rows.sort(key=lambda r: (r.t_start, r.seq))
        return rows

    def events(self, kind: Optional[str] = None) -> List[Tuple[int, float, Any]]:
        return self.journal.events(kind)

    def counters(self) -> Dict[str, int]:
        """Every counter's value, by name."""
        return {name: c.value for name, c in sorted(self._counters.items())}

    # ------------------------------------------------------------- export
    def chrome_trace(self) -> Dict[str, Any]:
        """Spans + journal as a Chrome ``trace_event`` JSON object (open
        in Perfetto or ``chrome://tracing``).  Tracks (tids) are derived
        from span attrs: the ``engine`` attr names the lane, else the
        span-name prefix ("router", "train", "plan", ...).  A span's args
        hold its ``seq`` and, under an enclosing span, that span's
        ``parent`` seq; each counter is one ``"C"`` event at export time."""
        spans = self._ring.snapshot()
        tracks: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []

        def tid_for(track: str) -> int:
            if track not in tracks:
                tid = len(tracks) + 1
                tracks[track] = tid
                events.append({
                    "name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
                    "args": {"name": track},
                })
            return tracks[track]

        for s in spans:
            track = s.attrs.get("engine") or s.name.split(".", 1)[0]
            args = {"trace_id": s.trace_id, "seq": s.seq}
            if s.parent is not None:
                args["parent"] = s.parent
            args.update(s.attrs)
            events.append({
                "name": s.name, "ph": "X", "pid": 1, "tid": tid_for(track),
                "ts": s.t_start * 1e6,                  # microseconds
                "dur": max(s.t_end - s.t_start, 0.0) * 1e6,
                "args": args,
            })
        for seq, ts, t_perf, ev in self.journal._rows():
            kind = getattr(ev, "kind", type(ev).__name__)
            track = getattr(ev, "engine", None) or "journal"
            args = {"seq": seq, "ts_unix": ts}
            args.update(dataclasses.asdict(ev))
            events.append({
                "name": kind, "ph": "i", "s": "g", "pid": 1,
                "tid": tid_for(track),
                "ts": t_perf * 1e6,   # perf clock: same timeline as spans
                "args": args,
            })
        now = time.perf_counter() * 1e6
        for name, value in self.counters().items():
            events.append({"name": name, "ph": "C", "pid": 1, "ts": now,
                           "args": {"value": value}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f, default=str)

    def close(self) -> None:
        self.journal.close()
