"""Serving: ``ServiceConfig -> InferenceService -> ServePlan``.

The inference-side mirror of the compile step.  Training binds a Network to
one ExecutionPlan through ``network.compile(ExecutionConfig(...))``;
serving binds a compiled network to one :class:`ServePlan`::

    service = compiled.serve(ServiceConfig(max_batch=64, buckets=(16, 64)))
    scores  = service.predict(x)             # class scores, on the compiled device

Three strategies of the JAX package's ``repro/runtime/service.py`` are
ported:

* :class:`BatchedPlan`: BCPNN classification through the compiled
  network's shared level-H projection and readout head (the
  ``build_head`` that ``compiled.predict`` uses), with padding-bucket
  selection on the batch axis, so a service facing arbitrary request sizes
  runs a bounded set of shapes.  With the activation store on, repeated
  request batches hit the cached projection (content canonicalization) and
  pay only the head.  Zero-padding rows never change real outputs: the
  forward is row-independent, and the kernels zero-fill the rows of a tile
  past the batch.
* :class:`StreamingPlan`: the latency path, over the compiled network's
  :class:`~repro_torch.core.streaming.StreamingSession` (host-side
  coalescing, LRU-bounded per-size cells, state adoption on close).
* :class:`~repro_torch.runtime.continual.ContinualPlan` (``plan=
  "continual"`` or ``continual=ContinualConfig(...)``): batched
  classification that keeps learning from labeled ``Feedback``.

Token decoding (``plan="decode"``) is not ported: it raises a
``ValueError`` that names it and the slice that will bring it.  The
reference's ``strict=`` and ``router=`` options are absent, so passing
either raises a ``TypeError`` that names it: ``router=`` is read only by
the reference's ``serve_fleet``, which serves the LM zoo and waits for
Slice F.  A fleet of engines is built with
:class:`~repro_torch.runtime.router.Router` directly.

:class:`InferenceService` owns the request queue (admission control via
``max_queue``, ``policy="fcfs"``) and delegates execution to its plan.
``service.start()`` (or ``ServiceConfig(async_mode=True)``) hands the queue
to the executor thread of :class:`repro_torch.runtime.engine.AsyncEngine`:
``submit()`` then returns a ``concurrent.futures.Future``.  Every plan
records latency telemetry (:mod:`repro_torch.runtime.metrics`), surfaced
through ``service.stats["telemetry"]``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.runtime.epoch_engine import rows_to
from repro_torch.runtime.metrics import ServiceMetrics

POLICIES = ("fcfs", "sjf")

# Plans of the reference that wait for a later slice of the port: the
# plan's name -> what brings it.
_UNPORTED_PLANS = {"decode": "token decoding of the LM zoo (Slice F)"}


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------------ config
@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Everything about *how* a network serves, none of *what* it serves.

    max_batch:  padding chunk cap (BatchedPlan, without buckets), the
                coalescing micro-batch (StreamingPlan), and the async
                engine's micro-batch.
    buckets:    ascending batch-size padding buckets for BatchedPlan; the
                largest is the chunk cap.  None = exact sizes.
    policy:     queue admission order: "fcfs" (arrival).  "sjf" orders
                decode requests by prompt length, so these plans refuse it.
    cache_size: LRU bound on the streaming plan's per-size cells.
    plan:       "batched" | "streaming" | "continual"; None picks
                "continual" when ``continual`` is set, else "batched".
    max_wait_s: micro-batch aggregation deadline: the async engine (and the
                streaming plan's coalescing buffer) waits at most this long
                to fill ``max_batch`` before dispatching a partial batch.
    max_queue:  admission control: submit() beyond this depth is rejected
                (None = unbounded); it also bounds the async engine's inbox.
    layer:      the streaming plan's target hidden layer.
    async_mode: start the executor thread at bind time: ``submit()`` returns
                a ``Future``.  For streaming plans the async surface serves
                per-item INFERENCE (sync submit+drain feeds training samples).
    continual:  a ``repro_torch.runtime.continual.ContinualConfig``
                enabling the online-learning tier: the bound plan becomes
                :class:`~repro_torch.runtime.continual.ContinualPlan`
                (inference unchanged; labeled ``Feedback`` items drive
                Hebbian adapter updates, merges, drift detection and
                rollback).  None = frozen serving.
    trace:      a ``repro_torch.runtime.trace.TraceConfig`` enabling
                per-request spans (engine inbox, batch aggregation, batch,
                learn, end to end), exportable as Chrome trace JSON.  None
                (the default) constructs no tracer at all.
    """

    max_batch: int = 4
    buckets: Optional[Tuple[int, ...]] = None
    policy: str = "fcfs"
    cache_size: int = 8
    plan: Optional[str] = None
    max_wait_s: float = 0.0
    max_queue: Optional[int] = None
    layer: int = 0
    async_mode: bool = False
    continual: Optional[Any] = None
    trace: Optional[Any] = None

    def __post_init__(self):
        if self.continual is not None or self.plan == "continual":
            # Importing the continual module registers ContinualPlan in
            # SERVE_PLANS before the plan-name validation below runs (it
            # imports this module for the plan base, so not at the top).
            from repro_torch.runtime.continual import ContinualConfig

            if self.continual is not None and not isinstance(self.continual, ContinualConfig):
                raise TypeError(
                    f"continual must be a ContinualConfig, got {type(self.continual).__name__}"
                )
            if self.plan not in (None, "continual"):
                raise ValueError(
                    f"continual learning serves through plan='continual', got plan={self.plan!r}"
                )
        if self.plan in _UNPORTED_PLANS:
            raise ValueError(
                f"ServiceConfig(plan={self.plan!r}) is not ported yet: it waits for "
                f"{_UNPORTED_PLANS[self.plan]}"
            )
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.layer < 0:
            raise ValueError(f"layer must be >= 0, got {self.layer}")
        if self.policy not in POLICIES:
            raise ValueError(f"Unknown policy {self.policy!r} (want one of {POLICIES})")
        if self.plan is not None and self.plan not in SERVE_PLANS:
            raise ValueError(f"Unknown plan {self.plan!r} (want one of {sorted(SERVE_PLANS)})")
        if self.policy == "sjf":  # every ported plan: only decode requests have a length
            raise ValueError(
                f"policy='sjf' orders decode Requests by prompt length; the "
                f"{self.plan or 'batched'!r} plan has no request length to order by "
                f"(use policy='fcfs')"
            )
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s}")
        if self.buckets is not None:
            b = tuple(int(x) for x in self.buckets)
            if not b or any(x <= 0 for x in b) or list(b) != sorted(set(b)):
                raise ValueError(
                    f"buckets must be strictly ascending positive ints, got {self.buckets!r}"
                )
            object.__setattr__(self, "buckets", b)
        if self.trace is not None:
            from repro_torch.runtime.trace import TraceConfig

            if not isinstance(self.trace, TraceConfig):
                raise ValueError(f"trace must be a TraceConfig, got {type(self.trace).__name__}")

    def bucket_for(self, n: int) -> int:
        """Smallest configured bucket >= n, or n itself when none fits."""
        if self.buckets is not None:
            for b in self.buckets:
                if b >= n:
                    return b
        return n


# ------------------------------------------------------------------- plans
class ServePlan:
    """Base serving strategy.  Subclasses implement the capability they
    serve; calling an unsupported capability raises with the plan name.
    Every plan owns a :class:`ServiceMetrics` bundle (shared with the
    service front door and the async engine) and a ``_lock`` guarding its
    stat counters: the engine's executor thread mutates them while caller
    threads read ``stats``.  ``device`` is where the plan's tensors live
    (None for a plan with none); the engine's thread runs on it."""

    name: str = "?"
    device: Optional[torch.device] = None

    def __init__(self, config: ServiceConfig, metrics: Optional[ServiceMetrics] = None):
        self.config = config
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        self._lock = threading.Lock()
        # Per-request tracer, attached by the service via bind_tracer();
        # None keeps every span site a dead check.
        self.tracer = None

    def bind_tracer(self, tracer) -> None:
        with self._lock:
            self.tracer = tracer

    def _unsupported(self, what: str):
        raise NotImplementedError(f"{type(self).__name__} ({self.name!r}) does not serve {what}")

    # capability surface -------------------------------------------------
    def predict(self, x):
        self._unsupported("predict()")

    def feed(self, sample) -> None:
        self._unsupported("feed()")

    def infer(self, sample):
        self._unsupported("infer()")

    def flush(self) -> None:  # batch plans have no buffer
        pass

    def close(self) -> None:
        pass

    @property
    def stats(self) -> Dict[str, Any]:
        return {}


class BatchedPlan(ServePlan):
    """BCPNN classification through the compiled network's shared head.

    ``predict`` chunks the input along the batch axis (chunk cap: the
    largest bucket, else ``max_batch``), pads each chunk up to its bucket
    with zero rows and, with the compiled network's activation store on,
    projects it through the store, as ``compiled.predict``/``evaluate`` do,
    then applies the one shared head (``compiled._head_fn()``).  The store
    keys its projections by the identity of the array, so padded chunks are
    content-canonicalized (a small LRU maps chunk bytes to one anchor
    array): a repeated request batch hits the cached level-H projection and
    pays only the head.  Without the store (``cache_activations=False``)
    the full-network forward (``compiled._forward_fn()``) runs instead."""

    name = "batched"

    _CANON_CAPACITY = 32  # distinct padded chunks remembered for reuse

    def __init__(self, compiled, config: ServiceConfig,
                 metrics: Optional[ServiceMetrics] = None):
        super().__init__(config, metrics)
        self.compiled = compiled
        self.device = compiled.device
        self._fwd = compiled._forward_fn()
        self._requests = 0
        self._rows = 0
        self._padded_rows = 0
        # digest -> the first array seen with those bytes.
        self._canon: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._reuse_hits = 0

    def _chunk_cap(self) -> int:
        if self.config.buckets is not None:
            return self.config.buckets[-1]
        return self.config.max_batch

    def _canonical(self, xb: np.ndarray) -> np.ndarray:
        key = (
            xb.shape,
            str(xb.dtype),
            hashlib.blake2b(np.ascontiguousarray(xb).tobytes(), digest_size=16).digest(),
        )
        with self._lock:
            hit = self._canon.get(key)
            if hit is not None:
                self._canon.move_to_end(key)
                self._reuse_hits += 1
                return hit
            # Anchor a private copy, never a view of the caller's array: the
            # mapping (and the store's identity-keyed projection) must
            # survive the caller writing into their buffer.
            anchor = np.array(xb, copy=True)
            self._canon[key] = anchor
            while len(self._canon) > self._CANON_CAPACITY:
                self._canon.popitem(last=False)
            return anchor

    def _scores(self, xb: np.ndarray) -> torch.Tensor:
        """One padded chunk -> class scores, through the shared head."""
        compiled = self.compiled
        state = compiled.state
        if compiled.activations is not None and compiled.hidden_layers:
            xb = self._canonical(xb)
            h = compiled.activations.level(
                len(compiled.hidden_layers), list(state.layers), xb, chunk=xb.shape[0]
            )
            hd = rows_to(h, 0, h.shape[0], self.device)  # a spilled level comes back
            return compiled._head_fn()(state.layers, state.readout, hd)
        xd = rows_to(xb, 0, xb.shape[0], self.device)
        return self._fwd(state.layers, state.readout, xd)

    def predict(self, x) -> torch.Tensor:
        """Class scores of host rows ``x`` (n, F) or one row (F,), on the
        compiled device."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        cap = self._chunk_cap()
        outs = []
        for i in range(0, x.shape[0], cap):
            xb = x[i : i + cap]
            n = xb.shape[0]
            m = self.config.bucket_for(n)
            if m > n:
                xb = np.concatenate([xb, np.zeros((m - n,) + xb.shape[1:], xb.dtype)], axis=0)
                with self._lock:
                    self._padded_rows += m - n
            t0 = time.perf_counter()
            scores = self._scores(xb)
            _sync(self.device)  # the chunk's latency ends on the device
            self.metrics.batch_s.observe(time.perf_counter() - t0)
            outs.append(scores[:n])
            with self._lock:
                self._rows += n
        with self._lock:
            self._requests += 1
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    @property
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "requests": self._requests,
                "rows": self._rows,
                "padded_rows": self._padded_rows,
                "projection_reuse_hits": self._reuse_hits,
            }


class StreamingPlan(ServePlan):
    """The latency path: online BCPNN updates and inference through the
    compiled network's StreamingSession (coalescing buffer, shared
    LRU-bounded cells, state adoption on close) behind the front door."""

    name = "streaming"

    def __init__(self, compiled, config: ServiceConfig,
                 metrics: Optional[ServiceMetrics] = None):
        super().__init__(config, metrics)
        self.device = compiled.device
        self.session = compiled.streaming(
            layer=config.layer,
            max_batch=config.max_batch,
            max_wait_s=config.max_wait_s,
            cache_size=config.cache_size,
        )

    def feed(self, sample) -> None:
        self.session.feed(sample)

    def infer(self, sample) -> np.ndarray:
        t0 = time.perf_counter()
        out = self.session.infer(sample)  # a host array: the device is done
        self.metrics.batch_s.observe(time.perf_counter() - t0)
        return out

    def flush(self) -> None:
        self.session.flush()

    def close(self) -> None:
        self.session.close()

    @property
    def stats(self) -> Dict[str, Any]:
        return self.session.stats


SERVE_PLANS = {
    BatchedPlan.name: BatchedPlan,
    StreamingPlan.name: StreamingPlan,
}


# ----------------------------------------------------------------- service
class InferenceService:
    """The serving front door: a request queue with admission control,
    delegating execution to one bound ServePlan.

    Two execution surfaces share the queue semantics:

    * the synchronous path: ``submit()`` returns bool, ``drain()`` runs
      everything queued through the plan in one call;
    * the async path: ``start()`` hands the plan to a dedicated executor
      thread (:class:`repro_torch.runtime.engine.AsyncEngine`) and
      ``submit()`` returns a ``concurrent.futures.Future``.
    """

    def __init__(self, plan: ServePlan, config: ServiceConfig):
        self.plan = plan
        self.config = config
        self.metrics = plan.metrics
        from repro_torch.runtime.trace import build_tracer

        self.tracer = build_tracer(config.trace)
        if self.tracer is not None:
            plan.bind_tracer(self.tracer)
        self.engine = None  # set by start()
        self._queue: Deque = deque()
        self._queue_t: Deque[float] = deque()

    # --------------------------------------------------------------- async
    def start(self, run: bool = True):
        """Bind (and by default start) the async engine; ``submit()``
        afterwards returns Futures.  Idempotent while the engine is live.

        ``run=False`` binds the engine without launching its thread:
        submits queue into the bounded inbox and execute when ``start()``
        (or ``drain_and_stop()``) runs it.  Items already in the sync queue
        have no Future to resolve into, so ``start()`` refuses while it is
        non-empty (``drain()`` it first)."""
        from repro_torch.runtime.engine import AsyncEngine

        if self._queue:
            raise RuntimeError(
                f"{len(self._queue)} item(s) in the sync queue have no Future to "
                "resolve into; drain() before start()"
            )
        if self.engine is not None and not self.engine.stopped:
            if run:
                self.engine.start()
            return self.engine
        self.engine = AsyncEngine(self.plan, self.config, tracer=self.tracer)
        if run:
            self.engine.start()
        return self.engine

    def drain_and_stop(self):
        """Finish all in-flight and queued async work, then stop the
        engine.  No-op when the engine was never started."""
        if self.engine is not None:
            self.engine.drain_and_stop()

    # --------------------------------------------------------------- queue
    def submit(self, item):
        """Queue one sample.

        Synchronous mode: returns True, or False when ``max_queue`` rejects
        the item.  Once ``start()`` has bound the async engine, delegates to
        it and returns a ``concurrent.futures.Future`` (backpressure raises
        ``QueueFull``; a stopped engine raises ``EngineStopped``).

        The streaming plan's surfaces differ: sync ``submit`` + ``drain``
        FEEDS samples (online training), async submits run INFERENCE per
        item (futures resolve to activations)."""
        if self.engine is not None:
            return self.engine.submit(item)
        if self.config.max_queue is not None and len(self._queue) >= self.config.max_queue:
            self.metrics.rejected.inc()
            return False
        self._queue.append(item)
        self._queue_t.append(time.perf_counter())
        self.metrics.submitted.inc()
        self.metrics.queue_depth.set(len(self._queue))
        return True

    def drain(self):
        """Run everything queued through the plan: stacked scores
        (batched), a flush (streaming), or one result per item in arrival
        order (continual: an ack dict per ``Feedback``, a score row per
        other item)."""
        if self.engine is not None and not self.engine.stopped:
            raise RuntimeError(
                "the async engine owns this service's queue; submit() returns "
                "Futures — use them, or drain_and_stop() first"
            )
        items = list(self._queue)
        stamps = list(self._queue_t)
        self._queue.clear()
        self._queue_t.clear()
        self.metrics.queue_depth.set(0)
        now = time.perf_counter()
        for t in stamps:
            self.metrics.queue_wait_s.observe(now - t)
        if not items:
            self.plan.flush()
            return None
        if self.plan.name == "streaming":
            for s in items:
                self.plan.feed(s)
            self.plan.flush()
            out = None
        elif self.plan.name == "continual":
            # Mixed traffic in arrival order: Feedback learns, anything
            # else infers, one result per item, as on the async path.
            from repro_torch.runtime.continual import Feedback

            out = [
                self.plan.learn(s) if isinstance(s, Feedback) else self.plan.infer(s)
                for s in items
            ]
        else:
            out = self.plan.predict(np.stack([np.asarray(s) for s in items]))
        _sync(self.plan.device)
        end = time.perf_counter()
        for t in stamps:
            self.metrics.e2e_s.observe(end - t)
        self.metrics.completed.inc(len(items))
        return out

    # -------------------------------------------------- direct conveniences
    def predict(self, x):
        return self.plan.predict(x)

    def feed(self, sample) -> None:
        self.plan.feed(sample)

    def infer(self, sample):
        return self.plan.infer(sample)

    def flush(self) -> None:
        self.plan.flush()

    def close(self) -> None:
        if self.engine is not None:
            self.engine.drain_and_stop()
        self.plan.close()

    @property
    def stats(self) -> Dict[str, Any]:
        engine_live = self.engine is not None and not self.engine.stopped
        out = {
            "plan": self.plan.name,
            # The sync queue plus the engine inbox: every waiting item.
            "queued": len(self._queue) + (self.engine.inbox_depth if engine_live else 0),
            "rejected": self.metrics.rejected.value,
            **self.plan.stats,
            "telemetry": self.metrics.snapshot(),
        }
        if self.engine is not None:
            out["engine"] = self.engine.stats
        return out


__all__ = [
    "POLICIES",
    "ServiceConfig",
    "ServePlan",
    "BatchedPlan",
    "StreamingPlan",
    "SERVE_PLANS",
    "InferenceService",
]
