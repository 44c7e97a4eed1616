"""Async serving engine: continuous batching, deadline micro-batching, futures, backpressure.

The port of the JAX package's ``repro/runtime/engine.py``.  The synchronous
:class:`~repro_torch.runtime.service.InferenceService` path is a
hand-crank: callers ``submit()`` into a deque and block on ``drain()``.
This module gives a :class:`~repro_torch.runtime.service.ServePlan` a
serving runtime:

* ``AsyncEngine(plan, config)`` owns device execution on ONE dedicated
  executor thread: kernels never launch from caller threads.  The thread
  runs under ``torch.cuda.device(plan.device)`` when the plan lives on a
  card, so every launch goes to that card's current stream.
  ``submit(item)`` returns a ``concurrent.futures.Future`` that resolves to
  a ``Completion`` (decode) or a host numpy array (a score row, or a
  streaming inference's activations).
* **Continuous batching (DecodePlan):** the loop admits new requests into
  free decode slots *between* steps: a request submitted while others are
  mid-generation lands in the next freed slot instead of waiting for the
  whole queue to drain.  The loop drives the same
  :class:`~repro_torch.runtime.service.DecodeSession` admit/evict/step
  schedule as the synchronous ``generate()``, so under deterministic
  arrivals the two are token-identical.  ``policy="sjf"`` admits the
  shortest queued prompt first.  ``torch.inference_mode`` is thread-local,
  so the loop enters it on its own thread.
* **Deadline micro-batching (BatchedPlan):** requests aggregate until
  ``max_batch`` is reached or ``max_wait_s`` has elapsed since the batch
  opened.
* **Per-item inference (StreamingPlan):** the lowest-latency path.
* **Update/infer interleave (ContinualPlan):** labeled ``Feedback`` items
  learn, every other item infers, in arrival order on the one thread.
* **Backpressure:** the inbox is bounded by ``max_queue`` (the knob the
  sync queue uses); a submit beyond it raises :class:`QueueFull` and counts
  into ``metrics.rejected``.
* **Graceful shutdown:** ``drain_and_stop()`` rejects new submits
  (:class:`EngineStopped`), completes everything in flight and queued, then
  joins the thread; no Future is ever dropped.  A failed batch fails its
  futures with the exception (so every future resolves, and the caller sees
  the fault); a loop crash fails the remaining futures.
* **Restart seam:** ``drain_and_stop()`` returns the work items the loop
  could NOT complete (empty on a graceful drain).  A supervisor (the
  :mod:`repro_torch.runtime.router` Router) re-enqueues them onto a
  replacement engine built from the same plan factory (hot restart).

Latency telemetry (queue wait, prefill, per-token decode, batch, end to
end) records into the plan's
shared :class:`~repro_torch.runtime.metrics.ServiceMetrics` bundle.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

__all__ = ["AsyncEngine", "QueueFull", "EngineStopped"]


class QueueFull(RuntimeError):
    """submit() bounced off the bounded inbox (``max_queue``)."""


class EngineStopped(RuntimeError):
    """submit() after drain_and_stop() began."""


@dataclasses.dataclass
class _Work:
    item: Any
    future: Future
    t_submit: float
    tag: int
    trace_id: Optional[int] = None  # set only when a tracer is attached
    t_open: Optional[float] = None  # batched: when this item's batch opened


class AsyncEngine:
    """One executor thread turning a ServePlan into a continuous service.

    States: ``new`` (constructed; submits queue up) -> ``running`` (loop
    live) -> ``draining`` (no new submits; finishing queued + in-flight)
    -> ``stopped``.
    """

    _POLL_S = 0.05  # idle wakeup so state changes are never missed

    def __init__(self, plan, config, metrics=None, name: str = "engine",
                 tracer=None):
        self.plan = plan
        self.config = config
        self.name = name  # thread / diagnostics label
        self.metrics = metrics if metrics is not None else plan.metrics
        # Per-request tracing is opt-in: None (the default, when neither the
        # supervisor nor the plan carries a Tracer) keeps every span site a
        # dead `is not None` check — zero allocation, zero lock traffic.
        self.tracer = tracer if tracer is not None else getattr(
            plan, "tracer", None
        )
        self._inbox: Deque[_Work] = deque()
        self._cv = threading.Condition()
        self._state = "new"
        self._thread: Optional[threading.Thread] = None
        self._next_tag = 0
        # Work the loop could not complete (crash path): handed back to
        # supervisors via drain_and_stop()'s return value.
        self._leftover: List[Any] = []
        # Engine-level counters (plan/latency stats live in self.metrics).
        self.admitted = 0  # decode requests placed into slots
        self.batches = 0  # batched micro-batches dispatched

    # ---------------------------------------------------------------- state
    @property
    def state(self) -> str:
        with self._cv:
            return self._state

    @property
    def stopped(self) -> bool:
        return self.state == "stopped"

    @property
    def inbox_depth(self) -> int:
        with self._cv:
            return len(self._inbox)

    @property
    def stats(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "state": self.state,
            "inbox": self.inbox_depth,
            "admitted": self.admitted,
            "batches": self.batches,
        }

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "AsyncEngine":
        """Start the executor thread (idempotent while running)."""
        with self._cv:
            if self._state == "running":
                return self
            if self._state in ("draining", "stopped"):
                raise RuntimeError(f"cannot start a {self._state} engine")
            self._state = "running"
            self._thread = threading.Thread(
                target=self._run, name=f"repro-serve-{self.name}", daemon=True
            )
            self._thread.start()
        return self

    def submit(self, item, trace_id: Optional[int] = None) -> Future:
        """Queue one work item; the Future resolves to its result as a host
        array (a score row for batched, activations for streaming infer).
        Raises :class:`QueueFull` on backpressure and :class:`EngineStopped`
        once draining has begun.

        ``trace_id`` correlates this item's spans with an existing trace;
        when tracing is on and no id is given, one is minted here (and
        written back onto an item that carries a ``trace_id`` attribute)."""
        if self.tracer is not None:
            if trace_id is None:
                trace_id = getattr(item, "trace_id", None)
            if trace_id is None:
                trace_id = self.tracer.new_trace()
            if hasattr(item, "trace_id") and item.trace_id is None:
                item.trace_id = trace_id
        with self._cv:
            if self._state in ("draining", "stopped"):
                self.metrics.rejected.inc()
                raise EngineStopped(
                    "engine is draining/stopped; new submits are rejected"
                )
            if (
                self.config.max_queue is not None
                and len(self._inbox) >= self.config.max_queue
            ):
                self.metrics.rejected.inc()
                raise QueueFull(
                    f"engine inbox at max_queue={self.config.max_queue}"
                )
            fut: Future = Future()
            if trace_id is not None:
                fut.trace_id = trace_id  # caller-visible correlation handle
            self._inbox.append(
                _Work(item, fut, time.perf_counter(), self._next_tag,
                      trace_id=trace_id)
            )
            self._next_tag += 1
            self.metrics.submitted.inc()
            self.metrics.queue_depth.set(len(self._inbox))
            self._cv.notify_all()
        return fut

    def drain_and_stop(self, timeout: Optional[float] = None) -> List[Any]:
        """Reject new submits, finish queued + in-flight work, stop.

        Returns the work items the loop could NOT complete — the restart
        contract: empty after a graceful drain (every queued and in-flight
        item was served before the thread exited), non-empty when the loop
        crashed (the still-queued inbox plus any in-flight items; their
        futures were failed with :class:`EngineStopped` carrying the causal
        exception).  A supervisor re-enqueues the returned items onto a
        replacement engine instead of re-reading private engine state.
        Idempotent: repeated calls return the same
        list.

        Raises ``TimeoutError`` (leaving the engine ``draining``) if the
        loop is still working when ``timeout`` expires — the engine is NOT
        marked stopped while its thread may still drive the plan."""
        with self._cv:
            if self._state == "stopped":
                return list(self._leftover)
            if self._state == "new":
                # Work queued before start(): run it to completion rather
                # than dropping futures on the floor.
                self._state = "running"
                self._thread = threading.Thread(
                    target=self._run, name=f"repro-serve-{self.name}",
                    daemon=True,
                )
                self._thread.start()
            self._state = "draining"
            self._cv.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(
                f"engine still draining after {timeout}s; retry "
                "drain_and_stop() — a second engine must not bind while "
                "this thread drives the plan"
            )
        with self._cv:
            self._state = "stopped"
            self.metrics.queue_depth.set(0)
            return list(self._leftover)

    # ------------------------------------------------------------ main loop
    @staticmethod
    def _crash_exc(message: str, cause: Optional[BaseException]) -> EngineStopped:
        """EngineStopped carrying the loop's causal exception, so
        ``future.result()`` callers see WHY, not just that it died."""
        exc = EngineStopped(
            f"{message}: {cause!r}" if cause is not None else message
        )
        exc.__cause__ = cause
        return exc

    def _run(self) -> None:
        cause: Optional[BaseException] = None
        device = getattr(self.plan, "device", None)
        on_card = (
            torch.cuda.device(device)
            if device is not None and device.type == "cuda"
            else contextlib.nullcontext()
        )
        try:
            with on_card:
                if self.plan.name == "decode":
                    self._loop_decode()
                elif self.plan.name == "batched":
                    self._loop_batched()
                elif self.plan.name == "continual":
                    self._loop_continual()
                else:
                    self._loop_streaming()
        except BaseException as e:
            cause = e
            raise
        finally:
            # A crashed loop must not strand futures or keep accepting
            # work: mark the engine stopped (submit() then raises
            # EngineStopped), fail whatever is left queued, and record the
            # undone items so drain_and_stop() can hand them to a
            # supervisor for re-enqueue (hot restart).
            with self._cv:
                self._state = "stopped"
                leftover = list(self._inbox)
                self._inbox.clear()
                self._leftover.extend(w.item for w in leftover)
            for w in leftover:
                self._fail(
                    w,
                    self._crash_exc("engine loop exited with work queued", cause),
                )

    def _claim(self, work: _Work) -> bool:
        """Transition a dequeued future to running; False when the caller
        cancelled it while it waited (skip the work, don't serve it)."""
        return work.future.set_running_or_notify_cancel()

    def _span_inbox(self, work: _Work, now: float) -> None:
        """Submit -> claim dwell in this engine's inbox (one hop of the
        request's trace); no-op unless both tracer and trace id exist."""
        if self.tracer is not None and work.trace_id is not None:
            self.tracer.record(work.trace_id, "engine.inbox",
                               work.t_submit, now, engine=self.name)

    def _complete(self, work: _Work, result) -> None:
        work.future.set_result(result)
        self.metrics.completed.inc()
        now = time.perf_counter()
        self.metrics.e2e_s.observe(now - work.t_submit)
        if self.tracer is not None and work.trace_id is not None:
            self.tracer.record(work.trace_id, "engine.e2e",
                               work.t_submit, now, engine=self.name)

    @staticmethod
    def _fail(work: _Work, exc: BaseException) -> None:
        """set_exception that tolerates caller-cancelled futures."""
        if work.future.cancelled() or work.future.done():
            return
        if work.future.running() or work.future.set_running_or_notify_cancel():
            work.future.set_exception(exc)

    # ------------------------------------------------------------- decode
    def _pop_next_decode(self) -> _Work:
        """Next request under the configured policy (caller holds _cv)."""
        if self.config.policy == "sjf":
            i = min(range(len(self._inbox)), key=lambda j: len(self._inbox[j].item.prompt))
            w = self._inbox[i]
            del self._inbox[i]
            return w
        return self._inbox.popleft()

    @torch.inference_mode()
    def _loop_decode(self) -> None:
        """Continuous batching: admission happens between steps, so a
        request submitted mid-flight lands in the next freed slot."""
        sess = self.plan.session()
        inflight: Dict[int, _Work] = {}  # tag -> work
        popped: Deque[_Work] = deque()  # taken from the inbox, not yet admitted
        try:
            while True:
                # Pop as many queued requests as there are free slots
                # (under the lock), then prefill and admit outside it:
                # submitters must not block behind a prefill.
                with self._cv:
                    while not self._inbox and not sess.has_active() and self._state == "running":
                        self._cv.wait(self._POLL_S)
                    if not self._inbox and not sess.has_active() and self._state != "running":
                        break
                    n_free = sess.free_slots()
                    while self._inbox and len(popped) < n_free:
                        popped.append(self._pop_next_decode())
                    self.metrics.queue_depth.set(len(self._inbox))
                now = time.perf_counter()
                admitted_now = 0
                while popped:
                    w = popped[0]  # leaves only once admitted or failed
                    if self._claim(w):  # else the caller cancelled it while queued
                        self.metrics.queue_wait_s.observe(now - w.t_submit)
                        self._span_inbox(w, now)
                        try:
                            sess.admit(w.item, tag=w.tag)
                            inflight[w.tag] = w
                            admitted_now += 1
                        except Exception as e:  # noqa: BLE001 — per-request failure
                            w.future.set_exception(e)
                    popped.popleft()
                if admitted_now:
                    with self._cv:
                        self.admitted += admitted_now
                if sess.has_active():
                    for tag, completion in sess.step():
                        self._complete(inflight.pop(tag), completion)
        except BaseException as e:
            # A crash must not strand a future: the admitted requests and
            # those taken from the inbox but not admitted yet (a crash in
            # a prefill) fail with the real cause, and count as undone
            # work for the restart seam.  (The reference fails only the
            # admitted ones, and the others' futures never resolve.)
            undone = list(inflight.values()) + list(popped)
            with self._cv:
                self._leftover.extend(w.item for w in undone)
            for w in undone:
                self._fail(w, self._crash_exc("engine loop crashed with requests in flight", e))
            raise

    # ------------------------------------------------- batched (micro-batch)
    def _loop_batched(self) -> None:
        """Deadline-driven micro-batching: a batch opens at the first
        dequeued item and dispatches when it reaches ``max_batch`` or
        ``max_wait_s`` after opening — partial batches fly rather than
        waiting forever."""
        cfg = self.config
        while True:
            batch: List[_Work] = []
            with self._cv:
                while not self._inbox and self._state == "running":
                    self._cv.wait(self._POLL_S)
                if not self._inbox and self._state != "running":
                    break
                batch.append(self._inbox.popleft())
                t_open = time.perf_counter()  # the batch opens HERE
                deadline = t_open + cfg.max_wait_s
                while len(batch) < cfg.max_batch:
                    if self._inbox:
                        batch.append(self._inbox.popleft())
                        continue
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0 or self._state != "running":
                        break
                    self._cv.wait(remaining)
                self.metrics.queue_depth.set(len(self._inbox))
            batch = [w for w in batch if self._claim(w)]  # drop cancelled
            if not batch:
                continue
            now = time.perf_counter()
            for w in batch:
                self.metrics.queue_wait_s.observe(now - w.t_submit)
                if self.tracer is not None and w.trace_id is not None:
                    # Two hops: inbox dwell before the batch opened, then
                    # the aggregation window (waiting for max_batch /
                    # max_wait_s) until dispatch.
                    joined = max(w.t_submit, t_open)
                    self.tracer.record(w.trace_id, "engine.inbox",
                                       w.t_submit, joined, engine=self.name)
                    self.tracer.record(w.trace_id, "engine.batch_agg",
                                       joined, now, engine=self.name,
                                       batch=len(batch))
            try:
                x = np.stack([np.asarray(w.item) for w in batch])
                # torchlint: allow[TL001] reason=futures resolve to host arrays; one read back a micro-batch, after the plan's guarded dispatch
                scores = self.plan.predict(x).cpu().numpy()
                with self._cv:
                    self.batches += 1
                t_done = time.perf_counter()
                for i, w in enumerate(batch):
                    if self.tracer is not None and w.trace_id is not None:
                        self.tracer.record(w.trace_id, "engine.batch",
                                           now, t_done, engine=self.name,
                                           batch=len(batch))
                    self._complete(w, scores[i])
            except Exception as e:  # noqa: BLE001 — fail the whole batch
                for w in batch:
                    w.future.set_exception(e)
            except BaseException as e:
                # Loop-killing crash mid-batch: the claimed futures must not
                # hang, and the items count as undone for the restart seam.
                with self._cv:
                    self._leftover.extend(w.item for w in batch)
                for w in batch:
                    self._fail(
                        w,
                        self._crash_exc(
                            "engine loop crashed with a batch in flight", e
                        ),
                    )
                raise

    # ------------------------------------ per item: streaming, continual
    def _loop_streaming(self) -> None:
        """Per-item inference through the streaming session: the lowest
        latency path; coalesced training feeds stay on the sync surface.
        The streaming plan answers with a host array already."""
        self._loop_items(lambda item, _trace_id: self.plan.infer(np.asarray(item)))

    def _loop_continual(self) -> None:
        """Update/infer interleave on the ONE loop thread: labeled Feedback
        items run the plan's online-learning step (micro-batch Hebbian
        update, merge, drift safety loop), everything else is per-item
        inference (a host score row), so a rollback can never race an
        in-flight prediction, and every future (feedback acks included)
        resolves in arrival order."""
        from repro_torch.runtime.continual import Feedback

        def serve(item, trace_id):
            if not isinstance(item, Feedback):
                # torchlint: allow[TL001] reason=futures resolve to host score rows; after the plan's guarded dispatch
                return self.plan.infer(np.asarray(item)).cpu().numpy()
            t0 = time.perf_counter()
            ack = self.plan.learn(item)
            if self.tracer is not None and trace_id is not None:
                self.tracer.record(trace_id, "engine.learn", t0, time.perf_counter(),
                                   engine=self.name, tenant=item.tenant)
            return ack

        self._loop_items(serve)

    def _loop_items(self, serve) -> None:
        """One item at a time, in arrival order: ``serve(item, trace_id)``
        gives the item's result."""
        while True:
            with self._cv:
                while not self._inbox and self._state == "running":
                    self._cv.wait(self._POLL_S)
                if not self._inbox and self._state != "running":
                    break
                w = self._inbox.popleft()
                self.metrics.queue_depth.set(len(self._inbox))
            if not self._claim(w):
                continue  # caller cancelled while queued
            now = time.perf_counter()
            self.metrics.queue_wait_s.observe(now - w.t_submit)
            self._span_inbox(w, now)
            try:
                self._complete(w, serve(w.item, w.trace_id))
            except Exception as e:  # noqa: BLE001 — per-item failure
                w.future.set_exception(e)
            except BaseException as e:
                # Loop-killing crash mid-item: fail the claimed future and
                # hand the item back through the restart seam.
                with self._cv:
                    self._leftover.append(w.item)
                self._fail(
                    w,
                    self._crash_exc(
                        "engine loop crashed with an item in flight", e
                    ),
                )
                raise
