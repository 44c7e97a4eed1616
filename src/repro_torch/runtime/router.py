"""Serving fabric: an SLO-aware Router scheduling N AsyncEngines.

The port of the JAX package's ``repro/runtime/router.py``.  One
:class:`~repro_torch.runtime.engine.AsyncEngine` owns exactly one
ServePlan: one decode loop, one batched head, one streaming session, one
continual learner.  The Router is the fabric that turns those single-plan
engines into a multi-tenant service on one box (several decode engines
over one shared model, beside batched, streaming and continual engines),
all behind one futures API::

    router = Router(RouterConfig(tenants={"free": TenantConfig(weight=1),
                                          "paid": TenantConfig(weight=4)}))
    router.add_engine("decode0", factory, config)   # factory -> ServePlan
    router.add_engine("decode1", factory, config)
    router.start()
    fut = router.submit(request, tenant="paid", priority=1, deadline_s=0.5)

The scheduler thread launches no kernel: it only moves work into engine
inboxes, and each engine's own thread runs its plan on the plan's device.

The scheduling model, from the outside in:

* **Per-tenant bounded queues.**  Every tenant owns its own queue (bounded
  by ``TenantConfig.max_queue``); overload is shed *per tenant* with a
  typed :class:`TenantQueueFull` — one tenant flooding the box can never
  FIFO-starve another tenant's admission.
* **EDF within a tenant.**  A tenant's queue orders by ``(priority desc,
  deadline asc, arrival)`` — earliest-deadline-first among equal
  priorities.  A request whose deadline expires while queued is shed
  *before* dispatch: its future fails with :class:`DeadlineExceeded`
  (the causal exception, never a silent drop), and the engine never pays
  for work that already missed its SLO.
* **Deficit round-robin across tenants.**  Each scheduling round credits
  every backlogged tenant ``quantum * weight`` dispatch credits; a tenant
  spends one credit per dispatch and unspent credit carries (bounded), so
  a low-weight tenant always makes progress under a flood (weighted
  fairness, not priority starvation).
* **Telemetry-driven engine selection.**  Within the target pool (engines
  grouped by plan name: decode / batched / streaming / continual), the
  Router routes to the engine with the lowest p95 queue-wait read from the engine's
  histograms (:meth:`ServiceMetrics.snapshot` — one consistent lock
  acquisition), tie-broken by inbox depth then least-recently-used.
  ``RouterConfig(routing="round_robin")`` keeps the naive policy as the
  benchmark baseline.  Engine inboxes stay shallow (``max_queue`` on the
  engine's ServiceConfig) so queueing — and therefore policy — lives in
  the Router, not in FIFO inboxes.
* **Continual-tier awareness.**  Engines serving the ``continual`` plan
  hold per-tenant adapter state on their device, so the Router
  pins each tenant to the first continual engine that served it
  (``(pool, tenant) -> slot`` affinity; a full pinned engine HOLDS the
  tenant's work rather than migrating it and abandoning the adapter).
  While a continual engine's drift window reads degraded, its queued
  work is shed with the typed ``DriftDetected`` instead of being fed to
  a drifting model (``RouterConfig(shed_on_drift=False)`` opts out).
* **Health tracking + hot restart.**  A crashed engine loop fails its
  futures with ``EngineStopped``; the Router's completion hook re-enqueues
  those requests (bounded by ``max_redispatch``) instead of surfacing the
  crash, and the scheduler's health check builds a replacement engine from
  the slot's plan factory (``factory(config, metrics) -> ServePlan``) —
  the same :meth:`AsyncEngine.drain_and_stop` contract returns the undone
  items, and the replacement inherits the slot's metrics bundle so the
  scheduling signal survives the restart.  ``max_restarts`` bounds crash
  loops; a pool whose engines are all dead fails its queued work with
  :class:`NoEngineAvailable` rather than hanging it.

Threading: ONE scheduler thread owns dispatch; caller threads submit and
engine executor threads complete.  All shared state is guarded by one
condition variable, and caller-visible futures are only ever resolved OUTSIDE the
lock — a future callback may legally re-enter ``submit``.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.runtime.continual import DriftDetected
from repro_torch.runtime.engine import AsyncEngine, EngineStopped, QueueFull
from repro_torch.runtime.metrics import RouterMetrics
from repro_torch.runtime.trace import (
    DeadlineShed,
    EngineRestart,
    TenantShed,
    build_tracer,
)

__all__ = [
    "RouterError",
    "TenantQueueFull",
    "DeadlineExceeded",
    "NoEngineAvailable",
    "RouterStopped",
    "TenantConfig",
    "RouterConfig",
    "Router",
]

ROUTING_POLICIES = ("p95", "round_robin")


class RouterError(RuntimeError):
    """Base class for router-level failures."""


class TenantQueueFull(RouterError):
    """submit() bounced off ONE tenant's bounded queue (per-tenant shed —
    other tenants' admission is unaffected)."""

    def __init__(self, tenant: str, depth: int, bound: int):
        super().__init__(
            f"tenant {tenant!r} queue at max_queue={bound} (depth {depth}); "
            "shedding this tenant's new work, not other tenants'"
        )
        self.tenant = tenant
        self.depth = depth
        self.bound = bound


class DeadlineExceeded(RouterError):
    """The request's deadline expired while it waited in the router queue;
    it was shed BEFORE dispatch (the engine never paid for it).  Carried on
    the request's future."""

    def __init__(self, tenant: str, deadline_s: float, waited_s: float):
        super().__init__(
            f"deadline_s={deadline_s:.4f} expired after waiting "
            f"{waited_s:.4f}s in tenant {tenant!r}'s queue; shed before "
            "dispatch"
        )
        self.tenant = tenant
        self.deadline_s = deadline_s
        self.waited_s = waited_s


class NoEngineAvailable(RouterError):
    """No live engine serves the request's pool (none registered, or every
    slot exhausted its restart budget)."""


class RouterStopped(RouterError):
    """submit() after drain_and_stop() began."""


# ------------------------------------------------------------------- config
@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """Per-tenant scheduling knobs.

    weight:    deficit-round-robin share (dispatch credits per round are
               ``quantum * weight``); relative across tenants.
    max_queue: bounded router-queue depth for this tenant; submits beyond
               it raise :class:`TenantQueueFull`.  None = unbounded.
    """

    weight: float = 1.0
    max_queue: Optional[int] = 256

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1, got {self.max_queue}"
            )


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Everything about *how* the fleet schedules, none of *what* it serves.

    tenants:        pre-registered tenant configs; unknown tenants at
                    submit() auto-register with ``default_tenant``.
    default_tenant: config applied to auto-registered tenants.
    routing:        "p95" (lowest p95 queue-wait from the engine's
                    telemetry histograms, depth tie-break) or
                    "round_robin" (least-recently-used; the baseline the
                    benchmark compares against).
    quantum:        DRR credits granted per round per unit weight.
    max_restarts:   hot-restart budget per engine slot; beyond it the slot
                    is dead (its pool fails over to surviving slots).
    max_redispatch: re-enqueue budget per request across engine crashes
                    before its future fails with the causal EngineStopped.
    p95_refresh_s:  how often the cached per-engine p95 scheduling signal
                    is re-read from the metrics snapshot.
    spill_patience_s: SLO-aware hold (p95 routing only): when the only
                    engine with inbox capacity has a p95 queue-wait more
                    than this much worse than the pool's best engine, keep
                    the work in the router queue instead of feeding the
                    degraded replica — the best engine's next completion
                    re-wakes the scheduler, so the hold costs at most
                    about one service time.  0 = pure work-conserving.
    poll_s:         scheduler idle wakeup (health checks + deadline sheds
                    happen at least this often).
    shed_on_drift:  when True (default), queued work whose tenant is
                    pinned to a continual engine that currently reads
                    drifted (``plan.drifting``) is shed with the causal
                    ``DriftDetected`` instead of dispatched — callers see
                    a typed refusal while the plan's safety loop rolls
                    back, never silent answers from a degraded model.
    trace:          optional :class:`~repro_torch.runtime.trace.TraceConfig`.
                    When set, the Router owns ONE Tracer for the whole
                    fabric: it mints trace ids at the front door, records
                    router.sched / router.e2e spans, journals restart and
                    shed events, and hands the tracer to every engine and
                    plan it builds.  None (default) keeps every span site
                    a dead ``is not None`` check — zero allocation, zero
                    lock traffic.
    """

    tenants: Mapping[str, TenantConfig] = dataclasses.field(
        default_factory=dict
    )
    default_tenant: TenantConfig = TenantConfig()
    routing: str = "p95"
    quantum: float = 1.0
    max_restarts: int = 3
    max_redispatch: int = 8
    p95_refresh_s: float = 0.05
    spill_patience_s: float = 0.02
    poll_s: float = 0.02
    shed_on_drift: bool = True
    trace: Optional[Any] = None

    def __post_init__(self):
        if self.trace is not None:
            from repro_torch.runtime.trace import TraceConfig

            if not isinstance(self.trace, TraceConfig):
                raise TypeError(
                    f"trace must be a TraceConfig, got {type(self.trace).__name__}"
                )
        if self.routing not in ROUTING_POLICIES:
            raise ValueError(
                f"Unknown routing {self.routing!r} "
                f"(want one of {ROUTING_POLICIES})"
            )
        if self.quantum <= 0:
            raise ValueError(f"quantum must be > 0, got {self.quantum}")
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {self.max_restarts}"
            )
        if self.max_redispatch < 0:
            raise ValueError(
                f"max_redispatch must be >= 0, got {self.max_redispatch}"
            )
        if self.spill_patience_s < 0:
            raise ValueError(
                f"spill_patience_s must be >= 0, got {self.spill_patience_s}"
            )
        if self.poll_s <= 0:
            raise ValueError(f"poll_s must be > 0, got {self.poll_s}")


# ------------------------------------------------------------ internal state
@dataclasses.dataclass
class _RouterWork:
    """One submitted request plus its scheduling envelope."""

    item: Any
    future: Future
    tenant: str
    pool: str
    priority: float
    deadline: Optional[float]  # absolute perf_counter deadline
    deadline_s: Optional[float]  # caller-relative, for error messages
    t_submit: float
    seq: int
    retries: int = 0
    claimed: bool = False  # set_running_or_notify_cancel already done
    trace_id: Optional[int] = None  # fabric trace id (None = tracing off)

    def key(self) -> Tuple[float, float, int]:
        """EDF-within-priority heap key: higher priority first, then
        earliest deadline, then arrival order."""
        d = self.deadline if self.deadline is not None else float("inf")
        return (-self.priority, d, self.seq)


class _TenantState:
    """One tenant's queues (a heap per pool) + DRR bookkeeping.  All fields
    are guarded by the Router's condition variable."""

    def __init__(self, name: str, cfg: TenantConfig):
        self.name = name
        self.cfg = cfg
        self.heaps: Dict[str, List[Tuple[Tuple[float, float, int], _RouterWork]]] = {}
        self.depth = 0
        self.deficit = 0.0

    def push(self, work: _RouterWork) -> None:
        heapq.heappush(
            self.heaps.setdefault(work.pool, []), (work.key(), work)
        )
        self.depth += 1

    def deficit_cap(self, quantum: float) -> float:
        # Carry at most a few rounds of credit: a tenant blocked on engine
        # capacity stays entitled, but can never bank an unbounded burst.
        return max(1.0, quantum * self.cfg.weight) * 4.0


class _EngineSlot:
    """One engine position in the fleet: the live engine plus the factory
    that rebuilds its plan on hot restart.  Guarded by the Router's cv."""

    def __init__(self, name, pool, factory, config, metrics):
        self.name = name
        self.pool = pool
        self.factory = factory
        self.config = config
        self.metrics = metrics  # survives restarts: scheduling signal
        self.engine: Optional[AsyncEngine] = None
        self.restarts = 0
        self.dead = False
        self.last_used = 0  # global dispatch stamp (LRU round-robin)
        self.p95 = 0.0
        self.p95_read_t = float("-inf")


# -------------------------------------------------------------------- router
class Router:
    """SLO-aware front door over N AsyncEngines (see module docstring).

    Lifecycle mirrors the engine: ``new`` (submits queue, nothing
    dispatches) -> ``running`` (scheduler live) -> ``draining`` (no new
    submits; queued + in-flight work finishes) -> ``stopped``.
    """

    def __init__(self, config: Optional[RouterConfig] = None):
        self.config = config if config is not None else RouterConfig()
        self.metrics = RouterMetrics()
        # ONE tracer per fabric (None unless config.trace enables it); the
        # Router mints trace ids and every engine/plan it builds shares it.
        self.tracer = build_tracer(self.config.trace)
        self._cv = threading.Condition()
        self._state = "new"
        self._thread: Optional[threading.Thread] = None
        self._slots: Dict[str, _EngineSlot] = {}
        self._tenants: Dict[str, _TenantState] = {}
        self._ring: List[str] = []  # tenant visit order (first-submit order)
        self._ring_idx = 0
        self._seq = 0
        self._dispatch_stamp = 0
        self._inflight = 0
        # (pool, tenant) -> slot name.  Continual engines hold per-tenant
        # adapter state on-device, so a tenant must keep landing on the
        # engine that owns its adapter; entries are dropped when the slot
        # dies (the adapter died with it).
        self._affinity: Dict[Tuple[str, str], str] = {}

    # ---------------------------------------------------------------- fleet
    def add_engine(
        self,
        name: str,
        factory: Callable[..., Any],
        config: Optional[Any] = None,
    ) -> "Router":
        """Register one engine slot.  ``factory(service_config, metrics)``
        must return a fresh ServePlan — it is called now AND on every hot
        restart, so it must close over immutable inputs (model + params),
        never over live plan state.  ``config`` is the engine's
        ServiceConfig (its ``max_queue`` bounds the engine inbox — keep it
        shallow so queueing policy stays in the Router)."""
        if config is None:
            from repro_torch.runtime.service import ServiceConfig

            config = ServiceConfig()
        metrics = self.metrics.register_engine(name)
        plan = factory(config, metrics)
        if self.tracer is not None and hasattr(plan, "bind_tracer"):
            plan.bind_tracer(self.tracer)
        engine = AsyncEngine(
            plan, config, metrics=metrics, name=name, tracer=self.tracer
        )
        with self._cv:
            if self._state in ("draining", "stopped"):
                raise RouterStopped(
                    f"cannot add engine to a {self._state} router"
                )
            if name in self._slots:
                raise ValueError(f"engine name {name!r} already registered")
            slot = _EngineSlot(name, plan.name, factory, config, metrics)
            slot.engine = engine
            self._slots[name] = slot
            if self._state == "running":
                engine.start()
            self._cv.notify_all()
        return self

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "Router":
        """Start every registered engine plus the scheduler thread
        (idempotent while running).  Submits made before ``start()`` were
        queued and dispatch now."""
        with self._cv:
            if self._state == "running":
                return self
            if self._state in ("draining", "stopped"):
                raise RouterStopped(f"cannot start a {self._state} router")
            if not self._slots:
                raise NoEngineAvailable(
                    "no engines registered; add_engine() before start()"
                )
            self._state = "running"
            for slot in self._slots.values():
                slot.engine.start()
            self._thread = threading.Thread(
                target=self._sched_loop, name="repro-router-sched", daemon=True
            )
            self._thread.start()
            self._cv.notify_all()
        return self

    def drain_and_stop(self, timeout: Optional[float] = None) -> None:
        """Reject new submits, dispatch and finish everything queued and
        in flight (hot-restarting crashed engines as needed to do so),
        then stop every engine and the scheduler.  No future is dropped:
        every submitted request resolves to a result or a typed exception.
        """
        with self._cv:
            if self._state == "stopped":
                return
            if self._state == "new":
                if self._slots and self._total_depth_locked() > 0:
                    # Queued submits deserve service: run them to
                    # completion rather than dropping futures.
                    self._cv.release()
                    try:
                        self.start()
                    finally:
                        self._cv.acquire()
                elif not self._slots:
                    self._state = "stopped"
                    return
            self._state = "draining"
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"router still draining after {timeout}s; retry "
                    "drain_and_stop()"
                )
        with self._cv:
            slots = list(self._slots.values())
        for slot in slots:
            if slot.engine is not None:
                slot.engine.drain_and_stop(timeout)
        with self._cv:
            self._state = "stopped"

    # --------------------------------------------------------------- submit
    def submit(
        self,
        item: Any,
        tenant: str = "default",
        priority: float = 0.0,
        deadline_s: Optional[float] = None,
        pool: Optional[str] = None,
    ) -> Future:
        """Queue one request; returns a Future resolving to the plan's
        result (a Completion for decode, a score row for batched,
        activations for streaming, an ack dict or a score row for
        continual).

        tenant:     per-tenant queue + fair-share identity (auto-registered
                    with ``default_tenant`` config when unknown).
        priority:   higher dispatches first WITHIN the tenant.
        deadline_s: SLO budget from now; expiry in the router queue sheds
                    the request with :class:`DeadlineExceeded` ON THE
                    FUTURE (already-expired submits shed immediately).
        pool:       target engine pool ("decode"/"batched"/"streaming"/
                    "continual"); when omitted, a decode ``Request`` goes
                    to the decode pool, and a sample to the batched pool,
                    else the streaming pool (``Feedback`` names
                    ``pool="continual"``).

        Raises :class:`TenantQueueFull` (typed per-tenant backpressure),
        :class:`NoEngineAvailable` (no engine serves the pool), and
        :class:`RouterStopped` (after drain began) synchronously."""
        now = time.perf_counter()
        fut: Future = Future()
        tm = self.metrics.tenant(tenant)
        trace_id: Optional[int] = None
        if self.tracer is not None:
            # Front door mints the fabric trace id (or adopts one already
            # stamped on the item) so EVERY downstream hop correlates.
            trace_id = getattr(item, "trace_id", None)
            if trace_id is None:
                trace_id = self.tracer.new_trace()
                if hasattr(item, "trace_id"):
                    item.trace_id = trace_id
            fut.trace_id = trace_id
        with self._cv:
            if self._state in ("draining", "stopped"):
                raise RouterStopped(
                    "router is draining/stopped; new submits are rejected"
                )
            if pool is not None:
                live = {
                    s.pool for s in self._slots.values() if not s.dead
                }
                if pool not in live:
                    raise NoEngineAvailable(
                        f"no live engine serves pool {pool!r} "
                        f"(pools: {sorted(live) or 'none'})"
                    )
                target_pool = pool
            else:
                target_pool = self._infer_pool_locked(item)
            t = self._tenant_locked(tenant)
            if (
                t.cfg.max_queue is not None
                and t.depth >= t.cfg.max_queue
            ):
                tm.shed_queue_full.inc()
                if self.tracer is not None:
                    self.tracer.emit(
                        TenantShed(
                            depth=t.depth,
                            reason="queue_full",
                            trace_id=trace_id,
                            tenant=tenant,
                        )
                    )
                raise TenantQueueFull(tenant, t.depth, t.cfg.max_queue)
            work = _RouterWork(
                item=item,
                future=fut,
                tenant=tenant,
                pool=target_pool,
                priority=float(priority),
                deadline=(now + deadline_s) if deadline_s is not None else None,
                deadline_s=deadline_s,
                t_submit=now,
                seq=self._seq,
                trace_id=trace_id,
            )
            self._seq += 1
            tm.submitted.inc()
            if deadline_s is not None and deadline_s <= 0:
                expired: Optional[_RouterWork] = work
            else:
                expired = None
                t.push(work)
                tm.queue_depth.set(t.depth)
                self._cv.notify_all()
        if expired is not None:
            # Dead on arrival: shed with the causal exception, outside the
            # lock (future callbacks may re-enter submit()).
            tm.shed_deadline.inc()
            if self.tracer is not None:
                self.tracer.emit(
                    DeadlineShed(
                        waited_s=0.0, trace_id=trace_id, tenant=tenant
                    )
                )
            fut.set_exception(
                DeadlineExceeded(tenant, deadline_s, 0.0)
            )
        return fut

    # ------------------------------------------------------- submit helpers
    def _infer_pool_locked(self, item: Any) -> str:
        from repro_torch.runtime.service import Request

        pools = {s.pool for s in self._slots.values() if not s.dead}
        if isinstance(item, Request):
            if "decode" not in pools:
                raise NoEngineAvailable(
                    "decode Request submitted but no decode engine is "
                    f"registered (pools: {sorted(pools) or 'none'})"
                )
            return "decode"
        for pool in ("batched", "streaming"):
            if pool in pools:
                return pool
        raise NoEngineAvailable(
            "sample submitted but no batched/streaming engine is "
            f"registered (pools: {sorted(pools) or 'none'}); pass pool="
        )

    def _tenant_locked(self, name: str) -> _TenantState:
        t = self._tenants.get(name)
        if t is None:
            cfg = self.config.tenants.get(name, self.config.default_tenant)
            t = _TenantState(name, cfg)
            self._tenants[name] = t
            self._ring.append(name)
        return t

    def _total_depth_locked(self) -> int:
        return sum(t.depth for t in self._tenants.values())

    # ------------------------------------------------------ scheduler thread
    def _sched_loop(self) -> None:
        try:
            while True:
                self._health_check()
                if self._dispatch_once():
                    continue
                with self._cv:
                    if (
                        self._state != "running"
                        and self._total_depth_locked() == 0
                        and self._inflight == 0
                    ):
                        break
                    self._cv.wait(self.config.poll_s)
        except BaseException:
            # A scheduler crash must not hang caller futures: fail
            # everything still queued, then re-raise for visibility.
            self._fail_all_queued(
                RouterError("router scheduler crashed; request not dispatched")
            )
            raise

    def _fail_all_queued(self, exc: BaseException) -> None:
        with self._cv:
            victims: List[_RouterWork] = []
            for t in self._tenants.values():
                for heap in t.heaps.values():
                    victims.extend(w for _, w in heap)
                    heap.clear()
                t.depth = 0
        for w in victims:
            self._fail_future(w, exc)

    @staticmethod
    def _fail_future(work: _RouterWork, exc: BaseException) -> None:
        """set_exception tolerating caller-cancelled futures."""
        if work.future.cancelled() or work.future.done():
            return
        work.future.set_exception(exc)

    # ----------------------------------------------------------- health/HA
    def _health_check(self) -> None:
        with self._cv:
            slots = list(self._slots.values())
        for slot in slots:
            engine = slot.engine
            if slot.dead or engine is None or engine.state != "stopped":
                continue
            # Crashed (the router only stops engines after the scheduler
            # exits).  The drain contract hands back the undone items —
            # their futures already failed with EngineStopped, which
            # re-enqueued them via _on_engine_done; the count is the
            # restart's audit trail.
            leftover = engine.drain_and_stop()
            with self._cv:
                if slot.restarts >= self.config.max_restarts:
                    slot.dead = True
                    slot.engine = None
                    self._cv.notify_all()
                    continue
                slot.restarts += 1
            self.metrics.restarts.inc()
            plan = slot.factory(slot.config, slot.metrics)
            if self.tracer is not None and hasattr(plan, "bind_tracer"):
                plan.bind_tracer(self.tracer)
            replacement = AsyncEngine(
                plan,
                slot.config,
                metrics=slot.metrics,
                name=slot.name,
                tracer=self.tracer,
            )
            replacement.start()
            if self.tracer is not None:
                self.tracer.emit(
                    EngineRestart(
                        engine=slot.name,
                        restarts=slot.restarts,
                        leftover=len(leftover),
                    )
                )
            with self._cv:
                slot.engine = replacement
                slot.last_leftover = len(leftover)
                self._cv.notify_all()

    # ------------------------------------------------------------- dispatch
    def _dispatch_once(self) -> bool:
        """One scheduling decision: shed expired work, pick (tenant via
        DRR, item via EDF, engine via telemetry), dispatch outside the
        lock.  Returns True when any progress was made."""
        shed: List[Tuple[_RouterWork, BaseException]] = []
        with self._cv:
            if self._state not in ("running", "draining"):
                return False
            picked = self._pick_locked(shed)
            if picked is not None:
                work, slot = picked
                self._inflight += 1
        progressed = False
        for w, exc in shed:
            tm = self.metrics.tenant(w.tenant)
            if isinstance(exc, DeadlineExceeded):
                tm.shed_deadline.inc()
                if self.tracer is not None:
                    self.tracer.emit(
                        DeadlineShed(
                            waited_s=exc.waited_s,
                            trace_id=w.trace_id,
                            tenant=w.tenant,
                        )
                    )
            elif isinstance(exc, DriftDetected):
                tm.shed_drift.inc()
                if self.tracer is not None:
                    self.tracer.emit(
                        TenantShed(
                            reason="drift",
                            trace_id=w.trace_id,
                            tenant=w.tenant,
                        )
                    )
            else:
                tm.failed.inc()
            self._fail_future(w, exc)
            progressed = True
        if picked is None:
            return progressed
        progressed = True
        if not work.claimed:
            if not work.future.set_running_or_notify_cancel():
                # Caller cancelled while queued: skip, never dispatch.
                with self._cv:
                    self._inflight -= 1
                return progressed
            work.claimed = True
        try:
            engine_future = slot.engine.submit(
                work.item, trace_id=work.trace_id
            )
        except (QueueFull, EngineStopped):
            # Lost a race with a crash (or a foreign submitter filled the
            # inbox): put the work back; the health check rebuilds the
            # engine and the next round redispatches.
            with self._cv:
                self._inflight -= 1
                self._requeue_locked(work)
            return progressed
        tm = self.metrics.tenant(work.tenant)
        t_disp = time.perf_counter()
        tm.sched_wait_s.observe(t_disp - work.t_submit)
        if self.tracer is not None and work.trace_id is not None:
            # "target" (not "engine") keeps this span on the router's
            # chrome-trace track while still naming the chosen engine.
            self.tracer.record(
                work.trace_id,
                "router.sched",
                work.t_submit,
                t_disp,
                tenant=work.tenant,
                pool=work.pool,
                target=slot.name,
            )
        self.metrics.dispatched.inc()
        engine_future.add_done_callback(
            lambda f, w=work, s=slot: self._on_engine_done(w, s, f)
        )
        return progressed

    def _requeue_locked(self, work: _RouterWork) -> None:
        t = self._tenant_locked(work.tenant)
        t.push(work)
        self.metrics.tenant(work.tenant).queue_depth.set(t.depth)
        self._cv.notify_all()

    def _pick_locked(
        self, shed: List[Tuple[_RouterWork, BaseException]]
    ) -> Optional[Tuple[_RouterWork, _EngineSlot]]:
        """DRR across tenants, EDF within, capacity-gated engine choice.
        Expired/dead-pool work is moved into ``shed`` for the caller to
        fail outside the lock.

        Each engine's inbox depth is read once, before the scan: an engine
        thread that takes an item mid-scan must not hand the freed slot to
        a tenant later in the ring while the tenant at the ring's head,
        which holds the credit, was just turned away as full.  (The JAX
        package's Router reads the depth live at every tenant, so which
        tenant is served there can depend on thread timing.)"""
        now = time.perf_counter()
        cfg = self.config
        depths = {
            name: slot.engine.inbox_depth
            for name, slot in self._slots.items()
            if slot.engine is not None
        }
        for attempt in (0, 1):
            n = len(self._ring)
            credit_blocked = False
            for k in range(n):
                i = (self._ring_idx + k) % n
                t = self._tenants[self._ring[i]]
                if t.depth == 0:
                    t.deficit = 0.0  # classic DRR: empty queue forfeits
                    continue
                if t.deficit < 1.0:
                    continue
                picked = self._pop_tenant_locked(t, now, shed, depths)
                if picked is None:
                    credit_blocked = True  # capacity, not credit
                    continue
                t.deficit -= 1.0
                self._ring_idx = (
                    i if (t.deficit >= 1.0 and t.depth > 0) else (i + 1) % n
                )
                return picked
            if attempt == 0:
                if credit_blocked:
                    # Someone holds unspent credit and is blocked only by
                    # engine capacity: replenishing now would let a heavy
                    # tenant bank credit every blocked poll and starve the
                    # light ones.  Wait for capacity instead — deficits
                    # only refill once the outstanding credit is spent.
                    return None
                backlogged = [
                    t for t in self._tenants.values() if t.depth > 0
                ]
                if not backlogged:
                    return None
                for t in backlogged:
                    t.deficit = min(
                        t.deficit + cfg.quantum * t.cfg.weight,
                        t.deficit_cap(cfg.quantum),
                    )
        return None

    def _pop_tenant_locked(
        self,
        t: _TenantState,
        now: float,
        shed: List[Tuple[_RouterWork, BaseException]],
        depths: Dict[str, int],
    ) -> Optional[Tuple[_RouterWork, _EngineSlot]]:
        """EDF across this tenant's pool heaps, considering only pools
        whose engines have inbox capacity (by ``depths``, the inbox depths
        the pick read).  Sheds expired / cancelled / dead-pool work
        encountered at the heads."""
        best_pool: Optional[str] = None
        best_slot: Optional[_EngineSlot] = None
        best_key = None
        tm = self.metrics.tenant(t.name)
        for pool, heap in t.heaps.items():
            while heap:
                key, work = heap[0]
                if work.future.cancelled():
                    heapq.heappop(heap)
                    t.depth -= 1
                    continue
                if work.deadline is not None and now > work.deadline:
                    heapq.heappop(heap)
                    t.depth -= 1
                    shed.append(
                        (
                            work,
                            DeadlineExceeded(
                                t.name, work.deadline_s, now - work.t_submit
                            ),
                        )
                    )
                    continue
                break
            if not heap:
                continue
            slot = self._slot_for_pool_locked(pool, now, depths, tenant=t.name)
            if slot is None:
                if self._pool_dead_locked(pool):
                    # Every slot exhausted its restart budget: fail the
                    # whole backlog rather than hanging it forever.
                    while heap:
                        _, work = heapq.heappop(heap)
                        t.depth -= 1
                        shed.append(
                            (
                                work,
                                NoEngineAvailable(
                                    f"pool {pool!r} has no surviving engine "
                                    f"(restart budget exhausted)"
                                ),
                            )
                        )
                continue
            if (
                self.config.shed_on_drift
                and getattr(slot.engine.plan, "drifting", False)
            ):
                # The tenant's continual engine reads degraded: refuse
                # its whole backlog with the causal exception while the
                # plan's safety loop rolls back, rather than serving
                # answers from (or learning into) a drifting model.
                exc = self._drift_exc_locked(slot)
                while heap:
                    _, work = heapq.heappop(heap)
                    t.depth -= 1
                    shed.append((work, exc))
                continue
            if best_key is None or heap[0][0] < best_key:
                best_key = heap[0][0]
                best_pool, best_slot = pool, slot
        tm.queue_depth.set(t.depth)
        if best_pool is None:
            return None
        _, work = heapq.heappop(t.heaps[best_pool])
        t.depth -= 1
        tm.queue_depth.set(t.depth)
        self._dispatch_stamp += 1
        best_slot.last_used = self._dispatch_stamp
        if best_pool == "continual":
            # Adapter residency: this tenant's per-tenant LayerState now
            # lives on this engine — pin its future traffic there.
            self._affinity[(best_pool, t.name)] = best_slot.name
        return work, best_slot

    @staticmethod
    def _drift_exc_locked(slot: _EngineSlot) -> BaseException:
        """Build the DriftDetected carried on sheds from a drifting
        continual engine, from the slot's own drift telemetry."""
        dw = slot.metrics.drift
        snap = dw.snapshot()
        baseline = snap.get("baseline_accuracy")
        return DriftDetected(
            baseline_accuracy=baseline if baseline is not None else 0.0,
            accuracy=snap["accuracy"],
            samples=snap["samples"],
            threshold=dw.threshold,
        )

    def _pool_dead_locked(self, pool: str) -> bool:
        slots = [s for s in self._slots.values() if s.pool == pool]
        return bool(slots) and all(s.dead for s in slots)

    def _slot_for_pool_locked(
        self,
        pool: str,
        now: float,
        depths: Dict[str, int],
        tenant: Optional[str] = None,
    ) -> Optional[_EngineSlot]:
        """The pool's best engine with inbox capacity: lowest cached p95
        queue-wait (telemetry-driven), tie-broken by inbox depth then
        least-recently-used; ``routing="round_robin"`` uses LRU only.

        SLO-aware hold: under p95 routing, when every engine with capacity
        is ``spill_patience_s`` worse than the pool's best engine, returns
        None — the work waits (briefly) for the good engine rather than
        spilling onto a degraded replica.

        Tenant affinity: a ``(pool, tenant)`` pin (recorded when a
        continual engine first serves the tenant) short-circuits
        selection — the tenant's adapter state lives on that engine, so a
        full or restarting pinned engine HOLDS the work (returns None)
        instead of migrating it; only a dead pin (adapter gone for good)
        is dropped and falls through to fresh selection."""
        if tenant is not None:
            pinned = self._affinity.get((pool, tenant))
            if pinned is not None:
                slot = self._slots.get(pinned)
                if slot is None or slot.dead:
                    # The adapter died with the engine: re-pinning
                    # elsewhere restarts this tenant from the shared base.
                    self._affinity.pop((pool, tenant), None)
                else:
                    engine = slot.engine
                    if engine is None or engine.state != "running":
                        return None  # restarting: hold, don't migrate
                    if (
                        slot.config.max_queue is not None
                        and depths[slot.name] >= slot.config.max_queue
                    ):
                        return None  # full: hold for the pinned engine
                    return slot
        best = None
        best_key = None
        pool_best_p95 = None  # across ALL live slots, full or not
        for slot in self._slots.values():
            if slot.pool != pool or slot.dead or slot.engine is None:
                continue
            engine = slot.engine
            if engine.state != "running":
                continue
            depth = depths[slot.name]
            if self.config.routing != "round_robin":
                if now - slot.p95_read_t > self.config.p95_refresh_s:
                    snap = slot.metrics.snapshot()
                    slot.p95 = snap["queue_wait_s"]["p95"]
                    slot.p95_read_t = now
                if pool_best_p95 is None or slot.p95 < pool_best_p95:
                    pool_best_p95 = slot.p95
            if (
                slot.config.max_queue is not None
                and depth >= slot.config.max_queue
            ):
                continue
            if self.config.routing == "round_robin":
                key = (slot.last_used,)
            else:
                key = (slot.p95, depth, slot.last_used)
            if best_key is None or key < best_key:
                best, best_key = slot, key
        if (
            best is not None
            and self.config.routing != "round_robin"
            and self.config.spill_patience_s > 0
            and best.p95 > pool_best_p95 + self.config.spill_patience_s
        ):
            return None  # hold for the better (currently full) engine
        return best

    # ----------------------------------------------------------- completion
    def _on_engine_done(
        self, work: _RouterWork, slot: _EngineSlot, engine_future: Future
    ) -> None:
        """Engine-thread completion hook: resolve the caller future, or —
        when the engine died under the request — re-enqueue for the
        replacement engine instead of surfacing the crash."""
        exc = engine_future.exception()
        tm = self.metrics.tenant(work.tenant)
        requeued = False
        with self._cv:
            self._inflight -= 1
            if isinstance(exc, EngineStopped) and self._state != "stopped":
                if work.retries < self.config.max_redispatch:
                    work.retries += 1
                    self._requeue_locked(work)
                    requeued = True
            self._cv.notify_all()
        if requeued:
            tm.requeued.inc()
            return
        if exc is None:
            tm.completed.inc()
            t_done = time.perf_counter()
            tm.e2e_s.observe(t_done - work.t_submit)
            if self.tracer is not None and work.trace_id is not None:
                self.tracer.record(
                    work.trace_id,
                    "router.e2e",
                    work.t_submit,
                    t_done,
                    tenant=work.tenant,
                    pool=work.pool,
                )
            work.future.set_result(engine_future.result())
        else:
            tm.failed.inc()
            self._fail_future(work, exc)

    # ------------------------------------------------------------ inspection
    @property
    def state(self) -> str:
        with self._cv:
            return self._state

    @property
    def pools(self) -> Dict[str, List[str]]:
        """pool name -> engine slot names (dead slots excluded)."""
        with self._cv:
            out: Dict[str, List[str]] = {}
            for slot in self._slots.values():
                if not slot.dead:
                    out.setdefault(slot.pool, []).append(slot.name)
            return out

    @property
    def stats(self) -> Dict[str, Any]:
        with self._cv:
            slots = list(self._slots.values())
            out: Dict[str, Any] = {
                "state": self._state,
                "queued": self._total_depth_locked(),
                "inflight": self._inflight,
                "tenants": {
                    name: {
                        "depth": t.depth,
                        "weight": t.cfg.weight,
                        "deficit": t.deficit,
                    }
                    for name, t in self._tenants.items()
                },
            }
        out["engines"] = {
            slot.name: {
                "pool": slot.pool,
                "dead": slot.dead,
                "restarts": slot.restarts,
                **(slot.engine.stats if slot.engine is not None else {}),
            }
            for slot in slots
        }
        out["telemetry"] = self.metrics.snapshot()
        return out
