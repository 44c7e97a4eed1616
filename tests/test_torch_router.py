"""Serving fabric on the port (``repro_torch.runtime.router``): the
reference's ``tests/test_router.py`` (every class but ``TestDecodeFleet``:
token decoding of the LM zoo is not ported) over the port's ``ServePlan``
with the same sleepy plans (multi-tenant DRR fairness, EDF + deadline
shedding, typed admission control, telemetry-driven engine selection, and
crash + hot-restart with no dropped futures), plus one parity test: a
scripted schedule dispatches in the JAX package's Router's order."""
import threading
import time

import numpy as np
import torch
import pytest

from repro.runtime import DeadlineExceeded as JDeadlineExceeded
from repro.runtime import Router as JRouter
from repro.runtime import RouterConfig as JRouterConfig
from repro.runtime import ServiceConfig as JServiceConfig
from repro.runtime import TenantConfig as JTenantConfig
from repro.runtime import TenantQueueFull as JTenantQueueFull
from repro.runtime.service import ServePlan as JServePlan
from repro_torch.runtime import (
    AsyncEngine,
    DeadlineExceeded,
    EngineStopped,
    NoEngineAvailable,
    Router,
    RouterConfig,
    RouterStopped,
    ServiceConfig,
    ServiceMetrics,
    TenantConfig,
    TenantQueueFull,
)
from repro_torch.runtime.service import ServePlan

RNG = np.random.default_rng(7)


class SleepyPlan(ServePlan):
    """Streaming plan with a pure-sleep infer: deterministic fabric tests
    with zero compute noise.  Records served items per engine tag."""

    name = "streaming"

    def __init__(self, config, metrics=None, delay_s=0.002, tag="e",
                 served=None):
        super().__init__(config, metrics=metrics)
        self.delay_s = delay_s
        self.tag = tag
        self.served = served if served is not None else []

    def infer(self, x):
        time.sleep(self.delay_s)
        self.served.append(int(x))
        return (self.tag, int(x))


class _Boom(BaseException):
    """Escapes the per-item Exception handler: kills the engine loop."""


def sleepy_factory(delay_s=0.002, tag="e", served=None):
    def factory(config, metrics):
        return SleepyPlan(config, metrics=metrics, delay_s=delay_s, tag=tag,
                          served=served)

    return factory


def crashy_factory(crash_on, armed, delay_s=0.001, served=None):
    """Crashes the engine loop (BaseException) the first time an item in
    ``crash_on`` is served while ``armed`` holds the key "on"."""

    def factory(config, metrics):
        plan = SleepyPlan(config, metrics=metrics, delay_s=delay_s,
                          served=served)
        orig = plan.infer

        def infer(x):
            if int(x) in crash_on and armed.pop("on", None):
                raise _Boom(f"injected crash at {int(x)}")
            return orig(x)

        plan.infer = infer
        return plan

    return factory


def fleet(*factories, config=None, max_queue=1, **router_kw):
    router = Router(RouterConfig(**router_kw))
    for i, f in enumerate(factories):
        router.add_engine(
            f"e{i}", f, config or ServiceConfig(max_queue=max_queue)
        )
    return router


# ------------------------------------------------------------------ basics
class TestFabricBasics:
    def test_fleet_completes_everything_across_engines(self):
        r = fleet(sleepy_factory(tag="e0"), sleepy_factory(tag="e1"),
                  max_queue=2).start()
        futs = [r.submit(i) for i in range(30)]
        res = [f.result(timeout=10) for f in futs]
        assert sorted(x for _, x in res) == list(range(30))
        assert {t for t, _ in res} == {"e0", "e1"}  # both engines served
        r.drain_and_stop(timeout=10)
        assert r.state == "stopped"
        snap = r.metrics.snapshot()
        assert snap["dispatched"] == 30
        assert snap["tenants"]["default"]["completed"] == 30

    def test_submit_before_start_queues_deterministically(self):
        r = fleet(sleepy_factory())
        futs = [r.submit(i) for i in range(5)]
        assert all(not f.done() for f in futs)
        r.start()
        assert [f.result(timeout=5)[1] for f in futs] == list(range(5))
        r.drain_and_stop(timeout=5)

    def test_submit_after_drain_raises_typed(self):
        r = fleet(sleepy_factory()).start()
        r.drain_and_stop(timeout=5)
        with pytest.raises(RouterStopped):
            r.submit(1)

    def test_no_engine_for_pool_is_typed(self):
        r = fleet(sleepy_factory())
        with pytest.raises(NoEngineAvailable):
            r.submit(np.zeros(4), pool="batched")

    def test_stats_shape(self):
        r = fleet(sleepy_factory(), max_queue=2).start()
        [f.result(timeout=5) for f in [r.submit(i) for i in range(4)]]
        st = r.stats
        assert st["state"] == "running"
        assert st["engines"]["e0"]["pool"] == "streaming"
        assert st["engines"]["e0"]["restarts"] == 0
        assert "telemetry" in st and "engines" in st["telemetry"]
        r.drain_and_stop(timeout=5)


# ------------------------------------------------------- fairness/deadlines
class TestScheduling:
    def test_low_weight_tenant_progresses_under_flood(self):
        """The DRR satellite: a weight-1 tenant flooded out by a weight-4
        tenant still progresses — its items complete interleaved, not
        after the heavy tenant's entire backlog."""
        served = []
        r = fleet(
            sleepy_factory(served=served),
            tenants={"heavy": TenantConfig(weight=4),
                     "light": TenantConfig(weight=1)},
        )
        # Everything queued before the scheduler runs: completion order is
        # exactly DRR dispatch order (one engine, inbox depth 1).
        heavy = [r.submit(i, tenant="heavy") for i in range(20)]
        light = [r.submit(100 + i, tenant="light") for i in range(4)]
        r.start()
        for f in heavy + light:
            f.result(timeout=10)
        r.drain_and_stop(timeout=10)
        # 4:1 weights => light's first item lands within the first DRR
        # round (5 dispatches), its last by ~4 rounds — far before the
        # heavy backlog drains.
        light_pos = sorted(served.index(100 + i) for i in range(4))
        assert light_pos[0] <= 5, f"light starved: order {served}"
        assert light_pos[-1] <= 20, f"light starved: order {served}"
        # Weighted share: in the window where both tenants were
        # backlogged (up to light's last item), heavy got ~4x light.
        window = served[: light_pos[-1] + 1]
        heavy_in_window = sum(1 for x in window if x < 100)
        assert 2.5 <= heavy_in_window / 4 <= 5.5

    def test_priority_orders_within_tenant(self):
        served = []
        r = fleet(sleepy_factory(served=served))
        r.submit(0, priority=0.0)
        r.submit(1, priority=5.0)
        r.submit(2, priority=1.0)
        r.start()
        r.drain_and_stop(timeout=10)
        assert served == [1, 2, 0]

    def test_edf_within_priority(self):
        served = []
        r = fleet(sleepy_factory(served=served))
        r.submit(0)                    # no deadline: sorts last
        r.submit(1, deadline_s=30.0)
        r.submit(2, deadline_s=10.0)   # earliest deadline first
        r.start()
        r.drain_and_stop(timeout=10)
        assert served == [2, 1, 0]

    def test_expired_deadline_shed_before_dispatch(self):
        """The deadline satellite: an expired request never reaches an
        engine and its future carries the causal DeadlineExceeded."""
        served = []
        # One slow engine, inbox 1: two high-priority submits occupy the
        # engine (~80ms); the deadlined one (EDF would otherwise jump it
        # ahead, so priority pins it behind) expires in the router queue.
        r = fleet(sleepy_factory(delay_s=0.04, served=served))
        blockers = [r.submit(i, priority=1.0) for i in (0, 1)]
        doomed = r.submit(2, deadline_s=0.01)
        r.start()
        with pytest.raises(DeadlineExceeded) as ei:
            doomed.result(timeout=10)
        assert ei.value.tenant == "default"
        assert ei.value.deadline_s == pytest.approx(0.01)
        assert ei.value.waited_s >= 0.01
        [f.result(timeout=10) for f in blockers]
        r.drain_and_stop(timeout=10)
        assert 2 not in served  # shed BEFORE dispatch, engine never paid
        assert r.metrics.snapshot()["tenants"]["default"]["shed_deadline"] == 1

    def test_dead_on_arrival_deadline_shed_on_future(self):
        r = fleet(sleepy_factory()).start()
        fut = r.submit(7, deadline_s=-1.0)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=5)
        r.drain_and_stop(timeout=5)

    def test_tenant_queue_full_is_per_tenant(self):
        """Admission control sheds the flooding tenant only — the other
        tenant keeps admitting (never FIFO-blind drops)."""
        r = fleet(
            sleepy_factory(delay_s=0.02),
            tenants={"flood": TenantConfig(max_queue=3),
                     "calm": TenantConfig(max_queue=3)},
        )
        floods = [r.submit(i, tenant="flood") for i in range(3)]
        with pytest.raises(TenantQueueFull) as ei:
            r.submit(99, tenant="flood")
        assert ei.value.tenant == "flood" and ei.value.bound == 3
        calm = r.submit(0, tenant="calm")  # unaffected
        r.start()
        assert calm.result(timeout=10)[1] == 0
        [f.result(timeout=10) for f in floods]
        r.drain_and_stop(timeout=10)
        snap = r.metrics.snapshot()
        assert snap["tenants"]["flood"]["shed_queue_full"] == 1
        assert snap["tenants"]["calm"]["shed_queue_full"] == 0


# ------------------------------------------------------------- engine choice
class TestRouting:
    def test_p95_routing_avoids_degraded_engine(self):
        """Telemetry-driven selection: with one engine 10x slower, p95
        routing sends it a (much) smaller share than round-robin."""

        def share_of_slow(routing):
            slow_served = []
            r = fleet(
                sleepy_factory(delay_s=0.002),
                sleepy_factory(delay_s=0.02, served=slow_served),
                max_queue=2,
                routing=routing,
            ).start()
            futs = [r.submit(i) for i in range(120)]
            for f in futs:
                f.result(timeout=30)
            r.drain_and_stop(timeout=30)
            return len(slow_served)

        rr = share_of_slow("round_robin")
        p95 = share_of_slow("p95")
        assert p95 < rr, f"p95 routing sent {p95} to the slow engine vs {rr}"

    def test_round_robin_spreads_evenly(self):
        e0, e1 = [], []
        r = fleet(
            sleepy_factory(served=e0),
            sleepy_factory(served=e1),
            max_queue=2,
            routing="round_robin",
        ).start()
        [f.result(timeout=10) for f in [r.submit(i) for i in range(20)]]
        r.drain_and_stop(timeout=10)
        assert abs(len(e0) - len(e1)) <= 6


# ------------------------------------------------------------ crash/restart
# Crash injection raises a BaseException out of the engine loop thread on
# purpose (that is the failure mode under test); pytest's threadexception
# plugin would otherwise warn about each injected crash.
@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning"
)
class TestHotRestart:
    def test_crash_requeues_and_restarts_no_stranded_futures(self):
        """The acceptance invariant: an injected engine crash mid-run
        strands nothing — undone work re-enqueues, a replacement engine
        spins up from the same factory, every future resolves."""
        armed = {"on": True}
        r = fleet(
            crashy_factory({5}, armed),
            max_queue=2,
            tenants={"a": TenantConfig(), "b": TenantConfig()},
        ).start()
        futs = [r.submit(i, tenant="ab"[i % 2]) for i in range(12)]
        res = [f.result(timeout=30) for f in futs]
        assert sorted(x for _, x in res) == list(range(12))
        st = r.stats
        assert st["engines"]["e0"]["restarts"] == 1
        snap = r.metrics.snapshot()
        assert snap["restarts"] == 1
        assert sum(tm["requeued"] for tm in snap["tenants"].values()) >= 1
        r.drain_and_stop(timeout=30)

    def test_restart_budget_exhausted_fails_typed_not_hangs(self):
        """A permanently-broken engine must terminate, not hang: the slot
        dies after max_restarts and queued work fails NoEngineAvailable
        (or the redispatch budget fails it with EngineStopped)."""
        armed = {"on": True}

        def always_crash(config, metrics):
            plan = SleepyPlan(config, metrics=metrics, delay_s=0.001)

            def infer(x):
                raise _Boom("permanently broken")

            plan.infer = infer
            return plan

        r = Router(RouterConfig(max_restarts=1, max_redispatch=2))
        r.add_engine("e0", always_crash, ServiceConfig(max_queue=1))
        r.start()
        futs = [r.submit(i) for i in range(4)]
        for f in futs:
            with pytest.raises((NoEngineAvailable, EngineStopped)):
                f.result(timeout=30)
        r.drain_and_stop(timeout=30)
        assert r.stats["engines"]["e0"]["dead"] is True

    def test_engine_drain_and_stop_returns_leftovers(self):
        """The engine satellite: drain_and_stop() RETURNS the items the
        loop could not complete after a crash (and [] on a graceful
        drain), so supervisors re-enqueue without reading private state."""
        # Graceful: everything completes, nothing handed back.
        served = []
        eng = AsyncEngine(
            SleepyPlan(ServiceConfig(), served=served),
            ServiceConfig(),
        ).start()
        futs = [eng.submit(i) for i in range(3)]
        assert eng.drain_and_stop(timeout=10) == []
        assert [f.result(timeout=1)[1] for f in futs] == [0, 1, 2]

        # Crash: the in-flight item and the still-queued inbox come back.
        class CrashFirst(SleepyPlan):
            def infer(self, x):
                raise _Boom("down")

        eng = AsyncEngine(CrashFirst(ServiceConfig()), ServiceConfig())
        futs = [eng.submit(i) for i in range(3)]
        eng.start()
        deadline = time.perf_counter() + 10
        while not eng.stopped and time.perf_counter() < deadline:
            time.sleep(0.005)
        leftover = eng.drain_and_stop(timeout=10)
        assert sorted(int(x) for x in leftover) == [0, 1, 2]
        for f in futs:
            with pytest.raises(EngineStopped):
                f.result(timeout=1)


# --------------------------------------------------------------- telemetry
class TestMetrics:
    def test_service_metrics_snapshot_is_consistent(self):
        """The snapshot satellite: counters are read under ONE lock
        acquisition — a reader can never observe completed > submitted
        even while a writer bumps both."""
        m = ServiceMetrics()
        stop = threading.Event()

        def writer():
            while not stop.is_set():
                m.submitted.inc()
                m.completed.inc()

        t = threading.Thread(target=writer)
        t.start()
        try:
            for _ in range(2000):
                snap = m.snapshot()
                assert snap["completed"] <= snap["submitted"], snap
        finally:
            stop.set()
            t.join()

    def test_snapshot_includes_histogram_percentiles(self):
        m = ServiceMetrics()
        for v in (0.001, 0.002, 0.003):
            m.queue_wait_s.observe(v)
        snap = m.snapshot()
        assert snap["queue_wait_s"]["count"] == 3
        assert snap["queue_wait_s"]["p50"] == pytest.approx(0.002)

    def test_router_metrics_engine_bundle_survives_restart(self):
        from repro_torch.runtime import RouterMetrics

        rm = RouterMetrics()
        a = rm.register_engine("e0")
        a.queue_wait_s.observe(0.5)
        b = rm.register_engine("e0")  # hot restart re-register
        assert b is a  # histograms (the scheduling signal) survive


# ---------------------------------------------------- parity with the JAX Router
class _RecordingJaxPlan(JServePlan):
    """The JAX package's twin of :class:`SleepyPlan`, over its ServePlan."""

    name = "streaming"

    def __init__(self, config, metrics=None, served=None):
        super().__init__(config, metrics=metrics)
        self.served = served

    def infer(self, x):
        time.sleep(0.001)
        self.served.append(int(x))
        return int(x)


# (item, tenant, priority, deadline_s) in submit order: weights 1:4, two
# priorities, EDF among deadlines, two requests dead on arrival and two
# whose deadlines expire in the router queue before start().
SCHEDULE = (
    [(i, "heavy", 0.0, None) for i in range(12)]
    + [(100 + i, "light", 0.0, None) for i in range(4)]
    + [(200, "light", 2.0, None), (201, "heavy", 1.0, 30.0), (202, "heavy", 1.0, 10.0),
       (203, "light", 0.0, -1.0), (204, "heavy", 0.0, 0.0),
       (205, "light", 0.0, 0.001), (206, "heavy", 5.0, 0.001),
       (207, "light", 0.0, 20.0), (208, "heavy", 0.0, 15.0)]
    + [(300 + i, "burst", 0.0, None) for i in range(3)]
)


def _run_schedule(router_cls, config_cls, tenant_cls, service_cls, plan_factory):
    served = []
    router = router_cls(config_cls(tenants={
        "light": tenant_cls(weight=1), "heavy": tenant_cls(weight=4),
        "burst": tenant_cls(weight=1, max_queue=2)}))
    router.add_engine("e0", plan_factory(served), service_cls(max_queue=1))
    outcomes = []
    for item, tenant, priority, deadline_s in SCHEDULE:
        try:
            fut = router.submit(item, tenant=tenant, priority=priority, deadline_s=deadline_s)
        except Exception as e:  # noqa: BLE001 — the typed refusal is the outcome
            outcomes.append((item, type(e).__name__, e.tenant))
            continue
        outcomes.append((item, fut))
    time.sleep(0.05)  # the 1 ms deadlines expire in the queue
    router.start()
    router.drain_and_stop(timeout=30)
    resolved = []
    for out in outcomes:
        if len(out) == 3:
            resolved.append(out)
            continue
        item, fut = out
        exc = fut.exception(timeout=30)
        resolved.append((item, None if exc is None else type(exc).__name__,
                         getattr(exc, "tenant", None)))
    snap = router.metrics.snapshot()["tenants"]
    sheds = {t: (v["shed_deadline"], v["shed_queue_full"], v["completed"])
             for t, v in sorted(snap.items())}
    return served, resolved, sheds


def test_scripted_schedule_dispatches_in_the_reference_order():
    """The same schedule, submitted before ``start()`` to a JAX Router and a
    port Router with one engine each (inbox depth 1): the engines serve the
    items in the same order (priority, then EDF, within a tenant; DRR at
    weights 1:4 across tenants), and the same items are shed with the same
    typed errors (DeadlineExceeded dead on arrival and in the queue,
    TenantQueueFull past a tenant's bound)."""
    port = _run_schedule(
        Router, RouterConfig, TenantConfig, ServiceConfig,
        lambda served: sleepy_factory(delay_s=0.001, served=served))
    ref = _run_schedule(
        JRouter, JRouterConfig, JTenantConfig, JServiceConfig,
        lambda served: (lambda config, metrics: _RecordingJaxPlan(config, metrics, served)))
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    errors = {name for _, name, _ in port[1] if name is not None}
    assert errors == {DeadlineExceeded.__name__, TenantQueueFull.__name__}
    assert {JDeadlineExceeded.__name__, JTenantQueueFull.__name__} == errors
    # Every item either served once or shed; the light tenant's first item
    # lands within the first DRR round.
    shed = {item for item, name, _ in port[1] if name is not None}
    assert sorted(port[0]) == sorted(item for item, *_ in SCHEDULE if item not in shed)
    assert port[0].index(200) <= 5


# ------------------------------------------- two engines over one network
def test_two_batched_engines_over_one_network():
    """Two batched engines behind one Router over ONE compiled network
    (and so one activation store, which has no lock), four client threads,
    the interpreter switching threads every 10 us: every future resolves to
    the row's scores from ``compiled.predict``.  (Each continual engine
    needs a network of its own: adoption swaps the shared state.)"""
    import sys

    from repro_torch.core import (
        DenseLayer, ExecutionConfig, Network, StructuralPlasticityLayer, UnitLayout, onehot_layout)
    from repro_torch.data import complementary_code, mnist_like
    from repro_torch.runtime import BatchedPlan

    ds = mnist_like(n_train=256, n_test=256, n_features=32, seed=0)
    x, layout = complementary_code(ds.x_train)
    xt, _ = complementary_code(ds.x_test)
    net = Network(seed=0).add(
        StructuralPlasticityLayer(layout, UnitLayout(4, 8), fan_in=16, lam=0.05, gain=4.0)
    ).add(DenseLayer(UnitLayout(4, 8), onehot_layout(10), lam=0.05))
    compiled = net.compile(ExecutionConfig(device="cpu"))
    compiled.fit((x, ds.y_train), epochs_hidden=1, epochs_readout=1, batch_size=64)
    want = compiled.predict(xt).numpy()

    router = Router(RouterConfig(routing="round_robin"))
    for i in range(2):
        router.add_engine(f"b{i}", lambda cfg, m: BatchedPlan(compiled, cfg, m),
                          ServiceConfig(max_batch=8, max_wait_s=0.001, max_queue=4))
    results, errors = {}, []

    def client(rows):
        try:
            futs = [(i, router.submit(xt[i], tenant=f"c{i % 4}")) for i in rows]
            for i, f in futs:
                results[i] = f.result(timeout=60)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        router.start()
        threads = [threading.Thread(target=client, args=(range(t, len(xt), 4),)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        router.drain_and_stop(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    got = np.stack([results[i] for i in range(len(xt))])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    served = [e["completed"] for e in router.metrics.snapshot()["engines"].values()]
    assert sum(served) == len(xt) and all(n > 0 for n in served)


def test_activation_store_shared_by_threads():
    """Six threads project distinct batches through one store whose budget
    spills and evicts on every insert (the interpreter switching every
    1 us): no thread's entry is evicted before it is returned, and every
    projection equals the frozen forward's."""
    import sys

    from repro_torch.core import (
        DenseLayer, ExecutionConfig, Network, StructuralPlasticityLayer, UnitLayout, onehot_layout)
    from repro_torch.data import complementary_code, mnist_like

    ds = mnist_like(n_train=64, n_test=8, n_features=32, seed=0)
    x, layout = complementary_code(ds.x_train)
    net = Network(seed=0).add(
        StructuralPlasticityLayer(layout, UnitLayout(4, 8), fan_in=16, lam=0.05, gain=4.0)
    ).add(DenseLayer(UnitLayout(4, 8), onehot_layout(10), lam=0.05))
    compiled = net.compile(ExecutionConfig(device="cpu", activation_budget_mb=0.001))
    store, states = compiled.activations, list(compiled.state.layers)
    layer = compiled.layers[0]
    errors = []

    def hammer(t):
        try:
            for k in range(400):
                a = np.array(x[(k + t) % 62:(k + t) % 62 + 2])
                got = store.level(1, states, a, chunk=2)
                torch.testing.assert_close(got, layer.forward(states[0], torch.from_numpy(a)),
                                           rtol=0, atol=0)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer, args=(t,)) for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert store.stats["projections"] == 6 * 400 and store.stats["evictions"] > 0
