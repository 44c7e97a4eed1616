"""Observability of the port: request tracing and the event journal
(``repro_torch.runtime.trace``), the metrics bundles
(``repro_torch.runtime.metrics``: the service's, the drift window, the
router's per-tenant and per-engine roll-up, the latency line), OpenMetrics
export and ``checkmetrics`` (``repro_torch.runtime.export``), the engine's,
the router's and the continual plan's request spans, and the training
program's ``train.<phase>`` spans.  The tracer, journal, chrome-trace,
histogram-merge, latency-line, render/parse, ``MetricsServer``, fleet-trace
and snapshot-consistency cases are those of the reference's
``tests/test_observability.py``; the port's modules copy the reference's
instruments, so their snapshots and rendered text are also held equal to
the reference's on the same inputs (the reference's bundle also carries the
decode plan's histograms, which the port brings with that slice)."""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from repro.runtime import DriftWindow as JDriftWindow
from repro.runtime import RouterMetrics as JRouterMetrics
from repro.runtime import ServiceMetrics as JServiceMetrics
from repro.runtime import format_latency_line as jformat_latency_line
from repro.runtime import render_openmetrics as jrender_openmetrics
from repro_torch.core import (
    DenseLayer,
    ExecutionConfig,
    Network,
    StructuralPlasticityLayer,
    UnitLayout,
    onehot_layout,
)
from repro_torch.data import complementary_code, mnist_like
from repro_torch.kernels import ops
from repro_torch.runtime import (
    DriftWindow,
    EngineRestart,
    EventJournal,
    Histogram,
    MetricsServer,
    OpenMetricsError,
    Router,
    RouterConfig,
    RouterMetrics,
    ServiceConfig,
    ServiceMetrics,
    TenantConfig,
    TraceConfig,
    Tracer,
    build_tracer,
    format_latency_line,
    parse_openmetrics,
    render_openmetrics,
)
from repro_torch.runtime import trace
from repro_torch.runtime.service import ServePlan
from torch_plain_gathering import plain_gathering

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data():
    ds = mnist_like(n_train=128, n_test=32, n_features=32, seed=0)
    x, layout = complementary_code(ds.x_train)
    return ds, np.asarray(x, np.float32), layout


_Restart = EngineRestart


# ----------------------------------------------------------- plan fixtures
class SleepyPlan(ServePlan):
    """Streaming plan with pure-sleep infer: deterministic fabric tests."""

    name = "streaming"

    def __init__(self, config, metrics=None, delay_s=0.002):
        super().__init__(config, metrics=metrics)
        self.delay_s = delay_s

    def infer(self, x):
        time.sleep(self.delay_s)
        return int(x)


class _Boom(BaseException):
    """Escapes the per-item Exception handler: kills the engine loop."""


def sleepy_factory(delay_s=0.002, crash_on=(), armed=None):
    def factory(config, metrics):
        plan = SleepyPlan(config, metrics=metrics, delay_s=delay_s)
        if crash_on:
            orig = plan.infer

            def infer(x):
                if int(x) in crash_on and armed.pop("on", None):
                    raise _Boom(f"injected crash at {int(x)}")
                return orig(x)

            plan.infer = infer
        return plan

    return factory


def traced_fleet(n=2, trace=None, max_queue=8, **factory_kw):
    router = Router(RouterConfig(
        routing="round_robin", trace=trace if trace is not None else TraceConfig()))
    for i in range(n):
        router.add_engine(f"e{i}", sleepy_factory(**factory_kw), ServiceConfig(max_queue=max_queue))
    return router


def _net(layout):
    hidden = UnitLayout(4, 8)
    return Network(seed=0).add(
        StructuralPlasticityLayer(layout, hidden, fan_in=16, lam=0.05)
    ).add(DenseLayer(hidden, onehot_layout(10), lam=0.05))


# ------------------------------------------------------------ tracer core
class TestTracerCore:
    def test_build_tracer_gates(self):
        assert build_tracer(None) is None
        assert build_tracer(TraceConfig(enabled=False)) is None
        assert isinstance(build_tracer(TraceConfig()), Tracer)

    def test_config_validation(self):
        with pytest.raises(ValueError):
            TraceConfig(ring_size=0)
        with pytest.raises(ValueError):
            TraceConfig(journal_size=0)

    def test_ring_bounded_and_ordered(self):
        tr = Tracer(TraceConfig(ring_size=8))
        for i in range(20):
            tr.record(1, f"s{i}", float(i), float(i) + 0.5)
        spans = tr.spans()
        assert len(spans) == 8  # bounded: oldest 12 overwritten
        assert [s.name for s in spans] == [f"s{i}" for i in range(12, 20)]
        assert all(b.seq > a.seq for a, b in zip(spans, spans[1:]))

    def test_trace_filters_and_sorts(self):
        tr = Tracer()
        a, b = tr.new_trace(), tr.new_trace()
        tr.record(a, "late", 5.0, 6.0)
        tr.record(b, "other", 0.5, 1.0)
        tr.record(a, "early", 1.0, 2.0, engine="e0")
        got = tr.trace(a)
        assert [s.name for s in got] == ["early", "late"]  # t_start order
        assert got[0].attrs == {"engine": "e0"}
        assert all(s.trace_id == b for s in tr.trace(b))

    def test_span_names_filter(self):
        tr = Tracer()
        tr.record(1, "router.sched", 0.0, 1.0)
        tr.record(1, "engine.inbox", 0.0, 1.0)
        assert [s.name for s in tr.spans("router.sched")] == ["router.sched"]

    def test_chrome_trace_shape(self):
        tr = Tracer()
        t = tr.new_trace()
        tr.record(t, "router.sched", 1.0, 2.0, tenant="a")
        tr.record(t, "engine.inbox", 2.0, 3.0, engine="e0")
        tr.emit(_Restart(engine="e0", restarts=1, leftover=0))
        doc = tr.chrome_trace()
        assert doc["displayTimeUnit"] == "ms"
        evs = doc["traceEvents"]
        xs = [e for e in evs if e["ph"] == "X"]
        assert {e["name"] for e in xs} == {"router.sched", "engine.inbox"}
        for e in xs:
            assert e["args"]["trace_id"] == t
            assert e["dur"] >= 0
        metas = {e["args"]["name"] for e in evs if e["ph"] == "M"}
        assert {"router", "e0"} <= metas
        instants = [e for e in evs if e["ph"] == "i"]
        assert len(instants) == 1 and instants[0]["name"] == "engine_restart"
        json.loads(json.dumps(doc))  # round-trips as JSON (the Perfetto contract)

    def test_journal_events_share_their_engine_lane(self):
        tr = Tracer()
        tr.record(tr.new_trace(), "engine.batch", 1.0, 2.0, engine="e0")
        tr.emit(_Restart(engine="e0", restarts=1))
        tr.emit(_Restart())  # no engine: the journal's own lane
        evs = tr.chrome_trace()["traceEvents"]
        lanes = {e["args"]["name"]: e["tid"] for e in evs if e["ph"] == "M"}
        span = next(e for e in evs if e["ph"] == "X")
        instants = [e for e in evs if e["ph"] == "i"]
        assert span["tid"] == instants[0]["tid"] == lanes["e0"]
        assert instants[1]["tid"] == lanes["journal"]
        assert instants[0]["args"]["restarts"] == 1 and instants[0]["args"]["seq"] == 0

    def test_write_chrome_trace(self, tmp_path):
        tr = Tracer()
        tr.record(tr.new_trace(), "x", 0.0, 1.0)
        path = str(tmp_path / "trace.json")
        tr.write_chrome_trace(path)
        with open(path) as f:
            assert json.load(f)["traceEvents"]

    def test_spans_nest_inherit_and_export_parents_and_counters(self):
        tr = Tracer()
        t = tr.new_trace()
        with tr.span("outer", trace_id=t, rows=4) as attrs:
            with tr.span("inner"):
                tr.count("things", 3)
            attrs["late"] = 1
        with tr.span("top"):
            tr.count("things")
        outer, inner, top = tr.spans("outer")[0], tr.spans("inner")[0], tr.spans("top")[0]
        assert outer.parent is None and top.parent is None and inner.parent == outer.seq
        assert inner.trace_id == outer.trace_id == t
        assert top.trace_id == tr.TRAIN_TRACE_ID
        assert outer.attrs == {"rows": 4, "late": 1}
        assert outer.t_start <= inner.t_start <= inner.t_end <= outer.t_end
        assert [s.name for s in tr.spans()] == ["outer", "inner", "top"]  # opening order
        assert tr.counters() == {"things": 4}
        evs = tr.chrome_trace()["traceEvents"]
        x = {e["name"]: e for e in evs if e["ph"] == "X"}
        assert x["inner"]["args"]["parent"] == x["outer"]["args"]["seq"]
        assert "parent" not in x["outer"]["args"]
        assert [(e["name"], e["args"]) for e in evs if e["ph"] == "C"] == [
            ("things", {"value": 4})]

    def test_active_tracer_is_set_for_a_block(self):
        tr = Tracer()
        assert trace.active() is None
        with trace.activate(tr):
            assert trace.active() is tr
            with trace.activate(None):
                assert trace.active() is None
            assert trace.active() is tr
        assert trace.active() is None


# ---------------------------------------------------------------- journal
class TestJournal:
    def test_typed_events_bounded_and_filtered(self):
        j = EventJournal(size=4)
        for i in range(6):
            j.emit(_Restart(engine=f"e{i}", restarts=i))
        rows = j.events()
        assert len(rows) == 4  # bounded deque
        assert [e.engine for _, _, e in rows] == ["e2", "e3", "e4", "e5"]
        assert [s for s, _, _ in rows] == [2, 3, 4, 5]  # seqs survive wrap
        assert j.events(kind="merge_applied") == []

    def test_kinds_filter_apart(self):
        @dataclasses.dataclass(frozen=True)
        class _Shed:
            kind = "deadline_shed"
            waited_s: float = None

        j = EventJournal(size=8)
        j.emit(_Restart(engine="e0", restarts=1))
        j.emit(_Shed(waited_s=0.5))
        j.emit(_Restart(engine="e0", restarts=2))
        assert [e.restarts for _, _, e in j.events(kind="engine_restart")] == [1, 2]
        assert [s for s, _, _ in j.events(kind="deadline_shed")] == [1]
        assert len(j.events()) == 3

    def test_jsonl_sink(self, tmp_path):
        path = str(tmp_path / "journal.jsonl")
        j = EventJournal(size=8, path=path)
        j.emit(_Restart(engine="e0", restarts=2, leftover=1))
        j.close()
        with open(path) as f:
            lines = [json.loads(x) for x in f]
        assert len(lines) == 1
        row = lines[0]
        assert row["kind"] == "engine_restart"
        assert row["engine"] == "e0" and row["restarts"] == 2
        assert row["seq"] == 0 and row["ts"] > 0


# ------------------------------------------------------- histogram merge
class TestHistogramMerge:
    def test_merged_percentiles_match_concatenated_windows(self):
        rng = np.random.default_rng(0)
        a, b = Histogram(window=256), Histogram(window=256)
        va, vb = rng.exponential(1.0, 100), rng.exponential(2.0, 150)
        for v in va:
            a.observe(float(v))
        for v in vb:
            b.observe(float(v))
        snap = Histogram(window=512).merge(a).merge(b).snapshot()
        both = np.concatenate([va, vb])
        assert snap["count"] == 250
        for q, key in ((50, "p50"), (95, "p95"), (99, "p99")):
            assert snap[key] == pytest.approx(float(np.percentile(both, q)), rel=1e-6)
        assert snap["max"] == pytest.approx(float(both.max()))

    def test_merge_truncates_to_window_keeping_newest(self):
        src = Histogram(window=256)
        for v in range(200):
            src.observe(float(v))
        snap = Histogram(window=100).merge(src).snapshot()
        assert snap["count"] == 200  # lifetime count still adds
        assert snap["p50"] == pytest.approx(float(np.percentile(np.arange(100, 200), 50)))

    def test_merge_same_lock_no_deadlock(self):
        m = ServiceMetrics()
        h1, h2 = m.hist("queue_wait_s"), m.hist("e2e_s")
        h1.observe(1.0)
        h2.observe(2.0)
        h1.merge(h2)  # shared bundle RLock: single acquisition path
        assert h1.snapshot()["count"] == 2

    def test_self_merge_rejected(self):
        h = Histogram()
        with pytest.raises(ValueError):
            h.merge(h)


    def test_fleet_rollup_exposes_fabric_quantiles(self):
        rm = RouterMetrics()
        e0 = rm.register_engine("e0")
        e1 = rm.register_engine("e1")
        v0, v1 = [0.01 * i for i in range(50)], [0.5 + 0.01 * i for i in range(50)]
        for v in v0:
            e0.e2e_s.observe(v)
        for v in v1:
            e1.e2e_s.observe(v)
        snap = rm.snapshot()
        assert "fleet" in snap
        fleet = snap["fleet"]["e2e_s"]
        both = np.asarray(v0 + v1)
        assert fleet["count"] == 100
        assert fleet["p95"] == pytest.approx(float(np.percentile(both, 95)), rel=1e-6)


# ------------------------------------------------- drift window and lines
class TestDriftWindowParity:
    def test_snapshots_equal_the_reference(self):
        """The same prequential stream (a baseline, a degraded window, a
        reset) gives the reference's snapshot and drift decision at every
        step."""
        rng = np.random.default_rng(3)
        port, ref = DriftWindow(window=8, min_samples=4, threshold=0.25), \
            JDriftWindow(window=8, min_samples=4, threshold=0.25)
        seen_drift = False
        for k in range(40):
            correct, conf = bool(rng.random() < (0.9 if k < 16 else 0.3)), float(rng.random())
            for dw in (port, ref):
                dw.observe(correct, conf)
                if k == 11:
                    dw.freeze_baseline()
                if k == 30:
                    dw.reset_current()
            assert port.snapshot() == ref.snapshot()
            assert port.drifted() == ref.drifted()
            assert (port.samples, port.baseline_samples) == (ref.samples, ref.baseline_samples)
            seen_drift |= port.drifted()
        assert seen_drift


class TestFormatLatencyLine:
    def test_explicit_names_shape_stable_at_zero(self):
        snap = ServiceMetrics().snapshot()
        line = format_latency_line(snap, "queue_wait_s", "e2e_s")
        # both requested histograms render even with zero observations
        assert "queue_wait p50=0.00ms p95=0.00ms p99=0.00ms" in line
        assert "e2e p50=0.00ms" in line

    def test_no_names_empty_still_summarizes(self):
        line = format_latency_line(ServiceMetrics().snapshot())
        assert "no latency samples" in line

    @pytest.mark.parametrize("names", [(), ("queue_wait_s", "e2e_s"), ("update_s",)],
                             ids=["all", "explicit", "update"])
    def test_text_equals_the_reference(self, names):
        port, ref = ServiceMetrics(), JServiceMetrics()
        _fill_service(port)
        _fill_service(ref)
        line = format_latency_line(port.snapshot(), *names)
        assert line == jformat_latency_line(ref.snapshot(), *names)
        assert "online updates=3 shed=1 merges=1 rollbacks=1 drift=1" in line


# ------------------------------------------------------------ openmetrics
def _fill_service(m):
    m.submitted.inc(3)
    m.completed.inc(2)
    m.rejected.inc()
    m.queue_depth.set(4)
    for v in (0.1, 0.25, 0.05):
        m.e2e_s.observe(v)
        m.batch_s.observe(v / 2)
        m.update_s.observe(v / 4)
    m.online_updates.inc(3)
    m.updates_shed.inc()
    m.merges.inc()
    m.rollbacks.inc()
    m.drift_events.inc()
    m.configure_drift(8, 4, 0.3)
    for k in range(6):
        m.drift.observe(k % 3 != 0, 0.5 + 0.05 * k)
    m.drift.freeze_baseline()
    for k in range(5):
        m.drift.observe(k == 0, 0.4)


def _fill_router(rm):
    rm.dispatched.inc(5)
    rm.restarts.inc()
    for tenant, n in (("paid", 4), ("free", 2)):
        tm = rm.tenant(tenant)
        tm.submitted.inc(n)
        tm.completed.inc(n - 1)
        tm.shed_deadline.inc()
        tm.queue_depth.set(n)
        for k in range(n):
            tm.sched_wait_s.observe(0.001 * (k + 1))
            tm.e2e_s.observe(0.01 * (k + 1))
    for i, name in enumerate(("e0", "e1")):
        em = rm.register_engine(name)
        _fill_service(em)
        for k in range(10 * (i + 1)):
            em.queue_wait_s.observe(0.002 * k)


def _without_time(snapshot):
    """A snapshot without its wall-clock fields (uptime), which differ
    between two bundles by construction."""
    if isinstance(snapshot, dict):
        return {k: _without_time(v) for k, v in snapshot.items() if "uptime" not in k}
    return snapshot


class TestOpenMetrics:
    def test_service_render_parse_round_trip(self):
        m = ServiceMetrics()
        _fill_service(m)
        fams = parse_openmetrics(render_openmetrics(m.snapshot()))
        assert fams["repro_submitted"]["type"] == "counter"
        samples = {name: v for name, _labels, v in fams["repro_submitted"]["samples"]}
        assert samples["repro_submitted_total"] == 3.0
        assert fams["repro_e2e_seconds"]["type"] == "summary"
        names = {n for n, _, _ in fams["repro_e2e_seconds"]["samples"]}
        assert "repro_e2e_seconds_count" in names
        assert set(fams) == {
            "repro_submitted", "repro_completed", "repro_rejected", "repro_queue_depth",
            "repro_online_updates", "repro_updates_shed", "repro_merges", "repro_rollbacks",
            "repro_drift_events", "repro_queue_wait_seconds", "repro_prefill_seconds",
            "repro_decode_step_seconds", "repro_batch_seconds",
            "repro_e2e_seconds", "repro_update_seconds", "repro_drift_accuracy",
            "repro_drift_baseline_accuracy", "repro_drift_confidence", "repro_drift_samples",
            "repro_drifted"}

    def test_snapshot_holds_the_served_instruments(self):
        snap = ServiceMetrics().snapshot()
        assert list(snap) == ["submitted", "completed", "rejected", "queue_depth",
                              "queue_wait_s", "prefill_s", "decode_step_s", "batch_s",
                              "e2e_s", "update_s",
                              "online_updates", "updates_shed", "merges", "rollbacks",
                              "drift_events", "drift"]
        assert snap["e2e_s"]["count"] == 0

    @pytest.mark.parametrize("fill", [lambda m: None, _fill_service], ids=["empty", "filled"])
    def test_snapshot_and_text_equal_the_reference(self, fill):
        """The port's snapshot equals the reference's on the instruments
        both carry, and renders to the reference's text."""
        port, ref = ServiceMetrics(), JServiceMetrics()
        fill(port)
        fill(ref)
        snap = _without_time(port.snapshot())
        want = {k: v for k, v in _without_time(ref.snapshot()).items() if k in snap}
        assert snap == want
        assert render_openmetrics(snap) == jrender_openmetrics(want)

    def test_router_render_parse_round_trip(self):
        rm = RouterMetrics()
        rm.dispatched.inc(5)
        tm = rm.tenant("paid")
        tm.submitted.inc(5)
        tm.e2e_s.observe(0.2)
        em = rm.register_engine("e0")
        em.e2e_s.observe(0.2)
        fams = parse_openmetrics(render_openmetrics(rm.snapshot()))
        assert "repro_router_dispatched" in fams
        tenant_samples = fams["repro_tenant_submitted"]["samples"]
        assert any(labels.get("tenant") == "paid" for _, labels, _ in tenant_samples)
        engine_samples = fams["repro_e2e_seconds"]["samples"]
        assert any(labels.get("engine") == "e0" for _, labels, _ in engine_samples)
        assert "repro_fleet_e2e_seconds" in fams

    def test_router_snapshot_and_text_equal_the_reference(self):
        """A router roll-up (tenants, engines, the fleet's merged windows)
        equals the reference's on the same inputs, on the instruments both
        carry, and its OpenMetrics text parses to the reference's."""
        port, ref = RouterMetrics(), JRouterMetrics()
        _fill_router(port)
        _fill_router(ref)
        snap, want = port.snapshot(), ref.snapshot()
        for name in ("dispatched", "restarts", "tenants"):
            assert snap[name] == want[name]
        for engine, esnap in snap["engines"].items():
            assert esnap == {k: v for k, v in want["engines"][engine].items() if k in esnap}
        assert snap["fleet"] == {k: v for k, v in want["fleet"].items() if k in snap["fleet"]}
        want = {**want, "fleet": snap["fleet"],
                "engines": {e: {k: v for k, v in want["engines"][e].items() if k in esnap}
                            for e, esnap in snap["engines"].items()}}
        assert parse_openmetrics(render_openmetrics(snap)) == \
            parse_openmetrics(jrender_openmetrics(want))

    def test_checkmetrics_cli(self, tmp_path):
        """``python -m repro_torch.runtime.export`` (the reference's
        ``tools/checkmetrics``) validates the port's router text."""
        rm = RouterMetrics()
        _fill_router(rm)
        path = tmp_path / "metrics.txt"
        path.write_text(render_openmetrics(rm.snapshot()))
        tracer = Tracer()
        tid = tracer.new_trace()
        tracer.record(tid, "router.sched", 0.0, 1.0, tenant="paid")
        trace = tmp_path / "trace.json"
        tracer.write_chrome_trace(str(trace))

        def run(*args):
            return subprocess.run(
                [sys.executable, "-m", "repro_torch.runtime.export", *args],
                capture_output=True, text=True, timeout=60, cwd=ROOT,
                env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")},
            )

        ok = run(str(path), "--require", "repro_router_dispatched",
                 "--require", "repro_tenant_e2e_seconds", "--trace", str(trace),
                 "--expect-trace-id", str(tid))
        assert ok.returncode == 0, ok.stdout + ok.stderr
        assert "checkmetrics: OK" in ok.stdout and "trace OK" in ok.stdout
        assert run(str(path), "--require", "repro_missing").returncode == 1
        assert run(str(path), "--trace", str(trace), "--expect-trace-id",
                   str(tid + 1)).returncode == 1
        invalid = tmp_path / "bad.txt"
        invalid.write_text("repro_x 1\n")
        assert run(str(invalid)).returncode == 1

    def test_rejected_submit_renders_as_a_counter(self, data):
        _, x, layout = data
        compiled = _net(layout).compile(ExecutionConfig(device="cpu"))
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=4, max_queue=1))
        assert svc.submit(x[0]) and not svc.submit(x[1])
        fams = parse_openmetrics(render_openmetrics(svc.metrics.snapshot()))
        values = {f: {n: v for n, _, v in fams[f]["samples"]} for f in fams}
        assert values["repro_rejected"]["repro_rejected_total"] == 1.0
        assert values["repro_submitted"]["repro_submitted_total"] == 1.0
        svc.drain()
        fams = parse_openmetrics(render_openmetrics(svc.metrics.snapshot()))
        counts = {n: v for n, _, v in fams["repro_e2e_seconds"]["samples"]}
        assert counts["repro_e2e_seconds_count"] == 1.0

    @pytest.mark.parametrize("text", [
        "repro_x_total 1\n",                                        # no EOF terminator
        "# TYPE repro_x counter\nrepro_x_total one\n# EOF\n",       # bad value
        "# TYPE repro_x bogus\n# EOF\n",                            # unknown type
        "# TYPE repro_x counter\n# TYPE repro_x counter\n# EOF\n",  # dupe
        "# TYPE repro_x counter\nrepro_y_total 1\n# EOF\n",         # orphan
        "# EOF\ntrailing 1\n",                                      # content after EOF
    ])
    def test_parser_rejects_invalid(self, text):
        with pytest.raises(OpenMetricsError):
            parse_openmetrics(text)

    def test_metrics_server_scrape(self):
        m = ServiceMetrics()
        m.submitted.inc(7)
        tracer = Tracer()
        tracer.record(tracer.new_trace(), "x", 0.0, 1.0)
        server = MetricsServer(m.snapshot, tracer=tracer, port=0)
        try:
            with urllib.request.urlopen(f"{server.url}/metrics", timeout=10) as resp:
                assert resp.status == 200
                fams = parse_openmetrics(resp.read().decode())
            samples = {n: v for n, _, v in fams["repro_submitted"]["samples"]}
            assert samples["repro_submitted_total"] == 7.0
            with urllib.request.urlopen(f"{server.url}/trace.json", timeout=10) as resp:
                assert json.loads(resp.read())["traceEvents"]
            with urllib.request.urlopen(f"{server.url}/metrics.json", timeout=10) as resp:
                assert json.loads(resp.read())["submitted"] == 7
        finally:
            server.close()

    def test_metrics_server_scrapes_a_live_service(self, data):
        _, x, layout = data
        compiled = _net(layout).compile(ExecutionConfig(device="cpu"))
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=4, async_mode=True))
        [f.result(timeout=30) for f in [svc.submit(r) for r in x[:6]]]
        svc.drain_and_stop()
        server = MetricsServer(svc.metrics.snapshot, port=0)
        try:
            with urllib.request.urlopen(f"{server.url}/metrics", timeout=10) as resp:
                fams = parse_openmetrics(resp.read().decode())
        finally:
            server.close()
        samples = {n: v for n, _, v in fams["repro_completed"]["samples"]}
        assert samples["repro_completed_total"] == 6.0


# ---------------------------------------------------------- serving spans
class TestServingTraces:
    def test_engine_spans_cover_each_request(self, data):
        _, x, layout = data
        compiled = _net(layout).compile(ExecutionConfig(device="cpu"))
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=4, async_mode=True,
                                           trace=TraceConfig()))
        futs = [svc.submit(r) for r in x[:8]]
        [f.result(timeout=30) for f in futs]
        svc.drain_and_stop()
        tr = svc.tracer
        assert svc.plan.tracer is tr and svc.engine.tracer is tr
        for f in futs:
            assert sorted(s.name for s in tr.trace(f.trace_id)) == [
                "engine.batch", "engine.batch_agg", "engine.e2e", "engine.inbox"]
        assert {e["name"] for e in tr.chrome_trace()["traceEvents"] if e["ph"] == "X"} >= {
            "engine.inbox", "engine.batch", "engine.e2e"}

    def test_streaming_engine_spans(self, data):
        _, x, layout = data
        compiled = _net(layout).compile(ExecutionConfig(device="cpu"))
        svc = compiled.serve(ServiceConfig(plan="streaming", async_mode=True,
                                           trace=TraceConfig()))
        f = svc.submit(x[0])
        f.result(timeout=30)
        svc.close()
        assert sorted(s.name for s in svc.tracer.trace(f.trace_id)) == [
            "engine.e2e", "engine.inbox"]

    @pytest.mark.parametrize("plan", ["batched", "streaming"])
    def test_tracing_disabled_is_zero_cost_and_bit_identical(self, data, plan):
        _, x, layout = data
        out = {}
        for trace in (None, TraceConfig()):
            compiled = _net(layout).compile(ExecutionConfig(device="cpu"))
            svc = compiled.serve(ServiceConfig(plan=plan, max_batch=4, async_mode=True,
                                               trace=trace))
            futs = [svc.submit(r) for r in x[:8]]
            out[trace is not None] = np.stack([f.result(timeout=30) for f in futs])
            svc.drain_and_stop()
            if trace is None:
                assert svc.tracer is None and svc.engine.tracer is None
                assert all(getattr(f, "trace_id", None) is None for f in futs)
            else:
                assert all(f.trace_id is not None for f in futs)
        np.testing.assert_array_equal(out[True], out[False])


# ------------------------------------------------------------ train spans
class TestTrainTracing:
    KW = dict(epochs_hidden=2, epochs_readout=2, batch_size=64)

    def _fit(self, data, trace=None):
        ds, x, layout = data
        compiled = _net(layout).compile(ExecutionConfig(device="cpu", trace=trace))
        return compiled, compiled.fit((x, ds.y_train), **self.KW)

    def test_history_splits_host_and_device_time(self, data):
        _, res = self._fit(data)
        epochs = [h for h in res.history if "epoch" in h]
        assert epochs
        for h in epochs:
            assert h["host_s"] >= 0 and h["device_wait_s"] >= 0
            assert h["seconds"] == pytest.approx(h["host_s"] + h["device_wait_s"], rel=1e-6,
                                                 abs=1e-9)

    def test_phase_spans_recorded_on_train_trace(self, data):
        compiled, res = self._fit(data, trace=TraceConfig())
        tr = compiled.tracer
        spans = [s for s in tr.trace(tr.TRAIN_TRACE_ID) if s.name.startswith("train.")]
        names = {s.name for s in spans}
        assert "train.hidden0" in names and "train.readout" in names
        hidden = [s for s in spans if s.name == "train.hidden0"]
        assert {s.attrs["epoch"] for s in hidden} == {0, 1}
        assert all("device_wait_s" in s.attrs for s in hidden)
        # one span per history entry that carries timings
        assert len(spans) == len([h for h in res.history if "seconds" in h])

    def test_train_tracing_off_builds_no_tracer_and_changes_nothing(self, data):
        ds, x, layout = data
        plain = _net(layout).compile(ExecutionConfig(device="cpu"))
        seen = []  # the active tracer at every training batch of the plain fit
        layer = plain.hidden_layers[0]
        inner = type(layer).train_batch.__get__(layer)

        def train_batch(state, xb):
            seen.append(trace.active())
            return inner(state, xb)

        layer.train_batch = train_batch
        plain.fit((x, ds.y_train), **self.KW)
        del layer.train_batch
        traced, _ = self._fit(data, trace=TraceConfig())
        assert plain.tracer is None and trace.active() is None
        assert seen and all(t is None for t in seen)
        for a, b in zip(plain.state.layers, traced.state.layers):
            assert torch.equal(a.w, b.w) and torch.equal(a.b, b.b)
            assert torch.equal(a.plast.hcu_mask, b.plast.hcu_mask) if a.plast else True
        assert torch.equal(plain.predict(x, batch_size=48), traced.predict(x, batch_size=48))
        assert plain.evaluate((x, ds.y_train)) == traced.evaluate((x, ds.y_train))
        assert trace.active() is None
        assert traced.tracer.spans("layer.step")

    def test_trace_option_validation(self):
        with pytest.raises(TypeError, match="TraceConfig"):
            ExecutionConfig(device="cpu", trace="on")


# ------------------------------------------- Listing 1 spans and counters
class TestListing1Spans:
    """The spans and counters inside fit, evaluate and predict, on a
    network with fan-in below the input HCUs, the store on and rewiring
    every EVERY batches."""

    EVERY = 3
    KW = dict(epochs_hidden=3, epochs_readout=2, batch_size=64)

    def _compiled(self, layout, trace=None):
        hidden = UnitLayout(4, 8)
        net = Network(seed=0).add(StructuralPlasticityLayer(
            layout, hidden, fan_in=16, lam=0.05, mask_update_every=self.EVERY,
        )).add(DenseLayer(hidden, onehot_layout(10), lam=0.05))
        return net.compile(ExecutionConfig(device="cpu", trace=trace))

    @pytest.fixture(scope="class", params=["dense", "gathered"])
    def run(self, request, data):
        """The traced fit and evaluate, with the hidden product dense over
        the unit mask (the CPU's path), or gathered over the HCU mask (the
        card's path at a low fan-in, its launch stood in for on the CPU)."""
        ds, x, layout = data
        compiled = self._compiled(layout, TraceConfig())
        assert layout.n_hcu > 16 and compiled.activations is not None
        ops.reset_launches()
        with plain_gathering() if request.param == "gathered" else contextlib.nullcontext():
            res = compiled.fit((x, ds.y_train), **self.KW)
            fit_projections = compiled.activations.stats["projections"]
            compiled.evaluate((x[:40], ds.y_train[:40]), batch_size=16)
        by_seq = {s.seq: s for s in compiled.tracer.spans()}
        return dict(compiled=compiled, res=res, tr=compiled.tracer, by_seq=by_seq,
                    fit_projections=fit_projections, batches=x.shape[0] // 64,
                    gathered=request.param == "gathered", launches=ops.launch_counts())

    def parent(self, run, span):
        return run["by_seq"][span.parent].name if span.parent is not None else None

    def test_rewires_counted_at_every_multiple_of_the_period(self, run):
        tr = run["tr"]
        hidden_batches = self.KW["epochs_hidden"] * run["batches"]
        want = [k for k in range(hidden_batches) if k % self.EVERY == 0]
        rewires = tr.spans("layer.rewire")
        assert [s.attrs["host_step"] for s in rewires] == want
        assert tr.counters()["layer.rewires"] == len(want)
        assert {self.parent(run, s) for s in rewires} == {"layer.step"}

    def test_one_step_span_per_training_batch_with_its_mask_child(self, run):
        tr, n = run["tr"], run["batches"]
        steps = tr.spans("layer.step")
        hidden = [s for s in steps if s.attrs["layer"] == 0]
        readout = [s for s in steps if s.attrs["layer"] == 1]
        assert len(hidden) == self.KW["epochs_hidden"] * n
        assert len(readout) == self.KW["epochs_readout"] * n
        assert all(s.attrs["rows"] == 64 for s in steps)
        masks = tr.spans("layer.unit_mask")
        children = {}
        for m in masks:
            children.setdefault(m.parent, []).append(m)
        assert all(len(children.get(s.seq, [])) == 1 for s in hidden)
        assert not any(s.seq in children for s in readout)  # a DenseLayer has no mask
        layer = run["compiled"].hidden_layers[0]
        nbytes = layer.spec.n_pre * layer.spec.n_post * 4
        assert all(m.attrs["bytes"] == nbytes for m in masks)
        assert tr.counters()["layer.unit_mask_bytes"] == nbytes * len(masks)
        assert {self.parent(run, s) for s in hidden} == {"train.hidden0"}
        assert {self.parent(run, s) for s in readout} == {"train.readout"}

    def test_one_store_project_span_per_projection(self, run):
        tr, store = run["tr"], run["compiled"].activations
        projects = tr.spans("store.project")
        assert len(projects) == store.stats["projections"] == run["fit_projections"] + 1
        fit_proj, eval_proj = projects
        assert self.parent(run, fit_proj) == "train.project"
        assert self.parent(run, eval_proj) == "predict"
        assert (fit_proj.attrs["j"], fit_proj.attrs["k"]) == (0, 1)
        assert fit_proj.attrs["rows"] == 128 and fit_proj.attrs["chunks"] == 2
        assert eval_proj.attrs["rows"] == 40 and eval_proj.attrs["chunks"] == 3
        assert fit_proj.attrs["bytes"] == 128 * 32 * 4 and fit_proj.attrs["spilled"] is False
        # a projection chunk expands the mask once, under the projection,
        # unless its product gathers over the HCU mask
        for p in projects:
            kids = [m for m in tr.spans("layer.unit_mask") if m.parent == p.seq]
            assert len(kids) == (0 if run["gathered"] else p.attrs["chunks"])

    def test_gathered_products_counted_at_the_forward(self, run):
        """``masked_matmul.gathered`` on the tracer and among the launch
        counts: every hidden product (training batches, the projections'
        chunks) when the product gathers, none of the readout's; 0 on the
        dense path."""
        tr = run["tr"]
        hidden = self.KW["epochs_hidden"] * run["batches"]
        chunks = sum(p.attrs["chunks"] for p in tr.spans("store.project"))
        want = hidden + chunks if run["gathered"] else 0
        assert tr.counters().get("masked_matmul.gathered", 0) == want
        assert run["launches"]["masked_matmul.gathered"] == want

    def test_parents_nest_as_documented(self, run):
        tr = run["tr"]
        (fit,) = tr.spans("fit")
        assert fit.parent is None and fit.attrs == {"rows": 128, "batch_size": 64}
        phases = [s for s in tr.spans() if s.name.startswith("train.")]
        assert phases and {self.parent(run, s) for s in phases} == {"fit"}
        (ev,) = tr.spans("evaluate")
        assert ev.parent is None and ev.attrs == {"rows": 40, "batch_size": 16}
        (pred,) = tr.spans("predict")
        assert pred.parent == ev.seq and pred.trace_id != ev.trace_id
        assert pred.attrs == {"rows": 40, "chunks": 3, "store": True}
        (rb,) = tr.spans("evaluate.readback")
        assert rb.parent == ev.seq and rb.trace_id == ev.trace_id
        assert pred.t_end <= rb.t_start  # the predict span ends before the read back
        train = tr.trace(tr.TRAIN_TRACE_ID)
        assert {s.name for s in train} == {"fit", "train.hidden0", "train.project",
                                           "train.readout", "layer.step", "layer.rewire",
                                           "layer.unit_mask", "store.project"}

    def test_predict_one_trace_id_per_call_and_a_chunk_span_per_chunk(self, data):
        _, x, layout = data
        compiled = self._compiled(layout)
        with compiled.tracing() as tr:
            for _ in range(2):
                compiled.predict(x[:50], batch_size=16)
        preds = tr.spans("predict")
        assert len({p.trace_id for p in preds}) == 2
        for p in preds:
            chunks = [s for s in tr.trace(p.trace_id) if s.name == "predict.chunk"]
            assert [s.attrs["rows"] for s in chunks] == [16, 16, 16, 2]
            assert all(s.parent == p.seq for s in chunks)

    def test_tracing_detaches_on_exit(self, data):
        _, x, layout = data
        compiled = self._compiled(layout)
        assert compiled.tracer is None
        with compiled.tracing(TraceConfig(ring_size=64)) as tr:
            assert compiled.tracer is tr and tr.config.ring_size == 64
            compiled.predict(x[:8])
            assert trace.active() is None  # active only inside the program's calls
        assert compiled.tracer is None and trace.active() is None
        before = len(tr.spans())
        compiled.predict(x[:8])
        assert len(tr.spans()) == before
        with pytest.raises(RuntimeError):
            with compiled.tracing():
                raise RuntimeError("boom")
        assert compiled.tracer is None

    def test_profiler_trace_holds_the_spans_as_user_annotations(self, data, tmp_path):
        from torch.profiler import ProfilerActivity, profile

        ds, x, layout = data
        compiled = self._compiled(layout)
        with compiled.tracing() as tr, profile(activities=[ProfilerActivity.CPU]) as prof:
            compiled.fit((x, ds.y_train), **self.KW)
            compiled.evaluate((x[:40], ds.y_train[:40]), batch_size=16)
        path = str(tmp_path / "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        annotated = {}
        for e in events:
            if e.get("cat") == "user_annotation":
                annotated[e["name"]] = annotated.get(e["name"], 0) + 1
        for name in ("fit", "train.hidden0", "train.project", "train.readout", "layer.step",
                     "layer.rewire", "layer.unit_mask", "store.project", "evaluate",
                     "predict", "predict.chunk", "evaluate.readback"):
            assert annotated.get(name) == len(tr.spans(name)) > 0, name


# -------------------------------------------------- snapshot consistency
def test_hammered_snapshots_never_tear():
    """Writers bump submitted before completed under one bundle lock; a
    snapshot never shows completed > submitted."""
    m = ServiceMetrics()
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            m.submitted.inc()
            m.e2e_s.observe(0.001)
            m.completed.inc()

    threads = [threading.Thread(target=writer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(200):
            snap = m.snapshot()
            assert snap["completed"] <= snap["submitted"]
    finally:
        stop.set()
        for t in threads:
            t.join(10)
    assert not any(t.is_alive() for t in threads)


# ------------------------------------------------------------- fleet traces
class TestFleetTracing:
    def test_single_trace_id_spans_full_path(self):
        r = traced_fleet(n=2).start()
        futs = [r.submit(i, tenant="a") for i in range(8)]
        [f.result(timeout=10) for f in futs]
        tids = [f.trace_id for f in futs]
        assert sorted(tids) == list(range(1, 9))  # minted per request
        tr = r.tracer
        for tid in tids:
            names = {s.name for s in tr.trace(tid)}
            assert {"router.sched", "engine.inbox", "router.e2e", "engine.e2e"} <= names
        # the sched span names tenant + chosen engine
        sched = tr.trace(tids[0])[0]
        assert sched.name == "router.sched"
        assert sched.attrs["tenant"] == "a"
        assert sched.attrs["target"] in ("e0", "e1")
        r.drain_and_stop(timeout=10)
        doc = tr.chrome_trace()
        assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) >= 32

    def test_tenant_queue_full_journals_tenant_shed(self):
        from repro_torch.runtime import TenantQueueFull

        rr = Router(RouterConfig(tenants={"t": TenantConfig(max_queue=2)}, trace=TraceConfig()))
        rr.add_engine("e0", sleepy_factory(delay_s=0.05), ServiceConfig(max_queue=1))
        futs = [rr.submit(i, tenant="t") for i in range(2)]
        with pytest.raises(TenantQueueFull):
            rr.submit(99, tenant="t")
        events = rr.tracer.events(kind="tenant_shed")
        assert len(events) == 1
        _, _, ev = events[0]
        assert ev.tenant == "t" and ev.reason == "queue_full"
        assert ev.trace_id is not None
        rr.start()
        [f.result(timeout=10) for f in futs]
        rr.drain_and_stop(timeout=10)

    def test_doa_deadline_journals_deadline_shed(self):
        from repro_torch.runtime import DeadlineExceeded

        r = traced_fleet(n=1)
        fut = r.submit(1, deadline_s=0.0)
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=5)
        events = r.tracer.events(kind="deadline_shed")
        assert len(events) == 1
        assert events[0][2].trace_id == fut.trace_id
        r.drain_and_stop(timeout=10)

    @pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_restart_survival_journals_engine_restart(self):
        armed = {"on": True}
        r = Router(RouterConfig(routing="round_robin", trace=TraceConfig()))
        r.add_engine("e0", sleepy_factory(delay_s=0.001, crash_on={3}, armed=armed),
                     ServiceConfig(max_queue=2))
        r.start()
        futs = [r.submit(i) for i in range(8)]
        res = [f.result(timeout=15) for f in futs]
        assert sorted(res) == list(range(8))  # crash victim redispatched
        r.drain_and_stop(timeout=15)
        assert r.metrics.snapshot()["restarts"] == 1
        events = r.tracer.events(kind="engine_restart")
        assert len(events) == 1
        ev = events[0][2]
        assert ev.engine == "e0" and ev.restarts == 1
        # per-engine telemetry bundle survived the restart (same object)
        snap = r.metrics.snapshot()
        assert snap["engines"]["e0"]["completed"] >= 1

    def test_tracing_disabled_is_zero_cost_and_unset(self):
        r = Router(RouterConfig(routing="round_robin"))
        r.add_engine("e0", sleepy_factory(), ServiceConfig(max_queue=4))
        r.start()
        futs = [r.submit(i) for i in range(4)]
        [f.result(timeout=10) for f in futs]
        assert r.tracer is None
        assert all(getattr(f, "trace_id", None) is None for f in futs)
        r.drain_and_stop(timeout=10)


class TestRouterSnapshotConsistency:
    def test_hammered_router_snapshots_never_tear(self):
        rm = RouterMetrics()
        bundles = [rm.register_engine(f"e{i}") for i in range(3)]
        stop = threading.Event()
        errors = []

        def writer(m):
            k = 0
            while not stop.is_set():
                m.submitted.inc()
                m.completed.inc()
                m.e2e_s.observe(0.001 * (k % 50))
                rm.dispatched.inc()
                k += 1

        def reader():
            last_dispatched = 0
            try:
                while not stop.is_set():
                    snap = rm.snapshot()
                    # counters are monotone across snapshots
                    assert snap["dispatched"] >= last_dispatched
                    last_dispatched = snap["dispatched"]
                    for eng in snap["engines"].values():
                        # per-bundle consistency: completed never exceeds
                        # submitted (both incremented under one lock)
                        assert eng["completed"] <= eng["submitted"]
                        assert eng["e2e_s"]["count"] >= 0
                    for h in snap["fleet"].values():
                        assert h["count"] >= 0
            except AssertionError as e:  # surfaced after join
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(m,)) for m in bundles] + [
            threading.Thread(target=reader) for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.4)
        stop.set()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        assert errors == []

    def test_histogram_window_lengths_bounded_under_merge_race(self):
        src = Histogram(window=64)
        dst = Histogram(window=32)
        stop = threading.Event()

        def observe():
            k = 0
            while not stop.is_set():
                src.observe(float(k % 10))
                k += 1

        t = threading.Thread(target=observe)
        t.start()
        try:
            for _ in range(200):
                dst.merge(src)
                snap = dst.snapshot()
                vals = dst._window_values()
                assert len(vals) <= 32
                assert snap["count"] >= len(vals)
        finally:
            stop.set()
            t.join(timeout=10)
        assert not t.is_alive()


# --------------------------------------------------------- continual fleet
class TestContinualFleetTrace:
    def test_feedback_trace_covers_learn_hops(self):
        """One trace id through a continual fleet covers router sched ->
        engine inbox -> learn, with plan.update / plan.merge spans and
        merge_applied journal events correlated."""
        from test_torch_continual import _cc, _fitted

        from repro_torch.runtime import ContinualPlan, Feedback

        compiled, xs, ys = _fitted()

        def factory(config, metrics):
            return ContinualPlan(compiled, config, metrics)

        router = Router(RouterConfig(routing="round_robin", trace=TraceConfig()))
        cfg = ServiceConfig(continual=_cc(update_batch=2, merge_every=2))
        router.add_engine("cl0", factory, cfg)
        router.start()
        futs = [router.submit(Feedback(xs[k], int(ys[k])), pool="continual") for k in range(8)]
        acks = [f.result(timeout=30) for f in futs]
        router.drain_and_stop(timeout=30)
        assert any(a["applied"] for a in acks)
        assert any(a["merged"] for a in acks)
        tr = router.tracer
        # the sample that applied an update carries the full hop chain
        applied_tid = futs[[a["applied"] for a in acks].index(True)].trace_id
        names = {s.name for s in tr.trace(applied_tid)}
        assert {"router.sched", "engine.inbox", "engine.learn", "plan.update"} <= names
        merged_tid = futs[[a["merged"] for a in acks].index(True)].trace_id
        assert "plan.merge" in {s.name for s in tr.trace(merged_tid)}
        merges = tr.events(kind="merge_applied")
        assert merges and merges[0][2].trace_id == merged_tid
        # the whole thing exports as valid Chrome trace JSON
        json.loads(json.dumps(tr.chrome_trace()))
