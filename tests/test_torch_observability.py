"""Observability of the port: request tracing and the event journal
(``repro_torch.runtime.trace``), the metrics bundle
(``repro_torch.runtime.metrics``), OpenMetrics export
(``repro_torch.runtime.export``), the engine's request spans and the
training program's ``train.<phase>`` spans.  The tracer, journal,
chrome-trace, histogram-merge, render/parse and ``MetricsServer`` cases are
those of the reference's ``tests/test_observability.py``; the port's
modules copy the reference's serving instruments, so their snapshots and
rendered text are also held equal to the reference's on the same inputs
(the reference's bundle also carries the decode and continual tiers'
instruments, which the port brings with those slices)."""
import dataclasses
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from repro.runtime import ServiceMetrics as JServiceMetrics
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
from repro_torch.runtime import (
    EventJournal,
    Histogram,
    MetricsServer,
    OpenMetricsError,
    ServiceConfig,
    ServiceMetrics,
    TraceConfig,
    Tracer,
    build_tracer,
    parse_openmetrics,
    render_openmetrics,
)


@pytest.fixture(scope="module")
def data():
    ds = mnist_like(n_train=128, n_test=32, n_features=32, seed=0)
    x, layout = complementary_code(ds.x_train)
    return ds, np.asarray(x, np.float32), layout


@dataclasses.dataclass(frozen=True)
class _Restart:
    """A journal event of the shape the reference's typed events have."""

    kind = "engine_restart"
    engine: str = None
    restarts: int = None
    leftover: int = None


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


# ------------------------------------------------------------ openmetrics
def _fill_service(m):
    m.submitted.inc(3)
    m.completed.inc(2)
    m.rejected.inc()
    m.queue_depth.set(4)
    for v in (0.1, 0.25, 0.05):
        m.e2e_s.observe(v)
        m.batch_s.observe(v / 2)


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
            "repro_queue_wait_seconds", "repro_batch_seconds", "repro_e2e_seconds"}

    def test_snapshot_holds_the_served_instruments(self):
        snap = ServiceMetrics().snapshot()
        assert list(snap) == ["submitted", "completed", "rejected", "queue_depth",
                              "queue_wait_s", "batch_s", "e2e_s"]
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
        spans = tr.trace(tr.TRAIN_TRACE_ID)
        names = {s.name for s in spans}
        assert "train.hidden0" in names and "train.readout" in names
        hidden = [s for s in spans if s.name == "train.hidden0"]
        assert {s.attrs["epoch"] for s in hidden} == {0, 1}
        assert all("device_wait_s" in s.attrs for s in hidden)
        # one span per history entry that carries timings
        assert len(spans) == len([h for h in res.history if "seconds" in h])

    def test_train_tracing_off_builds_no_tracer_and_changes_nothing(self, data):
        plain, _ = self._fit(data)
        traced, _ = self._fit(data, trace=TraceConfig())
        assert plain.tracer is None
        for a, b in zip(plain.state.layers, traced.state.layers):
            assert torch.equal(a.w, b.w) and torch.equal(a.b, b.b)

    def test_trace_option_validation(self):
        with pytest.raises(TypeError, match="TraceConfig"):
            ExecutionConfig(device="cpu", trace="on")


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
