"""Serving on the port (``compiled.serve()``, ``repro_torch.runtime.service``
and ``repro_torch.runtime.engine``) against the JAX package's serving from
the same carried-across state, plus the reference's serving contracts
(``tests/test_service.py`` ``TestBatchedService``, ``TestStreamingService``
and the BCPNN cases of ``TestServiceFrontDoor``;
``tests/test_async_engine.py`` ``TestAsyncBatched``, ``TestMetrics`` and the
engine lifecycle, here over a batched BCPNN plan) as tests of the port.
The JAX side runs as its own tests run it on the CPU (the jnp path); the
port runs its kernels' plain versions (``device="cpu"``)."""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import path_key
from repro.core import DenseLayer as JDense
from repro.core import ExecutionConfig as JExecutionConfig
from repro.core import Network as JNetwork
from repro.core import StructuralPlasticityLayer as JPlastic
from repro.core import UnitLayout as JUnitLayout
from repro.core import onehot_layout as jonehot
from repro.runtime import ServiceConfig as JServiceConfig
from repro_torch.checkpoint import network_state_from_flat
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
    AsyncEngine,
    BatchedPlan,
    Counter,
    EngineStopped,
    Histogram,
    QueueFull,
    ServiceConfig,
)

RNG = np.random.default_rng(11)
HIDDEN = (4, 8)
LAYER_KW = dict(fan_in=16, lam=0.05, gain=4.0)
BUCKETS = (4, 16, 64)
# The same functions on the same state: f32 sums in another order only.
RTOL, ATOL = 1e-5, 1e-6


def _jflat(layer_states):
    tree = {"layers": {str(i): s for i, s in enumerate(layer_states)}}
    return {
        path_key(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def data():
    ds = mnist_like(n_train=128, n_test=32, n_features=32, seed=0)
    x, layout = complementary_code(ds.x_train)
    return ds, np.asarray(x, np.float32), layout


def _compiled_bcpnn(layout, readout=False, **config):
    """``tests/test_service.py:_compiled_bcpnn`` on the port (32 features,
    4x8 hidden), optionally with a BCPNN readout of 10 classes."""
    net = Network(seed=0).add(StructuralPlasticityLayer(layout, UnitLayout(*HIDDEN), **LAYER_KW))
    if readout:
        net.add(DenseLayer(UnitLayout(*HIDDEN), onehot_layout(10), lam=0.05))
    return net.compile(ExecutionConfig(device="cpu", **config))


@pytest.fixture(scope="module")
def carried(data):
    """The JAX package's serving networks, one hidden-only and one fitted
    with a BCPNN readout, and the port's networks on their states."""
    ds, x, layout = data
    out = {}
    for readout in (False, True):
        jnet = JNetwork(seed=0).add(
            JPlastic(JUnitLayout(layout.n_hcu, layout.n_mcu), JUnitLayout(*HIDDEN), **LAYER_KW)
        )
        if readout:
            jnet.add(JDense(JUnitLayout(*HIDDEN), jonehot(10), lam=0.05))
        jc = jnet.compile(JExecutionConfig())
        if readout:
            jc.fit((x, ds.y_train), epochs_hidden=1, epochs_readout=1, batch_size=32)
        pc = _compiled_bcpnn(layout, readout=readout)
        pc.state = network_state_from_flat(_jflat(jc.state.layers), pc.layers)
        out[readout] = (jc, pc)
    return out


@pytest.mark.parametrize("readout", [False, True], ids=["hidden", "bcpnn_readout"])
@pytest.mark.parametrize("n", [1, 5, 17, 64])
def test_serve_matches_jax_serve(data, carried, readout, n):
    _, x, _ = data
    jc, pc = carried[readout]
    want = np.asarray(jc.serve(JServiceConfig(plan="batched", buckets=BUCKETS)).predict(x[:n]))
    got = pc.serve(ServiceConfig(plan="batched", buckets=BUCKETS)).predict(x[:n])
    assert isinstance(got, torch.Tensor) and got.device == pc.device
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_streaming_service_matches_jax(data, carried):
    """The streaming plan from one carried state on both sides: feed 24
    rows (3 flushes of 8), infer, close; the adopted states agree."""
    _, x, _ = data
    jc, pc = carried[False]
    jsvc = jc.serve(JServiceConfig(plan="streaming", max_batch=8, cache_size=4))
    psvc = pc.serve(ServiceConfig(plan="streaming", max_batch=8, cache_size=4))
    for row in x[:24]:
        jsvc.feed(row)
        psvc.feed(row)
    np.testing.assert_allclose(psvc.infer(x[0]), np.asarray(jsvc.infer(x[0])), rtol=RTOL,
                               atol=ATOL)
    jsvc.close()
    psvc.close()
    assert psvc.stats["flushes"] == jsvc.stats["flushes"] == 3
    for name in ("w", "b"):
        np.testing.assert_allclose(
            getattr(pc.state.layers[0], name).numpy(),
            np.asarray(getattr(jc.state.layers[0], name)), rtol=RTOL, atol=ATOL,
        )


class TestBatchedService:
    def test_bucket_padding_never_changes_predict(self, data):
        _, x, layout = data
        compiled = _compiled_bcpnn(layout)
        svc = compiled.serve(ServiceConfig(plan="batched", buckets=BUCKETS))
        for n in (1, 2, 3, 4, 5, 15, 16, 17, 33, 64, 100, 128):
            want = compiled.predict(x[:n]).numpy()
            got = svc.predict(x[:n]).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=f"n={n}")
            np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1), err_msg=f"n={n}")
        assert svc.stats["padded_rows"] > 0  # padding actually happened

    def test_default_plan_and_shared_forward(self, data):
        _, x, layout = data
        compiled = _compiled_bcpnn(layout)
        svc = compiled.serve()
        assert svc.plan.name == "batched"
        assert svc.plan._fwd is compiled._forward_fn()
        torch.testing.assert_close(svc.predict(x[:8]), compiled.predict(x[:8]), rtol=0, atol=0)

    def test_without_the_store_the_forward_serves(self, data):
        _, x, layout = data
        compiled = _compiled_bcpnn(layout, readout=True, cache_activations=False)
        svc = compiled.serve(ServiceConfig(plan="batched", buckets=BUCKETS))
        torch.testing.assert_close(svc.predict(x[:5]), compiled.predict(x[:5]), rtol=1e-5,
                                   atol=1e-7)
        assert svc.stats["projection_reuse_hits"] == 0

    def test_queue_drain_batched(self, data):
        _, x, layout = data
        compiled = _compiled_bcpnn(layout)
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=8))
        for row in x[:5]:
            assert svc.submit(row)
        scores = svc.drain()
        torch.testing.assert_close(scores, compiled.predict(x[:5]), rtol=0, atol=0)
        t = svc.stats["telemetry"]
        assert t["submitted"] == t["completed"] == 5
        assert t["queue_wait_s"]["count"] == 5 and t["e2e_s"]["count"] == 5
        assert svc.drain() is None  # an empty drain

    def test_served_predict_reuses_level_projection(self, data):
        """A repeated request batch hits the store's cached projection and
        pays only the head: no forward pair through the hidden layer."""
        _, x, layout = data
        compiled = _compiled_bcpnn(layout, readout=True)
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=64))
        store = compiled.activations
        a = svc.predict(x[:32])
        p = store.stats["projections"]
        hidden, calls = compiled.layers[0], []
        hidden.forward = lambda *args, _f=hidden.forward: calls.append(1) or _f(*args)
        b = svc.predict(np.array(x[:32]))  # a fresh array, the same bytes
        assert store.stats["projections"] == p and not calls
        assert svc.plan.stats["projection_reuse_hits"] >= 1
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert compiled._head is not None
        torch.testing.assert_close(a, compiled.predict(x[:32]), rtol=0, atol=0)

    def test_canonical_anchor_survives_caller_writes(self, data):
        _, x, layout = data
        compiled = _compiled_bcpnn(layout)
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=64))
        buf = np.array(x[:8])
        a = svc.predict(buf)
        buf[:] = x[8:16]  # the caller reuses its buffer
        torch.testing.assert_close(svc.predict(buf), compiled.predict(x[8:16]), rtol=0, atol=0)
        assert svc.plan.stats["projection_reuse_hits"] == 0
        assert not torch.equal(a, svc.predict(buf))


class TestStreamingService:
    def test_streaming_plan_adopts_state(self, data):
        _, x, layout = data
        compiled = _compiled_bcpnn(layout)
        svc = compiled.serve(ServiceConfig(plan="streaming", max_batch=8, cache_size=4))
        step0 = int(compiled.state.layers[0].step)
        for row in x[:24]:
            svc.feed(row)
        out = svc.infer(x[0])
        assert out.shape[0] == compiled.hidden_layers[0].spec.n_post
        svc.close()
        assert int(compiled.state.layers[0].step) == step0 + 3
        assert svc.stats["samples_seen"] == 24

    def test_streaming_matches_direct_session(self, data):
        _, x, layout = data
        compiled_a, compiled_b = _compiled_bcpnn(layout), _compiled_bcpnn(layout)
        svc = compiled_a.serve(ServiceConfig(plan="streaming", max_batch=8))
        sess = compiled_b.streaming(max_batch=8)
        for row in x[:16]:
            svc.feed(row)
            sess.feed(row)
        np.testing.assert_allclose(svc.infer(x[0]), sess.infer(x[0]), rtol=1e-6)
        svc.close()
        sess.close()

    def test_sync_submit_feeds_and_async_submit_infers(self, data):
        _, x, layout = data
        compiled = _compiled_bcpnn(layout)
        svc = compiled.serve(ServiceConfig(plan="streaming", max_batch=8))
        for row in x[:12]:
            assert svc.submit(row)
        assert svc.drain() is None
        assert svc.stats["samples_seen"] == 12 and svc.stats["flushes"] == 2
        want = [svc.infer(row) for row in x[:6]]
        svc.start()
        futs = [svc.submit(row) for row in x[:6]]
        got = [f.result(timeout=30) for f in futs]
        svc.close()
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray)
            np.testing.assert_array_equal(g, w)
        assert svc.stats["samples_seen"] == 12  # inference trains nothing


class TestServiceFrontDoor:
    def test_max_queue_admission_control(self, data):
        _, x, layout = data
        compiled = _compiled_bcpnn(layout)
        svc = compiled.serve(ServiceConfig(plan="batched", max_queue=2))
        assert svc.submit(x[0]) and svc.submit(x[1])
        assert not svc.submit(x[2])
        assert svc.stats["rejected"] == 1
        assert svc.drain().shape[0] == 2

    def test_config_validation(self):
        with pytest.raises(ValueError, match="policy"):
            ServiceConfig(policy="priority")
        with pytest.raises(ValueError, match="plan"):
            ServiceConfig(plan="sharded")
        with pytest.raises(ValueError, match="buckets"):
            ServiceConfig(buckets=(16, 8))
        with pytest.raises(ValueError, match="buckets"):
            ServiceConfig(buckets=(0,))
        with pytest.raises(ValueError, match="max_batch"):
            ServiceConfig(max_batch=0)
        with pytest.raises(ValueError, match="max_queue"):
            ServiceConfig(max_queue=0)
        with pytest.raises(ValueError, match="trace"):
            ServiceConfig(trace="on")

    @pytest.mark.parametrize("option,error", [
        (dict(router=object()), ValueError), (dict(continual=object()), ValueError),
        (dict(strict=True), None), (dict(plan="decode"), ValueError),
        (dict(plan="continual"), None),
    ], ids=["router", "continual", "strict", "decode", "continual_plan"])
    def test_unported_options_raise_by_name(self, option, error, data):
        """``continual`` and ``router`` take their config types and refuse
        anything else by name with ValueError, as the reference does; ``strict`` is accepted and binds the plan's
        recompile sentinel, the served scores unchanged; ``plan="decode"``
        serves the LM zoo (``serve_model``), so a BCPNN network's ``serve``
        refuses it; ``plan="continual"`` binds the continual tier."""
        (name, value), = option.items()
        if name == "strict":
            compiled = _compiled_bcpnn(data[2])
            x = np.asarray(data[1][:8], np.float32)
            strict = compiled.serve(ServiceConfig(**option))
            assert strict.plan._sentinel is not None
            plain = compiled.serve(ServiceConfig())
            assert plain.plan._sentinel is None
            torch.testing.assert_close(strict.predict(x), plain.predict(x), rtol=0, atol=0)
            assert strict.plan._sentinel.sizes()["head"] == 1
            return
        if error is None:
            from repro_torch.runtime import ContinualPlan
            from repro_torch.runtime.service import SERVE_PLANS

            assert SERVE_PLANS[ServiceConfig(**option).plan] is ContinualPlan
            return
        if name == "plan":
            from repro_torch.runtime import DecodePlan
            from repro_torch.runtime.service import SERVE_PLANS

            assert SERVE_PLANS[ServiceConfig(**option).plan] is DecodePlan
            with pytest.raises(error, match="decod.*serve_model"):
                _compiled_bcpnn(data[2]).serve(ServiceConfig(**option))
            return
        with pytest.raises(error, match=name):
            ServiceConfig(**option)

    def test_plan_capability_mismatch(self, data):
        _, x, layout = data
        compiled = _compiled_bcpnn(layout)
        svc = compiled.serve()
        with pytest.raises(NotImplementedError, match="feed"):
            svc.feed(x[0])
        with pytest.raises(NotImplementedError, match="infer"):
            svc.infer(x[0])
        stream = compiled.serve(ServiceConfig(plan="streaming"))
        with pytest.raises(NotImplementedError, match="predict"):
            stream.predict(x[:2])
        with pytest.raises(ValueError, match="decod"):
            compiled.serve(ServiceConfig(plan="decode"))


class TestAsyncBatched:
    def test_multithreaded_clients_hammering_submit(self, data):
        _, x, layout = data
        compiled = _compiled_bcpnn(layout)
        want = compiled.predict(x[:16]).numpy()
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=8, async_mode=True))
        results = {}
        lock = threading.Lock()

        def client(tid):
            futs = [(i, svc.submit(x[i])) for i in range(16)]
            for i, f in futs:
                r = f.result(timeout=60)
                with lock:
                    results[(tid, i)] = r

        threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        svc.drain_and_stop()
        assert len(results) == 64
        for (tid, i), got in results.items():
            assert isinstance(got, np.ndarray)
            np.testing.assert_allclose(got, want[i], rtol=1e-5, atol=1e-7, err_msg=f"{tid}:{i}")
        assert svc.stats["telemetry"]["completed"] == 64
        assert svc.engine.batches >= 64 // 8  # micro-batching really formed

    def test_deadline_flushes_partial_batch(self, data):
        _, x, layout = data
        compiled = _compiled_bcpnn(layout)
        want = compiled.predict(x[:2]).numpy()
        svc = compiled.serve(
            ServiceConfig(plan="batched", max_batch=64, max_wait_s=0.05, async_mode=True)
        )
        f0, f1 = svc.submit(x[0]), svc.submit(x[1])
        np.testing.assert_allclose(f0.result(timeout=30), want[0], rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(f1.result(timeout=30), want[1], rtol=1e-5, atol=1e-7)
        svc.drain_and_stop()
        assert svc.engine.batches >= 1

    def test_sjf_rejected_for_non_decode_plans(self, data):
        _, _, layout = data
        compiled = _compiled_bcpnn(layout)
        with pytest.raises(ValueError, match="sjf"):
            compiled.serve(ServiceConfig(plan="batched", policy="sjf"))
        with pytest.raises(ValueError, match="sjf"):
            compiled.serve(ServiceConfig(plan="streaming", policy="sjf"))
        # A decode plan orders its Requests by prompt length.
        import torch

        from repro_torch.configs import get_smoke_config
        from repro_torch.models import build_model
        from repro_torch.runtime import serve_model

        lm = build_model(get_smoke_config("yi-9b"), device="cpu")
        lm.init(torch.Generator().manual_seed(0))
        assert serve_model(lm, ServiceConfig(policy="sjf")).config.policy == "sjf"

    def test_failed_batch_fails_its_futures_and_serving_goes_on(self, data):
        """Every future resolves: a batch whose predict raises fails its
        futures with that exception, and the next batch is served."""
        _, x, layout = data
        compiled = _compiled_bcpnn(layout)
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=4))
        svc.start(run=False)
        bad = svc.submit(np.zeros(3, np.float32))  # the wrong width
        svc.engine.drain_and_stop()
        with pytest.raises(RuntimeError):
            bad.result(timeout=30)
        svc.start()
        good = svc.submit(x[0])
        np.testing.assert_allclose(good.result(timeout=30), compiled.predict(x[:1]).numpy()[0],
                                   rtol=RTOL, atol=ATOL)
        svc.drain_and_stop()


class TestMetrics:
    def test_histogram_percentiles_match_numpy(self):
        h = Histogram(window=4096)
        vals = RNG.permutation(np.linspace(0.001, 1.0, 1000))
        for v in vals:
            h.observe(float(v))
        for p in (50, 95, 99):
            assert h.percentile(p) == pytest.approx(float(np.percentile(vals, p)), rel=1e-12)
        snap = h.snapshot()
        assert snap["count"] == 1000
        assert snap["max"] == pytest.approx(1.0)
        assert snap["mean"] == pytest.approx(float(vals.mean()))

    def test_histogram_window_bounds_memory(self):
        h = Histogram(window=100)
        for v in range(250):
            h.observe(float(v))
        assert h.count == 250  # lifetime count is exact
        assert h.percentile(50) == pytest.approx(
            float(np.percentile(np.arange(150, 250, dtype=float), 50))
        )

    def test_counters_thread_safe(self):
        c = Counter()

        def spin():
            for _ in range(1000):
                c.inc()

        threads = [threading.Thread(target=spin) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        assert c.value == 8000
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_async_batched_records_telemetry(self, data):
        _, x, layout = data
        compiled = _compiled_bcpnn(layout)
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=4, async_mode=True))
        futs = [svc.submit(row) for row in x[:10]]
        [f.result(timeout=30) for f in futs]
        svc.drain_and_stop()
        t = svc.stats["telemetry"]
        assert t["submitted"] == t["completed"] == 10
        assert t["queue_wait_s"]["count"] == 10
        assert t["batch_s"]["count"] == svc.engine.batches >= 3
        assert t["e2e_s"]["max"] >= t["e2e_s"]["p50"] > 0


class TestEngineLifecycle:
    """The engine-lifecycle cases of ``tests/test_async_engine.py``, over a
    batched BCPNN plan instead of the LM."""

    @pytest.fixture
    def compiled(self, data):
        return _compiled_bcpnn(data[2])

    def test_engine_restart_rejected(self, data, compiled):
        x = data[1]
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=2))
        eng = svc.start()
        eng.drain_and_stop()
        with pytest.raises(RuntimeError, match="stopped"):
            eng.start()
        eng2 = svc.start()  # the service binds a FRESH engine after a stop
        assert eng2 is not eng
        assert svc.submit(x[0]).result(timeout=30).shape == (32,)
        svc.drain_and_stop()

    def test_drain_while_draining_is_idempotent(self, data, compiled):
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=2, async_mode=True))
        svc.submit(data[1][0])
        svc.drain_and_stop()
        svc.drain_and_stop()  # no-op, no deadlock
        assert svc.engine.stopped

    def test_sync_drain_raises_while_engine_owns_queue(self, compiled):
        svc = compiled.serve(ServiceConfig(plan="batched", async_mode=True))
        with pytest.raises(RuntimeError, match="engine"):
            svc.drain()
        svc.drain_and_stop()

    def test_start_refuses_with_items_in_sync_queue(self, data, compiled):
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=2))
        assert svc.submit(data[1][0]) is True
        with pytest.raises(RuntimeError, match="drain"):
            svc.start()
        assert svc.drain().shape[0] == 1  # still served by the sync path
        svc.start()
        svc.drain_and_stop()

    def test_cancelled_future_is_skipped_not_fatal(self, data, compiled):
        x = data[1]
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=1))
        svc.start(run=False)
        f0, f1, f2 = (svc.submit(x[i]) for i in range(3))
        assert f1.cancel()  # still queued: cancellable
        svc.drain_and_stop()
        want = compiled.predict(x[:3]).numpy()
        np.testing.assert_allclose(f0.result(), want[0], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(f2.result(), want[2], rtol=RTOL, atol=ATOL)
        assert f1.cancelled()
        assert svc.engine.batches == 2  # the cancelled item was never served
        assert svc.stats["telemetry"]["completed"] == 2

    def test_backpressure_rejection_counts(self, data, compiled):
        x = data[1]
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=1, max_queue=2))
        eng = svc.start(run=False)
        f1, f2 = svc.submit(x[0]), svc.submit(x[1])
        with pytest.raises(QueueFull):
            svc.submit(x[2])
        assert svc.stats["rejected"] == 1
        assert svc.stats["queued"] == 2  # the engine inbox counts as queued
        assert eng.drain_and_stop() == []  # a graceful drain leaves nothing
        assert f1.result(timeout=30).shape == f2.result(timeout=30).shape == (32,)
        with pytest.raises(EngineStopped):
            svc.submit(x[2])
        assert svc.stats["rejected"] == 2

    def test_engine_direct_construction(self, data, compiled):
        x = data[1]
        plan = BatchedPlan(compiled, ServiceConfig(max_batch=2))
        eng = AsyncEngine(plan, plan.config)
        futs = [eng.submit(x[i]) for i in range(3)]
        eng.drain_and_stop()
        want = compiled.predict(x[:3]).numpy()
        for i, f in enumerate(futs):
            np.testing.assert_allclose(f.result(), want[i], rtol=RTOL, atol=ATOL)
        assert eng.stats["state"] == "stopped"

    def test_engine_over_an_unported_plan_raises_by_name(self, compiled):
        """The decode loop, once refused by name, is ported: an engine over
        a DecodePlan serves a Request to its Completion."""
        import torch

        from repro_torch.configs import get_smoke_config
        from repro_torch.models import build_model
        from repro_torch.runtime import Completion, DecodePlan, Request

        lm = build_model(get_smoke_config("yi-9b"), device="cpu")
        lm.init(torch.Generator().manual_seed(0))
        plan = DecodePlan(lm, ServiceConfig(max_batch=1, max_seq=16))
        eng = AsyncEngine(plan, plan.config)
        fut = eng.submit(Request(rid=7, prompt=np.arange(5, dtype=np.int32), max_new_tokens=3))
        eng.drain_and_stop()
        done = fut.result(timeout=30)
        assert isinstance(done, Completion) and done.rid == 7 and len(done.tokens) == 3
        assert eng.stats["admitted"] == 1

    def test_engine_thread_serves_while_callers_wait(self, data, compiled):
        """Submits from many threads while the loop runs: every future
        resolves within its timeout, and the counts add up."""
        x = data[1]
        svc = compiled.serve(ServiceConfig(plan="batched", max_batch=4, max_wait_s=0.001,
                                           async_mode=True))
        futs, lock = [], threading.Lock()

        def client(rows):
            for r in rows:
                f = svc.submit(r)
                with lock:
                    futs.append(f)
                time.sleep(0.0005)

        threads = [threading.Thread(target=client, args=(x[i::8],)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert all(f.result(timeout=30).shape == (32,) for f in futs)
        svc.drain_and_stop()
        assert svc.stats["telemetry"]["completed"] == len(futs) == len(x)
