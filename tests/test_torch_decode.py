"""Decode serving on the port against the JAX package, on the CPU: the
``DecodePlan`` front door (token-identical ``generate``), ``pad_cache_like``,
the async engine's decode loop, and ``serve_fleet`` with a hot restart.

The reference's ``tests/test_service.py``, ``tests/test_async_engine.py``
and ``tests/test_router.py`` are the specification.  Both packages serve
the same weights: the JAX package's init, carried through its checkpoint.
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.checkpoint.store import save_checkpoint
from repro.configs import get_smoke_config
from repro.models import build_model as j_build_model
from repro_torch.checkpoint import lm_params_from_flat, load_flat
from repro_torch.runtime import (
    AsyncEngine,
    DecodePlan,
    EngineStopped,
    NoEngineAvailable,
    QueueFull,
    Request,
    Router,
    RouterConfig,
    ServiceConfig,
    TenantConfig,
    pad_cache_like,
    serve_fleet,
    serve_model,
)

RNG = np.random.default_rng(7)


def _pair(arch, tmp_path_factory):
    cfg = get_smoke_config(arch)
    jm = j_build_model(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    path = save_checkpoint(str(tmp_path_factory.mktemp(arch)), 0, params)
    return cfg, jm, params, lm_params_from_flat(cfg, load_flat(path), device="cpu")


@pytest.fixture(scope="module")
def yi(tmp_path_factory):
    return _pair("yi-9b", tmp_path_factory)


@pytest.fixture(scope="module")
def gemma(tmp_path_factory):
    return _pair("gemma3-1b", tmp_path_factory)


def _reqs(cfg, lengths, max_new=6, eos_id=None, cls=Request):
    return [
        cls(rid=i, prompt=RNG.integers(0, cfg.vocab_size, n).astype(np.int32),
            max_new_tokens=max_new, eos_id=eos_id)
        for i, n in enumerate(lengths)
    ]


def _as_ref(reqs):
    return [jrt.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                        eos_id=r.eos_id) for r in reqs]


def _assert_completions_equal(ref, out):
    ref = {c.rid: c for c in ref}
    out = {c.rid: c for c in out}
    assert ref.keys() == out.keys()
    for rid in ref:
        np.testing.assert_array_equal(ref[rid].tokens, out[rid].tokens, err_msg=f"rid={rid}")
        assert ref[rid].prefill_len == out[rid].prefill_len
        assert ref[rid].steps == out[rid].steps


def _both(pair, reqs, **kw):
    """(the reference's completions, the port's service and completions)."""
    cfg, jm, params, tm = pair
    ref = jrt.serve_model(jm, params, jrt.ServiceConfig(**kw)).generate(_as_ref(reqs))
    svc = serve_model(tm, ServiceConfig(**kw))
    return ref, svc, svc.generate(reqs)


# ------------------------------------------------------------------ parity
class TestGenerateParity:
    def test_mixed_lengths_and_slot_refill(self, yi):
        # 5 requests through 2 slots: admission, eviction, refill, each
        # slot at its own position in every fused step.
        ref, svc, out = _both(yi, _reqs(yi[0], (4, 11, 7, 16, 5)), max_batch=2, max_seq=48)
        _assert_completions_equal(ref, out)
        st = svc.stats
        assert st["mean_occupancy"] > 1.0  # slots really shared a step
        assert st["fused_steps"] < st["slot_steps"]

    def test_eos_exit(self, yi):
        cfg = yi[0]
        probe = _reqs(cfg, (6, 9, 5), max_new=8)
        first = serve_model(yi[3], ServiceConfig(max_batch=2, max_seq=48)).generate(probe)
        eos = int(sorted(first, key=lambda c: c.rid)[0].tokens[2])
        reqs = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=8, eos_id=eos) for r in probe]
        ref, _, out = _both(yi, reqs, max_batch=2, max_seq=48)
        assert any(len(c.tokens) < 8 for c in ref)  # eos fired somewhere
        _assert_completions_equal(ref, out)

    def test_bucketed_prefill_is_token_exact(self, gemma):
        # gemma3: windowed attention (window 16) + bucket padding + the
        # last_pos gather; two prompts longer than the window, decoding
        # past it.
        reqs = _reqs(gemma[0], (3, 12, 9, 17, 20), max_new=8)
        ref, svc, out = _both(gemma, reqs, max_batch=2, max_seq=64, buckets=(8, 24),
                              cache_size=4)
        _assert_completions_equal(ref, out)
        assert svc.stats["prefill_cells"] <= 2  # 5 prompt lengths on 2 cells

    def test_sjf_order(self, yi):
        cfg, jm, params, tm = yi
        reqs = _reqs(cfg, (9, 4, 13, 6), max_new=3)
        jsvc = jrt.serve_model(jm, params, jrt.ServiceConfig(max_batch=1, max_seq=32,
                                                             policy="sjf"))
        tsvc = serve_model(tm, ServiceConfig(max_batch=1, max_seq=32, policy="sjf"))
        for r, q in zip(reqs, _as_ref(reqs)):
            assert tsvc.submit(r) and jsvc.submit(q)
        out, ref = tsvc.drain(), jsvc.drain()
        assert [c.prefill_len for c in out] == [4, 6, 9, 13]
        _assert_completions_equal(ref, out)

    def test_max_seq_truncation(self, yi):
        ref, _, out = _both(yi, _reqs(yi[0], (10,), max_new=50), max_batch=1, max_seq=16)
        assert len(ref[0].tokens) < 50  # hit the cache limit, not max_new
        _assert_completions_equal(ref, out)

    def test_prompt_longer_than_max_seq_raises(self, yi):
        svc = serve_model(yi[3], ServiceConfig(max_batch=1, max_seq=8))
        with pytest.raises(ValueError, match="max_seq"):
            svc.generate(_reqs(yi[0], (9,)))
        with pytest.raises(ValueError, match="exceed max_seq"):
            serve_model(yi[3], ServiceConfig(max_seq=8, buckets=(4, 16)))

    def test_sync_drain_records_telemetry(self, yi):
        svc = serve_model(yi[3], ServiceConfig(max_batch=2, max_seq=48))
        assert svc.drain() == []
        for r in _reqs(yi[0], (4, 7), max_new=3):
            svc.submit(r)
        svc.drain()
        t = svc.stats["telemetry"]
        assert t["submitted"] == 2 and t["completed"] == 2
        assert t["queue_wait_s"]["count"] == 2
        assert t["prefill_s"]["count"] == 2
        assert t["decode_step_s"]["count"] >= 2
        assert t["e2e_s"]["max"] >= t["e2e_s"]["p50"] > 0

    def test_plan_capability_mismatch(self, yi):
        svc = serve_model(yi[3], ServiceConfig(max_batch=1))
        with pytest.raises(NotImplementedError, match="predict"):
            svc.predict(np.zeros((1, 4)))
        with pytest.raises(ValueError, match="decod"):
            serve_model(yi[3], ServiceConfig(plan="batched"))
        with pytest.raises(ValueError, match="decod"):
            serve_fleet(yi[3], ServiceConfig(plan="streaming"))


# ----------------------------------------------------- structural padding
class TestStructuralCachePadding:
    def test_pads_to_template_and_preserves_prefix(self, yi):
        cfg, tm = yi[0], yi[3]
        prompt = RNG.integers(0, cfg.vocab_size, 6).astype(np.int32)
        _, cache = tm.prefill({"tokens": torch.from_numpy(prompt[None]).long()})
        template = {k: torch.empty(s, device="meta") for k, s in tm.cache_shapes(1, 32).items()}
        padded = pad_cache_like(cache, template)
        for name, c in cache.items():
            assert padded[name].shape == template[name].shape
            assert torch.equal(padded[name][:, :, :6], c)
            assert not padded[name][:, :, 6:].any()

    def test_rejects_oversized_leaves(self, yi):
        cfg, tm = yi[0], yi[3]
        prompt = RNG.integers(0, cfg.vocab_size, 6).astype(np.int32)
        _, cache = tm.prefill({"tokens": torch.from_numpy(prompt[None]).long()})
        with pytest.raises(ValueError, match="cannot grow"):
            pad_cache_like(cache, tm.cache_shapes(1, 4))


# ----------------------------------------------------------- async engine
class TestAsyncDecode:
    def test_token_identical_to_sync_drain(self, yi):
        """Deterministic arrivals (everything queued before the loop
        runs): the engine drives the same DecodeSession schedule as
        drain(), and both equal the reference's."""
        cfg, jm, params, tm = yi
        reqs = _reqs(cfg, (4, 11, 7, 16, 5))
        ref = jrt.serve_model(jm, params, jrt.ServiceConfig(max_batch=2, max_seq=48)) \
            .generate(_as_ref(reqs))
        svc = serve_model(tm, ServiceConfig(max_batch=2, max_seq=48))
        svc.start(run=False)
        futs = [svc.submit(r) for r in reqs]
        svc.drain_and_stop()
        _assert_completions_equal(ref, [f.result(timeout=60) for f in futs])

    def test_mid_flight_slot_admission(self, yi):
        """A request submitted after start() lands in a freed slot while
        another is mid-generation, and decodes as it would alone."""
        cfg, tm = yi[0], yi[3]
        svc = serve_model(tm, ServiceConfig(max_batch=2, max_seq=64, async_mode=True))
        long_req = _reqs(cfg, (6,), max_new=40)[0]
        f_long = svc.submit(long_req)
        deadline = time.time() + 60
        while svc.plan.stats["fused_steps"] < 2 and time.time() < deadline:
            time.sleep(0.005)
        assert svc.plan.stats["fused_steps"] >= 2, "long request never started"
        late = Request(rid=99, prompt=long_req.prompt.copy(), max_new_tokens=4)
        late_done = svc.submit(late).result(timeout=60)
        long_done = f_long.result(timeout=60)
        svc.drain_and_stop()
        assert long_done.rid == 0 and len(long_done.tokens) == 40
        assert late_done.rid == 99 and len(late_done.tokens) == 4
        solo = serve_model(tm, ServiceConfig(max_batch=1, max_seq=64)).generate([late])
        np.testing.assert_array_equal(late_done.tokens, solo[0].tokens)
        assert svc.engine.admitted == 2
        assert svc.stats["mean_occupancy"] > 1.0

    def test_backpressure_rejection_counts(self, yi):
        cfg, tm = yi[0], yi[3]
        svc = serve_model(tm, ServiceConfig(max_batch=1, max_seq=48, max_queue=2))
        eng = svc.start(run=False)
        reqs = _reqs(cfg, (4, 5, 6), max_new=2)
        f1, f2 = svc.submit(reqs[0]), svc.submit(reqs[1])
        with pytest.raises(QueueFull):
            svc.submit(reqs[2])
        assert svc.stats["rejected"] == 1
        assert svc.stats["queued"] == 2
        eng.drain_and_stop()
        assert f1.result(timeout=60).rid == 0 and f2.result(timeout=60).rid == 1
        with pytest.raises(EngineStopped):
            svc.submit(reqs[2])
        assert svc.stats["rejected"] == 2

    def test_drain_and_stop_no_dropped_futures(self, yi):
        cfg, tm = yi[0], yi[3]
        svc = serve_model(tm, ServiceConfig(max_batch=2, max_seq=48, async_mode=True))
        futs = [svc.submit(r) for r in _reqs(cfg, (4, 9, 6, 5), max_new=3)]
        svc.drain_and_stop()
        assert all(f.done() for f in futs)
        assert sorted(f.result().rid for f in futs) == [0, 1, 2, 3]
        assert svc.engine.stopped
        t = svc.stats["telemetry"]
        assert t["completed"] == 4 and t["queue_wait_s"]["count"] == 4
        assert t["e2e_s"]["p95"] > 0

    def test_submit_error_fails_future_only(self, yi):
        cfg, tm = yi[0], yi[3]
        svc = serve_model(tm, ServiceConfig(max_batch=1, max_seq=16, async_mode=True))
        bad = Request(rid=0, prompt=np.arange(99, dtype=np.int32), max_new_tokens=2)
        f_bad, f_good = svc.submit(bad), svc.submit(_reqs(cfg, (4,), max_new=2)[0])
        with pytest.raises(ValueError, match="max_seq"):
            f_bad.result(timeout=60)
        assert len(f_good.result(timeout=60).tokens) == 2
        svc.drain_and_stop()

    def test_sjf_policy_in_engine(self, yi):
        cfg, tm = yi[0], yi[3]
        svc = serve_model(tm, ServiceConfig(max_batch=1, max_seq=48, policy="sjf"))
        svc.start(run=False)
        finished = []
        futs = [svc.submit(r) for r in _reqs(cfg, (15, 4, 9), max_new=3)]
        for f in futs:
            f.add_done_callback(lambda f: finished.append(f.result().prefill_len))
        svc.drain_and_stop()
        assert finished == [4, 9, 15]
        assert svc.engine.admitted == 3

    def test_cancelled_future_is_skipped_and_threads_hammer(self, yi):
        cfg, tm = yi[0], yi[3]
        plan = DecodePlan(tm, ServiceConfig(max_batch=2, max_seq=48))
        eng = AsyncEngine(plan, plan.config)
        reqs = _reqs(cfg, (4, 5, 6, 7, 8, 9), max_new=2)
        f0, f1 = eng.submit(reqs[0]), eng.submit(reqs[1])
        assert f1.cancel()
        results, lock = {}, threading.Lock()

        def client(rs):
            for r in rs:
                c = eng.submit(r).result(timeout=60)
                with lock:
                    results[c.rid] = c

        eng.start()
        threads = [threading.Thread(target=client, args=(reqs[i::2],)) for i in (2, 3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        eng.drain_and_stop()
        assert f0.result().rid == 0 and f1.cancelled()
        assert sorted(results) == [2, 3, 4, 5]
        assert eng.admitted == 5 and eng.stats["state"] == "stopped"


# ------------------------------------------------------------------ fleet
class TestDecodeFleet:
    def test_serve_fleet_matches_single_engine_with_a_restart(self, yi):
        """Two decode engines over ONE shared model give the single
        engine's tokens; one engine crashing at its 3rd request is
        restarted over the same weights, and its work is re-enqueued."""
        cfg, tm = yi[0], yi[3]

        def reqs():
            rng = np.random.default_rng(3)
            return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 6).astype(np.int32),
                            max_new_tokens=4) for i in range(8)]

        sync = serve_model(tm, ServiceConfig(max_batch=2, max_seq=48))
        for q in reqs():
            sync.submit(q)
        ref = {c.rid: c.tokens.tolist() for c in sync.drain()}

        weights = [p.data_ptr() for p in tm.parameters()]
        router = serve_fleet(tm, ServiceConfig(max_batch=2, max_seq=48, router=RouterConfig(
            tenants={"a": TenantConfig(), "b": TenantConfig(weight=2)})), fleet=2)
        plan = router._slots["decode0"].engine.plan
        real, seen = plan._prefill_one, []

        def crash_once(prompt):
            seen.append(1)
            if len(seen) == 3:
                raise _Crash("injected engine crash")
            return real(prompt)

        plan._prefill_one = crash_once
        futs = [router.submit(q, tenant="ab"[i % 2]) for i, q in enumerate(reqs())]
        out = {}
        for f in futs:
            c = f.result(timeout=60)
            out[c.rid] = c.tokens.tolist()
        router.drain_and_stop(timeout=60)
        assert out == ref
        st = router.stats
        assert st["telemetry"]["restarts"] == 1
        assert router._slots["decode0"].engine.plan.model is tm
        assert [p.data_ptr() for p in tm.parameters()] == weights  # nothing re-uploaded
        assert set(router.pools) == {"decode"}

    def test_request_needs_a_decode_pool(self):
        router = Router(RouterConfig())
        router.add_engine("b0", lambda cfg, metrics: _BatchedStub(cfg, metrics), ServiceConfig())
        with pytest.raises(NoEngineAvailable, match="decode Request"):
            router.submit(Request(rid=0, prompt=np.zeros(3, np.int32)))


class _Crash(BaseException):
    """Escapes the engine's per-request Exception handler: kills its loop."""


class _BatchedStub:
    """A plan in the batched pool with nothing to serve."""

    name = "batched"
    device = None

    def __init__(self, config, metrics):
        from repro_torch.runtime import ServiceMetrics

        self.config = config
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        self.tracer = None

    def bind_tracer(self, tracer):
        self.tracer = tracer
