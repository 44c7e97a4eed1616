"""The continual-learning tier on the port (``repro_torch.runtime.continual``)
against the JAX package's on the same feedback stream, plus the
reference's own tests (``tests/test_continual.py``) as tests of the port.

Every fitted network here is the reference's: it is fitted by the JAX
package and its state carried across with ``network_state_from_flat``, so
both packages start from the same bits.  The JAX side runs as its own tests
run it on the CPU; the port runs its kernels' plain versions
(``device="cpu"``)."""
import functools
import os

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
from repro.precision import PrecisionPolicy as JPrecisionPolicy
from repro.runtime import ContinualConfig as JContinualConfig
from repro.runtime import Feedback as JFeedback
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
from repro_torch.precision import PrecisionPolicy
from repro_torch.runtime import (
    ContinualConfig,
    ContinualPlan,
    DriftDetected,
    DriftWindow,
    Feedback,
    ServiceConfig,
)
from repro_torch.runtime.epoch_engine import forward_stack

N_CLASSES = 4
# The same functions on the same state: f32 sums in another order only.
RTOL, ATOL = 1e-5, 1e-6


def _easy_ds(seed=0):
    """Separable 4-class data: the fitted base reaches accuracy 1.0, so a
    label flip is an unambiguous drift signal."""
    ds = mnist_like(
        n_train=256, n_test=64, n_features=32, seed=seed,
        n_classes=N_CLASSES, prototypes_per_class=2, noise=0.05,
        informative_fraction=1.0,
    )
    x, layout = complementary_code(ds.x_train)
    return np.asarray(x, np.float32), np.asarray(ds.y_train), layout


def _jflat(layer_states):
    tree = {"layers": {str(i): s for i, s in enumerate(layer_states)}}
    return {
        path_key(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


# (name, [(kind, args)]) of each stack; the layouts are (n_hcu, n_mcu).
STACKS = {
    # tests/test_continual.py:_fitted
    "two": [("plastic", (None, (4, 8), dict(fan_in=16, lam=0.05, gain=4.0))),
            ("dense", ((4, 8), None, dict(lam=0.05)))],
    # tests/test_deep_networks.py:build_deep's three hidden layers
    "deep": [("plastic", (None, (4, 4), dict(fan_in=8, lam=0.05, init_jitter=1.0, gain=4.0))),
             ("plastic", ((4, 4), (3, 4), dict(fan_in=3, lam=0.05, init_jitter=1.0, gain=4.0))),
             ("plastic", ((3, 4), (2, 4), dict(fan_in=2, lam=0.05, init_jitter=1.0, gain=4.0))),
             ("dense", ((2, 4), None, dict(lam=0.05)))],
}


def _build(pkg, stack, layout, seed):
    net_cls, plastic, dense, unit, onehot = pkg
    net = net_cls(seed=seed)
    for kind, (pre, post, kw) in STACKS[stack]:
        pre = unit(layout.n_hcu, layout.n_mcu) if pre is None else unit(*pre)
        if kind == "plastic":
            net.add(plastic(pre, unit(*post), **kw))
        else:
            net.add(dense(pre, onehot(N_CLASSES), **kw))
    return net


JAX_PKG = (JNetwork, JPlastic, JDense, JUnitLayout, jonehot)
PORT_PKG = (Network, StructuralPlasticityLayer, DenseLayer, UnitLayout, onehot_layout)


@functools.lru_cache(maxsize=None)
def _jax_fit(seed=0, stack="two", state_tier=False):
    """The reference's fitted network (``_fitted``; 4 + 4 epochs of 64
    rows): its NetworkState (immutable arrays) and the same as flat
    arrays."""
    jc = _jax_compiled(seed, stack, state_tier)
    xs, ys, _ = _easy_ds(seed)
    jc.fit((xs, ys), epochs_hidden=4, epochs_readout=4, batch_size=64)
    return jc.state, _jflat(jc.state.layers)


def _jax_compiled(seed, stack, state_tier):
    _, _, layout = _easy_ds(seed)
    precision = JPrecisionPolicy.named("fp32", state_format="bf16") if state_tier else None
    return _build(JAX_PKG, stack, layout, seed).compile(JExecutionConfig(precision=precision))


def _jax_fitted(seed=0, stack="two", state_tier=False):
    """A fresh JAX compiled network on the fitted state."""
    jc = _jax_compiled(seed, stack, state_tier)
    jc.state = _jax_fit(seed, stack, state_tier)[0]
    xs, ys, _ = _easy_ds(seed)
    return jc, xs, ys


def _fitted(seed=0, stack="two", state_tier=False):
    """``tests/test_continual.py:_fitted`` on the port: the same network,
    compiled on the CPU, on the JAX package's fitted state."""
    xs, ys, layout = _easy_ds(seed)
    precision = PrecisionPolicy.named("fp32", state_format="bf16") if state_tier else None
    compiled = _build(PORT_PKG, stack, layout, seed).compile(
        ExecutionConfig(device="cpu", precision=precision))
    compiled.state = network_state_from_flat(_jax_fit(seed, stack, state_tier)[1], compiled.layers)
    return compiled, xs, ys


def _cc(cls=ContinualConfig, **kw):
    base = dict(
        update_batch=4, update_budget=16, merge_every=2, drift_window=16,
        drift_min_samples=8, drift_threshold=0.4, merge_strategy="replace",
    )
    base.update(kw)
    return cls(**base)


def _np(t):
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t, np.float32) if str(getattr(t, "dtype", "")) == "bfloat16" else np.asarray(t)


def _leaves_equal(a, b):
    """Two port LayerStates (or parts) equal bit for bit."""
    la = [x for x in (a if isinstance(a, tuple) else (a,)) if x is not None]
    lb = [x for x in (b if isinstance(b, tuple) else (b,)) if x is not None]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, tuple):
            _leaves_equal(x, y)
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def _offline_adapter(compiled, xs_rows, ys_rows, li, update_batch, start_state=None):
    """Replay the online update path offline: same update, same micro-batch
    grouping, starting from a clone of ``start_state`` (default: the live
    base).  Partial tail batches are dropped, as the plan drops them."""
    layer = compiled.layers[li]
    prefix = forward_stack(compiled.layers[:li]) if li > 0 else None
    state = (compiled.state.layers[li] if start_state is None else start_state).clone()
    n_full = (len(xs_rows) // update_batch) * update_batch
    for i in range(0, n_full, update_batch):
        xd = torch.from_numpy(np.stack(xs_rows[i:i + update_batch]))
        yd = torch.tensor(ys_rows[i:i + update_batch], dtype=torch.int32)
        xk = xd if prefix is None else prefix(tuple(compiled.state.layers[:li]), xd)
        if isinstance(layer, DenseLayer):
            state = layer.train_batch(state, xk, yd)[0]
        else:
            state = layer.train_batch(state, xk)[0]
    return state


# ---------------------------------------------------------------- parity
def _stream(xs, ys, n_clean=48, n_flip=24, n_after=24, infer_every=4):
    """Feedback from two alternating tenants: clean rows, a burst of
    flipped labels (y + 1 mod N), clean rows again; one plain row for
    inference after every ``infer_every``-th feedback row."""
    items = []
    flipped = (ys + 1) % N_CLASSES
    labels = np.concatenate([ys[:n_clean], flipped[n_clean:n_clean + n_flip],
                             ys[n_clean + n_flip:n_clean + n_flip + n_after]])
    for k, y in enumerate(labels):
        items.append(("fb", k, int(y), ("t0", "t1")[k % 2]))
        if (k + 1) % infer_every == 0:
            items.append(("x", 128 + k, None, None))
    return items


def _log_atol(jax_state):
    """The absolute floor of w and b: each is a sum of up to three f32 logs
    of traces (floored at EPS = 1e-8, so |log c| <= 18.5), and each log
    rounds to half an ulp of its magnitude; traces within RTOL/ATOL move
    the logs by about RTOL more.  So w and b are held to ATOL plus three
    ulps of the largest log, on top of RTOL."""
    logs = [np.abs(np.log(np.maximum(_np(t), 1e-8))).max() for t in jax_state.marginals]
    return ATOL + 3 * float(np.spacing(np.float32(max(logs))))


def _assert_state_close(port_state, jax_state, what):
    names = ("ci", "cj", "cij")
    for n, p, j in zip(names, port_state.marginals, jax_state.marginals):
        assert str(p.dtype).replace("torch.", "") == str(j.dtype), f"{what} {n} dtype"
        np.testing.assert_allclose(_np(p), _np(j), rtol=RTOL, atol=ATOL, err_msg=f"{what} {n}")
    atol = _log_atol(jax_state)
    np.testing.assert_allclose(_np(port_state.w), _np(jax_state.w), rtol=RTOL, atol=atol,
                               err_msg=f"{what} w")
    np.testing.assert_allclose(_np(port_state.b), _np(jax_state.b), rtol=RTOL, atol=atol,
                               err_msg=f"{what} b")
    if jax_state.plast is not None:
        np.testing.assert_array_equal(_np(port_state.plast.hcu_mask),
                                      _np(jax_state.plast.hcu_mask), err_msg=f"{what} mask")
    assert int(port_state.step) == int(jax_state.step) == port_state.host_step, what


def _drive_both(stack, layer, strategy, state_tier=False, check_states=True, **cc):
    """The same stream through both packages' sync drains, one item a
    drain; acks compared item by item and the states after every update,
    merge and rollback.  Returns the acks."""
    port, xs, ys = _fitted(stack=stack, state_tier=state_tier)
    jc, _, _ = _jax_fitted(stack=stack, state_tier=state_tier)
    kw = dict(layer=layer, merge_strategy=strategy, **cc)
    psvc = port.serve(ServiceConfig(continual=_cc(**kw)))
    jsvc = jc.serve(JServiceConfig(continual=_cc(JContinualConfig, **kw)))
    li = psvc.plan._li
    acks = []
    for kind, k, y, tenant in _stream(xs, ys):
        if kind == "fb":
            psvc.submit(Feedback(xs[k], y, tenant=tenant))
            jsvc.submit(JFeedback(xs[k], y, tenant=tenant))
        else:
            psvc.submit(xs[k])
            jsvc.submit(xs[k])
        (p_out,), (j_out,) = psvc.drain(), jsvc.drain()
        if kind == "x":
            np.testing.assert_allclose(_np(p_out), _np(j_out), rtol=RTOL, atol=ATOL)
            continue
        assert {k: v for k, v in p_out.items() if k != "confidence"} == \
            {k: v for k, v in j_out.items() if k != "confidence"}
        assert p_out["confidence"] == pytest.approx(j_out["confidence"], rel=1e-5)
        acks.append(p_out)
        if check_states and (p_out["applied"] or p_out["merged"] or p_out["rolled_back"]):
            _assert_state_close(port.state.layers[li], jc.state.layers[li], f"base at {k}")
            for t in sorted(jsvc.plan._adapters):
                _assert_state_close(psvc.plan._adapters[t].state,
                                    jsvc.plan._adapters[t].state, f"adapter {t} at {k}")
    assert psvc.plan._base_weight == jsvc.plan._base_weight
    return acks, port, jc, psvc, jsvc


class TestContinualParity:
    """The port's tier equals the reference's on one feedback stream: acks
    item by item, and base and adapter states after every update, merge and
    rollback, for each merge strategy at the hidden layer (``layer=0``), at
    the BCPNN readout (``layer=-1``, through the frozen prefix) and at the
    middle layer of a three-hidden-layer stack."""

    @pytest.mark.parametrize("strategy", ["trace", "mean", "replace"])
    @pytest.mark.parametrize("layer", [0, -1], ids=["hidden", "readout"])
    def test_same_acks_and_states(self, strategy, layer):
        acks, *_ = _drive_both("two", layer, strategy)
        assert any(a["applied"] for a in acks) and any(a["merged"] for a in acks)
        assert any(a["rolled_back"] for a in acks)

    @pytest.mark.parametrize("strategy", ["trace", "replace"])
    def test_middle_layer_of_a_deep_stack(self, strategy):
        acks, port, jc, psvc, _ = _drive_both("deep", 1, strategy)
        assert psvc.plan._prefix is not None and psvc.plan._li == 1
        assert any(a["merged"] for a in acks)
        # Layers other than the adapted one never change.
        for i in (0, 2, 3):
            _assert_state_close(port.state.layers[i], jc.state.layers[i], f"layer {i}")

    def test_bf16_state_traces_after_a_merge(self):
        """The reference's weighted average promotes bf16 traces to f32
        (``jnp.tensordot`` of f32 weights), so after a merge the base's
        traces are f32 while the layer's policy stores bf16; the next
        update of an adapter forked from it writes bf16 again."""
        port, xs, ys = _fitted(state_tier=True)
        jc, _, _ = _jax_fitted(state_tier=True)
        psvc = port.serve(ServiceConfig(continual=_cc(layer=0, merge_strategy="trace")))
        jsvc = jc.serve(JServiceConfig(continual=_cc(JContinualConfig, layer=0,
                                                     merge_strategy="trace")))
        assert port.state.layers[0].marginals.cij.dtype == torch.bfloat16
        merged = False
        k = 0
        while not merged:
            p_ack = psvc.plan.learn(Feedback(xs[k], int(ys[k])))
            j_ack = jsvc.plan.learn(JFeedback(xs[k], int(ys[k])))
            assert p_ack["merged"] == j_ack["merged"] and p_ack["applied"] == j_ack["applied"]
            merged = p_ack["merged"]
            k += 1
        for p, j in zip(port.state.layers[0].marginals, jc.state.layers[0].marginals):
            assert str(j.dtype) == "float32" and p.dtype == torch.float32
            np.testing.assert_allclose(_np(p), _np(j), rtol=2.0**-7, atol=ATOL)
        applied = False
        while not applied:
            applied = psvc.plan.learn(Feedback(xs[k], int(ys[k])))["applied"]
            jsvc.plan.learn(JFeedback(xs[k], int(ys[k])))
            k += 1
        p_ad = psvc.plan._adapters["default"].state
        j_ad = jsvc.plan._adapters["default"].state
        assert p_ad.marginals.cij.dtype == torch.bfloat16 and str(j_ad.marginals.cij.dtype) == "bfloat16"


# ----------------------------------------------------------- drift window
class TestDriftWindow:
    def test_baseline_freeze_and_drift(self):
        dw = DriftWindow(window=8, min_samples=4, threshold=0.3)
        for _ in range(8):
            dw.observe(True, 0.9)
        assert not dw.drifted()  # no baseline yet
        dw.freeze_baseline()
        assert dw.baseline_samples == 8
        assert dw.samples == 0  # freeze resets the current window
        for _ in range(4):
            dw.observe(False, 0.5)
        assert dw.drifted()
        snap = dw.snapshot()
        assert snap["drifted"] and snap["baseline_accuracy"] == 1.0
        assert snap["accuracy"] == 0.0 and snap["samples"] == 4

    def test_min_samples_gates_drift(self):
        dw = DriftWindow(window=8, min_samples=4, threshold=0.1)
        for _ in range(4):
            dw.observe(True, 0.9)
        dw.freeze_baseline()
        dw.observe(False, 0.5)  # 1 < min_samples
        assert not dw.drifted()

    def test_validation(self):
        with pytest.raises(ValueError):
            DriftWindow(window=0)
        with pytest.raises(ValueError):
            DriftWindow(window=4, min_samples=8)
        with pytest.raises(ValueError):
            DriftWindow(threshold=0.0)


# ----------------------------------------------------------------- config
class TestContinualConfig:
    def test_validation(self):
        with pytest.raises(ValueError, match="update_batch"):
            ContinualConfig(update_batch=0)
        with pytest.raises(ValueError, match="drift_min_samples"):
            ContinualConfig(drift_window=8, drift_min_samples=16)
        with pytest.raises(ValueError, match="merge_strategy"):
            ContinualConfig(merge_strategy="nope")

    def test_layer_out_of_range_at_bind(self):
        compiled, xs, ys = _fitted()
        with pytest.raises(ValueError, match="out of range"):
            compiled.serve(ServiceConfig(continual=_cc(layer=5)))

    def test_plan_name_conflict_rejected(self):
        with pytest.raises(ValueError, match="plan"):
            ServiceConfig(plan="batched", continual=_cc())


# ----------------------------------------- disabled => bit-identical serving
class TestDisabledBitIdentical:
    def test_default_serve_unchanged(self):
        compiled, xs, _ = _fitted()
        svc = compiled.serve(ServiceConfig())
        assert svc.plan.name == "batched"
        assert torch.equal(svc.predict(xs[:16]), compiled.predict(xs[:16]))

    def test_frozen_inference_identical_before_first_merge(self):
        # Until a merge adopts, learning happens only in adapters: the
        # served base scores stay bit-identical to a frozen twin.
        compiled_a, xs, ys = _fitted(seed=0)
        compiled_b, _, _ = _fitted(seed=0)
        svc = compiled_a.serve(ServiceConfig(continual=_cc(merge_every=10_000)))
        for k in range(8):
            svc.plan.learn(Feedback(xs[k], int(ys[k])))
        assert torch.equal(svc.predict(xs[:16]), compiled_b.predict(xs[:16]))


# ------------------------------------------------- online/offline parity
class TestOnlineOfflineParity:
    def test_adapter_updates_bit_match_offline_replay(self):
        compiled, xs, ys = _fitted()
        svc = compiled.serve(ServiceConfig(continual=_cc(merge_every=10_000)))
        plan = svc.plan
        rows_x, rows_y = [], []
        for k in range(13):  # 3 full micro-batches + 1 dropped tail sample
            svc.plan.learn(Feedback(xs[k], int(ys[k])))
            rows_x.append(xs[k])
            rows_y.append(int(ys[k]))
        expect = _offline_adapter(compiled, rows_x, rows_y, plan._li, plan.cc.update_batch)
        _leaves_equal(plan._adapters["default"].state, expect)

    def test_partial_buffers_dropped_on_close(self):
        compiled, xs, ys = _fitted()
        svc = compiled.serve(ServiceConfig(continual=_cc()))
        svc.plan.learn(Feedback(xs[0], int(ys[0])))  # 1 of 4: stays buffered
        assert len(svc.plan._adapters["default"].buf_x) == 1
        svc.close()
        assert svc.plan._adapters["default"].buf_x == []


# --------------------------------------------------------- tenant isolation
class TestTenantIsolation:
    def test_one_tenant_learning_never_touches_another(self):
        compiled, xs, ys = _fitted()
        svc = compiled.serve(ServiceConfig(continual=_cc(merge_every=10_000)))
        plan = svc.plan
        base = compiled.state.layers[plan._li]
        plan.learn(Feedback(xs[0], int(ys[0]), tenant="b"))  # buffered only
        for k in range(8):  # two applied micro-batches for tenant a
            plan.learn(Feedback(xs[k], int(ys[k]), tenant="a"))
        assert plan._adapters["a"].applied == 2
        # a's adapter moved; b's is still a bit-exact fork of the base.
        assert int(plan._adapters["a"].state.step) > int(base.step)
        assert plan._adapters["a"].state.host_step == base.host_step + 2
        _leaves_equal(plan._adapters["b"].state, base)
        # Pre-merge, the shared base object itself is untouched.
        assert compiled.state.layers[plan._li] is base


# ------------------------------------------------------- merge strategies
class TestMergeStrategies:
    def _drive_to_first_merge(self, strategy):
        compiled, xs, ys = _fitted()
        svc = compiled.serve(ServiceConfig(continual=_cc(merge_strategy=strategy)))
        plan = svc.plan
        base0 = compiled.state.layers[plan._li]
        w0 = plan._base_weight
        rows_x, rows_y = [], []
        merged = False
        k = 0
        while not merged:
            ack = plan.learn(Feedback(xs[k], int(ys[k])))
            rows_x.append(xs[k])
            rows_y.append(int(ys[k]))
            merged = ack["merged"]
            k += 1
        adapter = _offline_adapter(compiled, rows_x, rows_y, plan._li, plan.cc.update_batch,
                                   start_state=base0)
        return plan, compiled, base0, w0, adapter

    def test_replace_single_tenant_is_bit_exact_adoption(self):
        plan, compiled, _, _, adapter = self._drive_to_first_merge("replace")
        _leaves_equal(compiled.state.layers[plan._li].marginals, adapter.marginals)
        assert torch.equal(compiled.state.layers[plan._li].w, adapter.w)

    @pytest.mark.parametrize("strategy", ["trace", "mean"])
    def test_weighted_marginal_average(self, strategy):
        plan, compiled, base0, w0, adapter = self._drive_to_first_merge(strategy)
        n_applied = plan.cc.merge_every  # one tenant, merge_every updates
        if strategy == "trace":
            wb, wa = max(w0, 1.0), float(n_applied)
        else:
            wb, wa = 1.0, 1.0
        merged = compiled.state.layers[plan._li]
        for got, b, a in zip(merged.marginals, base0.marginals, adapter.marginals):
            want = (wb * b.numpy() + wa * a.numpy()) / (wb + wa)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
        # The step counter and its host mirror both advance by the updates.
        assert int(merged.step) == merged.host_step == base0.host_step + n_applied

    def test_adapters_refork_from_merged_base(self):
        plan, compiled, _, _, _ = self._drive_to_first_merge("trace")
        ad = plan._adapters["default"]
        assert ad.applied == 0
        _leaves_equal(ad.state, compiled.state.layers[plan._li])
        assert ad.state.w is not compiled.state.layers[plan._li].w  # a private copy

    def test_update_budget_sheds_excess_micro_batches(self):
        compiled, xs, ys = _fitted()
        svc = compiled.serve(ServiceConfig(continual=_cc(update_budget=1, merge_every=10_000)))
        plan = svc.plan
        acks = [plan.learn(Feedback(xs[k], int(ys[k]))) for k in range(8)]
        assert sum(a["applied"] for a in acks) == 1
        assert sum(a["shed"] for a in acks) == 1
        assert plan.metrics.updates_shed.value == 1


# --------------------------------------------------- adaptation under shift
class TestAdaptationUnderShift:
    def test_merges_recover_accuracy_on_shifted_labels(self):
        # Frozen serving scores 0 on flipped labels; with the continual
        # tier (rollback off: the shift is the new truth) merges adapt the
        # base and the prequential window recovers.
        compiled, xs, ys = _fitted()
        svc = compiled.serve(ServiceConfig(continual=_cc(
            merge_strategy="replace", rollback=False,
            drift_threshold=10.0,  # detection off: pure adaptation
        )))
        plan = svc.plan
        flipped = (ys + 1) % N_CLASSES
        hits = [
            plan.learn(Feedback(xs[k % 256], int(flipped[k % 256])))["correct"]
            for k in range(96)
        ]
        early, late = np.mean(hits[:16]), np.mean(hits[-16:])
        assert early < 0.5 and late > 0.8, (early, late)
        assert plan.stats["merges"] > 0


# ------------------------------------------- drift -> snapshot -> rollback
class TestDriftRollback:
    def test_drift_snapshot_rollback_all_futures_resolve(self, tmp_path):
        compiled, xs, ys = _fitted()
        snap_dir = str(tmp_path / "snaps")
        svc = compiled.serve(ServiceConfig(
            async_mode=True, continual=_cc(snapshot_dir=snap_dir, snapshot_retain=3)))
        flipped = (ys + 1) % N_CLASSES
        futures = []
        for k in range(32):  # clean: baseline freezes, merges confirm
            futures.append(svc.submit(Feedback(xs[k], int(ys[k]))))
        for k in range(16):  # injected label shift
            futures.append(svc.submit(Feedback(xs[k], int(flipped[k]))))
        for k in range(32):  # clean again: recovery
            futures.append(svc.submit(Feedback(xs[32 + k], int(ys[32 + k]))))
            futures.append(svc.submit(xs[32 + k]))  # interleaved inference
        acks = [f.result(timeout=60) for f in futures]
        svc.drain_and_stop()
        # EVERY future resolved, across the rollback.
        assert len(acks) == 32 + 16 + 64
        learn_acks = [a for a in acks if isinstance(a, dict)]
        assert len(learn_acks) == 80
        rows = [a for a in acks if not isinstance(a, dict)]
        assert all(isinstance(r, np.ndarray) and r.shape == (N_CLASSES,) for r in rows)
        assert any(a["rolled_back"] for a in learn_acks)
        snap = svc.stats["telemetry"]
        assert snap["drift_events"] >= 1
        assert snap["rollbacks"] >= 1
        assert snap["merges"] >= 2
        # Snapshots were written through the checkpoint manifest, bounded
        # by retain.
        ckpts = sorted(os.listdir(snap_dir))
        assert 1 <= len(ckpts) <= 3
        # The stream ended on clean traffic: the window measured healthy
        # again after the rollback.
        assert snap["drift"]["accuracy"] >= 0.8

    def test_rollback_restores_last_good_bit_exact(self):
        compiled, xs, ys = _fitted()
        svc = compiled.serve(ServiceConfig(continual=_cc()))
        plan = svc.plan
        flipped = (ys + 1) % N_CLASSES
        for k in range(32):
            plan.learn(Feedback(xs[k], int(ys[k])))
        last_good_base = plan._last_good[0]
        rolled = False
        k = 0
        while not rolled and k < 64:
            rolled = plan.learn(Feedback(xs[k % 256], int(flipped[k % 256])))["rolled_back"]
            k += 1
        assert rolled
        # Adoption republished the exact last-good object, and every
        # adapter re-forked from it.
        assert compiled.state.layers[plan._li] is last_good_base
        _leaves_equal(plan._adapters["default"].state, last_good_base)
        assert plan.metrics.rollbacks.value == 1

    def test_rollback_disabled_only_counts(self):
        compiled, xs, ys = _fitted()
        svc = compiled.serve(ServiceConfig(continual=_cc(rollback=False)))
        plan = svc.plan
        flipped = (ys + 1) % N_CLASSES
        for k in range(32):
            plan.learn(Feedback(xs[k], int(ys[k])))
        for k in range(24):
            ack = plan.learn(Feedback(xs[k % 256], int(flipped[k % 256])))
            assert not ack["rolled_back"]
        assert plan.metrics.drift_events.value >= 1
        assert plan.metrics.rollbacks.value == 0


# ------------------------------------------------- the interleaved lifecycle
class TestStrictMode:
    """The reference runs this lifecycle under its strict mode (the
    recompile sentinel over the tier's jitted cells), which the port does
    not have: ``strict`` is refused by name, and the same interleaved
    lifecycle runs with an exact count of forwards and updates instead."""

    def test_full_lifecycle_strict_clean(self):
        with pytest.raises(TypeError, match="strict"):
            ServiceConfig(strict=True, continual=_cc())
        compiled, xs, ys = _fitted()
        svc = compiled.serve(ServiceConfig(continual=_cc()))
        plan = svc.plan
        calls = {"view": 0, "update": 0}
        view, train = plan._view_fwd, plan._layer.train_batch

        def counted_view(*a):
            calls["view"] += 1
            return view(*a)

        def counted_train(*a):
            calls["update"] += 1
            return train(*a)

        plan._view_fwd, plan._layer.train_batch = counted_view, counted_train
        acks = []
        for k in range(24):  # updates + merges + interleaved inference
            acks.append(plan.learn(Feedback(xs[k], int(ys[k]))))
            if k % 3 == 0:
                assert tuple(plan.infer(xs[k]).shape) == (N_CLASSES,)
        assert calls["view"] == 24
        assert calls["update"] == sum(a["applied"] for a in acks) == 6
        assert sum(a["merged"] for a in acks) == 3


# ------------------------------------- streaming adoption store invalidation
class TestStreamingAdoptionInvalidation:
    def test_adoption_drops_cached_levels_above_and_recompute_is_exact(self):
        from repro_torch.runtime.activations import ActivationStore

        xs, ys, layout = _easy_ds()
        net = Network(seed=0).add(
            StructuralPlasticityLayer(layout, UnitLayout(4, 8), fan_in=16, lam=0.05, gain=4.0)
        ).add(
            StructuralPlasticityLayer(UnitLayout(4, 8), UnitLayout(4, 4), fan_in=16, lam=0.05,
                                      gain=4.0)
        ).add(DenseLayer(UnitLayout(4, 4), onehot_layout(N_CLASSES), lam=0.05))
        compiled = net.compile(ExecutionConfig(device="cpu"))
        compiled.fit((xs, ys), epochs_hidden=2, epochs_readout=2, batch_size=64)
        store = compiled.activations
        assert store is not None
        # Populate cached projections above hidden layer 0 for a second
        # dataset (a serving batch) on top of the training set's.
        probe = np.array(xs[:32])
        svc = compiled.serve(ServiceConfig(plan="batched"))
        svc.predict(probe)
        assert any(lvl > 0 for _, lvl in store._entries)
        ev0 = store.stats["evictions"]

        sess = compiled.streaming(layer=0, max_batch=8)
        for row in xs[:16]:
            sess.feed(row)
        sess.close()  # adopts the trained layer-0 state

        # Every cached level above the adopted layer was dropped eagerly,
        # at the adoption itself.
        assert all(lvl <= 0 for _, lvl in store._entries)
        assert store.stats["evictions"] > ev0
        # And the recomputed projection under the NEW states bit-matches a
        # fresh store built from scratch: no stale value survives.
        got = store.level(2, list(compiled.state.layers), probe, chunk=probe.shape[0])
        fresh = ActivationStore(compiled.layers, compiled.device).level(
            2, list(compiled.state.layers), probe, chunk=probe.shape[0]
        )
        assert torch.equal(got, fresh)

    def test_merge_adoption_drops_cached_levels_above(self):
        compiled, xs, ys = _fitted(stack="deep")
        store = compiled.activations
        svc = compiled.serve(ServiceConfig(continual=_cc(layer=1)))
        svc.predict(np.array(xs[:8]))
        assert any(lvl > 1 for _, lvl in store._entries)
        merged, k = False, 0
        while not merged:
            merged = svc.plan.learn(Feedback(xs[k], int(ys[k])))["merged"]
            k += 1
        assert all(lvl <= 1 for _, lvl in store._entries)


# ------------------------------------------------------- service front door
class TestServiceFrontDoor:
    def test_sync_drain_serves_mixed_traffic_in_order(self):
        compiled, xs, ys = _fitted()
        svc = compiled.serve(ServiceConfig(plan="continual", continual=_cc()))
        assert svc.submit(Feedback(xs[0], int(ys[0])))
        assert svc.submit(xs[1])
        assert svc.submit(Feedback(xs[2], int(ys[2])))
        out = svc.drain()
        assert isinstance(out[0], dict) and isinstance(out[2], dict)
        assert tuple(out[1].shape) == (N_CLASSES,)

    def test_continual_config_requires_continual_plan(self):
        compiled, _, _ = _fitted()
        svc = compiled.serve(ServiceConfig(continual=_cc()))
        assert svc.plan.name == "continual" and isinstance(svc.plan, ContinualPlan)
        # plan="continual" alone binds the default ContinualConfig.
        assert compiled.serve(ServiceConfig(plan="continual")).plan.cc == ContinualConfig()


# ------------------------------------------------------------- checkpoints
class TestAdapterCheckpoints:
    def test_snapshot_round_trip(self, tmp_path):
        from repro_torch.checkpoint import latest_checkpoint, load_adapters

        compiled, xs, ys = _fitted()
        snap_dir = str(tmp_path / "snaps")
        svc = compiled.serve(ServiceConfig(continual=_cc(snapshot_dir=snap_dir)))
        plan = svc.plan
        merged = False
        k = 0
        while not merged:
            merged = plan.learn(Feedback(xs[k], int(ys[k])))["merged"]
            k += 1
        _, path = latest_checkpoint(snap_dir)
        template = compiled.state.layers[plan._li]
        adapters = load_adapters(path, template)
        assert sorted(adapters) == ["default"]
        _leaves_equal(adapters["default"], plan._adapters["default"].state)
        assert adapters["default"].host_step == plan._adapters["default"].state.host_step

    def test_unsafe_tenant_name_rejected(self, tmp_path):
        from repro_torch.checkpoint import save_network

        compiled, _, _ = _fitted()
        with pytest.raises(ValueError, match="checkpoint-safe"):
            save_network(
                str(tmp_path), 0, compiled.state,
                adapters={"../evil": compiled.state.layers[-1]},
                adapter_layer=1,
            )


# ------------------------------------------------------------------ router
class TestRouterContinual:
    def _router(self, n_engines=2, **router_kw):
        from repro_torch.runtime import Router, RouterConfig

        def make_factory():
            compiled, xs, ys = _fitted()

            def factory(config, metrics):
                return ContinualPlan(compiled, config, metrics)

            return factory

        router = Router(RouterConfig(routing="round_robin", **router_kw))
        cfg = ServiceConfig(continual=_cc(merge_every=10_000))
        for i in range(n_engines):
            router.add_engine(f"cl{i}", make_factory(), cfg)
        return router

    def test_tenant_affinity_pins_continual_engine(self):
        router = self._router(n_engines=2)
        _, xs, ys = _fitted()
        router.start()
        futs = [
            router.submit(Feedback(xs[k], int(ys[k]), tenant="t1"), tenant="t1", pool="continual")
            for k in range(8)
        ]
        for f in futs:
            assert isinstance(f.result(timeout=60), dict)
        router.drain_and_stop()
        with router._cv:
            tenants_per_engine = [
                slot.engine.plan.stats["tenants"] for slot in router._slots.values()
            ]
        served = [t for t in tenants_per_engine if "t1" in t]
        assert len(served) == 1  # all eight landed on ONE engine
        assert ("continual", "t1") in router._affinity

    def test_shed_on_drift_refuses_with_typed_exception(self):
        router = self._router(n_engines=1)
        _, xs, ys = _fitted()
        router.start()
        # Prime: one served feedback records the affinity pin.
        router.submit(
            Feedback(xs[0], int(ys[0]), tenant="t1"), tenant="t1", pool="continual",
        ).result(timeout=60)
        with router._cv:
            slot = next(iter(router._slots.values()))
            plan = slot.engine.plan
        dw = plan.metrics.drift
        for _ in range(8):
            dw.observe(True, 0.9)
        dw.freeze_baseline()
        with plan._lock:
            plan._drifting = True
        fut = router.submit(
            Feedback(xs[1], int(ys[1]), tenant="t1"), tenant="t1", pool="continual",
        )
        with pytest.raises(DriftDetected):
            fut.result(timeout=60)
        assert router.metrics.tenant("t1").shed_drift.value >= 1
        with plan._lock:
            plan._drifting = False
        # Healthy again: the same tenant is served normally.
        assert isinstance(
            router.submit(
                Feedback(xs[2], int(ys[2]), tenant="t1"), tenant="t1", pool="continual",
            ).result(timeout=60),
            dict,
        )
        router.drain_and_stop()

    def test_shed_on_drift_opt_out(self):
        router = self._router(n_engines=1, shed_on_drift=False)
        _, xs, ys = _fitted()
        router.start()
        with router._cv:
            plan = next(iter(router._slots.values())).engine.plan
        with plan._lock:
            plan._drifting = True
        out = router.submit(
            Feedback(xs[0], int(ys[0]), tenant="t1"), tenant="t1", pool="continual",
        ).result(timeout=60)
        assert isinstance(out, dict)
        router.drain_and_stop()
