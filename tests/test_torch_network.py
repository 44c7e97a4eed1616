"""The port's slice as a whole: Network -> compile -> fit -> predict /
evaluate against the JAX package's ``ExecutionConfig(engine="scan",
use_kernels=True)`` from the same (carried-across) init and seed, the
fused-phase path (f32 and bf16 state) against the JAX package's
``ExecutionConfig(fused_phase=True, ...)``, the reduced datapath's
precision cliff (paper Fig. 3), plus the port's own engine, cache and
device contracts."""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import path_key
from repro.core import DenseLayer as JDense
from repro.core import Network as JNetwork
from repro.core import StructuralPlasticityLayer as JPlastic
from repro.core import UnitLayout as JUnitLayout
from repro.core import onehot_layout as jonehot
from repro.core.compiled import ExecutionConfig as JExecutionConfig
from repro.precision import PrecisionPolicy as JPrecisionPolicy
from repro.data import complementary_code as jcomplementary_code
from repro.data import mnist_like as jmnist_like
from repro_torch.checkpoint import flat_from_network_state, network_state_from_flat
from repro_torch.core import (
    BCPNNLayerSpec,
    DenseLayer,
    ExecutionConfig,
    Network,
    StructuralPlasticityLayer,
    UnitLayout,
    onehot_layout,
)
from repro_torch.data import complementary_code, mnist_like
from repro_torch.precision import PrecisionPolicy, quantize_marginals
from repro_torch.runtime.activations import ActivationStore

FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
HIDDEN = (4, 8)
LAYER_KW = dict(fan_in=6, lam=0.05, gain=4.0, init_jitter=1.0)
FIT_KW = dict(epochs_hidden=2, epochs_readout=2, batch_size=32)


def _jflat(layer_states):
    tree = {"layers": {str(i): s for i, s in enumerate(layer_states)}}
    return {
        path_key(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


@pytest.fixture(scope="module")
def data():
    ds = mnist_like(n_train=256, n_test=100, n_features=12, seed=0)
    x, layout = complementary_code(ds.x_train)
    xt, _ = complementary_code(ds.x_test)
    return ds, x, xt, layout


def _torch_net(seed=0):
    net = Network(seed=seed)
    net.add(StructuralPlasticityLayer(UnitLayout(12, 2), UnitLayout(*HIDDEN), **LAYER_KW))
    net.add(DenseLayer(UnitLayout(*HIDDEN), onehot_layout(10), lam=0.05))
    return net


def _jax_fit(data, config):
    """A JAX fit under ``config``: its initial and final states."""
    ds, x, xt, _ = data
    net = JNetwork(seed=0)
    net.add(JPlastic(JUnitLayout(12, 2), JUnitLayout(*HIDDEN), **LAYER_KW))
    net.add(JDense(JUnitLayout(*HIDDEN), jonehot(10), lam=0.05))
    compiled = net.compile(config)
    init = _jflat(compiled.state.layers)
    compiled.fit((x, ds.y_train), **FIT_KW)
    return dict(
        init=init,
        final=_jflat(compiled.state.layers),
        predict=np.asarray(compiled.predict(xt)),
        accuracy=compiled.evaluate((xt, ds.y_test)),
    )


@pytest.fixture(scope="module")
def jax_run(data):
    """A JAX fit on the Pallas kernel path."""
    return _jax_fit(data, JExecutionConfig(engine="scan", use_kernels=True))


BF16_STATE = dict(fused_phase=True, precision=PrecisionPolicy.named("fp32", state_format="bf16"))


@pytest.fixture(scope="module")
def jax_fused_runs(data):
    """JAX fits on the fused Pallas kernel, with f32 and with bf16 state."""
    return {
        "f32": _jax_fit(data, JExecutionConfig(engine="scan", fused_phase=True)),
        "bf16": _jax_fit(data, JExecutionConfig(
            engine="scan", fused_phase=True,
            precision=JPrecisionPolicy.named("fp32", state_format="bf16"),
        )),
    }


def _fit_from_jax_init(data, jax_run, **config):
    ds, x, _, _ = data
    compiled = _torch_net().compile(ExecutionConfig(device="cpu", **config))
    compiled.state = network_state_from_flat(jax_run["init"], compiled.layers)
    result = compiled.fit((x, ds.y_train), **FIT_KW)
    return compiled, result


def _assert_fit_matches(compiled, run, xt, rtol=FIT_RTOL, atol=FIT_ATOL):
    port = flat_from_network_state(compiled.state)
    assert sorted(port) == sorted(run["final"])
    for k, want in run["final"].items():
        np.testing.assert_allclose(
            port[k], np.asarray(want, np.float32), rtol=rtol, atol=atol, err_msg=k
        )
    np.testing.assert_allclose(compiled.predict(xt).numpy(), run["predict"], rtol=rtol, atol=atol)


def test_data_generators_are_identical():
    ds, jds = mnist_like(n_train=64, n_test=16, seed=3), jmnist_like(n_train=64, n_test=16, seed=3)
    for a, b in ((ds.x_train, jds.x_train), (ds.y_train, jds.y_train), (ds.x_test, jds.x_test)):
        np.testing.assert_array_equal(a, b)
    x, layout = complementary_code(ds.x_train)
    jx, jlayout = jcomplementary_code(jds.x_train)
    np.testing.assert_array_equal(x, jx)
    assert layout.shape == jlayout.shape


def test_fit_and_predict_match_jax(data, jax_run):
    ds, _, xt, _ = data
    compiled, result = _fit_from_jax_init(data, jax_run)
    _assert_fit_matches(compiled, jax_run, xt)
    assert compiled.evaluate((xt, ds.y_test)) == jax_run["accuracy"]
    phases = [h["phase"] for h in result.history]
    assert phases == ["hidden0", "hidden0", "project", "readout", "readout"]
    assert all(h["seconds"] >= h["host_s"] >= 0.0 for h in result.history)


def _states_equal(a, b):
    fa, fb = flat_from_network_state(a.state), flat_from_network_state(b.state)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_scan_plan_equals_batch_plan(data, jax_run):
    scan, _ = _fit_from_jax_init(data, jax_run, engine="scan")
    batch, _ = _fit_from_jax_init(data, jax_run, engine="batch")
    _states_equal(scan, batch)


@pytest.mark.parametrize("engine", ["scan", "batch"])
def test_cached_and_uncached_activations_agree(data, jax_run, engine):
    cached, _ = _fit_from_jax_init(data, jax_run, engine=engine)
    fused, result = _fit_from_jax_init(data, jax_run, engine=engine, cache_activations=False)
    _states_equal(cached, fused)
    assert "project" not in [h["phase"] for h in result.history]
    xt = data[2]
    np.testing.assert_array_equal(cached.predict(xt).numpy(), fused.predict(xt).numpy())


def test_donate_reuses_the_epoch_buffer(data, jax_run):
    donating, _ = _fit_from_jax_init(data, jax_run, donate=True)
    fresh, _ = _fit_from_jax_init(data, jax_run, donate=False)
    _states_equal(donating, fresh)
    assert set(donating.plan._buffers) == {"x", "y"} and not fresh.plan._buffers


def test_store_spills_and_reuses_levels(data):
    ds, x, xt, _ = data
    net = _torch_net().compile(ExecutionConfig(device="cpu"))
    net.fit((x, ds.y_train), **FIT_KW)
    states = list(net.state.layers)
    tiny = ActivationStore(net.layers, torch.device("cpu"), budget_bytes=1)
    roomy = ActivationStore(net.layers, torch.device("cpu"))
    h_tiny = tiny.level(1, states, x, chunk=32)
    h_roomy = roomy.level(1, states, x, chunk=32)
    assert tiny.resident(1, x) == "host" and roomy.resident(1, x) == "device"
    torch.testing.assert_close(h_tiny, h_roomy, rtol=0, atol=0)
    assert roomy.level(1, states, x, chunk=32) is h_roomy and roomy.stats["hits"] == 1
    # A new state object for layer 0 invalidates the level above it.
    states[0] = states[0]._replace()
    roomy.level(1, states, x, chunk=32)
    assert roomy.stats["evictions"] == 1 and roomy.stats["projections"] == 2
    # The ragged tail is padded to a full chunk: any chunk gives the same rows.
    torch.testing.assert_close(roomy.level(1, states, xt, chunk=32)[:64],
                               ActivationStore(net.layers, "cpu").level(1, states, xt[:64], chunk=64))


def test_partial_fit_reports_the_dropped_tail(data):
    ds, x, _, _ = data
    net = _torch_net().compile(ExecutionConfig(device="cpu"))
    result = net.partial_fit((x[:70], ds.y_train[:70]), batch_size=32, readout="bcpnn")
    assert result.history[0] == {"phase": "ragged_tail_dropped", "samples": 6}
    assert net.state.layers[0].host_step == 2 and int(net.state.layers[0].step) == 2


def test_default_device_needs_a_hopper_card(data):
    """compile() with the default config runs on the card or raises: it
    never carries on quietly on the CPU."""
    if torch.cuda.is_available() and torch.cuda.get_device_capability() >= (9, 0):
        assert _torch_net().compile().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device"):
        _torch_net().compile()
    with pytest.raises(RuntimeError):
        _torch_net().compile(ExecutionConfig(device="cuda:0"))


@pytest.mark.parametrize("engine", ["scan", "batch"])
def test_fused_fit_matches_jax(data, jax_fused_runs, engine):
    ds, _, xt, _ = data
    run = jax_fused_runs["f32"]
    compiled, _ = _fit_from_jax_init(data, run, engine=engine, fused_phase=True)
    assert compiled.layers[0].spec.fused_phase and not compiled.layers[1].spec.fused_phase
    _assert_fit_matches(compiled, run, xt)
    assert compiled.evaluate((xt, ds.y_test)) == run["accuracy"]


def test_fused_fit_matches_unfused(data, jax_run):
    """Port fused against port unfused, from one init: the same sums in
    other orders, so equal to f32 reassociation error."""
    xt = data[2]
    fused, _ = _fit_from_jax_init(data, jax_run, fused_phase=True)
    unfused, _ = _fit_from_jax_init(data, jax_run)
    fa, fb = flat_from_network_state(fused.state), flat_from_network_state(unfused.state)
    for k in fa:
        np.testing.assert_allclose(fa[k], fb[k], rtol=FIT_RTOL, atol=FIT_ATOL, err_msg=k)
    np.testing.assert_allclose(
        fused.predict(xt).numpy(), unfused.predict(xt).numpy(), rtol=FIT_RTOL, atol=FIT_ATOL
    )


# bf16 traces: the two packages round f32 sums taken in different orders, so
# a trace next to a rounding boundary may land one bf16 ulp (2^-8 relative)
# away; w and bias then move by ~2^-7 at that element, which the readout's
# softmax damps.  At this size no trace lands apart (the traces agree bit
# for bit); the test allows one ulp per trace and 2^-6 on the scores
# (per-class probabilities in [0, 1]), and accuracy within 0.03, the bar
# of the card check.
BF16_TRACE_RTOL = 2.0**-8
BF16_SCORE_ATOL = 2.0**-6


def test_fused_bf16_state_fit_matches_jax(data, jax_fused_runs):
    ds, _, xt, _ = data
    run = jax_fused_runs["bf16"]
    compiled, _ = _fit_from_jax_init(data, run, **BF16_STATE)
    for s in compiled.state.layers:
        assert {t.dtype for t in s.marginals} == {torch.bfloat16}
        assert s.w.dtype == s.b.dtype == torch.float32
    port = flat_from_network_state(compiled.state)
    for k, want in run["final"].items():
        if "marginals" in k:
            np.testing.assert_allclose(
                port[k], np.asarray(want, np.float32), rtol=BF16_TRACE_RTOL, atol=0, err_msg=k
            )
    np.testing.assert_allclose(
        compiled.predict(xt).numpy(), run["predict"], rtol=0, atol=BF16_SCORE_ATOL
    )
    assert abs(compiled.evaluate((xt, ds.y_test)) - run["accuracy"]) <= 0.03


def test_compile_quantizes_the_initial_state(data):
    """compile() rounds and casts the traces into the storage tier once."""
    net = _torch_net()
    plain = net.compile(ExecutionConfig(device="cpu"))
    tier = net.compile(ExecutionConfig(device="cpu", **BF16_STATE))
    for a, b in zip(plain.state.layers, tier.state.layers):
        for ta, tb in zip(a.marginals, b.marginals):
            assert tb.dtype == torch.bfloat16
            torch.testing.assert_close(tb.float(), ta, rtol=2.0**-8, atol=0)
        assert torch.equal(a.w, b.w)
    assert net.states[0].marginals.cij.dtype == torch.float32  # declarative state untouched


def test_fused_config_validation():
    with pytest.raises(ValueError, match="datapath"):
        ExecutionConfig(device="cpu", fused_phase=True, precision="bf20")
    with pytest.raises(ValueError, match="datapath"):
        BCPNNLayerSpec(
            pre=UnitLayout(2, 2), post=UnitLayout(2, 2), fused_phase=True,
            precision=PrecisionPolicy.named("bf20"),
        )
    assert ExecutionConfig(device="cpu", fused_phase=True).fused_phase is True
    # The spec needs no kernel switch: the fused kernel is the path.
    assert BCPNNLayerSpec(pre=UnitLayout(2, 2), post=UnitLayout(2, 2), fused_phase=True).fused_phase
    with pytest.raises(TypeError, match="use_kernels"):
        ExecutionConfig(device="cpu", fused_phase=True, use_kernels=True)
    net = _torch_net()
    bound = [ExecutionConfig(device="cpu", **BF16_STATE).bind_layer(la) for la in net.layers]
    assert [b.spec.fused_phase for b in bound] == [True, False]
    assert all(b.spec.precision.has_state_tier for b in bound)
    assert not any(la.spec.fused_phase or la.spec.precision for la in net.layers)


def test_unported_options_raise_by_name(data):
    ds, x, _, _ = data
    for name in ("trainer", "use_kernels", "strict", "profile_dir"):
        with pytest.raises(TypeError, match=name):
            ExecutionConfig(**{name: None})
    with pytest.raises(TypeError, match="use_kernels"):
        StructuralPlasticityLayer(UnitLayout(2, 2), UnitLayout(2, 2), use_kernels=True)
    net = _torch_net().compile(ExecutionConfig(device="cpu"))
    with pytest.raises(ValueError, match="readout"):
        net.fit((x, ds.y_train), readout="svm", **FIT_KW)
    # Streaming and serving are ported; the continual option takes its config
    # type only, and the fleet option and strict mode are refused by name.
    for method in ("streaming", "serve"):
        assert callable(getattr(net, method))
    from repro_torch.runtime import ServiceConfig

    for name in ("router", "continual", "strict"):
        with pytest.raises(TypeError, match=name):
            ServiceConfig(**{name: True})
    with pytest.raises(ValueError, match="decode"):
        ServiceConfig(plan="decode")
    with pytest.raises(ValueError, match="engine"):
        ExecutionConfig(engine="pipelined")


class TestPrecisionCliff:
    """Paper Fig. 3 on the port, ``tests/test_network_e2e.py``'s
    ``TestPrecisionCliff`` configuration (64 features, 16x16 hidden, 4096
    rows, 6 epochs) and assertions.  Each port fit starts from the JAX
    package's initial states, carried across, as every whole-fit parity test
    here does; the port's fits at fp32 and bf20 must land within 0.05 of the
    JAX package's (rewiring is a discrete choice on rounded traces, so whole
    fits agree at the accuracy level)."""

    FORMATS = ("fp32", "bf20", "bf16", "bf14")

    @pytest.fixture(scope="class")
    def cliff(self):
        ds = mnist_like(n_train=4096, n_test=512, n_features=64, seed=0)
        x, layout = complementary_code(ds.x_train)
        xt, _ = complementary_code(ds.x_test)
        hidden_kw = dict(fan_in=32, lam=0.02, init_jitter=1.0, gain=4.0)
        fit_kw = dict(epochs_hidden=6, epochs_readout=6, batch_size=128)
        jnet = JNetwork(seed=0)
        jnet.add(JPlastic(JUnitLayout(64, 2), JUnitLayout(16, 16), **hidden_kw))
        jnet.add(JDense(JUnitLayout(16, 16), jonehot(10), lam=0.02))
        jax_acc, init = {}, None
        for name in ("fp32", "bf20"):
            jc = jnet.compile(JExecutionConfig(precision=JPrecisionPolicy.named(name)))
            init = _jflat(jc.state.layers)
            jc.fit((x, ds.y_train), **fit_kw)
            jax_acc[name] = jc.evaluate((xt, ds.y_test))

        def port_fit(policy):
            net = Network(seed=0)
            net.add(StructuralPlasticityLayer(layout, UnitLayout(16, 16), **hidden_kw))
            net.add(DenseLayer(UnitLayout(16, 16), onehot_layout(10), lam=0.02))
            compiled = net.compile(ExecutionConfig(device="cpu", precision=policy))
            state = network_state_from_flat(init, compiled.layers)
            compiled.state = state._replace(layers=tuple(
                s._replace(marginals=quantize_marginals(s.marginals, policy))
                for s in state.layers
            ))
            compiled.fit((x, ds.y_train), **fit_kw)
            return compiled, compiled.evaluate((xt, ds.y_test))

        accs = {name: port_fit(PrecisionPolicy.named(name))[1] for name in self.FORMATS}
        tier, accs["bf20+bf16"] = port_fit(PrecisionPolicy.named("bf20", state_format="bf16"))
        return accs, jax_acc, tier

    def test_bf20_matches_fp32(self, cliff):
        accs = cliff[0]
        assert abs(accs["bf20"] - accs["fp32"]) < 0.05, accs

    def test_bf16_minor_degradation(self, cliff):
        accs = cliff[0]
        assert accs["bf16"] > accs["fp32"] - 0.15, accs

    def test_bf14_collapses(self, cliff):
        accs = cliff[0]
        assert accs["bf14"] < accs["fp32"] - 0.15, accs
        assert accs["bf14"] < accs["bf16"] - 0.10, accs

    def test_ordering(self, cliff):
        accs = cliff[0]
        assert accs["bf14"] <= accs["bf16"] + 0.05 <= accs["bf20"] + 0.10

    @pytest.mark.parametrize("name", ["fp32", "bf20"])
    def test_matches_jax(self, cliff, name):
        accs, jax_acc, _ = cliff
        assert abs(accs[name] - jax_acc[name]) <= 0.05, (accs, jax_acc)

    def test_datapath_with_state_tier(self, cliff):
        """bf20 arithmetic with bf16 traces: the traces stay bf16 through
        the fit, and the accuracy stays with bf20's."""
        accs, _, tier = cliff
        for s in tier.state.layers:
            assert {t.dtype for t in s.marginals} == {torch.bfloat16}
            assert s.w.dtype == s.b.dtype == torch.float32
        assert abs(accs["bf20+bf16"] - accs["bf20"]) < 0.05, accs


class TestAccuracy:
    """EXPERIMENTS.md §Validation rows 1 and 3 on the port, each fit from
    the port's own initial state (``Network(seed=...)``) at the reference's
    configuration (``tests/test_network_e2e.py``: 64 features, 16x16 hidden,
    4096 rows, B = 128)."""

    @pytest.fixture(scope="class")
    def e2e(self):
        ds = mnist_like(n_train=4096, n_test=512, n_features=64, seed=0)
        x, layout = complementary_code(ds.x_train)
        xt, _ = complementary_code(ds.x_test)
        return ds, x, xt, layout

    @staticmethod
    def _fit(e2e, gain=4.0, epochs=6, seed=0):
        ds, x, xt, layout = e2e
        net = Network(seed=seed)
        net.add(StructuralPlasticityLayer(layout, UnitLayout(16, 16), fan_in=32, lam=0.02,
                                          init_jitter=1.0, gain=gain))
        net.add(DenseLayer(UnitLayout(16, 16), onehot_layout(10), lam=0.02))
        compiled = net.compile(ExecutionConfig(device="cpu"))
        compiled.fit((x, ds.y_train), epochs_hidden=epochs, epochs_readout=epochs, batch_size=128)
        return compiled.evaluate((xt, ds.y_test))

    def test_unsupervised_plus_bcpnn_readout(self, e2e):
        """Row 1 (paper Fig. 2c): the BCPNN readout far above chance."""
        acc = self._fit(e2e)
        assert acc > 0.85, acc

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_gain_matters(self, e2e, seed):
        """Row 3: the soft-WTA gain drives the unsupervised clustering."""
        acc_sharp = self._fit(e2e, gain=4.0, epochs=3, seed=seed)
        acc_flat = self._fit(e2e, gain=1.0, epochs=3, seed=seed)
        assert acc_sharp > acc_flat, (acc_sharp, acc_flat)
