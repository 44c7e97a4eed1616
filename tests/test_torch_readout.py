"""The hybrid SGD readout (``fit(readout="sgd")``, the paper's 97.5%
configuration) against the JAX package's.

The head's initial weights come from ``jax.random`` in the reference and
from a ``torch.Generator`` here, so parity tests carry the JAX head across
(and the JAX-initialised layer states, as ``test_torch_network.py`` does).
One AdamW epoch from the same head on the same projected codes, in the same
shuffle order, must then agree to f32 reassociation error (the gradients'
batch sums run in other orders); ``partial_fit`` must resume the head and
its optimizer moments as the reference does.
"""
import jax
import jax.numpy as jnp
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
from repro.core.network import sgd_readout_setup as jsgd_readout_setup
from repro.runtime.epoch_engine import sgd_epoch_cached_fn as jsgd_epoch_cached_fn
from repro_torch.checkpoint import flat_from_network_state, network_state_from_flat
from repro_torch.core import (
    DenseLayer,
    ExecutionConfig,
    Network,
    StructuralPlasticityLayer,
    UnitLayout,
    onehot_layout,
)
from repro_torch.core.network import sgd_readout_setup
from repro_torch.data import complementary_code, mnist_like
from repro_torch.runtime.plans import make_plan

HIDDEN = (4, 8)
LAYER_KW = dict(fan_in=6, lam=0.05, gain=4.0, init_jitter=1.0)
FIT_KW = dict(epochs_hidden=2, epochs_readout=2, batch_size=32)
# One epoch of 8 AdamW steps from the same head: the gradients' sums differ
# by f32 reassociation, and Adam's normalised step carries that into the
# params at a few ulps of lr.
EPOCH_TOL = dict(rtol=1e-5, atol=1e-6)
FIT_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 1e-2


@pytest.fixture(scope="module")
def data():
    ds = mnist_like(n_train=256, n_test=100, n_features=12, seed=0)
    x, _ = complementary_code(ds.x_train)
    xt, _ = complementary_code(ds.x_test)
    return ds, x, xt


def _torch_net(readout=True):
    net = Network(seed=0)
    net.add(StructuralPlasticityLayer(UnitLayout(12, 2), UnitLayout(*HIDDEN), **LAYER_KW))
    if readout:
        net.add(DenseLayer(UnitLayout(*HIDDEN), onehot_layout(10), lam=0.05))
    return net


def _jax_compiled(**config):
    net = JNetwork(seed=0)
    net.add(JPlastic(JUnitLayout(12, 2), JUnitLayout(*HIDDEN), **LAYER_KW))
    net.add(JDense(JUnitLayout(*HIDDEN), jonehot(10), lam=0.05))
    return net.compile(JExecutionConfig(engine="scan", **config))


def _jflat(layer_states):
    tree = {"layers": {str(i): s for i, s in enumerate(layer_states)}}
    return {
        path_key(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _head(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


def _codes(seed=0, n=256):
    rng = np.random.default_rng(seed)
    s = 3 * rng.standard_normal((n, HIDDEN[0], HIDDEN[1]))
    h = (np.exp(s) / np.exp(s).sum(-1, keepdims=True)).reshape(n, -1).astype(np.float32)
    return h, rng.integers(0, 10, n).astype(np.int32)


def test_setup_and_loss_match_jax():
    h, y = _codes()
    n_hidden = h.shape[1]
    params, opt, opt_state, loss_fn = sgd_readout_setup(0, n_hidden, y, LR)
    jparams, jopt, _, jloss_fn = jsgd_readout_setup(0, n_hidden, y, LR)
    assert params["w"].shape == (n_hidden, 10) and not params["b"].any()
    assert (opt.learning_rate, opt.weight_decay) == (jopt.learning_rate, jopt.weight_decay) == (LR, 1e-4)
    # N(0, 1) / sqrt(n_hidden), from a generator seeded with seed + 1.
    again = sgd_readout_setup(0, n_hidden, y, LR)[0]
    other = sgd_readout_setup(1, n_hidden, y, LR)[0]
    assert torch.equal(params["w"], again["w"]) and not torch.equal(params["w"], other["w"])
    g = torch.Generator().manual_seed(1)
    torch.testing.assert_close(params["w"], torch.randn((n_hidden, 10), generator=g) / n_hidden**0.5)
    assert int(opt_state.step) == 0 and not opt_state.mu["w"].any()
    # The same loss on the JAX head, codes and labels.
    loss = loss_fn(_head(jparams), torch.from_numpy(h), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(jloss_fn(jparams, h, y)), rtol=1e-6)
    assert sgd_readout_setup(0, n_hidden, y, LR, n_classes=12, init_params=False)[0] is None
    assert sgd_readout_setup(0, n_hidden, y, LR, n_classes=12)[0]["w"].shape == (n_hidden, 12)


@pytest.mark.parametrize("engine", ["scan", "batch"])
def test_sgd_epoch_matches_jax(engine):
    """One epoch from the JAX head on the same projected codes and order."""
    h, y = _codes()
    n_hidden, B = h.shape[1], 32
    jparams, jopt, jstate, jloss_fn = jsgd_readout_setup(0, n_hidden, y, LR)
    idx = np.random.default_rng(3).permutation(len(h))
    jrun = jsgd_epoch_cached_fn(jopt, jloss_fn, donate=False)
    hs = jnp.asarray(h[idx].reshape(-1, B, n_hidden))
    ys = jnp.asarray(y[idx].reshape(-1, B))
    jparams_n, jstate_n, jlosses = jrun(jparams, jstate, hs, ys)

    _, opt, _, loss_fn = sgd_readout_setup(0, n_hidden, y, LR, init_params=False)
    params = _head(jparams)
    plan = make_plan(engine, [], "cpu")
    run = plan.sgd_epoch_cached(opt, loss_fn)
    params_n, state_n, loss = run(params, opt.init(params), torch.from_numpy(h), y, idx, B)
    for k in ("w", "b"):
        np.testing.assert_allclose(params_n[k].numpy(), np.asarray(jparams_n[k]), **EPOCH_TOL)
        np.testing.assert_allclose(state_n.mu[k].numpy(), np.asarray(jstate_n.mu[k]), **EPOCH_TOL)
        np.testing.assert_allclose(state_n.nu[k].numpy(), np.asarray(jstate_n.nu[k]), rtol=1e-4, atol=1e-12)
    assert int(state_n.step) == int(jstate_n.step) == len(h) // B
    np.testing.assert_allclose(float(loss), float(jlosses[-1]), rtol=1e-5)
    assert torch.equal(params["w"], _head(jparams)["w"])  # the input head is not written


def _sgd_fit(data, engine="scan", **config):
    ds, x, _ = data
    net = _torch_net().compile(ExecutionConfig(device="cpu", engine=engine, **config))
    result = net.fit((x, ds.y_train), readout="sgd", readout_lr=LR, **FIT_KW)
    return net, result


def _states_equal(a, b):
    fa, fb = flat_from_network_state(a.state), flat_from_network_state(b.state)
    assert sorted(fa) == sorted(fb) and "readout/w" in fa
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_scan_plan_equals_batch_plan(data):
    scan, result = _sgd_fit(data, "scan")
    batch, _ = _sgd_fit(data, "batch")
    _states_equal(scan, batch)
    phases = [h["phase"] for h in result.history]
    assert phases == ["hidden0", "hidden0", "project", "sgd_readout", "sgd_readout"]
    assert all(h["seconds"] >= h["host_s"] >= 0.0 for h in result.history)


@pytest.mark.parametrize("engine", ["scan", "batch"])
def test_cached_and_uncached_activations_agree(data, engine):
    cached, _ = _sgd_fit(data, engine)
    fused, result = _sgd_fit(data, engine, cache_activations=False)
    _states_equal(cached, fused)
    assert "project" not in [h["phase"] for h in result.history]
    xt = data[2]
    np.testing.assert_array_equal(cached.predict(xt).numpy(), fused.predict(xt).numpy())


def test_predict_runs_through_the_head(data):
    ds, x, xt = data
    net, _ = _sgd_fit(data)
    head = net.state.readout
    assert set(head) == {"w", "b"} and head["w"].shape == (HIDDEN[0] * HIDDEN[1], 10)
    codes = net.activations.level(1, list(net.state.layers), xt, chunk=1024)
    torch.testing.assert_close(net.predict(xt), codes @ head["w"] + head["b"], rtol=0, atol=0)
    # A BCPNN readout fit trains a replacement, and only then is the head dropped.
    net.fit((x, ds.y_train), epochs_hidden=0, epochs_readout=0)
    assert net.state.readout is head
    net.fit((x, ds.y_train), epochs_hidden=0, epochs_readout=1)
    assert net.state.readout is None
    # epochs_readout=0 still initializes the head (the reference's semantics).
    result = net.fit((x, ds.y_train), epochs_hidden=0, epochs_readout=0, readout="sgd")
    assert net.state.readout is not None
    assert [h["phase"] for h in result.history] == ["project"]


def test_partial_fit_resumes_the_optimizer_state(data):
    """Two partial_fit calls with readout="sgd" from the JAX head: the head
    and its moments carry over between the calls, as in the reference."""
    ds, x, xt = data
    jc = _jax_compiled()
    port = _torch_net().compile(ExecutionConfig(device="cpu"))
    port.state = network_state_from_flat(_jflat(jc.state.layers), port.layers)
    n_hidden = HIDDEN[0] * HIDDEN[1]
    jhead = jsgd_readout_setup(0, n_hidden, ds.y_train, 1e-3, n_classes=10)[0]
    port.state = port.state._replace(readout=_head(jhead))  # the head JAX draws
    chunks = [(x[:128], ds.y_train[:128]), (x[128:], ds.y_train[128:])]
    for chunk in chunks:
        port.partial_fit(chunk, batch_size=32, readout="sgd")
        jc.partial_fit(chunk, batch_size=32, readout="sgd")
    assert int(port._sgd_opt_state.step) == int(jc._sgd_opt_state.step) == 8
    for k in ("w", "b"):
        np.testing.assert_allclose(port.state.readout[k].numpy(), np.asarray(jc.state.readout[k]), **FIT_TOL)
        np.testing.assert_allclose(
            port._sgd_opt_state.mu[k].numpy(), np.asarray(jc._sgd_opt_state.mu[k]), **FIT_TOL
        )
    np.testing.assert_allclose(port.predict(xt).numpy(), np.asarray(jc.predict(xt)), **FIT_TOL)
    # A fresh fit starts a new trajectory: new head, new moments.
    port.fit(chunks[0], epochs_hidden=0, epochs_readout=1, batch_size=32, readout="sgd")
    assert int(port._sgd_opt_state.step) == 4


def test_headless_network_sizes_its_head_from_the_labels(data):
    ds, x, _ = data
    net = _torch_net(readout=False).compile(ExecutionConfig(device="cpu"))
    y = np.minimum(ds.y_train, 6)
    net.fit((x, y), epochs_hidden=1, epochs_readout=1, batch_size=32, readout="sgd")
    assert net.state.readout["w"].shape == (HIDDEN[0] * HIDDEN[1], 7)
    with pytest.raises(ValueError, match="exceeds the SGD head"):
        net.partial_fit((x, np.full_like(y, 9)), batch_size=32, readout="sgd")


@pytest.fixture(scope="module")
def e2e():
    ds = mnist_like(n_train=4096, n_test=512, n_features=64, seed=0)
    x, layout = complementary_code(ds.x_train)
    xt, _ = complementary_code(ds.x_test)
    return ds, x, xt, layout


def test_hybrid_sgd_readout_accuracy(e2e):
    """``tests/test_network_e2e.py::TestAccuracy::test_hybrid_sgd_readout``'s
    configuration and bar (> 0.85) for the port, from its own init, and
    within 0.05 of the JAX package's accuracy."""
    from repro.core import Network as JNet

    ds, x, xt, layout = e2e
    fit_kw = dict(epochs_hidden=6, epochs_readout=6, batch_size=128, readout="sgd")
    net = Network(seed=0)
    net.add(StructuralPlasticityLayer(layout, UnitLayout(16, 16), fan_in=32, lam=0.02,
                                      init_jitter=1.0, gain=4.0))
    net.add(DenseLayer(UnitLayout(16, 16), onehot_layout(10), lam=0.02))
    compiled = net.compile(ExecutionConfig(device="cpu"))
    compiled.fit((x, ds.y_train), **fit_kw)
    acc = compiled.evaluate((xt, ds.y_test))
    jnet = JNet(seed=0)
    jnet.add(JPlastic(JUnitLayout(64, 2), JUnitLayout(16, 16), fan_in=32, lam=0.02,
                      init_jitter=1.0, gain=4.0))
    jnet.add(JDense(JUnitLayout(16, 16), jonehot(10), lam=0.02))
    jc = jnet.compile(JExecutionConfig())
    jc.fit((x, ds.y_train), **fit_kw)
    jacc = jc.evaluate((xt, ds.y_test))
    assert acc > 0.85 and abs(acc - jacc) <= 0.05, (acc, jacc)
