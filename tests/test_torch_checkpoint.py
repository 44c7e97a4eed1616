"""Whole-network checkpoints: the port's own round trip, and checkpoints
crossing between the port and the JAX package in both directions.

Both packages write ``<dir>/step_<n>/{arrays.npz,manifest.json}`` with the
same keys, shapes and logical dtypes; bf16 traces (the quantized state
tier) are stored as their uint16 bits, the SGD readout head as
``readout/{w,b}``, continual-learning adapters as
``adapters/<tenant>/...``.  So every array read back must be bitwise equal
to the one written, whichever package wrote it.
"""
import json
import os

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
from repro.precision import PrecisionPolicy as JPrecisionPolicy
from repro.checkpoint import load_adapters as jload_adapters
from repro.checkpoint import save_network as jsave_network
from repro_torch.checkpoint import (
    flat_from_network_state,
    load_adapters,
    load_network,
    save_network,
    network_state_from_flat,
    latest_checkpoint,
    list_checkpoints,
    load_flat,
    load_manifest,
    restore_into_template,
    save_checkpoint,
)
from repro_torch.core import (
    DenseLayer,
    ExecutionConfig,
    Network,
    StructuralPlasticityLayer,
    UnitLayout,
    onehot_layout,
)
from repro_torch.core.learning import MarginalState
from repro_torch.data import complementary_code, mnist_like
from repro_torch.precision import PrecisionPolicy

HIDDEN = (4, 8)
LAYER_KW = dict(fan_in=6, lam=0.05, gain=4.0, init_jitter=1.0)
FIT_KW = dict(epochs_hidden=1, epochs_readout=1, batch_size=32)
PREDICT_TOL = dict(rtol=1e-4, atol=1e-5)
TIERS = {
    "f32": (dict(), dict()),
    "bf16": (
        dict(fused_phase=True, precision=PrecisionPolicy.named("fp32", state_format="bf16")),
        dict(fused_phase=True, precision=JPrecisionPolicy.named("fp32", state_format="bf16")),
    ),
}


@pytest.fixture(scope="module")
def data():
    ds = mnist_like(n_train=128, n_test=64, n_features=12, seed=1)
    x, _ = complementary_code(ds.x_train)
    xt, _ = complementary_code(ds.x_test)
    return x, ds.y_train, xt


def _torch_net(hidden=HIDDEN, seed=0):
    net = Network(seed=seed)
    net.add(StructuralPlasticityLayer(UnitLayout(12, 2), UnitLayout(*hidden), **LAYER_KW))
    net.add(DenseLayer(UnitLayout(*hidden), onehot_layout(10), lam=0.05))
    return net


def _jax_net(seed=0):
    net = JNetwork(seed=seed)
    net.add(JPlastic(JUnitLayout(12, 2), JUnitLayout(*HIDDEN), **LAYER_KW))
    net.add(JDense(JUnitLayout(*HIDDEN), jonehot(10), lam=0.05))
    return net


def _jflat(layer_states):
    tree = {"layers": {str(i): s for i, s in enumerate(layer_states)}}
    return {
        path_key(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _bits(a):
    a = np.asarray(a)
    return a.astype(np.float32).view(np.int32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def _assert_flat_bitwise(port_state, jax_flat, want_dtype):
    port = flat_from_network_state(port_state)
    assert sorted(port) == sorted(jax_flat)
    for k, want in jax_flat.items():
        np.testing.assert_array_equal(_bits(port[k]), _bits(want), err_msg=k)
    for s in port_state.layers:
        assert {t.dtype for t in s.marginals} == {want_dtype}


def _tier_dtype(tier):
    return torch.bfloat16 if tier == "bf16" else torch.float32


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_port_round_trip_is_bit_exact(data, tmp_path, tier):
    x, y, xt = data
    cfg = ExecutionConfig(device="cpu", **TIERS[tier][0])
    a = _torch_net().compile(cfg)
    a.fit((x, y), **FIT_KW)
    path = a.save(str(tmp_path), step=7)
    assert path.endswith("step_0000000007") and not any(
        n.startswith("tmp.") for n in os.listdir(tmp_path)
    )
    b = _torch_net(seed=3).compile(cfg).load(path)
    for sa, sb in zip(a.state.layers, b.state.layers):
        assert sa.host_step == sb.host_step == int(sb.step)
        for ta, tb in zip((*sa.marginals, sa.w, sa.b, sa.step), (*sb.marginals, sb.w, sb.b, sb.step)):
            assert ta.dtype == tb.dtype and torch.equal(ta, tb)
    assert b.state.layers[0].marginals.cij.dtype == _tier_dtype(tier)
    assert torch.equal(a.predict(xt), b.predict(xt))
    # The shuffle RNG resumes: both continue with the same draws.
    a.fit((x, y), **FIT_KW)
    b.fit((x, y), **FIT_KW)
    for sa, sb in zip(a.state.layers, b.state.layers):
        assert torch.equal(sa.marginals.cij, sb.marginals.cij) and torch.equal(sa.w, sb.w)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_jax_checkpoint_loads_into_the_port(data, tmp_path, tier):
    x, y, xt = data
    jc = _jax_net().compile(JExecutionConfig(engine="scan", **TIERS[tier][1]))
    jc.fit((x, y), **FIT_KW)
    path = jc.save(str(tmp_path), step=2)
    port = _torch_net(seed=5).compile(ExecutionConfig(device="cpu", **TIERS[tier][0]))
    port.load(path)
    _assert_flat_bitwise(port.state, _jflat(jc.state.layers), _tier_dtype(tier))
    np.testing.assert_allclose(port.predict(xt).numpy(), np.asarray(jc.predict(xt)), **PREDICT_TOL)
    assert port._rng.bit_generator.state == jc._rng.bit_generator.state


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_port_checkpoint_loads_into_jax(data, tmp_path, tier):
    x, y, xt = data
    port = _torch_net().compile(ExecutionConfig(device="cpu", **TIERS[tier][0]))
    port.fit((x, y), **FIT_KW)
    path = port.save(str(tmp_path), step=4)
    jc = _jax_net(seed=9).compile(JExecutionConfig(engine="scan", **TIERS[tier][1]))
    jc.load(path)
    _assert_flat_bitwise(port.state, _jflat(jc.state.layers), _tier_dtype(tier))
    if tier == "bf16":
        assert jc.state.layers[0].marginals.cij.dtype == jnp.bfloat16
    np.testing.assert_allclose(np.asarray(jc.predict(xt)), port.predict(xt).numpy(), **PREDICT_TOL)
    manifest = load_manifest(path)
    assert manifest["dtypes"]["layers/0/marginals/cij"] == ("bfloat16" if tier == "bf16" else "float32")
    assert manifest["extra"]["n_layers"] == 2 and manifest["extra"]["has_readout"] is False


def test_mismatched_architecture_raises(data, tmp_path):
    x, y, _ = data
    port = _torch_net().compile(ExecutionConfig(device="cpu"))
    port.fit((x, y), **FIT_KW)
    path = port.save(str(tmp_path))
    with pytest.raises(ValueError, match="shape mismatch"):
        _torch_net(hidden=(4, 6)).compile(ExecutionConfig(device="cpu")).load(path)
    deeper = Network(seed=0)
    deeper.add(StructuralPlasticityLayer(UnitLayout(12, 2), UnitLayout(*HIDDEN), **LAYER_KW))
    deeper.add(StructuralPlasticityLayer(UnitLayout(*HIDDEN), UnitLayout(*HIDDEN), **LAYER_KW))
    deeper.add(DenseLayer(UnitLayout(*HIDDEN), onehot_layout(10), lam=0.05))
    with pytest.raises(ValueError, match="3"):
        deeper.compile(ExecutionConfig(device="cpu")).load(path)
    raw = save_checkpoint(str(tmp_path / "raw"), 0, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="not a network checkpoint"):
        port.load(raw)
    manifest_path = os.path.join(path, "manifest.json")
    with open(manifest_path) as f:
        manifest = json.load(f)
    manifest["extra"]["has_readout"] = True
    with open(manifest_path, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(KeyError, match="readout"):
        port.load(path)


def test_store_retention_and_raw_trees(tmp_path):
    d = str(tmp_path)
    tree = {"m": MarginalState(torch.ones(2), torch.zeros(3).bfloat16(), torch.eye(2)), "skip": None}
    for step in (1, 5, 3, 9):
        save_checkpoint(d, step, tree, retain=2)
    assert [s for s, _ in list_checkpoints(d)] == [5, 9]
    assert latest_checkpoint(d)[0] == 9
    assert latest_checkpoint(str(tmp_path / "none")) is None
    template = {"m": MarginalState(torch.empty(2), torch.empty(3), torch.empty(2, 2)), "skip": None}
    flat = load_flat(latest_checkpoint(d)[1])
    back = restore_into_template(flat, template)
    assert back["m"].cj.dtype == torch.bfloat16 and torch.equal(back["m"].cij, torch.eye(2))
    assert back["skip"] is None
    with pytest.raises(KeyError, match="missing"):
        restore_into_template(flat, {"other": torch.empty(1)})
    with pytest.raises(TypeError, match="cannot checkpoint"):
        save_checkpoint(d, 10, {"bad": "string"})


SGD_FIT = dict(epochs_hidden=1, epochs_readout=2, batch_size=32, readout="sgd")


def _flat_with_head(layer_states, readout):
    flat = _jflat(layer_states)
    flat.update({f"readout/{k}": np.asarray(v) for k, v in readout.items()})
    return flat


def test_sgd_head_round_trip_in_the_port(data, tmp_path):
    x, y, xt = data
    a = _torch_net().compile(ExecutionConfig(device="cpu"))
    a.fit((x, y), **SGD_FIT)
    path = a.save(str(tmp_path), step=1)
    assert load_manifest(path)["extra"]["has_readout"] is True
    b = _torch_net(seed=3).compile(ExecutionConfig(device="cpu")).load(path)
    for k in ("w", "b"):
        assert torch.equal(a.state.readout[k], b.state.readout[k])
    assert torch.equal(a.predict(xt), b.predict(xt))
    assert b._sgd_opt_state is None  # moments are not checkpointed
    b.partial_fit((x, y), batch_size=32, readout="sgd")  # resumes the head, fresh moments
    assert int(b._sgd_opt_state.step) == 4
    with pytest.raises(ValueError, match="hidden features"):
        load_network(path, list(b.state.layers), readout_in_features=5)


def test_jax_sgd_checkpoint_loads_into_the_port(data, tmp_path):
    x, y, xt = data
    jc = _jax_net().compile(JExecutionConfig(engine="scan"))
    jc.fit((x, y), **SGD_FIT)
    path = jc.save(str(tmp_path), step=2)
    port = _torch_net(seed=5).compile(ExecutionConfig(device="cpu")).load(path)
    want = _flat_with_head(jc.state.layers, jc.state.readout)
    _assert_flat_bitwise(port.state, want, torch.float32)
    np.testing.assert_allclose(port.predict(xt).numpy(), np.asarray(jc.predict(xt)), **PREDICT_TOL)


def test_port_sgd_checkpoint_loads_into_jax(data, tmp_path):
    x, y, xt = data
    port = _torch_net().compile(ExecutionConfig(device="cpu"))
    port.fit((x, y), **SGD_FIT)
    path = port.save(str(tmp_path), step=4)
    jc = _jax_net(seed=9).compile(JExecutionConfig(engine="scan"))
    jc.load(path)
    _assert_flat_bitwise(port.state, _flat_with_head(jc.state.layers, jc.state.readout), torch.float32)
    np.testing.assert_allclose(np.asarray(jc.predict(xt)), port.predict(xt).numpy(), **PREDICT_TOL)


def test_network_state_from_flat_carries_the_head(data):
    x, y, xt = data
    jc = _jax_net().compile(JExecutionConfig(engine="scan"))
    jc.fit((x, y), **SGD_FIT)
    flat = _flat_with_head(jc.state.layers, jc.state.readout)
    port = _torch_net().compile(ExecutionConfig(device="cpu"))
    port.state = network_state_from_flat(flat, port.layers)
    np.testing.assert_allclose(port.predict(xt).numpy(), np.asarray(jc.predict(xt)), **PREDICT_TOL)
    assert sorted(flat_from_network_state(port.state)) == sorted(flat)
    with pytest.raises(ValueError, match="hidden features"):
        network_state_from_flat(
            {**flat, "readout/w": np.zeros((5, 10), np.float32)}, port.layers
        )
    # Adapters of the continual tier ride along in a snapshot's arrays; they
    # are not the network's state and are left for load_adapters.
    with_adapters = {**flat, **{f"adapters/t0/{k.split('/', 2)[2]}": v
                                for k, v in flat.items() if k.startswith("layers/0/")}}
    again = network_state_from_flat(with_adapters, port.layers)
    assert sorted(flat_from_network_state(again)) == sorted(flat)
    np.testing.assert_allclose(again.layers[0].w.numpy(), port.state.layers[0].w.numpy(), rtol=0)


# -------------------------------------------------- continual-tier adapters
def _adapter_states(states, n):
    """``n`` distinct adapters forked from layer 0's state (each a copy
    whose traces are scaled, so a mix-up between tenants shows)."""
    return [s._replace(marginals=type(s.marginals)(*(t * (1 + k) for t in s.marginals)))
            for k, s in enumerate([states[0]] * n)]


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_jax_adapters_load_into_the_port(data, tmp_path, tier):
    """A JAX base+adapters snapshot (``save_network(..., adapters=)``, as
    the continual tier writes at a merge) loads into the port: the base
    through ``load``, each tenant's adapter through ``load_adapters``, bit
    for bit."""
    x, y, xt = data
    jc = _jax_net().compile(JExecutionConfig(engine="scan", **TIERS[tier][1]))
    jc.fit((x, y), **FIT_KW)
    jadapters = dict(zip(("paid", "free.tier-1"), _adapter_states(jc.state.layers, 2)))
    path = jsave_network(str(tmp_path), 3, jc.state, adapters=jadapters, adapter_layer=0)
    port = _torch_net(seed=5).compile(ExecutionConfig(device="cpu", **TIERS[tier][0]))
    port.load(path)
    _assert_flat_bitwise(port.state, _jflat(jc.state.layers), _tier_dtype(tier))
    adapters = load_adapters(path, port.state.layers[0])
    assert sorted(adapters) == sorted(jadapters)
    for name, got in adapters.items():
        want = _jflat([jadapters[name]])
        for k, v in flat_from_network_state(type(port.state)(layers=(got,))).items():
            np.testing.assert_array_equal(_bits(v), _bits(want[k]), err_msg=f"{name} {k}")
        assert got.marginals.cij.dtype == _tier_dtype(tier)
        assert got.host_step == int(got.step) == int(jadapters[name].step)
    assert load_manifest(path)["extra"]["adapter_layer"] == 0


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_port_adapters_load_into_jax(data, tmp_path, tier):
    x, y, xt = data
    port = _torch_net().compile(ExecutionConfig(device="cpu", **TIERS[tier][0]))
    port.fit((x, y), **FIT_KW)
    padapters = dict(zip(("t0", "t1"), _adapter_states(port.state.layers, 2)))
    path = save_network(str(tmp_path), 5, port.state, adapters=padapters, adapter_layer=0)
    jc = _jax_net(seed=9).compile(JExecutionConfig(engine="scan", **TIERS[tier][1]))
    jc.load(path)
    _assert_flat_bitwise(port.state, _jflat(jc.state.layers), _tier_dtype(tier))
    jadapters = jload_adapters(path, jc.state.layers[0])
    assert sorted(jadapters) == ["t0", "t1"]
    for name, jstate in jadapters.items():
        want = flat_from_network_state(type(port.state)(layers=(padapters[name],)))
        for k, v in _jflat([jstate]).items():
            np.testing.assert_array_equal(_bits(v), _bits(want[k]), err_msg=f"{name} {k}")
    # ... and back through the port's own reader, bit for bit.
    back = load_adapters(path, port.state.layers[0])
    for name, got in back.items():
        for a, b in zip((*got.marginals, got.w, got.b, got.step),
                        (*padapters[name].marginals, padapters[name].w, padapters[name].b,
                         padapters[name].step)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert load_adapters(port.save(str(tmp_path / "plain")), port.state.layers[0]) == {}


@pytest.mark.parametrize("tenant", ["../evil", "a/b", "", "x y"])
def test_unsafe_tenant_name_refused(data, tmp_path, tenant):
    port = _torch_net().compile(ExecutionConfig(device="cpu"))
    with pytest.raises(ValueError, match="checkpoint-safe"):
        save_network(str(tmp_path), 0, port.state, adapters={tenant: port.state.layers[0]},
                     adapter_layer=0)
    assert list_checkpoints(str(tmp_path)) == []
