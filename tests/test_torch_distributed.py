"""The port's data-parallel trainer (the paper's MPI backend) against the
JAX package's, on the CPU with gloo.

* The batch pipeline (``epoch_batches``, ``lm_batches``) equals the
  reference's, batch for batch.
* The learning cycle (local means, one all-reduce, the reduced-means
  update) and its plain version against the reference's
  ``dp_learning_cycle`` inside ``shard_map`` on a (1, 1) mesh, in process.
* The layer steps of ``DataParallelTrainer`` at world size 1 (a gloo group
  of this process) and at 4 ranks on meshes (4, 1) and (2, 2) (two
  spawned launches of four processes) against the reference's shard_map
  trainer on the same meshes (a subprocess on 8 fake devices), at the
  reference test's tolerances (``tests/test_distributed.py:24-61``: w rtol
  2e-4 / atol 2e-5, C_ij rtol 2e-4 / atol 1e-7).
* The compiled fit of the deep gain-4 network
  (``tests/test_deep_networks.py:318-365``): the batch engine, uncached, in
  shard_map mode against the reference's shard_map fit; the scan engine,
  the cached path and pjit mode against the reference's single-device fit
  (its own shard_map fails there on jax 0.9, ROADMAP queue 3), step counts
  and masks equal; the SGD readout under a trainer against the reference's
  single-device SGD fit from the head it draws (and against the port's
  single-device readout); the three-layer stack at ``epochs_hidden=[3, 2,
  1]`` against the reference's fit.
* A level one rank alone cached (a rank-local predict) does not serve the
  ranks' collective projection: the ranks stay in step and match the
  reference's single-device fits.
* The per-rank rewire equals the global one, and the trainer refuses what
  it cannot run.

Workers and the reference subprocess exchange numpy arrays through npz
files; every assertion runs in this process.
"""
import datetime
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro.checkpoint.store import path_key
from repro.core import DenseLayer as JDense
from repro.core import Network as JNetwork
from repro.core import StructuralPlasticityLayer as JPlastic
from repro.core import UnitLayout as JUnitLayout
from repro.core import learning as jlearning
from repro.core import onehot_layout as jonehot
from repro.core import plasticity as jplasticity
from repro.core.compiled import ExecutionConfig as JExecutionConfig
from repro.core.network import sgd_readout_setup as jsgd_readout_setup
from repro.core.distributed import DataParallelTrainer as JTrainer
from repro.core.distributed import dp_learning_cycle as jdp_learning_cycle
from repro.data import complementary_code as jcomplementary_code
from repro.data import mnist_like as jmnist_like
from repro.data.pipeline import epoch_batches as jepoch_batches
from repro.data.pipeline import lm_batches as jlm_batches
from repro_torch.checkpoint import flat_from_network_state, network_state_from_flat
from repro_torch.core import (
    DenseLayer,
    ExecutionConfig,
    LayerState,
    MarginalState,
    Network,
    PlasticityState,
    StructuralPlasticityLayer,
    UnitLayout,
    onehot_layout,
)
from repro_torch.core import distributed as D
from repro_torch.core.distributed import DataParallelTrainer
from repro_torch.data import epoch_batches, lm_batches
from repro_torch.kernels import ref
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.precision import PrecisionPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The reference test's tolerances (tests/test_distributed.py:52-59).
W_TOL = dict(rtol=2e-4, atol=2e-5)
CIJ_TOL = dict(rtol=2e-4, atol=1e-7)
CYCLE_TOL = dict(rtol=1e-5, atol=1e-6)
# The step config of tests/test_distributed.py:24-61, plus a readout over
# its hidden layer.
STEP_PRE, STEP_POST, STEP_B, STEP_N = (8, 2), (4, 8), 64, 4
MESHES = ((4, 1), (2, 2))
# The deep gain-4 network of tests/test_deep_networks.py:318-365.
DEEP_HIDDEN = ((4, 4), (3, 4), (2, 4))
DEEP_FANIN = (8, 3, 2)
DEEP_KW = dict(epochs_hidden=2, epochs_readout=2, batch_size=64)
# The port's fits at 4 ranks (mesh (4, 1)): name -> (engine, cache, mode,
# shuffle); the first against the reference's shard_map fit, the others
# against its single-device fit.
DEEP_FITS = {
    "batch_uncached_shard_map": ("batch", False, "shard_map", False),
    "scan_cached_shard_map": ("scan", True, "shard_map", True),
    "scan_uncached_shard_map": ("scan", False, "shard_map", True),
    "scan_cached_pjit": ("scan", True, "pjit", True),
    "batch_cached_pjit": ("batch", True, "pjit", True),
}
# The SGD readout: AdamW on the averaged gradients against the same steps
# on the global batch; Adam's normalised step carries the gradients' f32
# reassociation into the head at a few ulps of lr a step.
SGD_TOL = dict(rtol=1e-4, atol=1e-5)
SGD_KW = dict(readout="sgd", readout_lr=1e-2)
# A readout-only refit after rank 0 alone predicted on the training set,
# then a partial_fit: fit(hidden only), [rank 0: predict], fit(readout
# only), partial_fit.
REFIT_KW = (dict(epochs_hidden=2, epochs_readout=0, batch_size=64),
            dict(epochs_hidden=0, epochs_readout=2, batch_size=64))
LAUNCH_TIMEOUT_S = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jflat(layer_states):
    tree = {"layers": {str(i): s for i, s in enumerate(layer_states)}}
    return {
        path_key(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _jhead(y):
    """The SGD head the reference's fit draws for the deep network."""
    n_hidden = DEEP_HIDDEN[-1][0] * DEEP_HIDDEN[-1][1]
    return jsgd_readout_setup(0, n_hidden, y, SGD_KW["readout_lr"], n_classes=10)[0]


def _jdeep(layout):
    net = JNetwork(seed=0)
    pre = layout
    for (hcu, mcu), fan_in in zip(DEEP_HIDDEN, DEEP_FANIN):
        post = JUnitLayout(hcu, mcu)
        net.add(JPlastic(pre, post, fan_in=fan_in, lam=0.05, init_jitter=1.0, gain=4.0))
        pre = post
    net.add(JDense(pre, jonehot(10), lam=0.05))
    return net


# ---------------------------------------------------------------- workers
# One rank of a spawned gloo group: the port alone (torch and repro_torch),
# inputs from IN, results into OUT_<rank>.npz.
WORKER = r"""
import datetime
import json
import sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
import repro_torch.core.network as network_module
from repro_torch.checkpoint import flat_from_network_state, network_state_from_flat
from repro_torch.core import (DenseLayer, ExecutionConfig, LayerState, MarginalState, Network,
                              PlasticityState, StructuralPlasticityLayer, UnitLayout,
                              onehot_layout)
from repro_torch.core.distributed import DataParallelTrainer, collective_counts, reset_collectives
from repro_torch.launch.mesh import make_host_mesh

inp_path, out_path, rank, world, port, model = sys.argv[1:7]
rank, world, model = int(rank), int(world), int(model)
# A rank left waiting in a collective fails the launch within the timeout.
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
                        timeout=datetime.timedelta(seconds=120))
inp = dict(np.load(inp_path))
out = {}
mesh = make_host_mesh(model=model, device_type="cpu")


def layer_state(prefix, plastic):
    t = {k: torch.from_numpy(inp[prefix + k]) for k in ("ci", "cj", "cij", "w", "b")}
    return LayerState(MarginalState(t["ci"], t["cj"], t["cij"]), t["w"], t["b"],
                      PlasticityState(torch.from_numpy(inp[prefix + "hcu_mask"])) if plastic else None,
                      torch.zeros((), dtype=torch.int32))


# The layer steps, both modes, from the reference's initial states.
hidden = StructuralPlasticityLayer(UnitLayout(8, 2), UnitLayout(4, 8), fan_in=8, lam=0.05,
                                   init_jitter=1.0)
readout = DenseLayer(UnitLayout(4, 8), onehot_layout(10), lam=0.05)
for mode in ("shard_map", "pjit"):
    tr = DataParallelTrainer(mesh, mode)
    rows = tr.rows(inp["step_x"].shape[0])
    for name, layer, plastic, args in (
        ("hidden", hidden, True, (inp["step_x"][rows],)),
        ("readout", readout, False, (inp["step_h"][rows], inp["step_y"][rows])),
    ):
        step = tr.hidden_step(layer) if plastic else tr.readout_step(layer)
        st = tr.place_state(layer, layer_state(f"step_{name}_", plastic))
        reset_collectives()
        for _ in range(int(inp["step_n"])):
            st = step(st, *(torch.from_numpy(a) for a in args))
        st = tr.gather_state(layer, st)
        out[f"step/{mode}/{name}/w"] = st.w.numpy()
        out[f"step/{mode}/{name}/cij"] = st.marginals.cij.numpy()
        out[f"step/{mode}/{name}/collectives"] = np.int64(collective_counts()["all_reduce"])

# A ("pod", "data", "model") mesh of (2, 2, 1): the batch over pod and
# data, the same four batch ranks as (4, 1).
if model == 1:
    tp = DataParallelTrainer(make_host_mesh(pod=2, device_type="cpu"), "shard_map")
    st = tp.place_state(hidden, layer_state("step_hidden_", True))
    step = tp.hidden_step(hidden)
    for _ in range(int(inp["step_n"])):
        st = step(st, torch.from_numpy(inp["step_x"][tp.rows(inp["step_x"].shape[0])]))
    out["step/pod/hidden/w"] = tp.gather_state(hidden, st).w.numpy()
    out["step/pod/batch"] = np.array([tp.baxes == ("pod", "data"), tp.n_batch, tp.batch_rank])

# This rank's rows of a global batch, by the batch pipeline.
from repro_torch.data import ShardedBatcher

out["batcher/rows"] = ShardedBatcher(mesh).global_batch(inp["step_x"]).numpy()
out["batcher/data_rank"] = np.int64(tr.batch_rank)

# A model axis must not split a hidden layer's hypercolumns.
try:
    DataParallelTrainer(mesh).hidden_step(
        StructuralPlasticityLayer(UnitLayout(8, 2), UnitLayout(3, 4), fan_in=4))
    out["refusal/split_hcu"] = np.array("no error")
except ValueError as e:
    out["refusal/split_hcu"] = np.array(str(e))

x, y = inp["deep_x"], inp["deep_y"]
init = {k[len("deep_init/"):]: v for k, v in inp.items() if k.startswith("deep_init/")}


def deep():
    net = Network(seed=0)
    pre = UnitLayout(int(inp["deep_pre"][0]), int(inp["deep_pre"][1]))
    for (hcu, mcu), fan_in in zip(inp["deep_hidden"].tolist(), inp["deep_fanin"].tolist()):
        post = UnitLayout(hcu, mcu)
        net.add(StructuralPlasticityLayer(pre, post, fan_in=fan_in, lam=0.05, init_jitter=1.0,
                                          gain=4.0))
        pre = post
    net.add(DenseLayer(pre, onehot_layout(10), lam=0.05))
    return net


def fit(engine, cache, mode, shuffle, model_axis=True, **kw):
    cfg = dict(engine=engine, device="cpu", cache_activations=cache)
    if mode is not None:
        cfg["trainer"] = DataParallelTrainer(mesh, mode)
    c = deep().compile(ExecutionConfig(**cfg))
    c.state = network_state_from_flat(init, c.layers)
    reset_collectives()
    c.fit((x, y), shuffle=shuffle, **{**dict(epochs_hidden=2, epochs_readout=2, batch_size=64),
                                      **kw})
    return c


if model == 1:  # the deep network's 3-hypercolumn layer needs a model axis of 1
    for name, (engine, cache, mode, shuffle) in json.loads(inp["deep_fits"].item()).items():
        c = fit(engine, cache, mode, shuffle)
        for k, v in flat_from_network_state(c.state).items():
            out[f"fit/{name}/{k}"] = v
        out[f"fit/{name}/collectives"] = np.int64(collective_counts()["all_reduce"])
        out[f"fit/{name}/accuracy"] = np.float64(c.evaluate((x, y)))
    # The project-once store under the trainer: each batch rank projects its
    # share of the chunks, one all-reduce fills in the rest; the level
    # equals a store's without a trainer bit for bit.
    from repro_torch.runtime.activations import ActivationStore

    states = list(c.state.layers)
    shared = ActivationStore(c.layers, "cpu", trainer=c.config.trainer)
    reset_collectives()
    got = shared.level(3, states, x, chunk=64, collective=True)
    out["store/all_reduce"] = np.int64(collective_counts()["all_reduce"])
    out["store/equal"] = np.bool_(torch.equal(got, ActivationStore(c.layers, "cpu").level(
        3, states, x, chunk=64)))
    # The SGD readout, under the trainer and on one device, from the head
    # the reference draws (a fit draws its head from a torch.Generator;
    # the port's setup is wrapped to hand back the reference's instead).
    setup = network_module.sgd_readout_setup

    def reference_head(*args, **kw):
        params, opt, opt_state, loss_fn = setup(*args, **kw)
        if params is not None:
            params = {k: torch.from_numpy(inp[f"sgd_head/{k}"]) for k in ("w", "b")}
            opt_state = opt.init(params)
        return params, opt, opt_state, loss_fn

    network_module.sgd_readout_setup = reference_head
    for name, mode in (("sgd_trainer", "shard_map"), ("sgd_single", None)):
        c = fit("scan", True, mode, True, **json.loads(inp["sgd_kw"].item()))
        out[f"{name}/w"] = c.state.readout["w"].numpy()
        out[f"{name}/b"] = c.state.readout["b"].numpy()
        out[f"{name}/scores"] = c.predict(x).numpy()
    network_module.sgd_readout_setup = setup
    # Rank 0 alone predicts on the training set (as a rank logging its
    # train accuracy would), caching the top level on rank 0 only; the
    # readout-only refit's collective projection of that level must not be
    # served by it, or rank 0 would skip the all-reduce the others enter.
    first, refit = json.loads(inp["refit_kw"].item())
    c = fit("scan", True, "shard_map", True, **first)
    if rank == 0:
        c.predict(x)
    reset_collectives()
    c.fit((x, y), **refit)
    c.partial_fit((x, y), batch_size=64, readout="bcpnn")
    for k, v in flat_from_network_state(c.state).items():
        out[f"refit/{k}"] = v
    out["refit/collectives"] = np.int64(collective_counts()["all_reduce"])
    # A batch the batch ranks do not divide.
    try:
        fit("scan", True, "shard_map", True, batch_size=30)
        out["refusal/batch"] = np.array("no error")
    except ValueError as e:
        out["refusal/batch"] = np.array(str(e))
np.savez(out_path.replace(".npz", f"_{rank}.npz"), **out)
dist.destroy_process_group()
"""

# The reference's shard_map trainer on 8 fake devices: the layer steps on
# each mesh of MESHES and the deep network's batch-engine, uncached fit on
# a (4,) data mesh.
REFERENCE = r"""
import json
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import DenseLayer, ExecutionConfig, Network, StructuralPlasticityLayer, UnitLayout, onehot_layout
from repro.core.distributed import DataParallelTrainer
from repro.checkpoint.store import path_key

inp = dict(np.load(sys.argv[1]))
out = {}
hidden = StructuralPlasticityLayer(UnitLayout(8, 2), UnitLayout(4, 8), fan_in=8, lam=0.05,
                                   init_jitter=1.0)
readout = DenseLayer(UnitLayout(4, 8), onehot_layout(10), lam=0.05)
h0 = hidden.init(jax.random.PRNGKey(0))
r0 = readout.init(jax.random.PRNGKey(1))
for shape in json.loads(inp["meshes"].item()):
    mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:shape[0] * shape[1]])
    tr = DataParallelTrainer(mesh, mode="shard_map")
    for name, layer, st, args in (
        ("hidden", hidden, h0, (inp["step_x"],)),
        ("readout", readout, r0, (inp["step_h"], inp["step_y"])),
    ):
        step = tr.hidden_step(layer) if name == "hidden" else tr.readout_step(layer)
        if name == "hidden":  # its place_state fails on a readout's state (no plast)
            st = tr.place_state(layer, st)
        args = [jax.device_put(jnp.asarray(a), tr.batch_sharding() if a.ndim == 2 else
                               jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(tr.baxes)))
                for a in args]
        for _ in range(int(inp["step_n"])):
            st = step(st, *args)
        key = f"{shape[0]}x{shape[1]}/{name}"
        out[f"{key}/w"] = np.asarray(jax.device_get(st.w))
        out[f"{key}/cij"] = np.asarray(jax.device_get(st.marginals.cij))

net = Network(seed=0)
pre = UnitLayout(int(inp["deep_pre"][0]), int(inp["deep_pre"][1]))
for (hcu, mcu), fan_in in zip(inp["deep_hidden"].tolist(), inp["deep_fanin"].tolist()):
    post = UnitLayout(hcu, mcu)
    net.add(StructuralPlasticityLayer(pre, post, fan_in=fan_in, lam=0.05, init_jitter=1.0,
                                      gain=4.0))
    pre = post
net.add(DenseLayer(pre, onehot_layout(10), lam=0.05))
tr = DataParallelTrainer(jax.make_mesh((4,), ("data",), devices=jax.devices()[:4]), "shard_map")
c = net.compile(ExecutionConfig(engine="batch", cache_activations=False, trainer=tr))
c.fit((inp["deep_x"], inp["deep_y"]), shuffle=False, epochs_hidden=2, epochs_readout=2,
      batch_size=64)
tree = {"layers": {str(i): s for i, s in enumerate(c.state.layers)}}
for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
    out[f"fit/{path_key(p)}"] = np.asarray(jax.device_get(leaf))
np.savez(sys.argv[2], **out)
"""


def _popen(code, args, env):
    return subprocess.Popen([sys.executable, "-c", code, *map(str, args)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def step_inputs():
    """The step config's inputs and the reference's initial states."""
    rng = np.random.default_rng(0)
    x = rng.random((STEP_B, 16)).astype(np.float32)
    h = rng.random((STEP_B, 4, 8)).astype(np.float32)
    h = (h / h.sum(-1, keepdims=True)).reshape(STEP_B, 32)
    y = rng.integers(0, 10, STEP_B)
    hidden = JPlastic(JUnitLayout(*STEP_PRE), JUnitLayout(*STEP_POST), fan_in=8, lam=0.05,
                      init_jitter=1.0)
    readout = JDense(JUnitLayout(*STEP_POST), jonehot(10), lam=0.05)
    h0, r0 = hidden.init(jax.random.PRNGKey(0)), readout.init(jax.random.PRNGKey(1))
    return dict(x=x, h=h, y=y, hidden=hidden, readout=readout, h0=h0, r0=r0)


def _state_arrays(prefix, st):
    out = {f"{prefix}{k}": np.asarray(v) for k, v in
           zip(("ci", "cj", "cij"), st.marginals)}
    out.update({f"{prefix}w": np.asarray(st.w), f"{prefix}b": np.asarray(st.b)})
    if st.plast is not None:
        out[f"{prefix}hcu_mask"] = np.asarray(st.plast.hcu_mask)
    return out


@pytest.fixture(scope="module")
def deep_data():
    ds = jmnist_like(n_train=256, n_test=64, n_features=16, seed=0)
    x, layout = jcomplementary_code(ds.x_train)
    return ds, np.asarray(x, np.float32), layout


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, step_inputs, deep_data):
    """The reference subprocess and the two port launches, run together;
    returns (reference arrays, {mesh: [rank arrays]})."""
    d = tmp_path_factory.mktemp("dp")
    ds, x, layout = deep_data
    init = _jflat(_jdeep(layout).compile(JExecutionConfig()).state.layers)
    inp = dict(
        step_x=step_inputs["x"], step_h=step_inputs["h"], step_y=step_inputs["y"],
        step_n=np.int64(STEP_N), meshes=np.array(json.dumps(MESHES)),
        deep_x=x, deep_y=np.asarray(ds.y_train), deep_pre=np.array([layout.n_hcu, layout.n_mcu]),
        deep_hidden=np.array(DEEP_HIDDEN), deep_fanin=np.array(DEEP_FANIN),
        deep_fits=np.array(json.dumps(DEEP_FITS)),
        sgd_kw=np.array(json.dumps(SGD_KW)), refit_kw=np.array(json.dumps(REFIT_KW)),
        **{f"sgd_head/{k}": np.asarray(v) for k, v in _jhead(ds.y_train).items()},
        **_state_arrays("step_hidden_", step_inputs["h0"]),
        **_state_arrays("step_readout_", step_inputs["r0"]),
        **{f"deep_init/{k}": v for k, v in init.items()},
    )
    inp_path = d / "in.npz"
    np.savez(inp_path, **inp)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([os.path.join(REPO, "src"), REPO])}
    jenv = {**env, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
            "JAX_PLATFORMS": "cpu"}
    procs = {"reference": _popen(REFERENCE, [inp_path, d / "ref.npz"], jenv)}
    for shape in MESHES:
        port = _free_port()
        for rank in range(shape[0] * shape[1]):
            procs[(shape, rank)] = _popen(
                WORKER, [inp_path, d / f"port_{shape[0]}x{shape[1]}.npz", rank,
                         shape[0] * shape[1], port, shape[1]], env)
    logs = {}
    try:
        for key, p in procs.items():
            logs[key] = p.communicate(timeout=LAUNCH_TIMEOUT_S)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for key, p in procs.items():
        assert p.returncode == 0, f"{key} exited {p.returncode}:\n{logs[key]}"
    port = {
        shape: [dict(np.load(d / f"port_{shape[0]}x{shape[1]}_{r}.npz"))
                for r in range(shape[0] * shape[1])]
        for shape in MESHES
    }
    return dict(np.load(d / "ref.npz")), port


@pytest.fixture(scope="module")
def world1():
    """A gloo group of this one process, and its (1, 1) mesh."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the pipeline
@pytest.mark.parametrize("seed,epoch", [(0, 0), (0, 1), (3, 0), (7, 5)])
@pytest.mark.parametrize("drop_remainder", [True, False])
def test_epoch_batches_equal_the_reference(seed, epoch, drop_remainder):
    rng = np.random.default_rng(11)
    x, y = rng.random((103, 5)).astype(np.float32), rng.integers(0, 10, 103)
    got = list(epoch_batches(x, y, 16, epoch, seed=seed, drop_remainder=drop_remainder))
    want = list(jepoch_batches(x, y, 16, epoch, seed=seed, drop_remainder=drop_remainder))
    assert len(got) == len(want) == (6 if drop_remainder else 7)
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    assert all(b is None for _, b in epoch_batches(x, None, 16, epoch, seed=seed))


@pytest.mark.parametrize("seed,epoch,batch,seq", [(0, 0, 4, 8), (1, 2, 3, 5), (5, 1, 2, 16)])
def test_lm_batches_equal_the_reference(seed, epoch, batch, seq):
    tokens = np.random.default_rng(3).integers(0, 50, 200)
    got = list(lm_batches(tokens, batch, seq, epoch, seed=seed))
    want = list(jlm_batches(tokens, batch, seq, epoch, seed=seed))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            assert g[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


def test_host_mesh_holds_tensors_on_the_card_unless_asked(world1):
    """``make_host_mesh`` puts the ranks' tensors on their card by default
    and on the CPU only when the caller passes ``device_type="cpu"``."""
    assert world1.device_type == "cpu"
    if torch.cuda.is_available():
        assert make_host_mesh().device_type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            make_host_mesh()
    with pytest.raises(ValueError, match="want 'cuda' or 'cpu'"):
        make_host_mesh(device_type="tpu")


def test_sharded_batcher_gives_this_ranks_rows(world1):
    from repro_torch.data import ShardedBatcher

    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    got = ShardedBatcher(world1).global_batch(x)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), x)  # one rank holds every row


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_batcher_splits_the_batch_over_the_data_ranks(spawned, step_inputs, mesh):
    """Each rank holds the contiguous block of its data coordinate; ranks
    that differ only in their model coordinate hold the same rows."""
    per = STEP_B // mesh[0]
    for out in spawned[1][mesh]:
        d = int(out["batcher/data_rank"])
        np.testing.assert_array_equal(out["batcher/rows"], step_inputs["x"][d * per:(d + 1) * per])
    assert sorted(int(o["batcher/data_rank"]) for o in spawned[1][mesh]) == sorted(
        list(range(mesh[0])) * mesh[1])


# ---------------------------------------------------------- the cycle
def _random_marginals(rng, f, h):
    ci = (0.25 + 0.5 * rng.random(f)).astype(np.float32)
    cj = (0.05 + 0.1 * rng.random(h)).astype(np.float32)
    cij = (ci[:, None] * cj[None, :] * np.exp(rng.standard_normal((f, h)))).astype(np.float32)
    return ci, cj, cij


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("f,h", [(16, 32), (12, 10)])
def test_dp_learning_cycle_matches_the_reference(world1, masked, f, h):
    """The port's cycle (gloo, world 1) and the reduced-means plain version
    against the reference's ``dp_learning_cycle`` inside ``shard_map`` on a
    (1, 1) mesh."""
    rng = np.random.default_rng(f + h + masked)
    ci, cj, cij = _random_marginals(rng, f, h)
    ai = rng.random((24, f)).astype(np.float32)
    aj = rng.random((24, h)).astype(np.float32)
    mask = (rng.random((f, h)) < 0.5).astype(np.float32) if masked else None
    lam, k_b = 0.05, 0.7
    mesh = jax.make_mesh((1, 1), ("data", "model"))

    def local(ci_, cj_, cij_, ai_, aj_, *m):
        st, w, b = jdp_learning_cycle(jlearning.MarginalState(ci_, cj_, cij_), ai_, aj_, lam, k_b,
                                      ("data",), mask=m[0] if m else None)
        return (*st, w, b)

    args = [jnp.asarray(a) for a in (ci, cj, cij, ai, aj)] + ([jnp.asarray(mask)] if masked else [])
    want = shard_map(local, mesh=mesh, in_specs=tuple(P() for _ in args),
                     out_specs=tuple(P() for _ in range(5)), check_rep=False)(*args)
    t = [torch.from_numpy(a) for a in (ci, cj, cij, ai, aj)]
    tmask = None if mask is None else torch.from_numpy(mask)
    group = D._axis_groups(world1, ("data",))[0]
    st, w, b = D.dp_learning_cycle(MarginalState(*t[:3]), t[3], t[4], lam, k_b, group, 1,
                                   mask=tmask)
    plain = ref.bcpnn_update_means(t[3].mean(0), t[4].mean(0), t[3].T @ t[4] / 24, *t[:3], lam,
                                   k_b=k_b, mask=tmask)
    for got in ((*st, w, b), plain):
        for g, ww in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(ww), **CYCLE_TOL)


# -------------------------------------------------------- the layer steps
def _step_reference(step_inputs, layer_name, mesh_shape=None):
    """The reference's STEP_N steps: its shard_map trainer on an in-process
    mesh, or the single-device ``train_batch`` when ``mesh_shape`` is None."""
    si = step_inputs
    layer, st = (si["hidden"], si["h0"]) if layer_name == "hidden" else (si["readout"], si["r0"])
    args = (si["x"],) if layer_name == "hidden" else (si["h"], si["y"])
    args = [jnp.asarray(a) for a in args]
    if mesh_shape is None:
        for _ in range(STEP_N):
            st = jax.jit(layer.train_batch)(st, *args)[0]
        return st
    tr = JTrainer(jax.make_mesh(mesh_shape, ("data", "model")), mode="shard_map")
    step = tr.hidden_step(layer) if layer_name == "hidden" else tr.readout_step(layer)
    if layer_name == "hidden":  # its place_state fails on a readout's state (no plast)
        st = tr.place_state(layer, st)
    for _ in range(STEP_N):
        st = step(st, *args)
    return st


def _port_state(st):
    def t(a):
        return torch.tensor(np.asarray(a))

    plast = None if st.plast is None else PlasticityState(t(st.plast.hcu_mask))
    return LayerState(MarginalState(*(t(m) for m in st.marginals)), t(st.w), t(st.b), plast,
                      torch.zeros((), dtype=torch.int32))


@pytest.mark.parametrize("mode", ["shard_map", "pjit"])
@pytest.mark.parametrize("layer_name", ["hidden", "readout"])
def test_layer_steps_at_world_size_1(world1, step_inputs, mode, layer_name):
    """shard_map against the reference's shard_map trainer on a (1, 1)
    mesh; pjit against the reference's single-device steps."""
    si = step_inputs
    want = _step_reference(si, layer_name, (1, 1) if mode == "shard_map" else None)
    tr = DataParallelTrainer(world1, mode)
    if layer_name == "hidden":
        layer = StructuralPlasticityLayer(UnitLayout(*STEP_PRE), UnitLayout(*STEP_POST), fan_in=8,
                                          lam=0.05, init_jitter=1.0)
        step, st0, args = tr.hidden_step(layer), si["h0"], (si["x"],)
    else:
        layer = DenseLayer(UnitLayout(*STEP_POST), onehot_layout(10), lam=0.05)
        step, st0, args = tr.readout_step(layer), si["r0"], (si["h"], si["y"])
    st = tr.place_state(layer, _port_state(st0))
    D.reset_collectives()
    for _ in range(STEP_N):
        st = step(st, *(torch.from_numpy(np.asarray(a)) for a in args))
    st = tr.gather_state(layer, st)
    np.testing.assert_allclose(st.w.numpy(), np.asarray(want.w), **W_TOL)
    np.testing.assert_allclose(st.marginals.cij.numpy(), np.asarray(want.marginals.cij), **CIJ_TOL)
    assert int(st.step) == int(want.step) == STEP_N
    # One all-reduce a step: the means (shard_map) or the rows (pjit; the
    # readout's labels too), and the hidden shards' gather.
    per_step = 2 if (mode, layer_name) == ("pjit", "readout") else 1
    assert D.collective_counts()["all_reduce"] == STEP_N * per_step + (layer_name == "hidden")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layer_name", ["hidden", "readout"])
def test_layer_steps_at_4_ranks_match_the_reference_trainer(spawned, mesh, layer_name):
    ref_out, port = spawned
    key = f"{mesh[0]}x{mesh[1]}/{layer_name}"
    for rank, out in enumerate(port[mesh]):
        np.testing.assert_allclose(out[f"step/shard_map/{layer_name}/w"], ref_out[f"{key}/w"],
                                   err_msg=f"rank {rank}", **W_TOL)
        np.testing.assert_allclose(out[f"step/shard_map/{layer_name}/cij"],
                                   ref_out[f"{key}/cij"], err_msg=f"rank {rank}", **CIJ_TOL)
        # Every rank ends with the same global state, bit for bit.
        for k in ("w", "cij"):
            np.testing.assert_array_equal(out[f"step/shard_map/{layer_name}/{k}"],
                                          port[mesh][0][f"step/shard_map/{layer_name}/{k}"])


def test_pod_axis_joins_the_batch_axes(spawned):
    """On a (2, 2, 1) ("pod", "data", "model") mesh the batch is split over
    pod and data, row-major: the steps equal the reference trainer's on
    four data ranks."""
    ref_out, port = spawned
    outs = port[(4, 1)]
    assert [o["step/pod/batch"].tolist() for o in outs] == [[1, 4, r] for r in range(4)]
    for out in outs:
        np.testing.assert_allclose(out["step/pod/hidden/w"], ref_out["4x1/hidden/w"], **W_TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("layer_name", ["hidden", "readout"])
def test_pjit_steps_at_4_ranks_match_the_single_device_steps(spawned, step_inputs, mesh,
                                                            layer_name):
    want = _step_reference(step_inputs, layer_name)
    for out in spawned[1][mesh]:
        np.testing.assert_allclose(out[f"step/pjit/{layer_name}/w"], np.asarray(want.w), **W_TOL)
        np.testing.assert_allclose(out[f"step/pjit/{layer_name}/cij"],
                                   np.asarray(want.marginals.cij), **CIJ_TOL)


# -------------------------------------------------------- the compiled fit
@pytest.fixture(scope="module")
def single_device_fit(deep_data):
    ds, x, layout = deep_data
    c = _jdeep(layout).compile(JExecutionConfig())
    c.fit((x, ds.y_train), **DEEP_KW)
    return _jflat(c.state.layers)


def _assert_flat_close(got, want, name):
    for k, w in want.items():
        g = got[f"fit/{name}/{k}"]
        if k.endswith(("step", "hcu_mask")):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {k}")
        elif k.endswith("cij"):
            np.testing.assert_allclose(g, w, err_msg=f"{name} {k}", **CIJ_TOL)
        else:
            np.testing.assert_allclose(g, w, err_msg=f"{name} {k}", **W_TOL)


def test_batch_engine_uncached_shard_map_fit_matches_the_reference_shard_map_fit(spawned):
    ref_out, port = spawned
    want = {k[len("fit/"):]: v for k, v in ref_out.items() if k.startswith("fit/")}
    assert want
    for out in port[(4, 1)]:
        _assert_flat_close(out, want, "batch_uncached_shard_map")


@pytest.mark.parametrize("name", [n for n in DEEP_FITS if n != "batch_uncached_shard_map"])
def test_fit_matches_the_single_device_fit(spawned, single_device_fit, name):
    for out in spawned[1][(4, 1)]:
        _assert_flat_close(out, single_device_fit, name)
        np.testing.assert_array_equal(out[f"fit/{name}/layers/0/w"],
                                      spawned[1][(4, 1)][0][f"fit/{name}/layers/0/w"])


def test_fit_collectives_and_accuracy(spawned):
    """A shard_map fit all-reduces once a learning cycle, once a hidden
    phase for the hidden shards and twice a projected level (levels 1-3:
    the ranks' hit-or-miss flag, then the projection); pjit once a hidden
    batch and twice a readout batch (rows and labels).  Every rank reads
    the same accuracy."""
    batches, n_hidden = 256 // 64, len(DEEP_HIDDEN)
    cycles = (n_hidden + 1) * DEEP_KW["epochs_hidden"] * batches
    want = {
        "batch_uncached_shard_map": cycles + n_hidden,
        "scan_uncached_shard_map": cycles + n_hidden,
        "scan_cached_shard_map": cycles + 3 * n_hidden,
        "scan_cached_pjit": cycles + DEEP_KW["epochs_readout"] * batches + 3 * n_hidden,
        "batch_cached_pjit": cycles + DEEP_KW["epochs_readout"] * batches + 3 * n_hidden,
    }
    outs = spawned[1][(4, 1)]
    for name, n in want.items():
        assert [int(o[f"fit/{name}/collectives"]) for o in outs] == [n] * 4, name
        assert len({float(o[f"fit/{name}/accuracy"]) for o in outs}) == 1


def test_store_under_a_trainer_gives_the_one_device_level(spawned):
    """A collective projection of the training set (4 chunks over 4 batch
    ranks; two all-reduces: the hit-or-miss flag, then the level) equals
    the plain store's level bit for bit."""
    for out in spawned[1][(4, 1)]:
        assert bool(out["store/equal"])
        assert int(out["store/all_reduce"]) == 2


@pytest.fixture(scope="module")
def single_device_sgd_fit(deep_data):
    """The reference's single-device fit with the SGD readout: its head,
    scores on the training set."""
    ds, x, layout = deep_data
    c = _jdeep(layout).compile(JExecutionConfig())
    c.fit((x, ds.y_train), **DEEP_KW, **SGD_KW)
    return {"w": np.asarray(c.state.readout["w"]), "b": np.asarray(c.state.readout["b"]),
            "scores": np.asarray(c.predict(x))}


@pytest.mark.parametrize("against", ["reference", "port_single_device"])
def test_sgd_readout_under_a_trainer_matches_the_single_device_readout(
        spawned, single_device_sgd_fit, against):
    """The SGD readout fitted under a shard_map trainer (AdamW on the
    gradients averaged over the batch ranks), from the reference's initial
    states and head, against the reference's single-device SGD fit and
    against the port's single-device fit, on every rank."""
    for rank, out in enumerate(spawned[1][(4, 1)]):
        for k in ("w", "b", "scores"):
            want = (single_device_sgd_fit[k] if against == "reference"
                    else out[f"sgd_single/{k}"])
            np.testing.assert_allclose(out[f"sgd_trainer/{k}"], want,
                                       err_msg=f"rank {rank} {k}", **SGD_TOL)


def test_rank_local_level_does_not_serve_a_collective_projection(spawned, deep_data):
    """Rank 0 alone predicted on the training set between a hidden-only fit
    and a readout-only refit; a partial_fit follows.  The refit's
    collective projection is not served by rank 0's entry: every rank
    all-reduces as often as the others, ends with the same state bit for
    bit, and matches the reference's single-device calls."""
    ds, x, layout = deep_data
    jc = _jdeep(layout).compile(JExecutionConfig())
    for kw in REFIT_KW:
        jc.fit((x, ds.y_train), **kw)
    jc.partial_fit((x, ds.y_train), batch_size=64, readout="bcpnn")
    want = _jflat(jc.state.layers)
    outs = spawned[1][(4, 1)]
    assert len({int(o["refit/collectives"]) for o in outs}) == 1
    for out in outs:
        _assert_flat_close({f"fit/refit/{k}": out[f"refit/{k}"] for k in want}, want, "refit")
        for k in want:
            np.testing.assert_array_equal(out[f"refit/{k}"], outs[0][f"refit/{k}"])


def test_per_layer_epoch_schedule_matches_the_reference(deep_data):
    """The three-hidden-layer stack at ``epochs_hidden=[3, 2, 1]`` against
    the reference's fit (its test: ``tests/test_deep_networks.py::
    TestPhaseProgram::test_per_layer_epoch_schedule``)."""
    ds, x, layout = deep_data
    kw = dict(epochs_hidden=[3, 2, 1], epochs_readout=1, batch_size=64)
    jc = _jdeep(layout).compile(JExecutionConfig())
    init = _jflat(jc.state.layers)
    jc.fit((x, ds.y_train), **kw)
    want = _jflat(jc.state.layers)
    net = Network(seed=0)
    pre = UnitLayout(layout.n_hcu, layout.n_mcu)
    for (hcu, mcu), fan_in in zip(DEEP_HIDDEN, DEEP_FANIN):
        post = UnitLayout(hcu, mcu)
        net.add(StructuralPlasticityLayer(pre, post, fan_in=fan_in, lam=0.05, init_jitter=1.0,
                                          gain=4.0))
        pre = post
    net.add(DenseLayer(pre, onehot_layout(10), lam=0.05))
    c = net.compile(ExecutionConfig(device="cpu"))
    c.state = network_state_from_flat(init, c.layers)
    c.fit((x, ds.y_train), **kw)
    got = flat_from_network_state(c.state)
    assert [int(got[f"layers/{i}/step"]) for i in range(4)] == [12, 8, 4, 4]
    _assert_flat_close({f"fit/s/{k}": v for k, v in got.items()}, want, "s")


# ------------------------------------------------------------ the rewire
@pytest.mark.parametrize("shards", [2, 4])
def test_per_rank_rewire_equals_the_global_rewire(shards):
    """Each model rank scores and swaps its own hypercolumns from its own
    columns: the global rewire (the reference's ``update_mask``) restricted
    to them."""
    rng = np.random.default_rng(shards)
    pre, post = UnitLayout(6, 2), UnitLayout(4, 5)
    ci, cj, cij = _random_marginals(rng, pre.n_units, post.n_units)
    mask = np.zeros((pre.n_hcu, post.n_hcu), np.float32)
    for j in range(post.n_hcu):
        mask[rng.permutation(pre.n_hcu)[:3], j] = 1.0
    want = np.asarray(jplasticity.update_mask(
        jplasticity.PlasticityState(jnp.asarray(mask)),
        jlearning.MarginalState(jnp.asarray(ci), jnp.asarray(cj), jnp.asarray(cij)),
        JUnitLayout(6, 2), JUnitLayout(4, 5)).hcu_mask)
    layer = StructuralPlasticityLayer(pre, post, fan_in=3)
    got = []
    for r in range(shards):
        # Model rank r of `shards`: the trainer's placement and local layer
        # alone, without a process group.
        tr = DataParallelTrainer.__new__(DataParallelTrainer)
        tr.n_model, tr.model_rank, tr.model_group, tr._local = shards, r, object(), {}
        local = tr.local_layer(layer)
        st = tr.place_state(layer, LayerState(
            MarginalState(*(torch.from_numpy(a) for a in (ci, cj, cij))),
            torch.zeros(pre.n_units, post.n_units), torch.zeros(post.n_units),
            PlasticityState(torch.from_numpy(mask)), torch.zeros((), dtype=torch.int32)))
        assert local.spec.post == UnitLayout(4 // shards, 5)
        got.append(local.maybe_update_mask(st).plast.hcu_mask.numpy())
    np.testing.assert_array_equal(np.concatenate(got, axis=1), want)
    assert (want != mask).any()  # a rewire happened


# ------------------------------------------------------------ refusals
def test_refusals(world1, spawned):
    with pytest.raises(ValueError, match="mode must be shard_map"):
        DataParallelTrainer(world1, mode="pmap")
    from torch.distributed.device_mesh import DeviceMesh

    with pytest.raises(ValueError, match="no pod/data axis"):
        DataParallelTrainer(DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("model",)))
    with pytest.raises(ValueError, match="DataParallelTrainer"):
        ExecutionConfig(trainer="mesh")
    for rank_out in spawned[1][(2, 2)]:
        assert "n_hcu=3 not divisible by shards=2" in str(rank_out["refusal/split_hcu"])
    for rank_out in spawned[1][(4, 1)]:
        assert "batch_size=30 does not split over 4" in str(rank_out["refusal/batch"])


@pytest.mark.parametrize("option,config", [
    ("precision='bf20'", dict(precision="bf20")),
    ("state_format", dict(precision=PrecisionPolicy.named("fp32", state_format="bf16"))),
    ("fused_phase", dict(fused_phase=True)),
])
def test_shard_map_refuses_what_it_would_drop(world1, option, config):
    """The reference's shard_map step never reads the datapath, the state
    tier or the fused phase and trains them in f32; the port refuses them
    by name, and pjit mode takes them."""
    net = Network(seed=0)
    net.add(StructuralPlasticityLayer(UnitLayout(8, 2), UnitLayout(4, 8), fan_in=4))
    net.add(DenseLayer(UnitLayout(4, 8), onehot_layout(10)))
    with pytest.raises(ValueError, match="mode='pjit'") as e:
        net.compile(ExecutionConfig(device="cpu", trainer=DataParallelTrainer(world1), **config))
    assert option.split("=")[0] in str(e.value)
    compiled = net.compile(ExecutionConfig(device="cpu", trainer=DataParallelTrainer(world1, "pjit"),
                                           **config))
    assert compiled.plan.trainer.mode == "pjit"


def test_trainer_bound_after_steps_compiled_raises(world1):
    net = Network(seed=0)
    net.add(StructuralPlasticityLayer(UnitLayout(8, 2), UnitLayout(4, 8), fan_in=4))
    compiled = net.compile(ExecutionConfig(device="cpu", engine="batch"))
    compiled.plan.hidden_step(0)
    with pytest.raises(RuntimeError, match="already compiled steps"):
        DataParallelTrainer(world1).decorate(compiled.plan)


def test_pjit_fit_with_the_state_tier_matches_the_single_device_fit(world1, deep_data):
    """pjit mode runs the layer's own train_batch: the state tier's bf16
    traces come back as on one device."""
    ds, x, layout = deep_data
    pol = PrecisionPolicy.named("fp32", state_format="bf16")
    fits = []
    for trainer in (None, DataParallelTrainer(world1, "pjit")):
        net = Network(seed=0)
        net.add(StructuralPlasticityLayer(UnitLayout(layout.n_hcu, layout.n_mcu), UnitLayout(4, 4),
                                          fan_in=8, lam=0.05, init_jitter=1.0, gain=4.0))
        net.add(DenseLayer(UnitLayout(4, 4), onehot_layout(10), lam=0.05))
        c = net.compile(ExecutionConfig(device="cpu", precision=pol, trainer=trainer))
        c.fit((x, ds.y_train), **DEEP_KW)
        fits.append(c)
    for a, b in zip(fits[0].state.layers, fits[1].state.layers):
        assert a.marginals.cij.dtype == b.marginals.cij.dtype == torch.bfloat16
        torch.testing.assert_close(a.w, b.w, rtol=0, atol=0)
        torch.testing.assert_close(a.marginals.cij, b.marginals.cij, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["shard_map", "pjit"])
def test_strict_fits_and_partial_fit_under_a_trainer(world1, deep_data, mode):
    """Strict mode watches the trainer's epochs (one signature each over
    two fits), and a partial_fit after them equals the same calls on one
    device."""
    ds, x, layout = deep_data

    def net():
        n = Network(seed=0)
        n.add(StructuralPlasticityLayer(UnitLayout(layout.n_hcu, layout.n_mcu), UnitLayout(4, 8),
                                        fan_in=8, lam=0.05, init_jitter=1.0, gain=4.0))
        n.add(DenseLayer(UnitLayout(4, 8), onehot_layout(10), lam=0.05))
        return n

    fits = []
    for cfg in (dict(strict=True, trainer=DataParallelTrainer(world1, mode)), {}):
        c = net().compile(ExecutionConfig(device="cpu", **cfg))
        for _ in range(2):
            c.fit((x, ds.y_train), epochs_hidden=1, epochs_readout=1, batch_size=64)
        c.partial_fit((x, ds.y_train), batch_size=64, readout="bcpnn")
        fits.append(c)
    sizes = fits[0]._sentinel.sizes()
    assert sizes and all(v == 1 for v in sizes.values()), sizes
    for a, b in zip(fits[0].state.layers, fits[1].state.layers):
        np.testing.assert_allclose(a.w.numpy(), b.w.numpy(), **W_TOL)
        np.testing.assert_allclose(a.marginals.cij.numpy(), b.marginals.cij.numpy(), **CIJ_TOL)
        assert int(a.step) == int(b.step)
