"""Streaming sessions of the port (``repro_torch.core.streaming`` and
``CompiledNetwork.streaming``) against the JAX package's, from the same
carried-across initial state, plus the reference's own streaming contracts
(``tests/test_network_e2e.py::TestStreaming`` and
``tests/test_compile_api.py::TestStreamingViaCompile``) as tests of the
port.  The JAX side runs as its own tests run it on the CPU (the jnp
path); the port runs its kernels' plain versions (``device="cpu"``)."""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.store import path_key
from repro.core import ExecutionConfig as JExecutionConfig
from repro.core import Network as JNetwork
from repro.core import StructuralPlasticityLayer as JPlastic
from repro.core import UnitLayout as JUnitLayout
from repro.core.streaming import StreamingSession as JStreamingSession
from repro_torch.checkpoint import flat_from_network_state, network_state_from_flat
from repro_torch.core import ExecutionConfig, Network, StructuralPlasticityLayer, UnitLayout
from repro_torch.core.compiled import NetworkState
from repro_torch.core.streaming import StreamingSession
from repro_torch.data import complementary_code, mnist_like

# The reference tests' streaming layer: 32 features, 4x8 hidden.
HIDDEN = (4, 8)
LAYER_KW = dict(fan_in=16, lam=0.05, gain=4.0, init_jitter=1.0)
# Four EWMA steps of the same rule on the same inputs: f32 sums in another
# order, nothing more.
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


def _port_layer(layout):
    return StructuralPlasticityLayer(layout, UnitLayout(*HIDDEN), **LAYER_KW)


def _jax_layer(layout):
    return JPlastic(JUnitLayout(layout.n_hcu, layout.n_mcu), JUnitLayout(*HIDDEN), **LAYER_KW)


def _assert_states_match(port_state, jax_state):
    port = flat_from_network_state(NetworkState(layers=(port_state,)))
    want = _jflat([jax_state])
    assert sorted(port) == sorted(want)
    for k, v in want.items():
        if k.endswith("hcu_mask") or k.endswith("step"):
            np.testing.assert_array_equal(port[k], np.asarray(v), err_msg=k)
        else:
            np.testing.assert_allclose(port[k], np.asarray(v, np.float32), rtol=RTOL, atol=ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("max_batch,flushes", [(16, 4), (10, 7)])
def test_session_matches_jax_session(data, max_batch, flushes):
    """64 rows through both sessions from one init: ``max_batch=16`` is 4
    full flushes; ``max_batch=10`` leaves 4 rows to the flush at close and
    crosses a second rewiring (every 4 batches here)."""
    _, x, layout = data
    jlayer = _jax_layer(layout)
    jstate = jlayer.init(jax.random.PRNGKey(0))
    layer = _port_layer(layout)
    state = network_state_from_flat(_jflat([jstate]), [layer]).layers[0]
    jsess = JStreamingSession(jlayer, jstate, max_batch=max_batch)
    sess = StreamingSession(layer, state, max_batch=max_batch)
    for row in x[:64]:
        jsess.feed(row)
        sess.feed(row)
    got, want = sess.close(), jsess.close()
    assert sess.flushes == jsess.flushes == flushes
    assert sess.stats["samples_seen"] == 64
    assert got.host_step == flushes
    _assert_states_match(got, want)
    np.testing.assert_allclose(sess.infer(x[3]), np.asarray(jsess.infer(x[3])), rtol=RTOL,
                               atol=ATOL)


def test_compiled_streaming_adopts_like_jax(data):
    """``compiled.streaming`` from one carried init on both sides: the
    adopted layer states agree, and the port's adoption frees the stale
    cached levels above the layer at once."""
    ds, x, layout = data
    jnet = JNetwork(seed=0).add(_jax_layer(layout))
    jc = jnet.compile(JExecutionConfig())
    pc = Network(seed=0).add(_port_layer(layout)).compile(ExecutionConfig(device="cpu"))
    pc.state = network_state_from_flat(_jflat(jc.state.layers), pc.layers)
    pc.predict(x)  # caches level 1 of x
    assert pc.activations.resident(1, x) == "device"
    jsess, sess = jc.streaming(max_batch=16), pc.streaming(max_batch=16)
    assert sess.state is not pc.state.layers[0]  # the session trains a copy
    for row in x[:64]:
        jsess.feed(row)
        sess.feed(row)
    jsess.close()
    st = sess.close()
    assert sess.flushes == 4
    assert pc.state.layers[0] is st
    assert pc.activations.resident(1, x) is None  # dropped at the adoption
    _assert_states_match(pc.state.layers[0], jc.state.layers[0])
    np.testing.assert_allclose(pc.predict(x).numpy(), np.asarray(jc.predict(x)), rtol=RTOL,
                               atol=ATOL)


class TestStreaming:
    """``tests/test_network_e2e.py::TestStreaming`` on the port."""

    def test_streaming_equals_batched(self, data):
        _, x, layout = data
        layer = _port_layer(layout)
        st0 = layer.init(torch.Generator().manual_seed(0))
        st_b = st0
        for i in range(0, 64, 16):
            st_b, _ = layer.train_batch(st_b, torch.from_numpy(x[i : i + 16]))
        sess = StreamingSession(layer, st0, max_batch=16)
        for row in x[:64]:
            sess.feed(row)
        st_s = sess.close()
        torch.testing.assert_close(st_s.w, st_b.w, rtol=1e-5, atol=1e-6)
        assert sess.flushes == 4

    def test_single_sample_inference(self, data):
        _, x, layout = data
        layer = _port_layer(layout)
        sess = StreamingSession(layer, layer.init(torch.Generator().manual_seed(0)))
        out = sess.infer(x[0])
        assert isinstance(out, np.ndarray) and out.shape == (32,)
        np.testing.assert_allclose(out.reshape(*HIDDEN).sum(-1), 1.0, rtol=1e-5)

    def test_closed_session_refuses_feed(self, data):
        _, x, layout = data
        layer = _port_layer(layout)
        sess = StreamingSession(layer, layer.init(torch.Generator().manual_seed(0)))
        st = sess.close()
        assert sess.close() is st  # idempotent
        with pytest.raises(RuntimeError, match="closed"):
            sess.feed(x[0])


class TestStreamingViaCompile:
    """``tests/test_compile_api.py::TestStreamingViaCompile`` on the port."""

    @staticmethod
    def _compiled(layout):
        return Network(seed=0).add(_port_layer(layout)).compile(ExecutionConfig(device="cpu"))

    def test_sessions_share_cells_and_adopt_state(self, data):
        _, x, layout = data
        compiled = self._compiled(layout)
        s1 = compiled.streaming(max_batch=16)
        s2 = compiled.streaming(max_batch=8)
        for row in x[:32]:
            s1.feed(row)
        for row in x[32:48]:
            s2.feed(row)
        assert compiled._stream_train_cells  # populated by the sessions
        assert s1._train_cells is s2._train_cells
        st = s1.close()
        assert compiled.state.layers[0] is st  # adopted on close

    def test_compiled_cell_cache_is_shape_bounded(self, data):
        _, x, layout = data
        compiled = self._compiled(layout)
        sess = compiled.streaming(max_batch=64, cache_size=3)
        for b in (1, 2, 3, 4, 5):
            for row in x[:b]:
                sess.feed(row)
            sess.flush()
        lru = compiled._stream_train_cells[0]
        assert len(lru) <= 3 and lru.evictions >= 2
        # A second session with a seen size gets the SAME cell object.
        sess2 = compiled.streaming(max_batch=64, cache_size=3)
        for row in x[:5]:
            sess2.feed(row)
        sess2.flush()
        assert sess2._train_cells.get(5) is lru.get(5)

    def test_lru_bounds_cell_cache(self, data):
        _, x, layout = data
        layer = _port_layer(layout)
        sess = StreamingSession(
            layer, layer.init(torch.Generator().manual_seed(0)), max_batch=64, cache_size=3
        )
        for b in (1, 2, 3, 4, 5, 6, 1, 2):  # 6 distinct sizes, cap 3
            for row in x[:b]:
                sess.feed(row)
            sess.flush()
        stats = sess.stats
        assert stats["train_cache_size"] <= 3
        assert stats["cache_capacity"] == 3
        assert stats["cache_evictions"] >= 3
        assert stats["flushes"] == 8
        assert stats["samples_seen"] == 1 + 2 + 3 + 4 + 5 + 6 + 1 + 2

    def test_close_warns_when_the_layer_trained_meanwhile(self, data):
        ds, x, layout = data
        compiled = self._compiled(layout)
        s1 = compiled.streaming(max_batch=8)
        for row in x[:8]:
            s1.feed(row)
        compiled.partial_fit((x[:32], None), batch_size=16)  # the layer moves on
        with pytest.warns(RuntimeWarning, match="trained elsewhere"):
            st = s1.close()
        assert compiled.state.layers[0] is st
        # No conflict, no warning.
        s2 = compiled.streaming(max_batch=8)
        for row in x[:8]:
            s2.feed(row)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            s2.close()

    def test_streaming_advances_the_host_step_as_fit_does(self, data):
        """Rewiring is decided on ``host_step``: a flush advances it and the
        device step together, so a session rewires on the fit schedule."""
        _, x, layout = data
        compiled = self._compiled(layout)
        start = compiled.state.layers[0]
        sess = compiled.streaming(max_batch=8)
        for row in x[:40]:
            sess.feed(row)
        st = sess.close()
        want = start
        for i in range(0, 40, 8):
            want, _ = compiled.layers[0].train_batch(want, torch.from_numpy(x[i : i + 8]))
        assert st.host_step == int(st.step) == want.host_step == 5
        assert torch.equal(st.plast.hcu_mask, want.plast.hcu_mask)
        torch.testing.assert_close(st.w, want.w, rtol=0, atol=0)
