"""The port's core modules (units, learning, plasticity, layers) against
the JAX package's, on the same numpy inputs.  Layer tests start from
JAX-initialised states carried across by ``network_state_from_flat``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import path_key
from repro.core import layers as jlayers
from repro.core import learning as jlearning
from repro.core import plasticity as jplast
from repro.core import units as junits
from repro_torch.checkpoint import flat_from_network_state, network_state_from_flat
from repro_torch.core import layers, learning, plasticity, units
from repro_torch.core.compiled import NetworkState

RTOL, ATOL = 1e-5, 1e-6
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5


def _jflat(layer_states):
    tree = {"layers": {str(i): s for i, s in enumerate(layer_states)}}
    return {
        path_key(p): np.asarray(leaf)
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _assert_flat_close(port: dict, want: dict, rtol=FIT_RTOL, atol=FIT_ATOL):
    assert sorted(port) == sorted(want)
    for k in want:
        np.testing.assert_allclose(port[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _marginals(rng, n_pre, n_post):
    return (
        (rng.random(n_pre) * 0.5 + 0.05).astype(np.float32),
        (rng.random(n_post) * 0.5 + 0.05).astype(np.float32),
        (rng.random((n_pre, n_post)) * 0.2 + 0.01).astype(np.float32),
    )


# ------------------------------------------------------------------ units
def test_units_match():
    lay, jlay = units.UnitLayout(3, 5), junits.UnitLayout(3, 5)
    x = np.arange(2 * 15, dtype=np.float32).reshape(2, 15)
    np.testing.assert_array_equal(lay.blocked(torch.from_numpy(x)).numpy(), jlay.blocked(x))
    np.testing.assert_array_equal(
        lay.flat(lay.blocked(torch.from_numpy(x))).numpy(), x
    )
    np.testing.assert_array_equal(lay.hcu_index().numpy(), np.asarray(jlay.hcu_index()))
    assert units.complementary_layout(7) == units.UnitLayout(7, 2)
    assert units.onehot_layout(10).shape == junits.onehot_layout(10).shape == (1, 10)
    with pytest.raises(ValueError):
        units.UnitLayout(0, 3)
    with pytest.raises(ValueError):
        lay.validate_divisible_by(2)


# --------------------------------------------------------------- learning
def test_learning_functions_match():
    rng = np.random.default_rng(0)
    pre, post = units.UnitLayout(6, 2), units.UnitLayout(3, 4)
    jpre, jpost = junits.UnitLayout(6, 2), junits.UnitLayout(3, 4)
    ci, cj, cij = _marginals(rng, 12, 12)
    ai = rng.random((9, 12)).astype(np.float32)
    aj = rng.random((9, 12)).astype(np.float32)
    mask = (rng.random((12, 12)) > 0.5).astype(np.float32)
    w = (rng.standard_normal((12, 12)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(12) * 0.3).astype(np.float32)
    T = torch.from_numpy
    state = learning.MarginalState(T(ci), T(cj), T(cij))
    jstate = jlearning.MarginalState(jnp.asarray(ci), jnp.asarray(cj), jnp.asarray(cij))

    def close(a, b):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=ATOL)

    init = learning.init_marginals(12, 12, pre, post)
    jinit = jlearning.init_marginals(12, 12, jpre, jpost)
    for a, b_ in zip(init, jinit):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
    for a, b_ in zip(learning.batch_means(T(ai), T(aj)), jlearning.batch_means(ai, aj)):
        close(a, b_)
    for a, b_ in zip(
        learning.update_marginals(state, *learning.batch_means(T(ai), T(aj)), 0.1),
        jlearning.update_marginals(jstate, *jlearning.batch_means(ai, aj), 0.1),
    ):
        close(a, b_)
    for a, b_ in zip(
        learning.weights_from_marginals(state, 0.5),
        jlearning.weights_from_marginals(jstate, 0.5),
    ):
        close(a, b_)
    new, w_n, b_n = learning.learning_cycle(state, T(ai), T(aj), 0.1, 0.5, mask=T(mask))
    jnew, jw, jb = jlearning.learning_cycle(jstate, ai, aj, 0.1, 0.5, mask=jnp.asarray(mask))
    for a, b_ in zip((*new, w_n, b_n), (*jnew, jw, jb)):
        close(a, b_)
    close(learning.hcu_softmax(T(w[:9]), post), jlearning.hcu_softmax(w[:9], jpost))
    close(
        learning.forward(T(ai), T(w), T(b), post, mask=T(mask), gain=4.0),
        jlearning.forward(ai, w, b, jpost, mask=jnp.asarray(mask), gain=4.0),
    )


def test_init_jitter_is_seeded_and_lognormal():
    pre, post = units.UnitLayout(4, 2), units.UnitLayout(2, 4)
    a = learning.init_marginals(8, 8, pre, post, generator=torch.Generator().manual_seed(3), jitter=1.0)
    b = learning.init_marginals(8, 8, pre, post, generator=torch.Generator().manual_seed(3), jitter=1.0)
    assert torch.equal(a.cij, b.cij)
    eta = torch.log(a.cij / (0.5 * 0.25))
    assert 0.5 < float(eta.std()) < 1.5  # ~N(0, jitter^2)


# ------------------------------------------------------------- plasticity
def _plast_problem(seed, n_pre_hcu=6, n_post_hcu=3, pre_mcu=2, post_mcu=4, fan_in=3):
    rng = np.random.default_rng(seed)
    n_pre, n_post = n_pre_hcu * pre_mcu, n_post_hcu * post_mcu
    ci, cj, cij = _marginals(rng, n_pre, n_post)
    cols = [rng.permutation(n_pre_hcu) < fan_in for _ in range(n_post_hcu)]
    hcu_mask = np.stack(cols).T.astype(np.float32)
    return (
        units.UnitLayout(n_pre_hcu, pre_mcu), units.UnitLayout(n_post_hcu, post_mcu),
        junits.UnitLayout(n_pre_hcu, pre_mcu), junits.UnitLayout(n_post_hcu, post_mcu),
        (ci, cj, cij), hcu_mask,
    )


@pytest.mark.parametrize("seed", range(4))
def test_update_mask_matches_jax(seed):
    """Equal masks, equal MI scores, and fan-in preserved, on random states
    whose scores are not near ties."""
    pre, post, jpre, jpost, (ci, cj, cij), hcu_mask = _plast_problem(seed)
    T = torch.from_numpy
    marg = learning.MarginalState(T(ci), T(cj), T(cij))
    jmarg = jlearning.MarginalState(jnp.asarray(ci), jnp.asarray(cj), jnp.asarray(cij))
    scores = plasticity.mi_scores(marg, pre, post)
    jscores = np.asarray(jplast.mi_scores(jmarg, jpre, jpost))
    np.testing.assert_allclose(scores.numpy(), jscores, rtol=RTOL, atol=ATOL)
    gaps = np.diff(np.sort(jscores, axis=0), axis=0)
    assert gaps.min() > 1e-4, "problem has near-ties; pick another seed"
    plast = plasticity.PlasticityState(T(hcu_mask))
    jplast_state = jplast.PlasticityState(jnp.asarray(hcu_mask))
    for n_swaps in (1, 2):
        new = plasticity.update_mask(plast, marg, pre, post, n_swaps=n_swaps)
        jnew = jplast.update_mask(jplast_state, jmarg, jpre, jpost, n_swaps=n_swaps)
        np.testing.assert_array_equal(new.hcu_mask.numpy(), np.asarray(jnew.hcu_mask))
        np.testing.assert_array_equal(
            plasticity.fan_in(new).numpy(), plasticity.fan_in(plast).numpy()
        )
    assert torch.equal(plast.hcu_mask, T(hcu_mask)), "update_mask mutated its input"
    np.testing.assert_array_equal(
        plast.unit_mask(pre, post).numpy(), np.asarray(jplast_state.unit_mask(jpre, jpost))
    )


def test_update_mask_breaks_ties_at_the_first_index():
    """Input HCUs 0/1 (active) tie for the weakest score and 2/3 (silent)
    tie for the strongest: both packages pick the first of each tie."""
    pre, post = units.UnitLayout(4, 2), units.UnitLayout(1, 2)
    jpre, jpost = junits.UnitLayout(4, 2), junits.UnitLayout(1, 2)
    ci = np.full(8, 0.5, np.float32)
    cj = np.full(2, 0.5, np.float32)
    row_weak = np.array([0.26, 0.24], np.float32)   # MI > 0, small
    row_strong = np.array([0.40, 0.10], np.float32)  # MI larger
    cij = np.stack([row_weak] * 4 + [row_strong] * 4).astype(np.float32)
    hcu_mask = np.array([[1.0], [1.0], [0.0], [0.0]], np.float32)
    new = plasticity.update_mask(
        plasticity.PlasticityState(torch.from_numpy(hcu_mask)),
        learning.MarginalState(*map(torch.from_numpy, (ci, cj, cij))), pre, post,
    )
    jnew = jplast.update_mask(
        jplast.PlasticityState(jnp.asarray(hcu_mask)),
        jlearning.MarginalState(jnp.asarray(ci), jnp.asarray(cj), jnp.asarray(cij)),
        jpre, jpost,
    )
    want = np.array([[0.0], [1.0], [1.0], [0.0]], np.float32)
    np.testing.assert_array_equal(np.asarray(jnew.hcu_mask), want)
    np.testing.assert_array_equal(new.hcu_mask.numpy(), want)
    scores = plasticity.mi_scores(
        learning.MarginalState(*map(torch.from_numpy, (ci, cj, cij))), pre, post
    )[:, 0]
    assert scores[0] == scores[1] and scores[2] == scores[3] and scores[2] > scores[0]


def test_random_mask_fan_in_and_full_mask():
    pre, post = units.UnitLayout(10, 2), units.UnitLayout(4, 3)
    m = plasticity.init_random_mask(torch.Generator().manual_seed(0), pre, post, fan_in=3)
    assert m.hcu_mask.shape == (10, 4)
    assert torch.equal(plasticity.fan_in(m), torch.full((4,), 3.0))
    assert torch.equal(plasticity.full_mask(pre, post).hcu_mask, torch.ones(10, 4))
    with pytest.raises(ValueError):
        plasticity.init_random_mask(torch.Generator(), pre, post, fan_in=11)


# ----------------------------------------------------------------- layers
def _layer_pair(mask_update_every=None):
    """Matching hidden + readout layers of both packages, the JAX ones on
    their pure-jnp path (the kernels are held against each other in
    test_torch_kernels.py), with the JAX init carried across."""
    kw = dict(fan_in=4, lam=0.05, gain=4.0, init_jitter=1.0,
              mask_update_every=mask_update_every)
    jh = jlayers.StructuralPlasticityLayer(
        junits.UnitLayout(8, 2), junits.UnitLayout(3, 5), **kw
    )
    jd = jlayers.DenseLayer(
        junits.UnitLayout(3, 5), junits.onehot_layout(4), lam=0.05
    )
    th = layers.StructuralPlasticityLayer(units.UnitLayout(8, 2), units.UnitLayout(3, 5), **kw)
    td = layers.DenseLayer(units.UnitLayout(3, 5), units.onehot_layout(4), lam=0.05)
    keys = jax.random.split(jax.random.PRNGKey(1), 2)
    jstates = [jh.init(keys[0]), jd.init(keys[1])]
    tstates = list(network_state_from_flat(_jflat(jstates), [th, td]).layers)
    return (jh, jd), (th, td), jstates, tstates


def test_layer_forward_and_train_batch_match_jax():
    (jh, jd), (th, td), (jsh, jsd), (tsh, tsd) = _layer_pair()
    j_forward, j_hidden, j_dense = (
        jax.jit(jh.forward), jax.jit(jh.train_batch), jax.jit(jd.train_batch)
    )
    rng = np.random.default_rng(5)
    y = rng.integers(0, 4, size=(4, 12)).astype(np.int32)
    for i in range(4):
        xb = rng.random((12, 16)).astype(np.float32)
        np.testing.assert_allclose(
            th.forward(tsh, torch.from_numpy(xb)).numpy(),
            np.asarray(j_forward(jsh, jnp.asarray(xb))), rtol=FIT_RTOL, atol=FIT_ATOL,
        )
        tsh, taj = th.train_batch(tsh, torch.from_numpy(xb))
        jsh, jaj = j_hidden(jsh, jnp.asarray(xb))
        np.testing.assert_allclose(taj.numpy(), np.asarray(jaj), rtol=FIT_RTOL, atol=FIT_ATOL)
        tsd, _ = td.train_batch(tsd, taj, torch.from_numpy(y[i]))
        jsd, _ = j_dense(jsd, jaj, jnp.asarray(y[i]))
    assert tsh.host_step == int(tsh.step) == 4
    _assert_flat_close(
        flat_from_network_state(NetworkState((tsh, tsd))), _jflat([jsh, jsd])
    )


def test_maybe_update_mask_rewires_on_the_same_batches_as_jax():
    (jh, _), (th, _), (jsh, _), (tsh, _) = _layer_pair(mask_update_every=2)
    j_rewire, j_train = jax.jit(jh.maybe_update_mask), jax.jit(jh.train_batch)
    rng = np.random.default_rng(11)
    changed, jchanged = [], []
    for _ in range(9):
        xb = rng.random((16, 16)).astype(np.float32)
        before, jbefore = tsh.plast, jsh.plast
        rewired = th.maybe_update_mask(tsh)
        jrewired = j_rewire(jsh)
        changed.append(rewired.plast is not before)
        jchanged.append(not np.array_equal(jrewired.plast.hcu_mask, jbefore.hcu_mask))
        np.testing.assert_array_equal(
            rewired.plast.hcu_mask.numpy(), np.asarray(jrewired.plast.hcu_mask)
        )
        tsh, _ = th.train_batch(tsh, torch.from_numpy(xb))
        jsh, _ = j_train(jsh, jnp.asarray(xb))
    # Rewiring runs exactly at host steps 0, 2, 4, ... and swaps whenever a
    # silent input scores higher, as it does in the reference.
    assert changed == [s % 2 == 0 for s in range(9)]
    assert all(j <= c for j, c in zip(jchanged, changed)) and any(jchanged)


def test_maybe_update_mask_never_reads_the_device_step():
    (_, _), (th, _), _, (tsh, _) = _layer_pair(mask_update_every=3)
    # A step tensor on the meta device cannot be read; the decision must
    # come from the host mirror alone.
    state = tsh._replace(step=torch.empty((), dtype=torch.int32, device="meta"), host_step=1)
    assert th.maybe_update_mask(state) is state
    rewired = th.maybe_update_mask(state._replace(host_step=3))
    assert rewired.plast is not state.plast


def test_dense_layer_one_hot_targets():
    (_, jd), (_, td), (_, jsd), (_, tsd) = _layer_pair()
    h = np.random.default_rng(2).random((6, 15)).astype(np.float32)
    y = np.array([0, 1, 2, 3, 0, 1], np.int32)
    new, aj = td.train_batch(tsd, torch.from_numpy(h), torch.from_numpy(y))
    jnew, jaj = jd.train_batch(jsd, jnp.asarray(h), jnp.asarray(y))
    np.testing.assert_array_equal(aj.numpy(), np.asarray(jaj))
    np.testing.assert_allclose(new.w.numpy(), np.asarray(jnew.w), rtol=RTOL, atol=ATOL)
    assert new.plast is None and tsd.host_step == 0 and new.host_step == 1
