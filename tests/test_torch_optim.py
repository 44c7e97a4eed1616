"""The port's optimizers against ``repro.optim``: several steps on the same
numpy params and gradients, every update, param, moment and step count
allclose at 1e-6 (the same f32 operations in the same order; ``pow`` and
``sqrt`` of the two libraries may differ in the last bit)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro_torch.optim import SGD, AdamW, apply_updates, tree_flatten, tree_map

TOL = dict(rtol=1e-6, atol=1e-6)
STEPS = 6


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((7, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    grads = [
        {k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-4, 1)).astype(np.float32)
         for k, v in params.items()}
        for _ in range(STEPS)
    ]
    return params, grads


def _close(port, ref, what):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), err_msg=what, **TOL)


def _run(opt, jopt, to_torch_lr=None):
    params, grads = _problem()
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    s, js = opt.init(p), jopt.init(jp)
    for i, g in enumerate(grads):
        u, s = opt.update({k: torch.from_numpy(v) for k, v in g.items()}, s, p)
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        p, jp = apply_updates(p, u), jadamw.apply_updates(jp, ju)
        for k in params:
            _close(u[k], ju[k], f"step {i} update {k}")
            _close(p[k], jp[k], f"step {i} param {k}")
        assert int(s.step) == int(js.step) == i + 1 and s.step.dtype == torch.int32
    return s, js


@pytest.mark.parametrize("kw", [
    dict(learning_rate=1e-3),
    dict(learning_rate=1e-3, weight_decay=1e-4),
    dict(learning_rate=0.05, b1=0.5, b2=0.9, eps=1e-6, weight_decay=0.1),
], ids=["plain", "readout", "custom"])
def test_adamw_matches(kw):
    s, js = _run(AdamW(**kw), jadamw.AdamW(**kw))
    for k in ("w", "b"):
        _close(s.mu[k], js.mu[k], f"mu {k}")
        _close(s.nu[k], js.nu[k], f"nu {k}")
        assert s.mu[k].dtype == s.nu[k].dtype == torch.float32


def test_adamw_schedule_matches():
    """A schedule gets the (device) step and returns the rate."""
    s, js = _run(
        AdamW(learning_rate=lambda step: 0.01 / step.to(torch.float32)),
        jadamw.AdamW(learning_rate=lambda step: 0.01 / step.astype(jnp.float32)),
    )
    _close(s.mu["w"], js.mu["w"], "mu")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(learning_rate=0.1, momentum=0.5, nesterov=True),
    dict(learning_rate=0.01, weight_decay=1e-3),
], ids=["default", "nesterov", "decay"])
def test_sgd_matches(kw):
    s, js = _run(SGD(**kw), jsgd.SGD(**kw))
    for k in ("w", "b"):
        _close(s.momentum[k], js.momentum[k], f"momentum {k}")


def test_trees_and_dtypes():
    """Updates take the params' structure and dtype; the moments stay f32."""
    p = {"head": [torch.ones(2, dtype=torch.bfloat16), torch.zeros(3)], "b": torch.ones(1)}
    leaves, rebuild = tree_flatten(p)
    assert len(leaves) == 3 and rebuild(leaves)["head"][1] is leaves[1]
    opt = AdamW(learning_rate=0.1, weight_decay=0.01)
    s = opt.init(p)
    u, s = opt.update(tree_map(torch.ones_like, p), s, p)
    assert u["head"][0].dtype == torch.bfloat16 and s.mu["head"][0].dtype == torch.float32
    new = apply_updates(p, u)
    assert new["head"][0].dtype == torch.bfloat16 and p["b"].item() == 1.0  # no in-place write
    torch.testing.assert_close(new["b"], torch.tensor([1.0 - 0.1 - 0.1 * 0.01]))
