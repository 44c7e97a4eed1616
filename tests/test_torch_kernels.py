"""The port's kernel layer against the JAX package's.

On CPU tensors ``repro_torch.kernels.ops`` runs each kernel's plain
version; it is held against JAX's ``ops`` (the Pallas kernels, in interpret
mode off the TPU) and JAX's pure-jnp oracles (``repro/kernels/ref.py``) on
the same numpy inputs, over the shape sweep of ``test_fused_phase.py`` plus
the paper's n_mcu=100 and n_mcu=10.  The Hopper kernels themselves run only
on a card: ``test_torch_cuda.py`` holds them against these plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.learning import MarginalState as JMarginalState
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.learning import MarginalState
from repro_torch.kernels import _build, ops, ref

# (B, F, n_hcu, n_mcu): tile-aligned, everything-prime, H-tile-splitting,
# multi-tile, batch > one chunk, then the MNIST hidden (100 MCUs) and
# readout (10 MCUs) hypercolumn widths.
SHAPES = [
    (32, 64, 4, 16),
    (13, 17, 3, 7),
    (64, 200, 2, 129),
    (130, 300, 20, 16),
    (257, 140, 2, 70),
    (40, 96, 3, 100),
    (48, 300, 1, 10),
]
RTOL, ATOL = 1e-5, 1e-6


def _problem(B, F, n_hcu, n_mcu, use_mask, seed=7):
    rng = np.random.default_rng(seed)
    H = n_hcu * n_mcu
    arrs = dict(
        x=rng.random((B, F)).astype(np.float32),
        aj=rng.random((B, H)).astype(np.float32),
        w=(rng.standard_normal((F, H)) * 0.1).astype(np.float32),
        b=(rng.standard_normal(H) * 0.1).astype(np.float32),
        s=(rng.standard_normal((B, H)) * 4.0).astype(np.float32),
        ci=(rng.random(F) * 0.5 + 0.25).astype(np.float32),
        cj=(rng.random(H) * 0.5 + 0.25).astype(np.float32),
        cij=(rng.random((F, H)) * 0.25 + 0.1).astype(np.float32),
        mask=(rng.random((F, H)) > 0.3).astype(np.float32) if use_mask else None,
    )
    return arrs


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(port, *refs):
    for r in refs:
        np.testing.assert_allclose(port.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_masked_matmul_matches_jax(shape, use_mask):
    p = _problem(*shape, use_mask)
    out = ops.masked_matmul(_t(p["x"]), _t(p["w"]), _t(p["b"]), mask=_t(p["mask"]))
    _close(
        out,
        jops.masked_matmul(_j(p["x"]), _j(p["w"]), _j(p["b"]), mask=_j(p["mask"])),
        jref.masked_matmul(_j(p["x"]), _j(p["w"]), _j(p["b"]), mask=_j(p["mask"])),
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_hcu_softmax_matches_jax(shape):
    _, _, n_hcu, n_mcu = shape
    p = _problem(*shape, use_mask=False)
    out = ops.hcu_softmax(_t(p["s"]), n_hcu, n_mcu)
    _close(
        out,
        jops.hcu_softmax(_j(p["s"]), n_hcu, n_mcu),
        jref.hcu_softmax(_j(p["s"]), n_hcu, n_mcu),
    )


@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_bcpnn_update_matches_jax(shape, use_mask):
    p = _problem(*shape, use_mask)
    lam, k_b = 0.05, 0.7
    marg = MarginalState(_t(p["ci"]), _t(p["cj"]), _t(p["cij"]))
    new, w, bias = ops.bcpnn_update(
        marg, _t(p["x"]), _t(p["aj"]), lam=lam, k_b=k_b, mask=_t(p["mask"])
    )
    jmarg = JMarginalState(_j(p["ci"]), _j(p["cj"]), _j(p["cij"]))
    jnew, jw, jbias = jops.bcpnn_update(
        jmarg, _j(p["x"]), _j(p["aj"]), lam=lam, k_b=k_b, mask=_j(p["mask"])
    )
    r = jref.bcpnn_update(
        _j(p["x"]), _j(p["aj"]), _j(p["ci"]), _j(p["cj"]), _j(p["cij"]), lam,
        k_b=k_b, mask=_j(p["mask"]),
    )
    for port, via_ops, oracle in zip(
        (new.ci, new.cj, new.cij, w, bias),
        (jnew.ci, jnew.cj, jnew.cij, jw, jbias),
        r,
    ):
        _close(port, via_ops, oracle)


def test_plain_versions_return_fresh_tensors():
    """States are replaced, never mutated: no output aliases an input."""
    p = _problem(13, 17, 3, 7, use_mask=True)
    inputs = [_t(p[k]) for k in ("x", "aj", "ci", "cj", "cij", "mask")]
    before = [t.clone() for t in inputs]
    outs = ops.bcpnn_update(
        MarginalState(*inputs[2:5]), inputs[0], inputs[1], lam=0.1, mask=inputs[5]
    )
    flat_outs = [*outs[0], outs[1], outs[2]]
    for t, b in zip(inputs, before):
        assert torch.equal(t, b)
        assert all(o.data_ptr() != t.data_ptr() for o in flat_outs)


@pytest.mark.parametrize("kernel", ["masked_matmul", "hcu_softmax", "bcpnn_update"])
def test_non_cpu_tensors_never_reach_the_plain_version(kernel, monkeypatch):
    """A tensor off the CPU goes to the kernel or raises; it never falls
    back to the plain version (meta tensors stand in for a device here)."""
    def boom(*a, **k):
        raise AssertionError("plain version reached with a non-CPU tensor")

    monkeypatch.setattr(ref, kernel, boom)
    meta = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        if kernel == "masked_matmul":
            ops.masked_matmul(meta(4, 6), meta(6, 8), meta(8))
        elif kernel == "hcu_softmax":
            ops.hcu_softmax(meta(4, 8), 2, 4)
        else:
            ops.bcpnn_update(
                MarginalState(meta(6), meta(8), meta(6, 8)), meta(4, 6), meta(4, 8), lam=0.1
            )


def test_mixed_devices_raise():
    with pytest.raises(ValueError, match="several devices"):
        ops.masked_matmul(torch.ones(2, 3), torch.empty(3, 4, device="meta"), None)


def test_cuda_tensor_without_card_raises():
    """Off the card a CUDA tensor cannot even be made; nothing in the
    kernel layer can turn that into a quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        ops.hcu_softmax(torch.zeros(2, 4, device="cuda"), 1, 4)


def test_state_format_not_ported():
    marg = MarginalState(torch.ones(3), torch.ones(2), torch.ones(3, 2))
    with pytest.raises(NotImplementedError, match="state_format"):
        ops.bcpnn_update(marg, torch.ones(1, 3), torch.ones(1, 2), lam=0.1, state_format="bf16")


def test_importing_builds_nothing():
    assert _build._libs == {}
    assert set(_build.SOURCES) == {"masked_matmul", "hcu_softmax", "bcpnn_update"}
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
