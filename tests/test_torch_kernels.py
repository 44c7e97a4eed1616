"""The port's kernel layer against the JAX package's.

On CPU tensors ``repro_torch.kernels.ops`` runs each kernel's plain
version; it is held against JAX's ``ops`` (the Pallas kernels, in interpret
mode off the TPU) and JAX's pure-jnp oracles (``repro/kernels/ref.py``) on
the same numpy inputs, over the shape sweep of ``test_fused_phase.py`` plus
the paper's n_mcu=100 and n_mcu=10.  The Hopper kernels themselves run only
on a card: ``test_torch_cuda.py`` holds them against these plain versions.

The quantized state tier rounds the traces to m mantissa bits.  The two
packages sum in different orders, so a trace that lies next to a rounding
boundary may land one ulp of the format apart: traces are compared at
rtol 2^-m, and w/bias (logs of the traces) at atol 2^-(m-1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ml_dtypes

from repro.core import UnitLayout as JUnitLayout
from repro.core.learning import MarginalState as JMarginalState
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import UnitLayout
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
# bcpnn_phase: (13,17,3,7), (64,200,2,129), (130,300,20,16), (40,96,3,100).
PHASE_SHAPES = [SHAPES[i] for i in (1, 2, 3, 5)]
PHASE_TOL = dict(rtol=1e-4, atol=1e-5)  # a_j, w, bias (test_fused_phase.py)
CIJ_TOL = dict(rtol=1e-5, atol=1e-7)
STATE_FORMATS = {"bf16": 7, "bf20": 11}


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


def _state_close(port, want, mant, what):
    """Traces within one ulp of the format; also equal dtype family."""
    want = np.asarray(want)
    assert port.dtype == (torch.bfloat16 if want.dtype == ml_dtypes.bfloat16 else torch.float32), what
    np.testing.assert_allclose(
        port.float().numpy(), want.astype(np.float32), rtol=2.0**-mant, atol=0, err_msg=what
    )


def _phase(p, shape, state_format=None):
    _, _, n_hcu, n_mcu = shape
    lam, k_b, gain = 0.05, 0.7, 1.3
    marg = MarginalState(_t(p["ci"]), _t(p["cj"]), _t(p["cij"]))
    port = ops.bcpnn_phase(
        marg, _t(p["x"]), _t(p["w"]), _t(p["b"]), UnitLayout(n_hcu, n_mcu), lam, k_b=k_b,
        gain=gain, mask=_t(p["mask"]), state_format=state_format,
    )
    jmarg = JMarginalState(_j(p["ci"]), _j(p["cj"]), _j(p["cij"]))
    jax_ops = jops.bcpnn_phase(
        jmarg, _j(p["x"]), _j(p["w"]), _j(p["b"]), JUnitLayout(n_hcu, n_mcu), lam, k_b=k_b,
        gain=gain, mask=_j(p["mask"]), state_format=state_format,
    )
    oracle = jref.bcpnn_phase(
        _j(p["x"]), _j(p["w"]), _j(p["b"]), _j(p["ci"]), _j(p["cj"]), _j(p["cij"]), lam,
        n_hcu, n_mcu, k_b=k_b, gain=gain, mask=_j(p["mask"]),
        state_mantissa=STATE_FORMATS.get(state_format),
    )
    return port, jax_ops, oracle


@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("shape", PHASE_SHAPES)
def test_bcpnn_phase_matches_jax(shape, use_mask):
    p = _problem(*shape, use_mask)
    (st, w, bias, aj), (jst, jw, jbias, jaj), r = _phase(p, shape)
    for port, via_ops, oracle, tol in (
        (aj, jaj, r[0], PHASE_TOL), (st.ci, jst.ci, r[1], PHASE_TOL),
        (st.cj, jst.cj, r[2], PHASE_TOL), (st.cij, jst.cij, r[3], CIJ_TOL),
        (w, jw, r[4], PHASE_TOL), (bias, jbias, r[5], PHASE_TOL),
    ):
        assert port.dtype == torch.float32
        for want in (via_ops, oracle):
            np.testing.assert_allclose(port.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("state_format", sorted(STATE_FORMATS))
@pytest.mark.parametrize("shape", [PHASE_SHAPES[0], PHASE_SHAPES[3]])
def test_bcpnn_phase_state_tier_matches_jax(shape, state_format):
    mant = STATE_FORMATS[state_format]
    p = _problem(*shape, use_mask=True)
    (st, w, bias, aj), (jst, jw, jbias, jaj), r = _phase(p, shape, state_format)
    np.testing.assert_allclose(aj.numpy(), np.asarray(jaj), **PHASE_TOL)
    for name, port, via_ops, oracle in zip(("ci", "cj", "cij"), st, jst, r[1:4]):
        _state_close(port, via_ops, mant, name)
        _state_close(port.float(), np.asarray(oracle), mant, name + " (oracle)")
    for port, via_ops, oracle in ((w, jw, r[4]), (bias, jbias, r[5])):
        for want in (via_ops, oracle):
            np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=0, atol=2.0 ** -(mant - 1))


@pytest.mark.parametrize("state_format", sorted(STATE_FORMATS))
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[5]])
def test_bcpnn_update_state_tier_matches_jax(shape, state_format):
    mant = STATE_FORMATS[state_format]
    p = _problem(*shape, use_mask=True)
    lam, k_b = 0.05, 0.7
    marg = MarginalState(_t(p["ci"]), _t(p["cj"]), _t(p["cij"]))
    new, w, bias = ops.bcpnn_update(
        marg, _t(p["x"]), _t(p["aj"]), lam=lam, k_b=k_b, mask=_t(p["mask"]),
        state_format=state_format,
    )
    jmarg = JMarginalState(_j(p["ci"]), _j(p["cj"]), _j(p["cij"]))
    jnew, jw, jbias = jops.bcpnn_update(
        jmarg, _j(p["x"]), _j(p["aj"]), lam=lam, k_b=k_b, mask=_j(p["mask"]),
        state_format=state_format,
    )
    for name, port, want in zip(("ci", "cj", "cij"), new, jnew):
        _state_close(port, want, mant, name)
    # bf16 traces go back in as the next batch's state: read in bf16, f32 math.
    again, _, _ = ops.bcpnn_update(
        new, _t(p["x"]), _t(p["aj"]), lam=lam, k_b=k_b, state_format=state_format
    )
    jagain, _, _ = jops.bcpnn_update(
        jnew, _j(p["x"]), _j(p["aj"]), lam=lam, k_b=k_b, state_format=state_format
    )
    for name, port, want in zip(("ci", "cj", "cij"), again, jagain):
        _state_close(port, want, mant, name + " (second cycle)")
    for port, want in ((w, jw), (bias, jbias)):
        np.testing.assert_allclose(port.numpy(), np.asarray(want), rtol=0, atol=2.0 ** -(mant - 1))


def test_state_tier_argument_checks():
    marg = MarginalState(torch.ones(3), torch.ones(2), torch.ones(3, 2))
    x, aj = torch.ones(1, 3), torch.ones(1, 2)
    mixed = MarginalState(torch.ones(3), torch.ones(2).bfloat16(), torch.ones(3, 2))
    with pytest.raises(ValueError, match="mixed dtypes"):
        ops.bcpnn_update(mixed, x, aj, lam=0.1)
    with pytest.raises(ValueError, match="unknown format"):
        ops.bcpnn_update(marg, x, aj, lam=0.1, state_format="bf99")
    from repro_torch.kernels import bcpnn_update as bk

    with pytest.raises(ValueError, match="at most 7"):
        bk.bcpnn_update(x, aj, *marg, 0.1, state_mantissa=11, state_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="state_mantissa"):
        bk.bcpnn_update(x, aj, *marg, 0.1, state_mantissa=23)
    # fp32 is the identity format: no rounding, f32 traces.
    new, _, _ = ops.bcpnn_update(marg, x, aj, lam=0.1, state_format="fp32")
    assert new.cij.dtype == torch.float32


@pytest.mark.parametrize(
    "kernel", ["masked_matmul", "hcu_softmax", "bcpnn_update", "bcpnn_phase", "bf_round"]
)
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
        elif kernel == "bcpnn_update":
            ops.bcpnn_update(
                MarginalState(meta(6), meta(8), meta(6, 8)), meta(4, 6), meta(4, 8), lam=0.1,
                state_format="bf16",
            )
        elif kernel == "bcpnn_phase":
            ops.bcpnn_phase(
                MarginalState(meta(6), meta(8), meta(6, 8)), meta(4, 6), meta(6, 8), meta(8),
                UnitLayout(2, 4), lam=0.1, state_format="bf16",
            )
        else:
            ops.bf_round(meta(4, 6), 7)


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


def test_state_format_bf16_keeps_bf16_traces():
    """The ported tier: bf16 traces in, rounded bf16 traces out, f32 w/b."""
    p = _problem(13, 17, 3, 7, use_mask=False)
    marg = MarginalState(*(_t(p[k]).bfloat16() for k in ("ci", "cj", "cij")))
    new, w, bias = ops.bcpnn_update(marg, _t(p["x"]), _t(p["aj"]), lam=0.1, state_format="bf16")
    assert {t.dtype for t in new} == {torch.bfloat16}
    assert w.dtype == bias.dtype == torch.float32
    st, w2, b2, aj = ops.bcpnn_phase(
        marg, _t(p["x"]), _t(p["w"]), _t(p["b"]), UnitLayout(3, 7), lam=0.1, state_format="bf16"
    )
    assert {t.dtype for t in st} == {torch.bfloat16} and aj.dtype == torch.float32


def test_importing_builds_nothing():
    assert _build._libs == {}
    assert set(_build.SOURCES) == {
        "masked_matmul", "hcu_softmax", "bcpnn_update", "bcpnn_phase", "bf_round",
    }
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    assert (_build.CSRC / "rne_round.cuh").is_file()


def test_build_dir_hashes_headers(tmp_path, monkeypatch):
    """Editing a shared header must give a new build directory, so no stale
    library is loaded."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.build_dir()
    with open(tmp_path / "rne_round.cuh", "a") as f:
        f.write("// edited\n")
    assert _build.build_dir() != before
