"""The reduced-precision datapath (paper Fig. 3) against the JAX package's.

``PrecisionPolicy.q`` must round bit for bit, bf16 operands and views
included.  ``quantized_support`` / ``quantized_forward`` and
``quantized_learning_cycle`` are held against ``repro.precision.policy`` on
the same numpy inputs, formats bf14 ... bf28, with and without a mask, at
gain 1 and 4, with state tiers None, bf16 and bf20, at a non-divisible and
a wide shape.

A stage rounds an f32 value that the two packages summed in different
orders (``masked_matmul``'s split K, the CPU's ``matmul`` and XLA's), so a
value within an f32 ulp or so of a rounding midpoint may round to the
neighbouring value of the format.  The rule for a stage (:func:`_assert_stage`):
every element within one ulp of the format at |ref| plus the stage's f32
tolerance, and at most 1% of the elements (at least one) beyond the f32
tolerance.  A stage whose own inputs differ between the packages is held,
besides, to what those differences carry into it (the softmax after a
support that rounded apart; w and bias after traces that rounded apart);
the stage itself is then held to the rule on the port's own inputs through
the reference's function for that stage.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.learning import MarginalState as JMarginalState
from repro.core.units import UnitLayout as JUnitLayout
from repro.precision import policy as jpolicy
from repro_torch.core import StructuralPlasticityLayer, UnitLayout
from repro_torch.core.learning import MarginalState, full_f32_matmul
from repro_torch.precision import policy
from repro_torch.precision.policy import PrecisionPolicy

DATAPATH = ["bf14", "bf15", "bf16", "bf20", "bf24", "bf28"]
SHAPES = [(13, 17, 3, 7), (64, 200, 2, 129)]  # (B, F, n_hcu, n_mcu)
# f32 tolerances of each stage, (rtol, atol): the support sums F products;
# the traces are EWMAs of means; w and bias are sums of three logs of
# traces ~1e-3 (|log| ~ 7, an f32 ulp there ~5e-7).
SUPPORT_TOL = (1e-4, 1e-5)
TRACE_TOL = (1e-5, 1e-8)
LOG_TOL = (1e-5, 1e-5)
LAM, K_B = 0.05, 0.7


def _mantissa(name):
    return int(name[2:]) - 9


def _ulp(x, mantissa):
    """One ulp of a ``mantissa``-bit format at |x| (f64)."""
    e = np.frexp(np.abs(np.asarray(x, np.float64)))[1]
    return np.ldexp(1.0, e - 1 - mantissa)


def _assert_stage(got, ref, mantissa, tol, carry=0.0, what=""):
    """The stage rule of the module docstring; ``carry`` (per element) is
    what differences in the stage's inputs carry into it, and elements with
    a carry are not counted against the 1%."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    rtol, atol = tol
    diff = np.abs(got - ref)
    f32 = rtol * np.abs(ref) + atol
    carry = np.broadcast_to(np.asarray(carry, np.float64), ref.shape)
    limit = _ulp(np.maximum(np.abs(ref), np.abs(got)), mantissa) + f32 + carry
    bad = diff > limit
    assert not bad.any(), (
        f"{what}: {int(bad.sum())} elements beyond one ulp + tolerance, worst "
        f"{diff[bad].max():.3e} at ref {ref[bad][np.argmax(diff[bad])]:.6e}"
    )
    apart = (diff > f32) & (carry == 0)
    assert apart.sum() <= max(1, 0.01 * apart.size), (
        f"{what}: {int(apart.sum())} of {apart.size} elements a format ulp apart"
    )


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _pair(name, state_format=None):
    return (
        PrecisionPolicy.named(name, state_format=state_format),
        jpolicy.PrecisionPolicy.named(name, state_format=state_format),
    )


def _forward_inputs(shape, seed=0):
    B, F, n_hcu, n_mcu = shape
    H = n_hcu * n_mcu
    rng = np.random.default_rng(seed)
    ai = rng.random((B, F)).astype(np.float32)
    w = rng.standard_normal((F, H)).astype(np.float32)
    b = rng.standard_normal(H).astype(np.float32)
    mask = (rng.random((F, H)) > 0.3).astype(np.float32)
    return ai, w, b, mask


def _cycle_inputs(shape, seed=1):
    B, F, n_hcu, n_mcu = shape
    H = n_hcu * n_mcu
    rng = np.random.default_rng(seed)
    ai = rng.random((B, F)).astype(np.float32)
    s = rng.standard_normal((B, n_hcu, n_mcu))
    aj = (np.exp(s) / np.exp(s).sum(-1, keepdims=True)).reshape(B, H).astype(np.float32)
    ci = (rng.random(F) * 0.5 + 0.25).astype(np.float32)
    cj = (rng.random(H) * 0.5 / n_mcu + 0.01).astype(np.float32)
    cij = (np.outer(ci, cj) * np.exp(0.3 * rng.standard_normal((F, H)))).astype(np.float32)
    mask = (rng.random((F, H)) > 0.3).astype(np.float32)
    return ai, aj, (ci, cj, cij), mask


# ---------------------------------------------------------------- q itself
def _values(seed=0, n=2041):
    rng = np.random.default_rng(seed)
    mag = rng.standard_normal(n) * np.exp2(rng.integers(-140, 127, n).astype(np.float64))
    specials = [0.0, -0.0, 1e-40, np.inf, -np.inf, np.nan, 1.9999999, 1.0 + 2**-8, 65504.0]
    return np.concatenate([mag, specials]).astype(np.float32).reshape(-1, 41)


@pytest.mark.parametrize("name", DATAPATH + ["fp32"])
def test_q_is_bit_exact(name):
    pol, jpol = _pair(name)
    x = _values()
    got = pol.q(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(jpol.q(jnp.asarray(x))))
    # A bf16 operand (a stored trace) rounds from its exact f32 value.
    xb = np.abs(x[:, :16]).astype(ml_dtypes.bfloat16)
    got_b = pol.q(torch.from_numpy(xb.astype(np.float32)).bfloat16())
    np.testing.assert_array_equal(_bits(got_b.numpy()), _bits(jpol.q(jnp.asarray(xb))))
    # A view that is not contiguous (a_i^T in the product) rounds as a copy.
    t = torch.from_numpy(x)
    assert torch.equal(pol.q(t.T).view(torch.int32), pol.q(t).T.contiguous().view(torch.int32))


# ------------------------------------------------------------- the forward
def _ref_support(jpol, ai, w, b, mask, gain):
    """The reference's support stage, as ``repro/precision/policy.py:94-98``
    writes it, through the reference's own ``q``."""
    weff = jpol.q(jnp.asarray(w) * jnp.asarray(mask)) if mask is not None else jpol.q(jnp.asarray(w))
    s = jpol.q(jpol.q(jnp.asarray(ai)) @ weff + jpol.q(jnp.asarray(b)))
    if gain != 1.0:
        s = jpol.q(s * gain)
    return np.asarray(s)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("gain", [1.0, 4.0])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("name", DATAPATH)
def test_quantized_forward_matches(name, masked, gain, shape):
    B, F, n_hcu, n_mcu = shape
    pol, jpol = _pair(name)
    m = _mantissa(name)
    ai, w, b, mask = _forward_inputs(shape)
    mask = mask if masked else None
    t = [torch.from_numpy(a) for a in (ai, w, b)]
    tmask = None if mask is None else torch.from_numpy(mask)

    s = policy.quantized_support(*t, pol, mask=tmask, gain=gain).numpy()
    s_ref = _ref_support(jpol, ai, w, b, mask, gain)
    _assert_stage(s, s_ref, m, SUPPORT_TOL, what="support")

    aj = policy.quantized_forward(*t, UnitLayout(n_hcu, n_mcu), pol, tmask, gain=gain).numpy()
    aj_ref = np.asarray(jpolicy.quantized_forward(
        *(jnp.asarray(a) for a in (ai, w, b)), JUnitLayout(n_hcu, n_mcu), jpol,
        None if mask is None else jnp.asarray(mask), gain=gain,
    ))
    # A support that rounded apart moves its hypercolumn's softmax: with
    # |ds| <= D over the block, each log a_j moves by at most 2D.
    d = np.abs(s.astype(np.float64) - s_ref).reshape(B, n_hcu, n_mcu).max(-1, keepdims=True)
    carry = (np.abs(aj_ref).reshape(B, n_hcu, n_mcu) * np.expm1(2 * d) * (1 + 2.0**-m))
    _assert_stage(aj, aj_ref, m, SUPPORT_TOL, carry=carry.reshape(B, -1), what="a_j")
    # The softmax stage alone, on the port's support: the reference's
    # forward of an identity input reproduces its support exactly.
    eye, zeros = np.eye(B, dtype=np.float32), np.zeros(n_hcu * n_mcu, np.float32)
    stage_ref = np.asarray(jpolicy.quantized_forward(
        jnp.asarray(eye), jnp.asarray(s), jnp.asarray(zeros), JUnitLayout(n_hcu, n_mcu), jpol
    ))
    _assert_stage(aj, stage_ref, m, SUPPORT_TOL, what="softmax stage")


# ------------------------------------------------------- the learning cycle
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("state_format", [None, "bf16", "bf20"])
@pytest.mark.parametrize("name", DATAPATH)
def test_quantized_learning_cycle_matches(name, state_format, masked, shape):
    pol, jpol = _pair(name, state_format)
    ai, aj, traces, mask = _cycle_inputs(shape)
    mask = mask if masked else None
    tmask = None if mask is None else torch.from_numpy(mask)
    marg = MarginalState(*(torch.from_numpy(a) for a in traces))
    jmarg = JMarginalState(*(jnp.asarray(a) for a in traces))
    if state_format == "bf16":  # traces arrive in their storage dtype
        marg = MarginalState(*(a.bfloat16() for a in marg))
        jmarg = JMarginalState(*(a.astype(jnp.bfloat16) for a in jmarg))
    state, w, bias = policy.quantized_learning_cycle(
        marg, torch.from_numpy(ai), torch.from_numpy(aj), LAM, pol, k_b=K_B, mask=tmask
    )
    jstate, jw, jbias = jpolicy.quantized_learning_cycle(
        jmarg, jnp.asarray(ai), jnp.asarray(aj), LAM, jpol, k_b=K_B,
        mask=None if mask is None else jnp.asarray(mask),
    )
    want_dtype = torch.bfloat16 if state_format == "bf16" else torch.float32
    assert {t.dtype for t in state} == {want_dtype}
    assert w.dtype == bias.dtype == torch.float32
    # Traces are rounded to the datapath format, then to the state tier.
    m = min(_mantissa(name), _mantissa(state_format) if state_format else 23)
    port = [t.float().numpy().astype(np.float64) for t in state]
    ref = [np.asarray(j, np.float32).astype(np.float64) for j in jstate]
    for label, p, r in zip(("c_i", "c_j", "c_ij"), port, ref):
        _assert_stage(p, r, m, TRACE_TOL, what=label)
    if mask is not None:
        assert not w.numpy()[mask == 0].any()
    # w and bias: the reference's stage on the port's own traces ...
    jport = JMarginalState(*(jnp.asarray(t.float().numpy()) for t in state))
    w_stage, b_stage = jpolicy._weights_from(
        jport, K_B, None if mask is None else jnp.asarray(mask)
    )
    _assert_stage(w.numpy(), np.asarray(jpol.q(w_stage)), _mantissa(name), LOG_TOL, what="w stage")
    _assert_stage(bias.numpy(), np.asarray(jpol.q(b_stage)), _mantissa(name), LOG_TOL,
                  what="bias stage")
    # ... and against the reference's end to end, with what traces that
    # rounded apart carry into the logs.
    dlog = [np.abs(np.log(np.maximum(p, 1e-8)) - np.log(np.maximum(r, 1e-8))) for p, r in zip(port, ref)]
    carry_w = (dlog[2] + dlog[0][:, None] + dlog[1][None, :]) * (1 if mask is None else mask)
    _assert_stage(w.numpy(), np.asarray(jw), _mantissa(name), LOG_TOL, carry=carry_w, what="w")
    _assert_stage(bias.numpy(), np.asarray(jbias), _mantissa(name), LOG_TOL,
                  carry=K_B * dlog[1], what="bias")


# ------------------------------------------------------ the layers' routing
def test_layers_route_every_cycle_through_the_datapath():
    """A layer with a datapath policy runs ``quantized_forward`` and, for
    each of its ``n_cycles``, ``quantized_learning_cycle`` (bit for bit the
    same as calling them), never the f32 kernels' plain versions."""
    pol = PrecisionPolicy.named("bf16", state_format="bf20")
    pre, post = UnitLayout(6, 2), UnitLayout(3, 4)
    layer = StructuralPlasticityLayer(pre, post, fan_in=4, lam=LAM, n_cycles=2, gain=4.0,
                                      precision=pol, init_jitter=1.0)
    st = layer.init(torch.Generator().manual_seed(0))
    x = torch.rand(8, pre.n_units, generator=torch.Generator().manual_seed(1))
    new, aj = layer.train_batch(st, x)
    st = layer.maybe_update_mask(st)  # the rewiring train_batch starts with
    mask = st.plast.unit_mask(pre, post)
    want_aj = policy.quantized_forward(x, st.w, st.b, post, pol, mask, gain=4.0)
    assert torch.equal(aj, want_aj)
    marg = st.marginals
    for _ in range(2):
        marg, w, b = policy.quantized_learning_cycle(marg, x, want_aj, LAM, pol, 1.0, mask=mask)
    for got, want in zip((*new.marginals, new.w, new.b), (*marg, w, b)):
        assert torch.equal(got, want)
    assert torch.equal(layer.forward(new, x), policy.quantized_forward(
        x, new.w, new.b, post, pol, mask, gain=4.0))


def test_full_f32_products_refuse_tf32():
    """The datapath's a_i^T a_j and the SGD head's product run in full f32:
    with TF32 on they raise instead of computing another function."""
    a, b = torch.ones(3, 2), torch.ones(2, 4)
    assert torch.equal(full_f32_matmul(a, b), a @ b)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="TF32"):
            full_f32_matmul(a, b)
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.get_float32_matmul_precision() == "highest"
