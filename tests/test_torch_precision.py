"""The port's quantized state tier against the JAX package's.

``bf_round`` must match the reference bit for bit (compared as int32
views), against both its pure-jnp oracle and its Pallas kernel in interpret
mode, over random values of every magnitude and the special values:
signed zeros, subnormals, infinities, NaN, values whose rounding carries
into the next binade, and the largest finite f32 (which rounds to inf).
The policy helpers are held against ``repro.precision`` on the same
inputs; the reduced datapath's parity is in ``test_torch_datapath.py``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.learning import MarginalState as JMarginalState
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.precision import formats as jformats
from repro.precision import policy as jpolicy
from repro_torch.core import DenseLayer, ExecutionConfig, StructuralPlasticityLayer, UnitLayout
from repro_torch.core.learning import MarginalState
from repro_torch.kernels import ops
from repro_torch.precision import formats, policy
from repro_torch.precision.policy import PrecisionPolicy

MANTISSAS = [1, 2, 7, 10, 11, 15, 19, 22, 23]
F32 = np.finfo(np.float32)
SPECIALS = np.array(
    [
        0.0, -0.0, 1e-40, -1e-40, F32.tiny, -F32.tiny, np.inf, -np.inf, np.nan,
        F32.max, -F32.max, 1.9999999, -1.9999999, 0.99999994, 1.5, 2.5,
        1.0039062, 3.9999998, 65504.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8,
    ],
    np.float32,
)


def _values(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    mag = rng.standard_normal(n) * np.exp2(rng.integers(-140, 127, n).astype(np.float64))
    bits = rng.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32).view(np.float32)
    return np.concatenate([mag.astype(np.float32), bits, SPECIALS]).reshape(3, -1)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("mantissa", MANTISSAS)
def test_bf_round_is_bit_exact(mantissa):
    x = _values()
    port = ops.bf_round(torch.from_numpy(x), mantissa)
    assert port.dtype == torch.float32 and port.shape == x.shape
    got = _bits(port.numpy())
    np.testing.assert_array_equal(got, _bits(jref.bf_round(jnp.asarray(x), mantissa)))
    np.testing.assert_array_equal(got, _bits(jops.bf_round(jnp.asarray(x), mantissa)))


def test_bf_round_rejects_bad_widths_and_copies_at_23():
    x = torch.ones(3)
    for m in (0, 24):
        with pytest.raises(ValueError, match="mantissa_bits"):
            ops.bf_round(x, m)
    y = ops.bf_round(x, 23)
    assert torch.equal(y, x) and y.data_ptr() != x.data_ptr()


@pytest.mark.parametrize("name", sorted(formats.FORMATS))
def test_formats_and_state_spec_match(name):
    fmt, jfmt = formats.get_format(name), jformats.get_format(name)
    assert (fmt.name, fmt.total_bits, fmt.mantissa_bits, fmt.is_identity) == (
        jfmt.name, jfmt.total_bits, jfmt.mantissa_bits, jfmt.is_identity,
    )
    mant, dtype = formats.state_spec(fmt)
    jmant, jdtype = jformats.state_spec(jfmt)
    assert mant == jmant
    assert (None if dtype is None else str(dtype).replace("torch.", "")) == (
        None if jdtype is None else np.dtype(jdtype).name
    )
    with pytest.raises(ValueError, match="unknown format"):
        formats.get_format("bf99")


@pytest.mark.parametrize("state_format", [None, "fp32", "bf14", "bf16", "bf20", "bf28"])
def test_policy_named_and_q_state_match(state_format):
    pol = PrecisionPolicy.named("fp32", state_format=state_format)
    jpol = jpolicy.PrecisionPolicy.named("fp32", state_format=state_format)
    assert pol.fmt.name == jpol.fmt.name
    assert pol.has_state_tier == jpol.has_state_tier
    x = np.abs(_values(3)).astype(np.float32)
    x[~np.isfinite(x)] = 1.0
    got = pol.q_state(torch.from_numpy(x))
    want = np.asarray(jpol.q_state(jnp.asarray(x)))
    assert got.dtype == (torch.bfloat16 if want.dtype == ml_dtypes.bfloat16 else torch.float32)
    np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(want.astype(np.float32)))


def _marginals(seed=5, F=9, H=6):
    rng = np.random.default_rng(seed)
    arrs = (
        (rng.random(F) * 0.5 + 0.25).astype(np.float32),
        (rng.random(H) * 0.5 + 0.25).astype(np.float32),
        (rng.random((F, H)) * 0.25 + 0.01).astype(np.float32),
    )
    mask = (rng.random((F, H)) > 0.3).astype(np.float32)
    return arrs, mask


@pytest.mark.parametrize("state_format", ["bf16", "bf20"])
def test_quantize_marginals_and_cycle_match(state_format):
    (ci, cj, cij), mask = _marginals()
    pol = PrecisionPolicy.named("fp32", state_format=state_format)
    jpol = jpolicy.PrecisionPolicy.named("fp32", state_format=state_format)
    marg = MarginalState(*(torch.from_numpy(a) for a in (ci, cj, cij)))
    jmarg = JMarginalState(*(jnp.asarray(a) for a in (ci, cj, cij)))
    q, jq = policy.quantize_marginals(marg, pol), jpolicy.quantize_marginals(jmarg, jpol)
    for t, j in zip(q, jq):
        np.testing.assert_array_equal(_bits(t.float().numpy()), _bits(np.asarray(j, np.float32)))
    (s, w, b) = policy.state_quantized_cycle(marg, pol, k_b=0.5, mask=torch.from_numpy(mask))
    (js, jw, jb) = jpolicy.state_quantized_cycle(jmarg, jpol, k_b=0.5, mask=jnp.asarray(mask))
    for t, j in zip(s, js):
        assert t.dtype == (torch.bfloat16 if state_format == "bf16" else torch.float32)
        np.testing.assert_array_equal(_bits(t.float().numpy()), _bits(np.asarray(j, np.float32)))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    assert policy.quantize_marginals(marg, None) is marg


def test_use_kernel_is_gone():
    """On the card the kernel is the path: there is no switch to name."""
    with pytest.raises(TypeError, match="use_kernel"):
        PrecisionPolicy.named("fp32", use_kernel=False)
    with pytest.raises(TypeError, match="use_kernel"):
        PrecisionPolicy(formats.get_format("fp32"), use_kernel=True)
    with pytest.raises(TypeError, match="use_kernel"):
        formats.round_to(torch.ones(2), formats.get_format("bf16"), use_kernel=False)


@pytest.mark.parametrize("name", ["bf14", "bf15", "bf16", "bf20", "bf24", "bf28"])
def test_reduced_datapath_configs_are_accepted(name):
    """Every datapath format is accepted by name or by policy, with and
    without a state tier, and bound into every layer, the readout too."""
    assert ExecutionConfig(device="cpu", precision=name).precision.fmt.name == name
    cfg = ExecutionConfig(device="cpu", precision=PrecisionPolicy.named(name, state_format="bf16"))
    assert cfg.precision.fmt.name == name and cfg.precision.has_state_tier
    hidden = StructuralPlasticityLayer(
        UnitLayout(2, 2), UnitLayout(2, 2), precision=PrecisionPolicy.named(name)
    )
    assert hidden.spec.precision.fmt.name == name
    readout = DenseLayer(UnitLayout(2, 2), UnitLayout(1, 3))
    assert cfg.bind_layer(readout).spec.precision is cfg.precision
    assert readout.spec.precision is None  # the declarative layer is untouched
    # The pure state tier is accepted, from a policy or a format name.
    assert ExecutionConfig(device="cpu", precision="fp32").precision.fmt.name == "fp32"
