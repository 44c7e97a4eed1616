"""The reduced datapath's kernel modes against the JAX package's stages.

The port rounds every stage of the reduced datapath (paper Fig. 3) inside
the kernel that makes the value: ``masked_matmul`` and ``hcu_softmax``
with ``round_mantissa=`` (the support, the gain and the softmax), and
``bcpnn_update`` with ``datapath_mantissa=`` (the whole learning cycle,
state tier included).  Here each mode's plain version, ``ops`` on CPU
tensors, is held against ``repro.precision.policy``'s stages on the same
numpy inputs, by the stage rule of ``tests/test_torch_datapath.py``:
formats bf14 ... bf28, masked and unmasked, gain 1 and 4, state tiers
None, bf16 and bf20, at a non-divisible and a wide shape.  The reference
rounds through its plain ``bf_round`` (``use_kernel=False``), which its own
tests hold bit for bit to its Pallas kernel.  Then the modes' argument
checks, and spies on a datapath ``fit``: ``bf_round`` only at compile, one
datapath update per learning cycle, every forward in the rounding mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.learning import MarginalState as JMarginalState
from repro.precision import policy as jpolicy
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
from repro_torch.kernels import ops
from repro_torch.precision import PrecisionPolicy
from test_torch_datapath import (
    DATAPATH,
    K_B,
    LAM,
    LOG_TOL,
    SHAPES,
    SUPPORT_TOL,
    TRACE_TOL,
    _assert_stage,
    _cycle_inputs,
    _forward_inputs,
    _mantissa,
    _ref_support,
)


def _jpol(name, state_format=None):
    return jpolicy.PrecisionPolicy.named(name, use_kernel=False, state_format=state_format)


# ------------------------------------------------- the forward pair's modes
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("gain", [1.0, 4.0])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("name", DATAPATH)
def test_support_mode_matches(name, masked, gain, shape):
    """``masked_matmul``'s rounding mode is the reference's support stage,
    ``q(q(q(x) @ q(w o mask) + q(b)) * gain)``."""
    m = _mantissa(name)
    ai, w, b, mask = _forward_inputs(shape)
    mask = mask if masked else None
    s = ops.masked_matmul(
        *(torch.from_numpy(a) for a in (ai, w, b)),
        mask=None if mask is None else torch.from_numpy(mask), round_mantissa=m, gain=gain,
    )
    assert s.dtype == torch.float32
    _assert_stage(s.numpy(), _ref_support(_jpol(name), ai, w, b, mask, gain), m, SUPPORT_TOL,
                  what="support")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", DATAPATH)
def test_softmax_mode_matches(name, shape):
    """``hcu_softmax``'s rounding mode is the reference's softmax stage,
    ``q(softmax_HCU(s))``, on a support already in the format."""
    B, _, n_hcu, n_mcu = shape
    m, jpol = _mantissa(name), _jpol(name)
    rng = np.random.default_rng(2)
    s = np.array(jpol.q(jnp.asarray(4 * rng.standard_normal((B, n_hcu * n_mcu)), jnp.float32)))
    got = ops.hcu_softmax(torch.from_numpy(s), n_hcu, n_mcu, round_mantissa=m)
    blocked = jnp.asarray(s).reshape(B, n_hcu, n_mcu)
    want = np.asarray(jpol.q(jax.nn.softmax(blocked, axis=-1).reshape(B, -1)))
    _assert_stage(got.numpy(), want, m, SUPPORT_TOL, what="softmax")


# ----------------------------------------------------- the update's mode
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("state_format", [None, "bf16", "bf20"])
@pytest.mark.parametrize("name", DATAPATH)
def test_update_mode_matches(name, state_format, masked, shape):
    """``bcpnn_update``'s datapath mode is the reference's
    ``quantized_learning_cycle``, its state tier included: the traces by
    the stage rule, w and bias by it on the port's own traces and against
    the reference's end to end with what traces that rounded apart carry."""
    jpol = _jpol(name, state_format)
    ai, aj, traces, mask = _cycle_inputs(shape)
    mask = mask if masked else None
    marg = MarginalState(*(torch.from_numpy(a) for a in traces))
    jmarg = JMarginalState(*(jnp.asarray(a) for a in traces))
    if state_format == "bf16":  # traces arrive in their storage dtype
        marg = MarginalState(*(a.bfloat16() for a in marg))
        jmarg = JMarginalState(*(a.astype(jnp.bfloat16) for a in jmarg))
    state, w, bias = ops.bcpnn_update(
        marg, torch.from_numpy(ai), torch.from_numpy(aj), LAM, k_b=K_B,
        mask=None if mask is None else torch.from_numpy(mask), state_format=state_format,
        datapath_mantissa=_mantissa(name),
    )
    jstate, jw, jbias = jpolicy.quantized_learning_cycle(
        jmarg, jnp.asarray(ai), jnp.asarray(aj), LAM, jpol, k_b=K_B,
        mask=None if mask is None else jnp.asarray(mask),
    )
    assert {t.dtype for t in state} == {torch.bfloat16 if state_format == "bf16" else torch.float32}
    assert w.dtype == bias.dtype == torch.float32
    m = min(_mantissa(name), _mantissa(state_format) if state_format else 23)
    port = [t.float().numpy().astype(np.float64) for t in state]
    ref = [np.asarray(j, np.float32).astype(np.float64) for j in jstate]
    for label, p, r in zip(("c_i", "c_j", "c_ij"), port, ref):
        _assert_stage(p, r, m, TRACE_TOL, what=label)
    if mask is not None:
        assert not w.numpy()[mask == 0].any()
    jport = JMarginalState(*(jnp.asarray(t.float().numpy()) for t in state))
    w_stage, b_stage = jpolicy._weights_from(
        jport, K_B, None if mask is None else jnp.asarray(mask)
    )
    _assert_stage(w.numpy(), np.asarray(jpol.q(w_stage)), _mantissa(name), LOG_TOL, what="w stage")
    _assert_stage(bias.numpy(), np.asarray(jpol.q(b_stage)), _mantissa(name), LOG_TOL,
                  what="bias stage")
    dlog = [np.abs(np.log(np.maximum(p, 1e-8)) - np.log(np.maximum(r, 1e-8))) for p, r in zip(port, ref)]
    carry_w = (dlog[2] + dlog[0][:, None] + dlog[1][None, :]) * (1 if mask is None else mask)
    _assert_stage(w.numpy(), np.asarray(jw), _mantissa(name), LOG_TOL, carry=carry_w, what="w")
    _assert_stage(bias.numpy(), np.asarray(jbias), _mantissa(name), LOG_TOL,
                  carry=K_B * dlog[1], what="bias")


# ------------------------------------ the plain modes are the staged stages
def _staged_cycle(marg, ai, aj, pol, mask):
    """The learning cycle as ``PrecisionPolicy.q`` and plain ops compose it,
    one ``q`` a stage (``quantized_learning_cycle`` before the modes)."""
    q = pol.q
    ai_q, aj_q = q(ai), q(aj)
    mi, mj = q(ai_q.mean(dim=0)), q(aj_q.mean(dim=0))
    mij = q((ai_q.T @ aj_q) / ai.shape[0])
    one_m = 1.0 - LAM
    ci, cj, cij = (q(one_m * c.float() + LAM * m) for c, m in zip(marg, (mi, mj, mij)))
    st = MarginalState(ci, cj, cij)
    if pol.has_state_tier:
        st = MarginalState(*(pol.q_state(t) for t in st))
    log = [torch.log(torch.clamp_min(t.float(), 1e-8)) for t in st]
    w = q(log[2] - log[0][:, None] - log[1][None, :])
    if mask is not None:
        w = w * mask
    return st, w, q(K_B * log[1])


@pytest.mark.parametrize("state_format", [None, "bf16", "bf20"])
@pytest.mark.parametrize("name", ["bf14", "bf20"])
def test_plain_modes_are_the_staged_stages_bit_for_bit(name, state_format):
    """On the CPU each mode is the staged composition, one ``q`` a stage,
    bit for bit: the forward at gain 1 and 4, masked and not, and the cycle
    with each state tier."""
    pol = PrecisionPolicy.named(name, state_format=state_format)
    m = _mantissa(name)
    shape = SHAPES[1]
    ai, w, b, mask = (torch.from_numpy(a) for a in _forward_inputs(shape))
    for mm in (None, mask):
        for gain in (1.0, 4.0):
            s = pol.q(ops.masked_matmul(pol.q(ai), pol.q(w), pol.q(b), mask=mm))
            s = pol.q(s * gain) if gain != 1.0 else s
            got = ops.masked_matmul(ai, w, b, mask=mm, round_mantissa=m, gain=gain)
            assert torch.equal(got.view(torch.int32), s.view(torch.int32))
        a = ops.hcu_softmax(got, shape[2], shape[3], round_mantissa=m)
        assert torch.equal(a.view(torch.int32),
                           pol.q(ops.hcu_softmax(got, shape[2], shape[3])).view(torch.int32))
    ai, aj, traces, mask = _cycle_inputs(shape)
    marg = MarginalState(*(torch.from_numpy(t) for t in traces))
    if state_format == "bf16":
        marg = MarginalState(*(t.bfloat16() for t in marg))
    ai, aj, mask = torch.from_numpy(ai), torch.from_numpy(aj), torch.from_numpy(mask)
    st, w, bias = ops.bcpnn_update(marg, ai, aj, LAM, k_b=K_B, mask=mask,
                                   state_format=state_format, datapath_mantissa=m)
    want_st, want_w, want_b = _staged_cycle(marg, ai, aj, pol, mask)
    for g, t in zip((*st, w, bias), (*want_st, want_w, want_b)):
        assert g.dtype == t.dtype and torch.equal(g, t)


# ------------------------------------------------------ the arguments
@pytest.mark.parametrize("mantissa", [0, 24, -3])
def test_modes_refuse_a_mantissa_outside_1_23(mantissa):
    x, w, b = torch.ones(3, 4), torch.ones(4, 6), torch.ones(6)
    with pytest.raises(ValueError, match="round_mantissa"):
        ops.masked_matmul(x, w, b, round_mantissa=mantissa)
    with pytest.raises(ValueError, match="round_mantissa"):
        ops.hcu_softmax(torch.ones(3, 6), 2, 3, round_mantissa=mantissa)
    marg = MarginalState(torch.full((4,), 0.5), torch.full((6,), 0.5), torch.full((4, 6), 0.25))
    with pytest.raises(ValueError, match="datapath_mantissa"):
        ops.bcpnn_update(marg, x, torch.ones(3, 6), 0.1, datapath_mantissa=mantissa)


def test_gain_needs_the_rounding_mode():
    """The f32 product leaves the gain to its caller; only the rounding
    mode takes one (and at gain 1 the two modes differ only by q)."""
    x, w, b = torch.rand(5, 4), torch.rand(4, 6), torch.rand(6)
    with pytest.raises(ValueError, match="gain"):
        ops.masked_matmul(x, w, b, gain=4.0)
    assert torch.equal(ops.masked_matmul(x, w, b, gain=1.0), ops.masked_matmul(x, w, b))
    assert torch.equal(ops.masked_matmul(x, w, b, round_mantissa=23, gain=1.0),
                       ops.masked_matmul(x, w, b))


def test_launch_counts_name_the_modes():
    """The counters: one per kernel (every mode), one per datapath mode,
    one for the update's reduced-means mode and one for the product's
    gathered variant; on the CPU nothing launches."""
    ops.reset_launches()
    ops.masked_matmul(torch.ones(2, 3), torch.ones(3, 4), None, round_mantissa=7)
    counts = ops.launch_counts()
    assert set(counts) == set(ops.KERNELS) | {
        "masked_matmul.datapath", "hcu_softmax.datapath", "bcpnn_update.datapath",
        "bcpnn_update.means", "masked_matmul.gathered"}
    assert not any(counts.values())


# ------------------------------------------------- a datapath fit, spied on
def test_datapath_fit_rounds_inside_the_kernels(monkeypatch):
    """A datapath fit with a state tier calls ``ops.bf_round`` only at
    compile (the initial traces of both layers), each forward pair in its
    rounding mode and ``ops.bcpnn_update`` in its datapath mode once per
    learning cycle (two cycles a hidden batch here)."""
    calls = {"bf_round": 0, "update": [], "forward": []}
    real = {k: getattr(ops, k) for k in ("bf_round", "bcpnn_update", "masked_matmul", "hcu_softmax")}

    def bf_round(*a, **kw):
        calls["bf_round"] += 1
        return real["bf_round"](*a, **kw)

    def bcpnn_update(*a, **kw):
        calls["update"].append(kw.get("datapath_mantissa"))
        return real["bcpnn_update"](*a, **kw)

    def masked_matmul(*a, **kw):
        calls["forward"].append(("masked_matmul", kw.get("round_mantissa")))
        return real["masked_matmul"](*a, **kw)

    def hcu_softmax(*a, **kw):
        calls["forward"].append(("hcu_softmax", kw.get("round_mantissa")))
        return real["hcu_softmax"](*a, **kw)

    for name, fn in (("bf_round", bf_round), ("bcpnn_update", bcpnn_update),
                     ("masked_matmul", masked_matmul), ("hcu_softmax", hcu_softmax)):
        monkeypatch.setattr(ops, name, fn)
    ds = mnist_like(n_train=256, n_test=64, n_features=12, seed=0)
    x, layout = complementary_code(ds.x_train)
    xt, _ = complementary_code(ds.x_test)
    net = Network(seed=0)
    net.add(StructuralPlasticityLayer(layout, UnitLayout(3, 8), fan_in=6, lam=0.05, gain=4.0,
                                      n_cycles=2))
    net.add(DenseLayer(UnitLayout(3, 8), onehot_layout(10), lam=0.05))
    pol = PrecisionPolicy.named("bf16", state_format="bf20")
    compiled = net.compile(ExecutionConfig(device="cpu", precision=pol))
    assert calls["bf_round"] == 6  # three traces of each layer
    assert compiled.state.layers[0].marginals.cij.dtype == torch.float32
    compiled.fit((x, ds.y_train), epochs_hidden=2, epochs_readout=1, batch_size=32)
    compiled.predict(xt)
    compiled.evaluate((xt, ds.y_test))
    assert calls["bf_round"] == 6
    batches = len(x) // 32
    assert calls["update"] == [pol.fmt.mantissa_bits] * (2 * 2 * batches + batches)
    assert calls["forward"] and all(m == pol.fmt.mantissa_bits for _, m in calls["forward"])
