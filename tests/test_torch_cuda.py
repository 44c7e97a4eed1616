"""The Hopper kernels on the card, against their plain versions.

Every test here carries the ``cuda`` marker and skips without a CUDA device
of compute capability 9.0 or above.  The file imports no JAX, so it runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

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
from repro_torch.kernels import bcpnn_phase as pk
from repro_torch.kernels import bcpnn_update as bk
from repro_torch.kernels import masked_matmul as mk
from repro_torch.kernels import ops, ref
from repro_torch.precision import PrecisionPolicy

# (B, F, n_hcu, n_mcu): the sweep of test_torch_kernels.py.
SHAPES = [
    (32, 64, 4, 16),
    (13, 17, 3, 7),
    (64, 200, 2, 129),
    (130, 300, 20, 16),
    (257, 140, 2, 70),
    (40, 96, 3, 100),
    (48, 300, 1, 10),
]
# Kernel sums run in another order than the plain versions' library calls:
# f32 reassociation error grows with the contraction depth (<= 300 here).
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA device of compute capability 9.0 or above")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _problem(B, F, n_hcu, n_mcu, use_mask, device, seed=7):
    rng = np.random.default_rng(seed)
    H = n_hcu * n_mcu
    arrs = dict(
        x=rng.random((B, F)),
        aj=rng.random((B, H)),
        w=rng.standard_normal((F, H)) * 0.1,
        b=rng.standard_normal(H) * 0.1,
        s=rng.standard_normal((B, H)) * 4.0,
        ci=rng.random(F) * 0.5 + 0.25,
        cj=rng.random(H) * 0.5 + 0.25,
        cij=rng.random((F, H)) * 0.25 + 0.1,
        mask=(rng.random((F, H)) > 0.3) if use_mask else None,
    )
    return {
        k: None if v is None else torch.as_tensor(v, dtype=torch.float32, device=device)
        for k, v in arrs.items()
    }


@pytest.mark.cuda
@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_on_card(card, shape, use_mask):
    p = _problem(*shape, use_mask, card)
    _, _, n_hcu, n_mcu = shape
    counts = ops.launch_counts()
    torch.testing.assert_close(
        ops.masked_matmul(p["x"], p["w"], p["b"], mask=p["mask"]),
        ref.masked_matmul(p["x"], p["w"], p["b"], mask=p["mask"]), **TOL,
    )
    torch.testing.assert_close(
        ops.hcu_softmax(p["s"], n_hcu, n_mcu), ref.hcu_softmax(p["s"], n_hcu, n_mcu), **TOL
    )
    marg = MarginalState(p["ci"], p["cj"], p["cij"])
    new, w, bias = ops.bcpnn_update(marg, p["x"], p["aj"], lam=0.05, k_b=0.7, mask=p["mask"])
    plain = ref.bcpnn_update(
        p["x"], p["aj"], p["ci"], p["cj"], p["cij"], 0.05, k_b=0.7, mask=p["mask"]
    )
    for got, want in zip((new.ci, new.cj, new.cij, w, bias), plain):
        torch.testing.assert_close(got, want, **TOL)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    for k in ("masked_matmul", "hcu_softmax", "bcpnn_update"):
        assert after[k] == counts[k] + 1


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(card):
    x = torch.ones(4, 6, device=card)
    with pytest.raises(ValueError, match="float32"):
        ops.masked_matmul(x.double(), torch.ones(6, 8, device=card, dtype=torch.float64), None)
    with pytest.raises(ValueError, match="contiguous"):
        ops.masked_matmul(x, torch.ones(8, 6, device=card).T, None)
    with pytest.raises(ValueError, match="several devices"):
        ops.masked_matmul(x, torch.ones(6, 8), None)


@pytest.mark.cuda
def test_fit_on_card_matches_cpu(card):
    """A small Listing-1 fit on the card against the same fit on the CPU
    (plain versions), from one initial state and one shuffle order."""
    ds = mnist_like(n_train=512, n_test=128, n_features=24, seed=0)
    x, layout = complementary_code(ds.x_train)
    xt, _ = complementary_code(ds.x_test)
    net = Network(seed=0)
    net.add(StructuralPlasticityLayer(layout, UnitLayout(4, 10), fan_in=12, lam=0.05, gain=4.0))
    net.add(DenseLayer(UnitLayout(4, 10), onehot_layout(10), lam=0.05))
    gpu = net.compile()
    cpu = net.compile(ExecutionConfig(device="cpu"))
    assert gpu.device.type == "cuda"
    for c in (gpu, cpu):
        c.fit((x, ds.y_train), epochs_hidden=1, epochs_readout=1, batch_size=64)
    for sg, sc in zip(gpu.state.layers, cpu.state.layers):
        torch.testing.assert_close(sg.w.cpu(), sc.w, rtol=1e-4, atol=1e-4)
        if sc.plast is not None:
            assert torch.equal(sg.plast.hcu_mask.cpu(), sc.plast.hcu_mask)
    torch.testing.assert_close(gpu.predict(xt).cpu(), cpu.predict(xt), rtol=1e-4, atol=1e-5)


# The state tier: the kernel and the plain version round f32 sums taken in
# different orders, so a trace may land one ulp of the format apart
# (rtol 2^-m) and w/bias, logs of the traces, ~2^-m apart (atol 2^-(m-1)).
def _state_close(got, want, mant):
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0**-mant, atol=0)


def _phase_args(p, shape):
    _, _, n_hcu, n_mcu = shape
    return p["x"], p["w"], p["b"], p["ci"], p["cj"], p["cij"], 0.05, n_hcu, n_mcu


@pytest.mark.cuda
@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("shape", SHAPES + [(600, 300, 3, 100)])  # the last: a_j re-read from global
def test_bcpnn_phase_matches_plain_on_card(card, shape, use_mask):
    p = _problem(*shape, use_mask, card)
    kw = dict(k_b=0.7, gain=1.3, mask=p["mask"])
    before = ops.launch_counts()["bcpnn_phase"]
    got = pk.bcpnn_phase(*_phase_args(p, shape), **kw)
    want = ref.bcpnn_phase(*_phase_args(p, shape), **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, **TOL)
    # ... and against the three-kernel composition it replaces.
    _, _, n_hcu, n_mcu = shape
    s = ops.masked_matmul(p["x"], p["w"], p["b"], mask=p["mask"]) * 1.3
    aj = ops.hcu_softmax(s, n_hcu, n_mcu)
    st, w_n, b_n = ops.bcpnn_update(
        MarginalState(p["ci"], p["cj"], p["cij"]), p["x"], aj, lam=0.05, k_b=0.7, mask=p["mask"]
    )
    for g, w in zip(got, (aj, *st, w_n, b_n)):
        torch.testing.assert_close(g, w, **TOL)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bcpnn_phase"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("mant,dtype", [(7, torch.bfloat16), (11, None)])
@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[5], (128, 1568, 30, 100)])
def test_rounding_epilogues_match_plain_on_card(card, shape, mant, dtype):
    p = _problem(*shape, True, card)
    store = dtype or torch.float32
    ci, cj, cij = (p[k].to(store) for k in ("ci", "cj", "cij"))
    args = _phase_args(p, shape)
    got = pk.bcpnn_phase(*args[:3], ci, cj, cij, *args[6:], k_b=0.7, gain=1.3, mask=p["mask"],
                         state_mantissa=mant, state_dtype=dtype)
    want = ref.bcpnn_phase(*args[:3], ci, cj, cij, *args[6:], k_b=0.7, gain=1.3, mask=p["mask"],
                           state_mantissa=mant)
    torch.testing.assert_close(got[0], want[0], **TOL)
    for g, w in zip(got[1:4], want[1:4]):
        assert g.dtype == store
        _state_close(g, w, mant)
    for g, w in zip(got[4:], want[4:]):
        torch.testing.assert_close(g, w, rtol=0, atol=2.0 ** -(mant - 1))
    got = bk.bcpnn_update(p["x"], want[0], ci, cj, cij, 0.05, k_b=0.7, mask=p["mask"],
                          state_mantissa=mant, state_dtype=dtype)
    want = ref.bcpnn_update(p["x"], want[0], ci, cj, cij, 0.05, k_b=0.7, mask=p["mask"],
                            state_mantissa=mant)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == store
        _state_close(g, w, mant)
    for g, w in zip(got[3:], want[3:]):
        torch.testing.assert_close(g, w, rtol=0, atol=2.0 ** -(mant - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("mant", [1, 7, 11, 22, 23])
def test_bf_round_bit_exact_on_card(card, mant):
    f32 = np.finfo(np.float32)
    specials = torch.tensor(
        [0.0, -0.0, 1e-40, -1e-40, float("inf"), -float("inf"), float("nan"), f32.max, -f32.max,
         1.9999999, 0.99999994, 1.0 + 2**-8, 3.9999998], device=card,
    )
    rng = np.random.default_rng(mant)
    bits = torch.from_numpy(rng.integers(-2**31, 2**31, 100_003, dtype=np.int64).astype(np.int32))
    x = torch.cat([specials, bits.view(torch.float32).to(card)])
    for t in (x, x[1:]):  # 16-byte aligned, then not: the scalar path
        got = ops.bf_round(t, mant)
        assert torch.equal(got.view(torch.int32), ref.bf_round(t, mant).view(torch.int32))


@pytest.mark.cuda
def test_fused_bf16_fit_on_card_matches_cpu(card):
    """The fused, bf16-state Listing 1 on the card against the CPU's plain
    versions, from one initial state and one shuffle order."""
    ds = mnist_like(n_train=512, n_test=128, n_features=24, seed=0)
    x, layout = complementary_code(ds.x_train)
    xt, _ = complementary_code(ds.x_test)
    net = Network(seed=0)
    net.add(StructuralPlasticityLayer(layout, UnitLayout(4, 10), fan_in=12, lam=0.05, gain=4.0))
    net.add(DenseLayer(UnitLayout(4, 10), onehot_layout(10), lam=0.05))
    cfg = dict(fused_phase=True, precision=PrecisionPolicy.named("fp32", state_format="bf16"))
    ops.reset_launches()
    gpu = net.compile(ExecutionConfig(**cfg))
    cpu = net.compile(ExecutionConfig(device="cpu", **cfg))
    for c in (gpu, cpu):
        c.fit((x, ds.y_train), epochs_hidden=1, epochs_readout=1, batch_size=64)
    counts = ops.launch_counts()
    assert counts["bcpnn_phase"] == 8 and counts["bcpnn_update"] == 8 and counts["bf_round"] == 6
    assert gpu.state.layers[0].marginals.cij.dtype == torch.bfloat16
    for sg, sc in zip(gpu.state.layers, cpu.state.layers):
        _state_close(sg.marginals.cij.cpu(), sc.marginals.cij, 7)
    torch.testing.assert_close(gpu.predict(xt).cpu(), cpu.predict(xt), rtol=0, atol=2.0**-6)


# --- the forward pair at the main path's shapes and at every launch plan ---

def _mm_inputs(m, k, n, device, use_mask=True, use_bias=True, seed=3):
    rng = np.random.default_rng(seed)
    arrs = (
        rng.random((m, k)),
        rng.standard_normal((k, n)) * 0.1,
        rng.standard_normal(n) * 0.1 if use_bias else None,
        (rng.random((k, n)) > 0.3) if use_mask else None,
    )
    return [None if a is None else torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in arrs]


def _unaligned(t):
    """A contiguous copy of t whose first element is 4 bytes past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    return view


# (M, K, N): the three shapes of the main path (hidden batch or projection
# chunk, predict's projection chunk, the readout head in predict/evaluate).
MM_MAIN = [(128, 1568, 3000), (1024, 1568, 3000), (1024, 3000, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MM_MAIN)
def test_masked_matmul_main_path_shapes(card, shape):
    x, w, b, mask = _mm_inputs(*shape, card, use_mask=shape[2] > 10)
    torch.testing.assert_close(
        ops.masked_matmul(x, w, b, mask=mask), ref.masked_matmul(x, w, b, mask), **TOL
    )


def _forced_plan(m, k, n, config, cl):
    cfg = mk.CONFIGS[config]
    kslice = mk.kslice_for(k, cl, cfg.bk)
    assert (cl - 1) * kslice < k <= cl * kslice, "every K slice non-empty"
    return mk.Plan(config, cl, kslice, mk._cdiv(m, cfg.bm), mk._cdiv(n, cfg.bn))


@pytest.mark.cuda
@pytest.mark.parametrize("cl", range(1, mk.MAX_CLUSTER + 1))
@pytest.mark.parametrize("config,n", [("wide", 300), ("narrow", 12)])
def test_masked_matmul_every_plan(card, config, n, cl):
    """Each tile configuration at each cluster size the plan can pick, on a
    ragged shape whose K (1000) no CL x BK divides."""
    m, k = 200, 1000
    x, w, b, mask = _mm_inputs(m, k, n, card)
    out = torch.empty((m, n), dtype=torch.float32, device=card)
    got = mk.launch_planned(x, w, b, mask, out, _forced_plan(m, k, n, config, cl))
    torch.testing.assert_close(got, ref.masked_matmul(x, w, b, mask), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("shape", [
    (64, 12, 96),     # K shorter than one stage, 16-byte rows
    (64, 5, 96),      # K shorter than one stage, 4-byte rows
    (128, 1100, 200),  # K not divisible by CL x BK
    (13, 17, 10),     # unaligned rows of x and of w
    (33, 17, 7),
    (130, 300, 20),
])
def test_masked_matmul_ragged_shapes(card, shape, use_mask, use_bias):
    x, w, b, mask = _mm_inputs(*shape, card, use_mask=use_mask, use_bias=use_bias)
    torch.testing.assert_close(
        ops.masked_matmul(x, w, b, mask=mask), ref.masked_matmul(x, w, b, mask), **TOL
    )


@pytest.mark.cuda
def test_masked_matmul_unaligned_base(card):
    """Rows whose length is a multiple of 4 but whose base is not 16-byte
    aligned take the 4-byte path."""
    x, w, b, mask = _mm_inputs(96, 256, 64, card)
    x, w, mask = _unaligned(x), _unaligned(w), _unaligned(mask)
    torch.testing.assert_close(
        ops.masked_matmul(x, w, b, mask=mask), ref.masked_matmul(x, w, b, mask), **TOL
    )


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [MM_MAIN[0], MM_MAIN[2]])
def test_masked_matmul_is_deterministic(card, shape):
    """The split-K sum runs in rank order: two calls agree bit for bit."""
    x, w, b, mask = _mm_inputs(*shape, card, use_mask=shape[2] > 10)
    assert mk.plan(*shape, mk.n_sm(card)).cl > 1
    first = ops.masked_matmul(x, w, b, mask=mask)
    second = ops.masked_matmul(x, w, b, mask=mask)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (128, 30, 100), (1024, 30, 100), (1024, 1, 10),  # the main path
    (64, 3, 7), (16, 5, 70),                          # n_mcu % 4 != 0
    (16, 2, 129), (8, 3, 130), (8, 2, 256), (4, 2, 1000),  # above 128
])
def test_hcu_softmax_shapes(card, shape):
    rows, n_hcu, n_mcu = shape
    s = torch.as_tensor(
        np.random.default_rng(rows + n_mcu).standard_normal((rows, n_hcu * n_mcu)) * 4.0,
        dtype=torch.float32, device=card,
    )
    want = ref.hcu_softmax(s, n_hcu, n_mcu)
    for t in (s, _unaligned(s)):  # a 16-byte aligned base, then one that is not
        got = ops.hcu_softmax(t, n_hcu, n_mcu)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        assert torch.equal(got, ops.hcu_softmax(t, n_hcu, n_mcu))


# --- masked_matmul's gathered variant (hcu_mask=) ---

# The gathered sums run over a hidden HCU's kept units (2,048 at the
# STL-10 width) in another order than the plain version's product over the
# expanded mask.  Two orders of an f32 sum of n terms whose partial sums are
# of order 1 differ by at most about n * 2^-24: 1.2e-4 at n = 2,048.
GATHER_TOL = dict(rtol=1e-4, atol=2048 * 2.0 ** -24)
STL = (27648, 2, 20, 150, 1024)  # n_pre_hcu, pre_mcu, n_post_hcu, post_mcu, fan_in


def _hcu_mask(n_pre, n_post, fan_in, device, seed=11, counts=None):
    """A random (n_pre, n_post) 0/1 mask keeping ``fan_in`` input HCUs in
    each hidden HCU's column, or ``counts[h]`` in column h."""
    rng = np.random.default_rng(seed)
    counts = [fan_in] * n_post if counts is None else counts
    m = np.zeros((n_pre, n_post), dtype=np.float32)
    for h, c in enumerate(counts):
        m[rng.permutation(n_pre)[:c], h] = 1.0
    return torch.as_tensor(m, device=device)


def _gather_inputs(m, n_pre, pre_mcu, n_post, post_mcu, device, seed=3):
    rng = np.random.default_rng(seed)
    k, n = n_pre * pre_mcu, n_post * post_mcu
    x = torch.as_tensor(rng.random((m, k), dtype=np.float32), device=device)
    w = torch.as_tensor(rng.standard_normal((k, n), dtype=np.float32) * 0.1, device=device)
    b = torch.as_tensor(rng.standard_normal(n, dtype=np.float32) * 0.1, device=device)
    return x, w, b


def _gathered(x, w, b, hm, pre_mcu, post_mcu, fan_in=None, cl=None):
    """The gathered kernel's product, at the plan's CL or at ``cl``."""
    assert mk.gathers(x, w, b, hm, pre_mcu, post_mcu, fan_in) or cl is not None
    if cl is None:
        return ops.masked_matmul(x, w, b, hcu_mask=hm, pre_mcu=pre_mcu, post_mcu=post_mcu,
                                 fan_in=fan_in)
    out = torch.empty((x.shape[0], w.shape[1]), device=x.device)
    p = mk.Plan("gathered", cl, 0, 0, 0)
    return mk.launch_gathered(x, w, b, hm, pre_mcu, post_mcu, out, p)


def _want(x, w, b, hm, pre_mcu, post_mcu):
    return ref.masked_matmul(x, w, b, ref.unit_mask(hm, pre_mcu, post_mcu))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [128, 1024])
def test_gathered_stl10_width(card, rows):
    """The main path's shapes: 55,296 x 3,000, 1,024 of 27,648 input HCUs
    kept a hidden HCU (the odd HCUs' columns 8-byte aligned only), one
    gathered launch a product."""
    n_pre, pre_mcu, n_post, post_mcu, fan_in = STL
    x, w, b = _gather_inputs(rows, n_pre, pre_mcu, n_post, post_mcu, card)
    hm = _hcu_mask(n_pre, n_post, fan_in, card)
    ops.reset_launches()
    got = _gathered(x, w, b, hm, pre_mcu, post_mcu, fan_in)
    counts = ops.launch_counts()
    assert counts["masked_matmul"] == counts["masked_matmul.gathered"] == 1
    torch.testing.assert_close(got, _want(x, w, b, hm, pre_mcu, post_mcu), **GATHER_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("cl", range(1, mk.MAX_CLUSTER + 1))
@pytest.mark.parametrize("shape", [
    (130, 300, 2, 8, 150, 40),   # ragged rows; odd HCUs start 8 bytes past 16
    (65, 97, 2, 5, 200, 30),     # 200 minicolumns: two column tiles a HCU
    (33, 50, 3, 3, 7, 20),       # three-unit input HCUs; N % 4 != 0
    (17, 64, 1, 6, 161, 64),     # one-unit input HCUs, the full mask
])
def test_gathered_every_cluster_size(card, shape, cl):
    m, n_pre, pre_mcu, n_post, post_mcu, fan_in = shape
    x, w, b = _gather_inputs(m, n_pre, pre_mcu, n_post, post_mcu, card)
    hm = _hcu_mask(n_pre, n_post, fan_in, card)
    got = _gathered(x, w, b, hm, pre_mcu, post_mcu, cl=cl)
    torch.testing.assert_close(got, _want(x, w, b, hm, pre_mcu, post_mcu), **GATHER_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("use_bias", [True, False])
def test_gathered_unequal_and_empty_lists(card, use_bias):
    """Unequal kept counts (a loaded checkpoint), a hidden HCU with none
    kept (its columns are the bias alone), one with all kept."""
    n_pre, n_post, post_mcu = 500, 6, 150
    x, w, b = _gather_inputs(96, n_pre, 2, n_post, post_mcu, card)
    b = b if use_bias else None
    hm = _hcu_mask(n_pre, n_post, 0, card, counts=[10, 0, 250, n_pre, 1, 37])
    for cl in (1, 3, 8):
        got = _gathered(x, w, b, hm, 2, post_mcu, cl=cl)
        torch.testing.assert_close(got, _want(x, w, b, hm, 2, post_mcu), **GATHER_TOL)
        cols = slice(post_mcu, 2 * post_mcu)
        want = torch.zeros_like(got[:, cols]) if b is None else b[cols].expand_as(got[:, cols])
        assert torch.equal(got[:, cols], want)


@pytest.mark.cuda
def test_gathered_unaligned_bases(card):
    """x 4 bytes past an 8-byte boundary (no 8-byte pieces), w and the
    output not 16-byte aligned (4-byte copies)."""
    x, w, b = _gather_inputs(40, 200, 2, 4, 150, card)
    hm = _hcu_mask(200, 4, 60, card)
    want = _want(x, w, b, hm, 2, 150)
    for xt, wt in ((_unaligned(x), w), (x, _unaligned(w)), (_unaligned(x), _unaligned(w))):
        got = _gathered(xt, wt, b, hm, 2, 150, cl=2)
        torch.testing.assert_close(got, want, **GATHER_TOL)


@pytest.mark.cuda
def test_gathered_is_deterministic(card):
    """Two calls agree bit for bit (the split's rank-order sum)."""
    n_pre, pre_mcu, n_post, post_mcu, fan_in = STL
    x, w, b = _gather_inputs(128, n_pre, pre_mcu, n_post, post_mcu, card)
    hm = _hcu_mask(n_pre, n_post, fan_in, card)
    assert mk.plan(*mk._gathered_key(x, w, hm, pre_mcu, post_mcu, fan_in)).cl > 1
    first = _gathered(x, w, b, hm, pre_mcu, post_mcu, fan_in)
    second = _gathered(x, w, b, hm, pre_mcu, post_mcu, fan_in)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


@pytest.mark.cuda
def test_hcu_mask_entry_refuses_a_dense_plan(card):
    """At the MNIST width (392 of 784 input HCUs kept) the plan is dense:
    ``hcu_mask=`` raises, as it does with the plain versions asked for, and
    launches nothing; the layer step passes the expanded mask there."""
    x, w, b = _gather_inputs(128, 784, 2, 30, 100, card)
    hm = _hcu_mask(784, 30, 392, card)
    assert not mk.gathers(x, w, b, hm, 2, 100, 392)
    ops.reset_launches()
    for plain in (False, True):
        with pytest.raises(ValueError, match="expanded mask"):
            mk.masked_matmul(x, w, b, hcu_mask=hm, pre_mcu=2, post_mcu=100, fan_in=392,
                             plain=plain)
    assert not any(ops.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [None, [5, 0, 300, 1], [300] * 4, [0] * 4])
def test_kept_lists_match_plain(card, counts):
    hm = _hcu_mask(300, 4, 17, card, counts=counts)
    kept, n = mk.kept_lists(hm)
    want_kept, want_n = ref.kept_lists(hm)
    assert torch.equal(n, want_n)
    for h in range(4):
        assert torch.equal(kept[h, :int(n[h])], want_kept[h, :int(n[h])])
    assert mk.kept_lists(hm)[0] is kept, "cached by the mask's identity"
    hm.mul_(1.0)  # changed in place: built again
    assert mk.kept_lists(hm)[0] is not kept


@pytest.mark.cuda
def test_gathered_one_kernel_launch_in_a_trace(card):
    """One device operation matching masked_matmul_kernel a product (the
    benchmark's roofline finds kernels by that symbol); the list-building kernel,
    launched on the mask's first use, matches no kernel's symbol."""
    import re

    n_pre, pre_mcu, n_post, post_mcu, fan_in = STL
    x, w, b = _gather_inputs(128, n_pre, pre_mcu, n_post, post_mcu, card)
    hm = _hcu_mask(n_pre, n_post, fan_in, card)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            _gathered(x, w, b, hm, pre_mcu, post_mcu, fan_in)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ours = [n for n in names if re.search(r"\bmasked_matmul_kernel\b", n)]
    assert len(ours) == 2, names
    builds = [n for n in names if "build_kept_lists" in n]
    assert len(builds) == 1, names
    assert not any(re.search(rf"\b{k}_kernel\b", n) for n in builds
                   for k in ops.KERNELS)


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [False, True])
def test_gathered_fit_on_card_matches_cpu(card, strict):
    """A Listing 1 fit at a width whose hidden product gathers (50 of 2,000
    input HCUs kept a hidden HCU): every hidden product, and only those, is
    one gathered launch, counted alike by ``ops.launch_counts()`` and the
    tracer, with no unit mask expanded for a projection; the states and
    scores hold to the CPU's plain fit; strict mode sees one plan a shape
    (its fit alone: a predict on the test split is a new projection
    signature, which strict mode refuses)."""
    ds = mnist_like(n_train=256, n_test=64, n_features=2000, seed=0)
    x, layout = complementary_code(ds.x_train)
    xt, _ = complementary_code(ds.x_test)
    hidden = UnitLayout(4, 150)
    net = Network(seed=0)
    net.add(StructuralPlasticityLayer(layout, hidden, fan_in=50, lam=0.05, gain=4.0,
                                      mask_update_every=2))
    net.add(DenseLayer(hidden, onehot_layout(10), lam=0.05))
    gpu = net.compile(ExecutionConfig(strict=strict))
    cpu = net.compile(ExecutionConfig(device="cpu"))
    assert mk.plan(64, 4000, 600, mk.n_sm(card), 100, 150).config == "gathered"
    ops.reset_launches()
    with gpu.tracing() as tr:
        gpu.fit((x, ds.y_train), epochs_hidden=1, epochs_readout=1, batch_size=64)
        got = None if strict else gpu.predict(xt, batch_size=32)
    counts = ops.launch_counts()
    cpu.fit((x, ds.y_train), epochs_hidden=1, epochs_readout=1, batch_size=64)
    hidden_steps = [s for s in tr.spans("layer.step") if s.attrs["layer"] == 0]
    projects = tr.spans("store.project")
    want = len(hidden_steps) + sum(p.attrs["chunks"] for p in projects)
    assert counts["masked_matmul.gathered"] == tr.counters()["masked_matmul.gathered"] == want
    assert counts["masked_matmul"] == want + len(tr.spans("predict.chunk"))  # + the head's
    assert not [m for m in tr.spans("layer.unit_mask") if m.parent in {p.seq for p in projects}]
    for sg, sc in zip(gpu.state.layers, cpu.state.layers):
        torch.testing.assert_close(sg.w.cpu(), sc.w, rtol=1e-4, atol=1e-4)
        if sc.plast is not None:
            assert torch.equal(sg.plast.hcu_mask.cpu(), sc.plast.hcu_mask)
    if not strict:
        torch.testing.assert_close(got.cpu(), cpu.predict(xt, batch_size=32), rtol=1e-4,
                                   atol=1e-5)
    else:
        sizes = gpu._sentinel.sizes()
        assert any(k.endswith(">masked_matmul.plan") for k in sizes)
        assert all(v == 1 for v in sizes.values()), sizes


# --- the training pair: bcpnn_update at every launch plan, both kernels
# deterministic at the main path's shapes ---

def _update_inputs(b, f, h, device, use_mask, seed=5):
    rng = np.random.default_rng(seed)
    arrs = (
        rng.random((b, f)), rng.random((b, h)),
        rng.random(f) * 0.5 + 0.25, rng.random(h) * 0.5 + 0.25,
        rng.random((f, h)) * 0.25 + 0.1,
        (rng.random((f, h)) > 0.3) if use_mask else None,
    )
    return [None if a is None else torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in arrs]


def _shifted(t):
    """A contiguous copy of t (f32 or bf16) whose base is 4 bytes past a
    16-byte boundary."""
    k = 4 // t.element_size()
    flat = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    view = flat[k:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    return view


def _forced_update_plan(b, f, h, config, cl):
    cfg = bk.CONFIGS[config]
    bslice = bk.bslice_for(b, cl, cfg.bk)
    assert (cl - 1) * bslice < b <= cl * bslice, "every batch slice non-empty"
    return bk.Plan(config, cl, bslice, bk._cdiv(f, cfg.tf), bk._cdiv(h, cfg.th))


# (config, H, state mantissa, mask): the prefetched tile with f32 and with
# bf16 traces (H % 8 == 0), 16-byte rows without the prefetch (bf16, H % 8
# != 0), 4-byte rows (H % 4 != 0), and the narrow tile with 4- and 16-byte rows.
UPDATE_PLAN_CASES = [
    ("wide", 140, None, True),
    ("wide", 144, 7, True),
    ("wide", 140, 7, True),
    ("wide", 142, None, False),
    ("narrow", 10, None, False),
    ("narrow", 12, 7, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("cl", range(1, bk.MAX_CLUSTER + 1))
@pytest.mark.parametrize("config,h,mant,use_mask", UPDATE_PLAN_CASES)
def test_bcpnn_update_every_plan(card, config, h, mant, use_mask, cl):
    """Each tile configuration at each cluster size, on a batch (600) that
    every CL splits into non-empty slices and a ragged F (300)."""
    b, f = 600, 300
    ai, aj, ci, cj, cij, mask = _update_inputs(b, f, h, card, use_mask)
    dtype = torch.bfloat16 if mant == 7 else torch.float32
    ci, cj, cij = ci.to(dtype), cj.to(dtype), cij.to(dtype)
    got = bk.launch_planned(ai, aj, ci, cj, cij, 0.05, 0.7, mask, mant, dtype,
                            _forced_update_plan(b, f, h, config, cl))
    want = ref.bcpnn_update(ai, aj, ci, cj, cij, 0.05, k_b=0.7, mask=mask, state_mantissa=mant)
    if mant is None:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
    else:
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == torch.bfloat16
            _state_close(g, w, mant)
        for g, w in zip(got[3:], want[3:]):
            torch.testing.assert_close(g, w, rtol=0, atol=2.0 ** -(mant - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("mant", [None, 7])
def test_bcpnn_update_unaligned_base(card, mant):
    """Rows whose length is a multiple of 8 but whose base is not 16-byte
    aligned take the 4-byte path, without the prefetch."""
    ai, aj, ci, cj, cij, mask = _update_inputs(96, 256, 136, card, True)
    dtype = torch.bfloat16 if mant else torch.float32
    ci, cj, cij = ci.to(dtype), cj.to(dtype), _shifted(cij.to(dtype))
    got = bk.bcpnn_update(ai, aj, ci, cj, cij, 0.05, k_b=0.7, mask=_shifted(mask),
                          state_mantissa=mant, state_dtype=dtype if mant else None)
    want = ref.bcpnn_update(ai, aj, ci, cj, cij, 0.05, k_b=0.7, mask=mask, state_mantissa=mant)
    for g, w in zip(got, want):
        if mant:
            torch.testing.assert_close(g.float(), w, rtol=2.0**-mant, atol=2.0 ** -(mant - 1))
        else:
            torch.testing.assert_close(g, w, **TOL)


# (B, F, H, mask): the hidden update of the unfused path and the readout.
UPDATE_MAIN = [(128, 1568, 3000, True), (128, 3000, 10, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", UPDATE_MAIN)
def test_bcpnn_update_main_path_shapes(card, shape):
    b, f, h, use_mask = shape
    ai, aj, ci, cj, cij, mask = _update_inputs(b, f, h, card, use_mask)
    got = bk.bcpnn_update(ai, aj, ci, cj, cij, 0.02, k_b=1.0, mask=mask)
    want = ref.bcpnn_update(ai, aj, ci, cj, cij, 0.02, k_b=1.0, mask=mask)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("mant", [None, 7])
@pytest.mark.parametrize("shape", UPDATE_MAIN)
def test_bcpnn_update_is_deterministic(card, shape, mant):
    """No atomics, sums in a fixed order: two calls agree bit for bit."""
    b, f, h, use_mask = shape
    ai, aj, ci, cj, cij, mask = _update_inputs(b, f, h, card, use_mask)
    dtype = torch.bfloat16 if mant else None
    state = [t.to(dtype or torch.float32) for t in (ci, cj, cij)]
    first = bk.bcpnn_update(ai, aj, *state, 0.02, mask=mask, state_mantissa=mant, state_dtype=dtype)
    second = bk.bcpnn_update(ai, aj, *state, 0.02, mask=mask, state_mantissa=mant, state_dtype=dtype)
    for g, w in zip(first, second):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
@pytest.mark.parametrize("mant", [None, 7])
def test_bcpnn_phase_is_deterministic(card, mant):
    """The rank-order sums of the softmax and the fixed update order: two
    calls at the main path's shape agree bit for bit."""
    p = _problem(128, 1568, 30, 100, True, card)
    dtype = torch.bfloat16 if mant else None
    state = [p[k].to(dtype or torch.float32) for k in ("ci", "cj", "cij")]
    args = (p["x"], p["w"], p["b"], *state, 0.02, 30, 100)
    kw = dict(k_b=1.0, gain=4.0, mask=p["mask"], state_mantissa=mant, state_dtype=dtype)
    first, second = pk.bcpnn_phase(*args, **kw), pk.bcpnn_phase(*args, **kw)
    for g, w in zip(first, second):
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
def test_bcpnn_phase_profile_variant(card):
    """The profiling variant computes what the kernel computes and stamps
    every CTA of the plan."""
    p = _problem(128, 1568, 30, 100, True, card)
    args = (p["x"], p["w"], p["b"], p["ci"], p["cj"], p["cij"], 0.02, 30, 100)
    kw = dict(k_b=1.0, gain=4.0, mask=p["mask"])
    before = ops.launch_counts()["bcpnn_phase"]
    outs, prof = pk.profile(*args, **kw)
    for g, w in zip(outs, pk.bcpnn_phase(*args, **kw)):
        assert torch.equal(g, w)
    assert prof.shape == (pk.plan(128, 1568, 30, 100).ctas, 2 + len(pk.PHASES))
    assert bool((prof[:, 1] >= prof[:, 0]).all()) and bool((prof[:, 0] > 0).all())
    assert ops.launch_counts()["bcpnn_phase"] == before + 1  # the profiled call is not counted


# --- the serving path's shapes: bucket-padded chunks and single rows of the
# forward pair, streaming micro-batches of the training pair ---

@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 10, 16, 64])
def test_forward_pair_serving_shapes(card, m):
    """The hidden layer (1568x3000, 30x100) and the head (3000x10, 1x10) at
    the served row counts and the streaming tail's 10 rows, the rows a view
    at an odd row offset."""
    x, w, b, mask = _mm_inputs(m + 1, 1568, 3000, card)
    rows = x[1:]
    s = ops.masked_matmul(rows, w, b, mask=mask)
    torch.testing.assert_close(s, ref.masked_matmul(rows, w, b, mask), **TOL)
    a = ops.hcu_softmax(4.0 * s, 30, 100)
    torch.testing.assert_close(a, ref.hcu_softmax(4.0 * s, 30, 100), rtol=1e-5, atol=1e-6)
    _, w_r, b_r, _ = _mm_inputs(1, 3000, 10, card, use_mask=False)
    head = ops.masked_matmul(a, w_r, b_r)
    torch.testing.assert_close(head, ref.masked_matmul(a, w_r, b_r), **TOL)
    torch.testing.assert_close(ops.hcu_softmax(head, 1, 10), ref.hcu_softmax(head, 1, 10),
                               rtol=1e-5, atol=1e-6)
    # Each row alone computes what it computes among the others.
    assert torch.equal(ops.masked_matmul(rows[-1:], w, b, mask=mask), s[-1:])


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 10, 16])
def test_bcpnn_update_streaming_batches(card, b):
    """Streaming flushes of 1..16 rows at the hidden shape, f32: padded batch
    rows stay out of the sums and the means divide by the true B."""
    ai, aj, ci, cj, cij, mask = _update_inputs(b, 1568, 3000, card, True)
    got = bk.bcpnn_update(ai, aj, ci, cj, cij, 0.02, k_b=1.0, mask=mask)
    want = ref.bcpnn_update(ai, aj, ci, cj, cij, 0.02, k_b=1.0, mask=mask)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [10, 16])
def test_bcpnn_phase_streaming_batches(card, b):
    """Fused streaming flushes of 10 and 16 rows, bf16 state: most of the
    forward tile is padding, kept out of the softmax and the update."""
    shape = (b, 1568, 30, 100)
    p = _problem(*shape, True, card)
    ci, cj, cij = (p[k].to(torch.bfloat16) for k in ("ci", "cj", "cij"))
    args = _phase_args(p, shape)
    kw = dict(k_b=1.0, gain=4.0, mask=p["mask"], state_mantissa=7)
    got = pk.bcpnn_phase(*args[:3], ci, cj, cij, *args[6:], state_dtype=torch.bfloat16, **kw)
    want = ref.bcpnn_phase(*args[:3], ci, cj, cij, *args[6:], **kw)
    torch.testing.assert_close(got[0], want[0], **TOL)
    for g, w in zip(got[1:4], want[1:4]):
        assert g.dtype == torch.bfloat16
        _state_close(g, w, 7)
    for g, w in zip(got[4:], want[4:]):
        torch.testing.assert_close(g, w, rtol=0, atol=2.0**-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1568), (4, 1568), (16, 1568), (64, 1568), (4, 3000),
                                   (16, 3000), (64, 3000), (4, 10), (16, 10), (64, 10)])
def test_bf_round_serving_shapes(card, shape):
    rng = np.random.default_rng(shape[0])
    x = torch.as_tensor(rng.standard_normal(shape) * 8.0, dtype=torch.float32, device=card)
    assert torch.equal(ops.bf_round(x, 11).view(torch.int32),
                       ref.bf_round(x, 11).view(torch.int32))


@pytest.mark.cuda
def test_serving_on_card_matches_cpu(card):
    """The batched plan (sync and async) and the streaming plan on the card
    against the same on the CPU, from one state."""
    from repro_torch.runtime import ServiceConfig

    ds = mnist_like(n_train=256, n_test=64, n_features=24, seed=0)
    x, layout = complementary_code(ds.x_train)
    net = Network(seed=0)
    net.add(StructuralPlasticityLayer(layout, UnitLayout(4, 10), fan_in=12, lam=0.05, gain=4.0))
    net.add(DenseLayer(UnitLayout(4, 10), onehot_layout(10), lam=0.05))
    gpu, cpu = net.compile(), net.compile(ExecutionConfig(device="cpu"))
    for c in (gpu, cpu):
        c.fit((x, ds.y_train), epochs_hidden=1, epochs_readout=1, batch_size=64)
    cfg = ServiceConfig(plan="batched", buckets=(4, 16, 64))
    for n in (1, 5, 17, 64, 100):
        got = gpu.serve(cfg).predict(x[:n])
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), cpu.serve(cfg).predict(x[:n]), rtol=1e-4, atol=1e-5)
    svc = gpu.serve(ServiceConfig(plan="batched", max_batch=16, async_mode=True))
    futs = [svc.submit(r) for r in x[:40]]
    served = np.stack([f.result(timeout=60) for f in futs])
    svc.drain_and_stop()
    torch.testing.assert_close(torch.from_numpy(served), cpu.predict(x[:40]), rtol=1e-4, atol=1e-5)
    sessions = [c.serve(ServiceConfig(plan="streaming", max_batch=16)) for c in (gpu, cpu)]
    for s in sessions:
        for row in x[:40]:
            s.feed(row)
        s.close()
    for sg, sc in zip(gpu.state.layers, cpu.state.layers):
        torch.testing.assert_close(sg.w.cpu(), sc.w, rtol=1e-4, atol=1e-4)
        assert sg.host_step == sc.host_step


# --- the continual tier's feedback micro-batch: B = 8 ---

@pytest.mark.cuda
@pytest.mark.parametrize("layer", ["hidden", "readout", "hidden_bf16_fused"])
def test_continual_update_at_b8_matches_plain(card, layer):
    """One continual update of 8 feedback rows at MNIST width on each
    adapted layer: the hidden update (1568x3000, masked), the readout's
    (3000x10, through the frozen prefix's codes) and the fused bf16-state
    hidden phase, each against its plain version on the same inputs."""
    if layer == "hidden":
        ai, aj, ci, cj, cij, mask = _update_inputs(8, 1568, 3000, card, True)
        got = bk.bcpnn_update(ai, aj, ci, cj, cij, 0.02, k_b=1.0, mask=mask)
        want = ref.bcpnn_update(ai, aj, ci, cj, cij, 0.02, k_b=1.0, mask=mask)
    elif layer == "readout":
        ai, _, ci, cj, cij, _ = _update_inputs(8, 3000, 10, card, False)
        aj = torch.nn.functional.one_hot(torch.arange(8, device=card) % 10, 10).float()
        got = bk.bcpnn_update(ai, aj, ci, cj, cij, 0.02, k_b=1.0)
        want = ref.bcpnn_update(ai, aj, ci, cj, cij, 0.02, k_b=1.0)
    else:
        shape = (8, 1568, 30, 100)
        p = _problem(*shape, True, card)
        # After a merge the traces are f32 while the policy stores bf16.
        args = _phase_args(p, shape)
        kw = dict(k_b=1.0, gain=4.0, mask=p["mask"], state_mantissa=7)
        got = pk.bcpnn_phase(*args, state_dtype=torch.bfloat16, **kw)
        want = ref.bcpnn_phase(*args, **kw)
        torch.testing.assert_close(got[0], want[0], **TOL)
        for g, w in zip(got[1:4], want[1:4]):
            assert g.dtype == torch.bfloat16
            _state_close(g, w, 7)
        for g, w in zip(got[4:], want[4:]):
            torch.testing.assert_close(g, w, rtol=0, atol=2.0**-6)
        return
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [0, -1])
def test_continual_tier_on_card_matches_cpu(card, layer):
    """The continual plan's sync drain on the card against the same on the
    CPU, from one fitted state, over one feedback stream with a label
    flip: equal acks, and the adopted base within the kernels' tolerance."""
    from repro_torch.runtime import ContinualConfig, Feedback, ServiceConfig

    ds = mnist_like(n_train=256, n_test=64, n_features=24, seed=0, n_classes=4,
                    prototypes_per_class=2, noise=0.05, informative_fraction=1.0)
    x, layout = complementary_code(ds.x_train)
    net = Network(seed=0)
    net.add(StructuralPlasticityLayer(layout, UnitLayout(4, 10), fan_in=12, lam=0.05, gain=4.0))
    net.add(DenseLayer(UnitLayout(4, 10), onehot_layout(4), lam=0.05))
    cpu = net.compile(ExecutionConfig(device="cpu"))
    cpu.fit((x, ds.y_train), epochs_hidden=2, epochs_readout=2, batch_size=64)
    gpu = net.compile()
    gpu.state = cpu.state._replace(layers=tuple(s.to(card) for s in cpu.state.layers))
    cc = ContinualConfig(layer=layer, update_batch=8, update_budget=16, merge_every=2,
                         drift_window=16, drift_min_samples=8, drift_threshold=0.4)
    svcs = [c.serve(ServiceConfig(continual=cc)) for c in (gpu, cpu)]
    y = np.concatenate([ds.y_train[:64], (ds.y_train[64:96] + 1) % 4, ds.y_train[96:128]])
    for s in svcs:
        for k in range(128):
            s.submit(Feedback(x[k], int(y[k]), tenant="ab"[k % 2]))
    acks_gpu, acks_cpu = (s.drain() for s in svcs)
    for a, b in zip(acks_gpu, acks_cpu):
        assert {k: v for k, v in a.items() if k != "confidence"} == \
            {k: v for k, v in b.items() if k != "confidence"}
    assert any(a["merged"] for a in acks_cpu)
    for sg, sc in zip(gpu.state.layers, cpu.state.layers):
        assert sg.host_step == sc.host_step == int(sg.step)
        torch.testing.assert_close(sg.marginals.cij.cpu(), sc.marginals.cij, rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(sg.w.cpu(), sc.w, rtol=1e-4, atol=1e-4)


# --- the reduced datapath's modes: every stage rounded inside the kernel ---

# f32 tolerances of each stage, (rtol, atol relative to max|want|), as in
# tests/test_torch_datapath.py: the support sums K products in another
# order than the plain version's library product, the softmax and the
# traces are a few f32 operations, w and bias sums of three logs.
DP_SUPPORT_TOL, DP_SOFTMAX_TOL = (1e-4, 1e-5), (1e-5, 1e-6)
DP_TRACE_TOL, DP_LOG_TOL = (1e-5, 1e-8), (1e-5, 1e-6)
DP_SHAPES = SHAPES + [(128, 1568, 30, 100)]


def _stage(got, want, mantissa, tol, carry=0.0):
    """The stage rule: every element within one ulp of the format plus the
    stage's f32 tolerance plus ``carry`` (what inputs that rounded apart
    carry into it), and at most 1% of the elements without a carry (at least
    one) beyond the f32 tolerance: rounded to a neighbour after an f32 sum
    in another order."""
    g, w = got.double().cpu(), want.double().cpu()
    assert g.shape == w.shape and bool(torch.isfinite(g).all())
    carry = torch.as_tensor(carry, dtype=torch.float64).expand_as(w)
    diff = (g - w).abs()
    f32 = tol[0] * w.abs() + tol[1] * float(w.abs().max())
    ulp = torch.ldexp(torch.ones_like(w),
                      torch.frexp(torch.maximum(g.abs(), w.abs())).exponent - 1 - mantissa)
    assert not bool((diff > ulp + f32 + carry).any()), float((diff - ulp - f32 - carry).max())
    assert int(((diff > f32) & (carry == 0)).sum()) <= max(1, 0.01 * diff.numel())


def _update_stages(got, want, mantissa, trace_mantissa, mask, k_b=0.7):
    for g, w in zip(got[:3], want[:3]):
        _stage(g, w, trace_mantissa, DP_TRACE_TOL)
    dlog = [(torch.log(g.double().clamp_min(1e-8)) - torch.log(w.double().clamp_min(1e-8))).abs()
            for g, w in zip(got[:3], want[:3])]
    carry_w = dlog[2] + dlog[0][:, None] + dlog[1][None, :]
    if mask is not None:
        carry_w = carry_w * mask
    _stage(got[3], want[3], mantissa, DP_LOG_TOL, carry=carry_w.cpu())
    _stage(got[4], want[4], mantissa, DP_LOG_TOL, carry=(k_b * dlog[1]).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("mant", [5, 11, 19])
@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("shape", DP_SHAPES)
def test_datapath_forward_modes_match_plain_on_card(card, shape, use_mask, mant):
    """The forward pair's rounding modes against their plain versions, the
    gain inside masked_matmul; each counted as a launch of its kernel and of
    its mode."""
    p = _problem(*shape, use_mask, card)
    _, _, n_hcu, n_mcu = shape
    before = ops.launch_counts()
    for gain in (1.0, 4.0):
        s = ops.masked_matmul(p["x"], p["w"], p["b"], mask=p["mask"], round_mantissa=mant,
                              gain=gain)
        want = ref.masked_matmul(p["x"], p["w"], p["b"], mask=p["mask"], round_mantissa=mant,
                                 gain=gain)
        _stage(s, want, mant, DP_SUPPORT_TOL)
    a = ops.hcu_softmax(want, n_hcu, n_mcu, round_mantissa=mant)
    _stage(a, ref.hcu_softmax(want, n_hcu, n_mcu, round_mantissa=mant), mant, DP_SOFTMAX_TOL)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["masked_matmul"] - before["masked_matmul"] == 2
    assert after["masked_matmul.datapath"] - before["masked_matmul.datapath"] == 2
    assert after["hcu_softmax.datapath"] - before["hcu_softmax.datapath"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("state", [None, (7, torch.bfloat16), (11, None)])
@pytest.mark.parametrize("mant", [5, 11, 19])
@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("shape", DP_SHAPES)
def test_datapath_update_mode_matches_plain_on_card(card, shape, use_mask, mant, state):
    """bcpnn_update's datapath mode (the whole quantized learning cycle,
    the state tier after it) against its plain version."""
    p = _problem(*shape, use_mask, card)
    smant, sdtype = state or (None, None)
    store = sdtype or torch.float32
    ci, cj, cij = (p[k].to(store) for k in ("ci", "cj", "cij"))
    before = ops.launch_counts()["bcpnn_update.datapath"]
    got = bk.bcpnn_update(p["x"], p["aj"], ci, cj, cij, 0.05, k_b=0.7, mask=p["mask"],
                          state_mantissa=smant, state_dtype=sdtype, datapath_mantissa=mant)
    want = ref.bcpnn_update(p["x"], p["aj"], ci, cj, cij, 0.05, k_b=0.7, mask=p["mask"],
                            state_mantissa=smant, datapath_mantissa=mant)
    assert all(g.dtype == store for g in got[:3])
    _update_stages(got, want, mant, min(mant, smant or 23), p["mask"])
    torch.cuda.synchronize()
    assert ops.launch_counts()["bcpnn_update.datapath"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("cl", range(1, mk.MAX_CLUSTER + 1))
@pytest.mark.parametrize("config,n", [("wide", 300), ("narrow", 12)])
def test_datapath_support_every_plan(card, config, n, cl):
    """The rounding mode at each cluster size: a split K rounds only the
    rank-order sum of the partial tiles."""
    m, k = 200, 1000
    x, w, b, mask = _mm_inputs(m, k, n, card)
    out = torch.empty((m, n), dtype=torch.float32, device=card)
    got = mk.launch_planned(x, w, b, mask, out, _forced_plan(m, k, n, config, cl),
                            round_mantissa=11, gain=4.0)
    _stage(got, ref.masked_matmul(x, w, b, mask, round_mantissa=11, gain=4.0), 11, DP_SUPPORT_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("cl", range(1, bk.MAX_CLUSTER + 1))
@pytest.mark.parametrize("config,h,mant,use_mask", UPDATE_PLAN_CASES)
def test_datapath_update_every_plan(card, config, h, mant, use_mask, cl):
    """The datapath mode at each tile configuration and cluster size: a
    split batch rounds the means only after the cluster's sum."""
    b, f = 600, 300
    ai, aj, ci, cj, cij, mask = _update_inputs(b, f, h, card, use_mask)
    dtype = torch.bfloat16 if mant == 7 else torch.float32
    ci, cj, cij = ci.to(dtype), cj.to(dtype), cij.to(dtype)
    got = bk.launch_planned(ai, aj, ci, cj, cij, 0.05, 0.7, mask, mant, dtype,
                            _forced_update_plan(b, f, h, config, cl), datapath_mantissa=11)
    want = ref.bcpnn_update(ai, aj, ci, cj, cij, 0.05, k_b=0.7, mask=mask, state_mantissa=mant,
                            datapath_mantissa=11)
    _update_stages(got, want, 11, min(11, mant or 23), mask)


@pytest.mark.cuda
def test_datapath_fit_on_card_matches_cpu(card):
    """A small datapath fit (bf20) on the card against the same fit on the
    CPU: three launches a hidden batch (the forward pair in its rounding
    mode, one datapath update), none of bf_round."""
    ds = mnist_like(n_train=512, n_test=128, n_features=24, seed=0)
    x, layout = complementary_code(ds.x_train)
    xt, _ = complementary_code(ds.x_test)
    net = Network(seed=0)
    net.add(StructuralPlasticityLayer(layout, UnitLayout(4, 10), fan_in=12, lam=0.05, gain=4.0))
    net.add(DenseLayer(UnitLayout(4, 10), onehot_layout(10), lam=0.05))
    ops.reset_launches()
    gpu = net.compile(ExecutionConfig(precision="bf20"))
    cpu = net.compile(ExecutionConfig(device="cpu", precision="bf20"))
    for c in (gpu, cpu):
        c.fit((x, ds.y_train), epochs_hidden=1, epochs_readout=1, batch_size=64)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    batches = len(x) // 64
    assert counts["bf_round"] == 0 and counts["bcpnn_phase"] == 0
    assert counts["bcpnn_update"] == counts["bcpnn_update.datapath"] == 2 * batches
    assert counts["masked_matmul"] == counts["masked_matmul.datapath"] >= batches
    assert counts["hcu_softmax"] == counts["hcu_softmax.datapath"] == counts["masked_matmul"]
    for sg, sc in zip(gpu.state.layers, cpu.state.layers):
        if sc.plast is not None:
            assert torch.equal(sg.plast.hcu_mask.cpu(), sc.plast.hcu_mask)
    # A trace one format ulp apart moves the scores by about as much; the
    # bf16-state fit above is held the same way.
    torch.testing.assert_close(gpu.predict(xt).cpu(), cpu.predict(xt), rtol=0, atol=2.0**-6)


# ------------------------------------------------------- the hot-path guard
def _guard_net(card, **config):
    ds = mnist_like(n_train=256, n_test=64, n_features=32, seed=0)
    x, layout = complementary_code(ds.x_train)
    net = Network(seed=0).add(
        StructuralPlasticityLayer(layout, UnitLayout(4, 8), fan_in=16, lam=0.05, gain=4.0)
    ).add(DenseLayer(UnitLayout(4, 8), onehot_layout(10), lam=0.05))
    c = net.compile(ExecutionConfig(device=str(card), **config))
    c.fit((np.asarray(x, np.float32), ds.y_train), epochs_hidden=1, epochs_readout=1,
          batch_size=64)
    return c, np.asarray(x, np.float32), ds.y_train


@pytest.mark.cuda
def test_guard_refuses_a_sync_in_its_thread_only(card):
    import threading

    from repro_torch.analysis.strict import HostTransferError, dispatch_guard

    t = torch.arange(64, device=card, dtype=torch.float32)
    with pytest.raises(HostTransferError, match="synchronizing"):
        with dispatch_guard(True, card):
            t.sum().item()
    seen = {}
    with dispatch_guard(True, card):
        th = threading.Thread(target=lambda: seen.update(v=t.sum().item()))
        th.start()
        th.join(timeout=60)
    assert seen["v"] == float(t.sum())
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_strict_fit_on_card_equals_plain(card):
    strict, x, y = _guard_net(card, strict=True)
    plain, _, _ = _guard_net(card)
    for a, b in zip(strict.state.layers, plain.state.layers):
        for ta, tb in zip(a.marginals, b.marginals):
            assert torch.equal(ta, tb)
        assert torch.equal(a.w, b.w)
    sizes = strict._sentinel.sizes()
    assert any(k.endswith(">masked_matmul.plan") for k in sizes)
    assert all(v == 1 for v in sizes.values()), sizes


@pytest.mark.cuda
def test_cpu_state_leaf_on_card_raises_without_running(card):
    from repro_torch.analysis.strict import HostTransferError

    c, x, y = _guard_net(card, strict=True)
    s0 = c.state.layers[0]
    c.state = c.state._replace(layers=(s0._replace(w=s0.w.cpu()),) + c.state.layers[1:])
    ops.reset_launches()
    with pytest.raises(HostTransferError, match=r"state\.w: a tensor on cpu"):
        c.partial_fit((x, y), batch_size=64)
    assert not any(ops.launch_counts().values())


@pytest.mark.cuda
def test_use_kernels_false_runs_plain_on_card(card):
    ops.reset_launches()
    c, x, y = _guard_net(card, use_kernels=False)
    assert not any(ops.launch_counts().values())
    kernel, _, _ = _guard_net(card)
    assert abs(c.evaluate((x, y)) - kernel.evaluate((x, y))) <= 0.03


# ------------------------------------------------ the reduced-means mode
@pytest.mark.cuda
@pytest.mark.parametrize("use_mask", [True, False])
@pytest.mark.parametrize("fh", [(1568, 3000), (1568, 1500), (3000, 10), (17, 7), (300, 1025)])
def test_bcpnn_update_means_matches_plain_on_card(card, fh, use_mask):
    """The update's reduced-means mode against its plain version, from the
    means of a batch: the hidden layer, a model rank's half, the readout,
    an odd shape (4-byte runs) and a width past one column tile."""
    f, h = fh
    p = _problem(64, f, 1, h, use_mask, card)
    mi, mj, mij = p["x"].mean(0), p["aj"].mean(0), p["x"].T @ p["aj"] / 64
    args = (mi, mj, mij, p["ci"], p["cj"], p["cij"], 0.05)
    before = ops.launch_counts()
    got = bk.bcpnn_update_means(*args, k_b=0.7, mask=p["mask"])
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["bcpnn_update.means"] == before["bcpnn_update.means"] + 1
    assert after["bcpnn_update"] == before["bcpnn_update"] + 1
    want = ref.bcpnn_update_means(*args, k_b=0.7, mask=p["mask"])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.cuda
def test_trainer_steps_at_world_size_1_on_card(card):
    """A one-rank NCCL group on the card: the shard_map steps launch the
    forward pair and the reduced-means update, and equal the single-device
    steps within the reference's data-parallel tolerance."""
    import socket

    import torch.distributed as dist

    from repro_torch.core.distributed import DataParallelTrainer
    from repro_torch.launch.mesh import make_host_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        tr = DataParallelTrainer(make_host_mesh(), "shard_map")
        layer = StructuralPlasticityLayer(UnitLayout(32, 2), UnitLayout(4, 16), fan_in=16,
                                          gain=4.0, init_jitter=1.0)
        st = layer.init(torch.Generator(device=card).manual_seed(0))
        x = torch.rand(64, 64, generator=torch.Generator(device=card).manual_seed(1), device=card)
        ops.reset_launches()
        got = tr.gather_state(layer, tr.hidden_step(layer)(tr.place_state(layer, st), x))
        counts = ops.launch_counts()
        assert (counts["masked_matmul"], counts["hcu_softmax"], counts["bcpnn_update"],
                counts["bcpnn_update.means"]) == (1, 1, 1, 1)
        want = layer.train_batch(st, x)[0]
        torch.testing.assert_close(got.w, want.w, rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(got.marginals.cij, want.marginals.cij, rtol=2e-4, atol=1e-7)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_xl_rank_step_with_256_lane_hypercolumns_on_card(card):
    """One rank of ``bcpnn_xl`` cut in width (``launch/dryrun_bcpnn.py``):
    hypercolumns 256 MCUs wide, dense receptive fields, gain 4, one
    shard_map hidden step through a one-rank NCCL group with the kernels
    against the same step with ``use_kernels=False`` on the card."""
    import socket

    import torch.distributed as dist

    from repro_torch.core.distributed import DataParallelTrainer
    from repro_torch.launch.dryrun_bcpnn import xl_layer
    from repro_torch.launch.mesh import make_host_mesh

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        tr = DataParallelTrainer(make_host_mesh(), "shard_map")
        n_f, n_hcu, rows = 2048, 4, 256
        kern, plain = xl_layer(n_f, n_hcu, 256), xl_layer(n_f, n_hcu, 256, use_kernels=False)
        st = kern.init(torch.Generator(device=card).manual_seed(0))
        x = torch.rand(rows, n_f, generator=torch.Generator(device=card).manual_seed(1),
                       device=card)
        ops.reset_launches()
        got = tr.hidden_step(kern)(st, x)
        counts = ops.launch_counts()
        assert (counts["masked_matmul"], counts["hcu_softmax"], counts["bcpnn_update"],
                counts["bcpnn_update.means"]) == (1, 1, 1, 1)
        want = tr.hidden_step(plain)(st, x)
        torch.testing.assert_close(got.w, want.w, rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(got.marginals.cij, want.marginals.cij, rtol=2e-4, atol=1e-7)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v2-236b"])
def test_moe_decode_step_on_card_matches_cpu_in_a_cuda_graph(card, arch):
    """The MoE family's smoke config (GQA or MLA attention, routed and
    shared experts) on the card against the CPU from the same weights:
    prefill logits, then four decode steps of three slots at their own
    lengths replayed from one captured CUDA graph (capture fails on any
    host sync), every step's logits and cache within 1e-4."""
    from repro_torch.checkpoint import lm_params_from_flat, flat_from_lm
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config(arch)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = lm_params_from_flat(cfg, flat_from_lm(cpu), device=card)
    rng = np.random.default_rng(3)
    lens, smax = (19, 7, 12), 32
    caches = {"cpu": cpu.init_cache(3, smax), "card": gpu.init_cache(3, smax)}
    with torch.inference_mode():
        for r, n in enumerate(lens):
            p = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))
            for name, m in (("cpu", cpu), ("card", gpu)):
                logits, c = m.prefill({"tokens": p.to(m.device)})
                for k, v in c.items():
                    caches[name][k][:, r, :n] = v[:, 0]
                if name == "cpu":
                    want = logits
            torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1)))
        cur = torch.tensor(lens)
        static_tok, static_cur = tok.to(card), cur.to(card)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up outside the capture, on scratch caches
            scratch = {k: v.clone() for k, v in caches["card"].items()}
            gpu.decode_step(scratch, static_tok, static_cur)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = gpu.decode_step(caches["card"], static_tok, static_cur)
        for _ in range(4):
            static_tok.copy_(tok)
            static_cur.copy_(cur)
            graph.replay()
            want, _ = cpu.decode_step(caches["cpu"], tok, cur)
            torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-4)
            for k in caches["cpu"]:
                torch.testing.assert_close(caches["card"][k].cpu(), caches["cpu"][k],
                                           rtol=1e-4, atol=1e-4)
            tok, cur = want.argmax(-1, keepdim=True), cur + 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b", "internvl2-1b"])
def test_ssm_hybrid_vlm_decode_on_card_matches_cpu_in_a_cuda_graph(card, arch):
    """The ssm, hybrid and vlm smoke configs on the card against the CPU
    from the same weights: prefill logits (a 2-token prompt among them,
    under the conv's K - 1; the vlm's with patch embeddings), then four
    decode steps of three slots at their own lengths replayed from one
    captured CUDA graph (capture fails on any host sync), every step's
    logits and cache within 1e-4."""
    from repro_torch.checkpoint import lm_params_from_flat, flat_from_lm
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model

    cfg = get_smoke_config(arch)
    cpu = build_model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = lm_params_from_flat(cfg, flat_from_lm(cpu), device=card)
    rng = np.random.default_rng(3)
    lens, smax = (19, 2, 12), 48
    n_front = cfg.n_patches if cfg.frontend else 0
    caches = {"cpu": cpu.init_cache(3, smax), "card": gpu.init_cache(3, smax)}
    with torch.inference_mode():
        for r, n in enumerate(lens):
            batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n)))}
            if n_front:
                batch["embeds"] = torch.from_numpy(
                    rng.standard_normal((1, n_front, cfg.d_model)).astype(np.float32))
            for name, m in (("cpu", cpu), ("card", gpu)):
                logits, c = m.prefill({k: v.to(m.device) for k, v in batch.items()})
                for k, v in c.items():
                    if k in ("k", "v"):
                        caches[name][k][:, r, :v.shape[2]] = v[:, 0]
                    else:
                        caches[name][k][:, r] = v[:, 0]
                if name == "cpu":
                    want = logits
            torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-4)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1)))
        cur = torch.tensor(lens) + n_front
        static_tok, static_cur = tok.to(card), cur.to(card)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up outside the capture, on scratch caches
            scratch = {k: v.clone() for k, v in caches["card"].items()}
            gpu.decode_step(scratch, static_tok, static_cur)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = gpu.decode_step(caches["card"], static_tok, static_cur)
        for _ in range(4):
            static_tok.copy_(tok)
            static_cur.copy_(cur)
            graph.replay()
            want, _ = cpu.decode_step(caches["cpu"], tok, cur)
            torch.testing.assert_close(out.cpu(), want, rtol=1e-4, atol=1e-4)
            for k in caches["cpu"]:
                torch.testing.assert_close(caches["card"][k].cpu(), caches["cpu"][k],
                                           rtol=1e-4, atol=1e-4)
            tok, cur = want.argmax(-1, keepdim=True), cur + 1


@pytest.mark.cuda
def test_matmul_f32_backward_on_card(card):
    """``matmul_f32`` on bf16 operands on the card: its forward is cuBLAS's
    f32 accumulator, its backward the autograd function's f32 products,
    both held to the CPU's f32 autograd of the widened operands (the same
    products summed in another order): the f32 results within 1e-5
    normwise, each bf16 gradient within one bf16 ulp plus 1e-5 x
    (|g| @ |b|^T) where its sum cancels.  A cotangent rounded to bf16
    first would move the f32 products by ~1e-3."""
    from repro_torch.models.common import _matmul_f32_grads, matmul_f32

    def ulps_off(got, want, scale):
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-38))) - 7)
        return int(((got.float() - want).abs() > ulp + 1e-5 * scale).sum())

    rng = np.random.default_rng(5)
    for b_shape in ((96, 40), (3, 96, 40)):
        a = torch.from_numpy(rng.standard_normal((3, 17, 96)).astype(np.float32)).bfloat16()
        b = torch.from_numpy(rng.standard_normal(b_shape).astype(np.float32)).bfloat16()
        g = torch.from_numpy(rng.standard_normal((3, 17, 40)).astype(np.float32))
        wa, wb = a.float().requires_grad_(True), b.float().requires_grad_(True)
        want_out = torch.matmul(wa, wb)
        want = torch.autograd.grad(want_out, (wa, wb), g)
        sa, sb = a.float().abs().requires_grad_(True), b.float().abs().requires_grad_(True)
        scale = torch.autograd.grad(torch.matmul(sa, sb), (sa, sb), g.abs())
        a_d = a.to(card).requires_grad_(True)
        b_d = b.to(card).requires_grad_(True)
        out = matmul_f32(a_d, b_d)
        got = torch.autograd.grad(out, (a_d, b_d), g.to(card))
        f32 = _matmul_f32_grads(a.to(card), b.to(card), g.to(card))
        rel = [float((x.cpu() - w.detach()).norm() / w.detach().norm())
               for x, w in zip((out.detach(), *f32), (want_out, *want))]
        assert out.dtype == torch.float32 and max(rel) <= 1e-5, rel
        for x, w, sc, inp in zip(got, want, scale, (a, b)):
            assert x.dtype == inp.dtype == torch.bfloat16
            assert ulps_off(x.cpu(), w, sc) == 0


@pytest.mark.cuda
def test_encdec_train_step_on_card(card):
    """One f32 train step of the enc-dec smoke config on the card against
    the CPU's: loss, and the params after the step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, tree_map

    cfg = get_smoke_config("seamless-m4t-large-v2")
    cpu = build_model(cfg, "cpu", param_dtype=torch.float32).init(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, card, param_dtype=torch.float32)
    rng = np.random.default_rng(2)
    batch = {"enc_embeds": torch.from_numpy(rng.standard_normal((2, 40, cfg.d_model))
                                            .astype(np.float32)),
             "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 10))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 10)))}
    opt = AdamW(learning_rate=1e-3)
    p_cpu = cpu.params()
    p_gpu = tree_map(lambda t: t.to(card), p_cpu)
    out_cpu = cpu.make_train_step(opt, 1)(p_cpu, opt.init(p_cpu), batch)
    out_gpu = gpu.make_train_step(opt, 1)(p_gpu, opt.init(p_gpu),
                                          {k: v.to(card) for k, v in batch.items()})
    torch.testing.assert_close(out_gpu[2]["loss"].cpu(), out_cpu[2]["loss"], rtol=1e-5, atol=1e-6)
