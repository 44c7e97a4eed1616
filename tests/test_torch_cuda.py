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
