"""``masked_matmul``'s gathered variant on the CPU, with no card and no JAX.

The kernel runs only on the card (``tests/test_torch_cuda.py``); here: the
plan's choice between the gathered and the dense kernel at the main path's
shapes, the kept lists' plain version, the ``hcu_mask=`` entry (which on the
CPU refuses: the layer step expands the mask there), and the layer step
around it (a Listing 1 fit bit for bit as with the unit mask passed in, also
through a stand-in for the gathered launch; the ``masked_matmul.gathered``
counter).
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
from repro_torch.core import layers as layers_mod
from repro_torch.data import complementary_code, mnist_like
from repro_torch.kernels import masked_matmul as mk
from repro_torch.kernels import ops, ref
from repro_torch.runtime.trace import TraceConfig
from torch_plain_gathering import plain_gathering

N_SM = 132  # the H100 SXM
# (rows, K, N, kept units a hidden HCU, minicolumns a hidden HCU): Listing 1's
# hidden product at the STL-10 width (1,024 of 27,648 two-unit input HCUs a
# hidden HCU, 3.7% of K) and at the MNIST width (392 of 784, 50%), a
# training batch or projection chunk (128 rows) and predict's chunk (1,024).
STL10 = [(128, 55296, 3000, 2048, 150), (1024, 55296, 3000, 2048, 150)]
MNIST = [(128, 1568, 3000, 784, 100), (1024, 1568, 3000, 784, 100)]


@pytest.mark.parametrize("shape", STL10)
def test_plan_gathers_at_stl10_width(shape):
    p = mk.plan(*shape[:3], N_SM, *shape[3:])
    assert p.config == "gathered"
    assert p.ctas >= N_SM, "the split of the kept lists fills the card"
    assert p.tiles_n == 20, "one column tile a hidden HCU: 150 columns from a 4-aligned start"


@pytest.mark.parametrize("shape", MNIST)
def test_plan_choice_at_mnist_width(shape):
    """Pinned to the faster kernel in the rows measured on the card (PERF.md
    §6): at half the input HCUs kept and 100 of a tile's 160 columns used,
    the dense tiles."""
    p = mk.plan(*shape[:3], N_SM, *shape[3:])
    assert p == mk.plan(*shape[:3], N_SM)


def test_plan_without_kept_units_is_the_dense_plan():
    for m, k, n, _, _ in STL10 + MNIST:
        assert mk.plan(m, k, n, N_SM).config == "wide"


@pytest.mark.parametrize("kept,n_mcu", [(0, 150), (2048, 150), (16, 7), (55296, 150)])
def test_gathered_plans_obey_the_kernel_contract(kept, n_mcu):
    for cl_plan in mk._candidates("gathered", mk.GATHERED, 2, mk.gathered_tiles_n(20, n_mcu),
                                  kept, N_SM):
        p = cl_plan[-1]
        assert 1 <= p.cl <= mk.MAX_CLUSTER
        assert p.cl == 1 or (p.cl - 1) * p.kslice < kept, "every slice non-empty"
        assert p.tiles_n == 20 * mk._cdiv(n_mcu + 3, 160)


def test_plan_rejects_a_bad_hcu_layout():
    for kept, n_mcu in [(2048, 7), (60000, 150), (-1, 150), (16, 0), (16, None)]:
        with pytest.raises(ValueError):
            mk.plan(128, 55296, 3000, N_SM, kept, n_mcu)


def _mask(n_pre, n_post, counts, seed=0):
    rng = np.random.default_rng(seed)
    m = np.zeros((n_pre, n_post), dtype=np.float32)
    for h, c in enumerate(counts):
        m[rng.permutation(n_pre)[:c], h] = 1.0
    return m


@pytest.mark.parametrize("counts", [
    [17, 17, 17, 17, 17],    # equal, as init_random_mask and update_mask keep them
    [3, 0, 60, 1, 29],       # unequal (a loaded checkpoint), one hidden HCU with none
    [0, 0, 0, 0, 0],
    [60, 60, 60, 60, 60],    # full_mask
])
def test_kept_lists_plain_version_is_nonzero(counts):
    m = _mask(60, 5, counts)
    kept, n = ref.kept_lists(torch.as_tensor(m))
    assert kept.dtype == n.dtype == torch.int32 and kept.shape == (5, 60)
    for h in range(5):
        rows = np.nonzero(m[:, h])[0]
        assert int(n[h]) == len(rows) == counts[h]
        assert kept[h, :len(rows)].tolist() == rows.tolist()
        assert not kept[h, len(rows):].any()


def _product_inputs(shape, use_bias):
    m, n_pre, pre_mcu, n_post, post_mcu, fan_in = shape
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.random((m, n_pre * pre_mcu), dtype=np.float32))
    w = torch.as_tensor(rng.standard_normal((n_pre * pre_mcu, n_post * post_mcu), dtype=np.float32))
    b = torch.as_tensor(rng.standard_normal(n_post * post_mcu, dtype=np.float32)) if use_bias else None
    return x, w, b, torch.as_tensor(_mask(n_pre, n_post, [fan_in] * n_post))


PRODUCTS = [(13, 40, 2, 5, 150, 9), (8, 12, 3, 4, 7, 12), (1, 9, 1, 2, 6, 0)]


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("shape", PRODUCTS)
def test_hcu_mask_entry_is_the_unit_mask_on_the_cpu(shape, use_bias):
    """The layer step's product over its HCU mask (``_support``) on the CPU
    expands the unit mask and runs the dense path, bit for bit ``mask=``,
    whether it expands the mask itself or is handed it; nothing launches."""
    m, n_pre, pre_mcu, n_post, post_mcu, fan_in = shape
    x, w, b, hm = _product_inputs(shape, use_bias)
    layer = StructuralPlasticityLayer(UnitLayout(n_pre, pre_mcu), UnitLayout(n_post, post_mcu),
                                      fan_in=1)
    state = layer.init(torch.Generator().manual_seed(0))
    state = state._replace(w=w, b=torch.zeros(w.shape[1]) if b is None else b,
                           plast=state.plast._replace(hcu_mask=hm))
    unit = ref.unit_mask(hm, pre_mcu, post_mcu)
    want = ops.masked_matmul(x, w, state.b, mask=unit)
    ops.reset_launches()
    assert not ops.masked_matmul_gathers(x, w, state.b, hm, pre_mcu, post_mcu, fan_in)
    for mask in (None, unit):
        got = layers_mod._support(layer.spec, state, x, mask, fan_in)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("use_bias", [True, False])
@pytest.mark.parametrize("shape", PRODUCTS)
def test_hcu_mask_entry_launches_only_the_gathered_kernel(shape, use_bias):
    """On the CPU no product gathers, and ``hcu_mask=`` refuses rather than
    expanding the mask: the choice and the expansion are the caller's."""
    _, _, pre_mcu, _, post_mcu, fan_in = shape
    x, w, b, hm = _product_inputs(shape, use_bias)
    ops.reset_launches()
    assert not ops.masked_matmul_gathers(x, w, b, hm, pre_mcu, post_mcu, fan_in)
    with pytest.raises(ValueError, match="gathered kernel"):
        ops.masked_matmul(x, w, b, hcu_mask=hm, pre_mcu=pre_mcu, post_mcu=post_mcu,
                          fan_in=fan_in)
    assert not any(ops.launch_counts().values())


def test_hcu_mask_entry_refuses_what_it_excludes():
    x, w, hm = torch.ones(2, 4), torch.ones(4, 6), torch.ones(2, 2)
    kw = dict(hcu_mask=hm, pre_mcu=2, post_mcu=3)
    with pytest.raises(ValueError, match="excludes"):
        ops.masked_matmul(x, w, None, mask=torch.ones(4, 6), **kw)
    with pytest.raises(ValueError, match="excludes"):
        ops.masked_matmul(x, w, None, round_mantissa=7, **kw)
    with pytest.raises(ValueError, match="pre_mcu"):
        ops.masked_matmul(x, w, None, hcu_mask=hm)


class _UnitMaskLayer(StructuralPlasticityLayer):
    """The plastic layer as it was before the HCU mask reached the product:
    every forward expands the unit mask and hands it to the dense product."""

    def forward(self, state, x):
        return layers_mod._forward(self.spec, state, x, layers_mod._unit_mask(self.spec, state))

    def train_batch(self, state, x):
        state = self.maybe_update_mask(state)
        mask = layers_mod._unit_mask(self.spec, state)
        aj = layers_mod._forward(self.spec, state, x, mask)
        return layers_mod._learn(self.spec, state, x, aj, mask), aj


def _listing1(layer_cls, trace=None):
    ds = mnist_like(n_train=384, n_test=96, n_features=24, seed=0)
    x, layout = complementary_code(ds.x_train)
    xt, _ = complementary_code(ds.x_test)
    hidden = UnitLayout(4, 10)
    net = Network(seed=0)
    net.add(layer_cls(layout, hidden, fan_in=9, lam=0.05, gain=4.0, mask_update_every=4))
    net.add(DenseLayer(hidden, onehot_layout(10), lam=0.05))
    compiled = net.compile(ExecutionConfig(device="cpu", trace=trace))
    compiled.fit((x, ds.y_train), epochs_hidden=2, epochs_readout=1, batch_size=64)
    return compiled, compiled.predict(xt, batch_size=32), compiled.evaluate((xt, ds.y_test))


@pytest.mark.parametrize("gathered", [False, True])
def test_listing1_fit_bit_for_bit_as_with_the_unit_mask(gathered):
    """States, scores and accuracy of a Listing 1 fit equal, bit for bit,
    those of the plastic layer that hands the unit mask to every product;
    also with the gathered launch stood in for by its plain version."""
    want = _listing1(_UnitMaskLayer)
    ops.reset_launches()
    if gathered:
        with plain_gathering():
            got = _listing1(StructuralPlasticityLayer)
    else:
        got = _listing1(StructuralPlasticityLayer)
    assert (ops.launch_counts()["masked_matmul.gathered"] > 0) == gathered
    for a, b in zip(got[0].state.layers, want[0].state.layers):
        for ta, tb in zip(a.marginals + (a.w, a.b), b.marginals + (b.w, b.b)):
            assert torch.equal(ta, tb)
        if a.plast is not None:
            assert torch.equal(a.plast.hcu_mask, b.plast.hcu_mask)
    assert torch.equal(got[1], want[1])
    assert got[2] == want[2]


def test_gathered_counter_reads_zero_on_the_cpu():
    """On the CPU no product gathers: the tracer counts none and the launch
    counter stays at 0, while the unit mask is expanded per product."""
    ops.reset_launches()
    compiled, _, _ = _listing1(StructuralPlasticityLayer, TraceConfig())
    assert compiled.tracer.counters().get("masked_matmul.gathered", 0) == 0
    assert ops.launch_counts()["masked_matmul.gathered"] == 0
    assert compiled.tracer.spans("layer.unit_mask")
