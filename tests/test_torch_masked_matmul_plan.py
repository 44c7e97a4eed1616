"""The launch plan of the Hopper ``masked_matmul`` kernel, on the CPU.

``repro_torch.kernels.masked_matmul.plan`` is a pure function of the
product's shape and the card's SM count; the kernel trusts what it says.
These tests hold it to the kernel's contract (cluster size, non-empty K
slices that cover K, a grid that covers the output) and to the choices the
main path relies on, with no card and no JAX.
"""
import pytest

from repro_torch.kernels import masked_matmul as mk

N_SM = 132  # the H100 SXM
MAIN = {  # (M, K, N) of the main path at MNIST width
    "hidden": (128, 1568, 3000),
    "predict": (1024, 1568, 3000),
    "readout": (1024, 3000, 10),
}
SWEEP = list(MAIN.values()) + [
    (1, 1, 1), (13, 17, 7), (13, 17, 10), (32, 64, 64), (64, 200, 258), (130, 300, 320),
    (257, 140, 140), (600, 300, 300), (128, 3000, 10), (48, 300, 10), (64, 12, 96),
    (64, 5, 96), (128, 1100, 200), (128, 0, 20), (4096, 4096, 4096), (2048, 784, 16),
    (7, 100000, 17),
]


@pytest.mark.parametrize("n_sm", [N_SM, 16, 1])
@pytest.mark.parametrize("shape", SWEEP)
def test_plan_obeys_the_kernel_contract(shape, n_sm):
    m, k, n = shape
    p = mk.plan(m, k, n, n_sm)
    cfg = mk.CONFIGS[p.config]
    assert 1 <= p.cl <= mk.MAX_CLUSTER
    assert p.kslice == mk.kslice_for(k, p.cl, cfg.bk) and p.kslice % cfg.bk == 0
    assert p.cl * p.kslice >= k, "the slices cover K"
    assert p.cl == 1 or (p.cl - 1) * p.kslice < k, "every K slice is non-empty"
    assert p.tiles_m * cfg.bm >= m > (p.tiles_m - 1) * cfg.bm, "the grid covers M"
    assert p.tiles_n * cfg.bn >= n > (p.tiles_n - 1) * cfg.bn, "the grid covers N"
    assert p.ctas == p.tiles_m * p.tiles_n * p.cl
    assert (p.config == "narrow") == (n <= mk.NARROW_MAX_N)


@pytest.mark.parametrize("name", sorted(MAIN))
def test_main_path_fills_the_card_where_it_can(name):
    m, k, n = MAIN[name]
    p = mk.plan(m, k, n, N_SM)
    most = max(  # the most CTAs any tile that the plan may take can give
        mk._cdiv(m, c.bm) * mk._cdiv(n, c.bn) * min(mk.MAX_CLUSTER, max(1, mk._cdiv(k, c.bk)))
        for name_, c in mk.CONFIGS.items()
        if (name_ == "narrow") == (n <= mk.NARROW_MAX_N)
    )
    assert p.ctas >= min(N_SM, most)


def test_main_path_choices():
    hidden = mk.plan(*MAIN["hidden"], N_SM)
    assert hidden.cl > 1 and hidden.config == "wide"
    assert mk.plan(*MAIN["predict"], N_SM).cl == 1
    readout = mk.plan(*MAIN["readout"], N_SM)
    assert (readout.config, readout.cl) == ("narrow", mk.MAX_CLUSTER)


@pytest.mark.parametrize("n", [1, 7, 10, 16, 17, 64, 3000])
def test_narrow_tile_only_for_narrow_outputs(n):
    p = mk.plan(256, 512, n, N_SM)
    assert (p.config == "narrow") == (n <= 16)


def test_plan_rejects_bad_shapes():
    for bad in [(0, 4, 4, N_SM), (4, 4, 0, N_SM), (4, -1, 4, N_SM), (4, 4, 4, 0)]:
        with pytest.raises(ValueError):
            mk.plan(*bad)
