"""The launch plans of the Hopper training pair, on the CPU.

``repro_torch.kernels.bcpnn_update.plan`` and
``repro_torch.kernels.bcpnn_phase.plan`` are pure functions of the shapes
(and, for the update, the card's SM count); the kernels trust what they
say.  These tests hold them to the kernels' contracts (cluster size,
non-empty slices that cover the batch or F, a grid that covers the output)
and to the choices the main path relies on, with no card and no JAX.
"""
import pytest

from repro_torch.kernels import bcpnn_phase as pk
from repro_torch.kernels import bcpnn_update as bk

N_SM = 132  # the H100 SXM
MAIN = {  # (B, F, H) of the main path at MNIST width
    "hidden": (128, 1568, 3000),
    "readout": (128, 3000, 10),
}
SWEEP = list(MAIN.values()) + [
    (1, 1, 1), (13, 17, 7), (257, 140, 140), (600, 300, 300), (32, 64, 64), (64, 200, 258),
    (130, 300, 320), (48, 300, 10), (600, 300, 12), (4096, 784, 16), (128, 3000, 17),
    (7, 100000, 3),
]


@pytest.mark.parametrize("n_sm", [N_SM, 16, 1])
@pytest.mark.parametrize("shape", SWEEP)
def test_update_plan_obeys_the_kernel_contract(shape, n_sm):
    b, f, h = shape
    p = bk.plan(b, f, h, n_sm)
    cfg = bk.CONFIGS[p.config]
    assert 1 <= p.cl <= bk.MAX_CLUSTER
    assert p.bslice == bk.bslice_for(b, p.cl, cfg.bk) and p.bslice % cfg.bk == 0
    assert p.bslice % 16 == 0, "the C entry point takes slices of whole 16-row stages"
    assert p.cl * p.bslice >= b, "the slices cover the batch"
    assert p.cl == 1 or (p.cl - 1) * p.bslice < b, "every batch slice is non-empty"
    assert p.tiles_f * cfg.tf >= f > (p.tiles_f - 1) * cfg.tf, "the grid covers F"
    assert p.tiles_h * cfg.th >= h > (p.tiles_h - 1) * cfg.th, "the grid covers H"
    assert p.ctas == p.tiles_f * p.tiles_h * p.cl
    assert (p.config == "narrow") == (h <= bk.NARROW_MAX_H)


def test_update_main_path_choices():
    hidden = bk.plan(*MAIN["hidden"], N_SM)
    assert (hidden.config, hidden.cl) == ("wide", 1) and hidden.ctas >= N_SM
    readout = bk.plan(*MAIN["readout"], N_SM)
    assert readout.config == "narrow" and readout.cl > 1
    assert readout.ctas >= N_SM, "the split batch brings the readout to every SM"


@pytest.mark.parametrize("h", [1, 7, 10, 16, 17, 64, 3000])
def test_update_narrow_tile_only_for_narrow_outputs(h):
    assert (bk.plan(128, 512, h, N_SM).config == "narrow") == (h <= 16)


def test_update_plan_rejects_bad_shapes():
    for bad in [(0, 4, 4, N_SM), (4, 0, 4, N_SM), (4, 4, 0, N_SM), (4, 4, 4, 0)]:
        with pytest.raises(ValueError):
            bk.plan(*bad)


# (B, F, n_hcu, n_mcu): the main path, then the card tests' sweep.
PHASE_SWEEP = [
    (128, 1568, 30, 100), (32, 64, 4, 16), (13, 17, 3, 7), (64, 200, 2, 129),
    (130, 300, 20, 16), (257, 140, 2, 70), (40, 96, 3, 100), (48, 300, 1, 10),
    (600, 300, 3, 100), (128, 1, 1, 1), (128, 100000, 2, 1000),
]


@pytest.mark.parametrize("shape", PHASE_SWEEP)
def test_phase_plan_obeys_the_kernel_contract(shape):
    b, f, n_hcu, n_mcu = shape
    p = pk.plan(b, f, n_hcu, n_mcu)
    assert 1 <= p.g <= n_hcu
    assert p.g == 1 or p.g * n_mcu <= pk.TN, "a group of several hypercolumns fits one tile"
    assert 1 <= p.cl <= pk.MAX_CLUSTER
    assert p.fslice == pk.fslice_for(f, p.cl) and p.fslice % pk.BK == 0
    assert p.cl * p.fslice >= f, "the slices cover F"
    assert p.cl == 1 or (p.cl - 1) * p.fslice < f, "every F slice is non-empty"
    assert p.cl == 1 or p.fslice >= pk.TM // 2
    assert p.groups * p.g >= n_hcu > (p.groups - 1) * p.g, "the groups cover the hypercolumns"
    assert p.ctas == p.groups * p.cl


def test_phase_main_path_choice():
    """At MNIST width one 100-unit hypercolumn a group, 8 CTAs splitting
    F = 1568 into 208-row slices: 240 CTAs, two on an SM in one wave."""
    p = pk.plan(128, 1568, 30, 100)
    assert (p.g, p.cl, p.fslice, p.ctas) == (1, 8, 208, 240)
    assert p.g * 100 / pk.TN > 0.95, "the group fills the tile's columns"


def test_phase_plan_rejects_bad_shapes():
    for bad in [(0, 4, 1, 1), (4, 0, 1, 1), (4, 4, 0, 1), (4, 4, 1, 0)]:
        with pytest.raises(ValueError):
            pk.plan(*bad)


# The reduced-means mode's tiling (csrc/bcpnn_update.cu:bcpnn_means_kernel):
# the hidden layer, a model rank's half of it, the readout, and odd shapes.
MEANS_SWEEP = [(1568, 3000), (1568, 1500), (3000, 10), (1, 1), (17, 7), (64, 32), (5, 4097),
               (100000, 3), (300, 1024), (300, 1025)]


@pytest.mark.parametrize("n_sm", [N_SM, 16, 1])
@pytest.mark.parametrize("shape", MEANS_SWEEP)
def test_means_plan_obeys_the_kernel_contract(shape, n_sm):
    f, h = shape
    p = bk.means_plan(f, h, n_sm)
    assert 0 < p.th <= bk.MEANS_MAX_TH and p.th % 4 == 0, "tiles of whole 16-byte runs"
    assert 0 < p.tr <= bk.MEANS_MAX_TR
    assert p.tr * (p.th // 4) <= bk.MEANS_RUNS, "a CTA takes at most MEANS_RUNS runs"
    assert p.tiles_f * p.tr >= f > (p.tiles_f - 1) * p.tr, "the grid covers F"
    assert p.tiles_h * p.th >= h > (p.tiles_h - 1) * p.th, "the grid covers H"
    assert p.ctas == p.tiles_f * p.tiles_h


def test_means_plan_main_path_choices():
    assert bk.means_plan(1568, 3000, N_SM) == bk.MeansPlan(th=1000, tr=4, tiles_f=392, tiles_h=3)
    assert bk.means_plan(3000, 10, N_SM) == bk.MeansPlan(th=12, tr=12, tiles_f=250, tiles_h=1)
    with pytest.raises(ValueError, match="bad shape"):
        bk.means_plan(0, 10, N_SM)
