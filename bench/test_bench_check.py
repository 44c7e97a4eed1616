"""The check that decides ``correct``: the reference against a BCPNN step
worked by hand, and runs with the timed path broken underneath (the
faults) or the TF32 control in the program's place, which have to come out
not correct.  CPU, small sizes; the same readings at the cells' own sizes
come from ``python3 bench/readings.py`` on the card."""
import contextlib
import json
import math
import time

import pytest
import torch

from bench.harness import check, kinds, runner
from bench.reference import bcpnn as ref
from bench.test_bench_harness import ROOT, SPEC, tiny_files


def kind(name: str) -> type:
    """The generator class of traffic kind ``name``, as the runner loads it."""
    return kinds.load(ROOT / "bench" / "kinds", name)


def test_reference_step_matches_a_step_worked_by_hand():
    # 2 input features (4 units), one hidden HCU of 2 units, fan-in 1 of the
    # 2 input HCUs, gain 1, lam 0.5; one batch of two rows
    net = dict(input_features=2, hidden_hcu=1, hidden_mcu=2, fan_in=1, mask_update_every=99,
               lam=0.5, gain=1.0)
    hcu_mask = torch.tensor([[1.0], [0.0]])
    ci = torch.full((4,), 0.5)
    cj = torch.full((2,), 0.5)
    cij = torch.tensor([[0.4, 0.1], [0.1, 0.4], [0.25, 0.25], [0.25, 0.25]])
    w, b = ref.weights(ci, cj, cij)
    state = dict(ci=ci, cj=cj, cij=cij, w=w * ref.unit_mask(hcu_mask, 2), b=b, hcu_mask=hcu_mask)
    x = torch.tensor([[1.0, 0.0, 1.0, 0.0], [0.0, 1.0, 0.0, 1.0]])
    out = ref.hidden_step(net, state, 1, x)  # step 1: no rewiring

    w1 = math.log(0.4 / 0.25)  # w of (unit 0, post 0), (1, 1); w of (0, 1), (1, 0) is log(0.4)
    w2 = math.log(0.1 / 0.25)
    bias = math.log(0.5)
    # row 0 reads input unit 0: s = (w1 + b, w2 + b); row 1 reads unit 1: s = (w2 + b, w1 + b)
    p = 1.0 / (1.0 + math.exp(w2 - w1))  # softmax of the larger support
    aj = torch.tensor([[p, 1 - p], [1 - p, p]])
    mi, mj = x.mean(0), aj.mean(0)
    mij = x.T @ aj / 2
    want_ci = 0.5 * ci + 0.5 * mi
    want_cj = 0.5 * cj + 0.5 * mj
    want_cij = 0.5 * cij + 0.5 * mij
    assert torch.allclose(out["ci"], want_ci) and torch.allclose(out["cj"], want_cj)
    assert torch.allclose(out["cij"], want_cij)
    # hand values of two entries: C_00 = 0.2 + 0.25 p, c_j = 0.5
    assert float(out["cij"][0, 0]) == pytest.approx(0.2 + 0.25 * p, rel=1e-6)
    assert float(out["cj"][0]) == pytest.approx(0.5, rel=1e-6)
    w00 = math.log((0.2 + 0.25 * p) / (float(want_ci[0]) * 0.5))
    assert float(out["w"][0, 0]) == pytest.approx(w00, rel=1e-5)
    assert float(out["w"][2, 0]) == 0.0  # masked out
    assert float(out["b"][1]) == pytest.approx(bias, rel=1e-6)
    assert w1 > 0 > w2


def test_rewiring_swaps_the_weakest_active_for_the_strongest_silent():
    mask = torch.tensor([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0], [0.0, 0.0]])
    scores = torch.tensor([[5.0, 1.0], [2.0, 9.0], [7.0, 3.0], [1.0, 3.0]])
    out = ref.rewire(mask, scores)
    # column 0: active {0: 5, 1: 2}, silent {2: 7, 3: 1}: swap 1 for 2;
    # column 1: active {0: 1, 2: 3}, silent {1: 9, 3: 3}: swap 0 for 1
    assert out.tolist() == [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [0.0, 0.0]]
    mi = scores
    assert check.mask_cols(mask, out, out, mi) == 0
    wrong = out.clone()
    wrong[:, 0] = torch.tensor([0.0, 1.0, 1.0, 0.0])  # dropped the stronger active input
    assert check.mask_cols(mask, wrong, out, mi) == 1


def test_change_err_reads_one_for_an_unchanged_state():
    before = dict(a=torch.zeros(10), b=torch.zeros(3))
    want = dict(a=torch.ones(10), b=torch.full((3,), 2.0))
    assert check.change_err(before, want, before, ("a", "b")) == pytest.approx(1.0)
    assert check.change_err(want, want, before, ("a", "b")) == 0.0


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0 - 2**-9])
    assert ref.tf32_round(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0 - 2**-9]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_comes_out_not_correct(cell):
    """The TF32 reference in the program's place fails the cell's limits and
    reads over a hundred times what the program reads, at a small size on
    the CPU (TF32 emulated by rounding the products' operands)."""
    files = tiny_files(cell)
    limits = json.loads((ROOT / "bench" / "workloads" / f"{cell}.json").read_text())["limits"]
    gen = kind(files["traffic"]["kind"])(files["cfg"], files["traffic"], 2**32 + 5, "cpu")
    gen.setup()
    for _ in range(gen.check_units(0)):  # the score cell's pool of 4; no training iteration
        gen.unit()
    gen.release()
    sound = gen.numbers()
    control = gen.numbers(gen.control())
    assert sound["init_gap"] == 0.0 and control["init_gap"] == 0.0
    assert all(v <= limits[k] for k, v in sound.items()), (sound, limits)
    assert any(v > limits[k] for k, v in control.items()), (control, limits)
    key = "hidden_err" if "hidden_err" in sound else "readout_err"
    assert control[key] > 100 * max(sound[key], 1e-9), (sound, control)


@pytest.mark.parametrize("cell,fault,number", [
    ("stl10-20x150.train", "half", "hidden_err"),
    ("stl10-20x150.train", "unchanged", "hidden_err"),
    ("stl10-20x150.train", "answer", "answer_gap"),
    ("stl10-20x150.score", "answer", "answer_gap"),
])
def test_a_broken_timed_path_comes_out_not_correct(cell, fault, number):
    """A whole run (its look for a card skipped) with a fault planted in the
    program: the check reads the fault's number over its limit, and
    ``correct`` is false."""
    with runner.Cell(ROOT, SPEC, cell).generator.faults[fault]():
        result, lines = runner.run(ROOT, SPEC, cell, 2**31 + 99, 0.1, False,
                                   torch.device("cpu"), time.perf_counter(),
                                   files=tiny_files(cell))
    assert result["correct"] is False
    got = result["check"][number]
    assert got["value"] > got["limit"], result["check"]
    if fault == "unchanged":
        assert got["value"] == pytest.approx(1.0)
    if cell.endswith("score"):
        assert result["failed"] == result["attempted"]


def test_limits_name_every_compared_number():
    for w in SPEC["workloads"]:
        limits = json.loads((ROOT / "bench" / "workloads" / f"{w['name']}.json").read_text())
        kind = json.loads((ROOT / "bench" / "traffic" / f"{w['traffic']}.json").read_text())["kind"]
        want = {"init_gap", "readout_err", "answer_gap"} | (
            {"hidden_err", "mask_cols"} if kind == "train" else set())
        assert set(limits["limits"]) == want
        assert limits["limits"]["init_gap"] == 0.0


@pytest.mark.parametrize("fault,number", [
    ("half", "hidden_err"), ("unchanged", "hidden_err"), ("answer", "answer_gap"),
])
def test_a_fault_only_after_set_up_comes_out_not_correct(fault, number, monkeypatch):
    """A training path that is wrong only once set-up is over (in steady
    state, as a CUDA graph captured after warm-up could be) is caught by the
    check of the state the window leaves and of the iteration after it."""
    train = kind("train")
    setup = train.setup
    with contextlib.ExitStack() as stack:
        def setup_then_fault(self):
            setup(self)
            stack.enter_context(train.faults[fault]())

        monkeypatch.setattr(train, "setup", setup_then_fault)
        result, _ = runner.run(ROOT, SPEC, "stl10-20x150.train", 2**31 + 77, 0.1, False,
                               torch.device("cpu"), time.perf_counter(),
                               files=tiny_files("stl10-20x150.train"))
    assert result["correct"] is False
    got = result["check"][number]
    assert got["value"] > got["limit"], result["check"]


def test_the_check_covers_the_window_and_the_iteration_after_it():
    files = tiny_files("stl10-20x150.train")
    gen = kind("train")(files["cfg"], files["traffic"], 2**31 + 5, "cpu")
    gen.setup()
    for _ in range(3):
        gen.unit()
    gen.after_window()
    ts = [it["t"] for it in gen.checked]
    assert ts == list(range(files["traffic"]["check_steps"])) + [gen.iterations - 1]
    assert gen.iterations == files["traffic"]["check_steps"] + 4
    post = gen.checked[-1]
    assert post["steps"][0] == gen.checked_step(post["t"]) >= post["t"] * gen.hidden_per_iter
    assert torch.equal(post["readout_before"]["w"], gen.end["readout"]["w"])
    gen.release()
    numbers = gen.numbers()
    assert numbers["hidden_err"] < 1e-4 and numbers["answer_gap"] < 1e-3, numbers
