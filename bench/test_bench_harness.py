"""The benchmark's harness on the CPU, at small sizes: its data generator,
its operation and byte counts, its trace arithmetic, its result line, and
what it imports.  Tests that need the card carry the ``cuda`` marker."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench.harness import counts, readers, runner, schedule, trace
from bench.harness.counts import Forward, Softmax, Update
from bench.harness.data import Draw

ROOT = Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
TINY_NET = dict(input_features=48, hidden_hcu=4, hidden_mcu=8, fan_in=12, mask_update_every=4)
TINY_DATA = dict(features=48, train_rows=320, test_rows=200)


def tiny_files(cell: str):
    """A cell's own files, cut to a size the CPU runs in a second."""
    entry = [w for w in SPEC["workloads"] if w["name"] == cell][0]
    config = [c for c in SPEC["configs"] if c["name"] == entry["config"]][0]
    cfg = json.loads((ROOT / config["file"]).read_text())
    cfg["network"].update(TINY_NET)
    cfg["data"].update(TINY_DATA)
    traffic = json.loads((ROOT / "bench" / "traffic" / f"{entry['traffic']}.json").read_text())
    if traffic["kind"] == "train":
        traffic.update(batch_size=32, epochs_hidden=2, check_steps=2, trace_iterations=1)
    else:
        traffic.update(request_rows=100, predict_chunk=32, fit_batch_size=32, pool=4,
                       trace_requests=2)
    return dict(cfg=cfg, traffic=traffic)


# ------------------------------------------------------------------ data
def test_draw_is_determined_by_the_seed():
    data = dict(features=20, classes=10, prototypes_per_class=4, noise=0.15,
                informative_fraction=0.5)
    a, b, c = (Draw(data, s, "cpu") for s in (2**31 + 7, 2**31 + 7, 5))
    xa, ya = a.rows(64)
    xb, yb = b.rows(64)
    xc, _ = c.rows(64)
    assert torch.equal(xa, xb) and torch.equal(ya, yb)
    assert not torch.equal(xa, xc)
    assert xa.shape == (64, 40)
    # complementary coding: each feature x is the pair (x, 1 - x), in [0, 1]
    assert torch.allclose(xa[:, 0::2] + xa[:, 1::2], torch.ones(64, 20))
    assert float(xa.min()) >= 0.0 and float(xa.max()) <= 1.0
    # the next draw of the same stream differs from the first
    assert not torch.equal(a.rows(64)[0], xa)


# ---------------------------------------------------------------- counts
def test_masked_forward_counts_only_the_kept_pairs():
    # 3 rows, 8 inputs (4 HCUs of 2), 6 outputs (2 HCUs), fan-in 2 HCUs: 4 kept inputs
    f = Forward(rows=3, features=8, units=6, kept=4, mask=4 * 2)
    flops, nbytes = counts.cost(f)
    assert flops == 2 * 3 * 4 * 6 + 3 * 6
    assert nbytes == 4 * (3 * 8 + 4 * 6 + 6 + 8 + 3 * 6)
    dense = counts.cost(Forward(3, 8, 6, 8))
    assert dense[0] == 2 * 3 * 8 * 6 + 3 * 6 and flops < dense[0]


def test_update_counts_every_pair():
    flops, nbytes = counts.cost(Update(rows=4, pre=8, post=6, mask=8))
    assert flops == 2 * 4 * 48 + 4 * (8 + 6) + 3 * 48
    read = 4 * 8 + 4 * 6 + 8 + 6 + 48 + 8
    written = 8 + 6 + 48 + 48 + 6
    assert nbytes == 4 * (read + written)


def test_softmax_and_bound():
    assert counts.cost(Softmax(rows=2, units=10)) == (80.0, 160.0)
    peaks = counts.Peaks(flops=100.0, bytes=10.0)
    assert counts.bound_s(Softmax(2, 10), peaks) == 16.0  # bytes bound: 160 / 10
    assert counts.peaks_for("NVIDIA H100 80GB HBM3").flops == 67e12
    with pytest.raises(SystemExit):
        counts.peaks_for("some other card")


def test_schedule_lists_an_iterations_launches():
    shapes = schedule.Shapes(dict(input_features=48, hidden_hcu=4, hidden_mcu=8, fan_in=12,
                                  classes=10, mask_update_every=4))
    traffic = dict(batch_size=32, epochs_hidden=2, epochs_readout=1, evaluate_chunk=64,
                   cache_activations=True)
    got = schedule.counted(schedule.iteration(shapes, traffic, 100, 130))
    # 3 batches an epoch: 6 hidden batches, 4 projection chunks (the last of
    # 4 rows), 3 readout batches, 3 evaluate chunks through both layers
    assert got == {"masked_matmul": 6 + 4 + 3 + 3, "hcu_softmax": 6 + 4 + 3 + 3,
                   "bcpnn_update": 6 + 3}
    assert schedule.samples(traffic, 100) == 3 * 96
    req = schedule.predict(shapes, 100, 32, store=False)
    assert [s.rows for k, s in req if k == "masked_matmul"] == [32, 32, 32, 32, 32, 32, 4, 4]


# ----------------------------------------------------------------- trace
def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_idle_share_merges_overlapping_kernels(tmp_path):
    ev = [
        dict(ph="X", cat="user_annotation", name=trace.WINDOW, ts=0, dur=100),
        dict(ph="X", cat="kernel", name="masked_matmul_kernel<1>", ts=10, dur=30),
        dict(ph="X", cat="kernel", name="other", ts=20, dur=30),  # overlaps: union 10-50
        dict(ph="X", cat="gpu_memcpy", name="Memcpy HtoD", ts=60, dur=10),
        dict(ph="X", cat="kernel", name="late", ts=95, dur=20),  # ends past the window
        dict(ph="X", cat="kernel", name="after", ts=130, dur=5),  # outside it
        dict(ph="X", cat="cpu_op", name="aten::index_select", ts=49, dur=12),
        dict(ph="X", cat="cpu_op", name="aten::copy_", ts=70, dur=30),
    ]
    s = trace.summarize(_trace(tmp_path, ev), ["masked_matmul", "bcpnn_update"])
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(55e-6)  # 10-50, 60-70 and 95-100
    assert s["device_ops"] == 4
    assert s["kernels"]["masked_matmul"] == dict(launches=1, seconds=pytest.approx(30e-6))
    assert s["kernels"]["bcpnn_update"]["launches"] == 0
    idle = s["idle_by_host_op"]
    assert idle[trace.NO_OP] == pytest.approx(10e-6)  # 0-10
    assert idle["aten::index_select"] == pytest.approx(10e-6)  # 50-60
    assert idle["aten::copy_"] == pytest.approx(25e-6)  # 70-95
    run = dict(traced=dict(summary=s))
    assert readers.idle_share(run) == pytest.approx(45.0)


def test_roofline_reader_needs_matching_launches():
    peaks = counts.Peaks(1e12, 1e12)
    launches = [("masked_matmul", Forward(10, 8, 6, 4))] * 2
    flops, nbytes = counts.cost(launches[0][1])
    summary = dict(kernels={"masked_matmul": dict(launches=2, seconds=4e-9)})
    run = dict(peaks=peaks, traced=dict(summary=summary, launches=launches,
                                        expected={"masked_matmul": 2}, launches_match=True))
    want = 100 * 2 * max(flops, nbytes) / 1e12 / 4e-9
    assert readers.roofline(run, "masked_matmul") == pytest.approx(want)
    run["traced"]["launches_match"] = False
    assert readers.roofline(run, "masked_matmul") is None
    assert readers.roofline(dict(run, peaks=None), "masked_matmul") is None


# ------------------------------------------------------ the run and its line
@pytest.mark.parametrize("cell,trace_on", [
    ("stl10-20x150.train", False), ("stl10-20x150.train", True),
    ("stl10-20x150.score", True), ("stl10-20x150.score", False),
])
def test_result_line_schema(cell, trace_on):
    result, lines = runner.run(ROOT, SPEC, cell, 2**31 + 11, 0.2, trace_on,
                               torch.device("cpu"), time.perf_counter(), files=tiny_files(cell))
    assert list(result)[-1] == "check"
    assert set(result) - {"check"} == {"correct", "attempted", "failed", "metrics", "device"} | (
        {"breakdown"} if trace_on else set())
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ({"busy_s", "window_s"} <= set(dev)) == trace_on
    if trace_on:
        for key in ("device_ops", "idle_gaps"):
            assert len(result["breakdown"][key]) <= 10
    else:
        assert "setup_s" in result["metrics"]
        assert any(k.startswith(("train_", "score_")) for k in result["metrics"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert [ln.split()[1] for ln in lines] == list(result["check"])
    json.dumps(result)


def test_every_metric_has_a_reader_and_a_cell():
    names = {w["name"] for w in SPEC["workloads"]}
    for group in ("end_to_end", "per_layer"):
        for m in SPEC[group]:
            assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
            assert set(m.get("workloads", names)) <= names
    for w in SPEC["workloads"]:
        assert (ROOT / "bench" / "workloads" / f"{w['name']}.json").exists()
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").exists()


# --------------------------------------------------------------- imports
def test_the_benchmark_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time, torch\n"
        "sys.path[:0] = ['src', '.']\n"
        "from bench.test_bench_harness import tiny_files, ROOT, SPEC\n"
        "from bench.harness import runner\n"
        "runner.run(ROOT, SPEC, 'stl10-20x150.train', 3, 0.1, True, torch.device('cpu'),\n"
        "           time.perf_counter(), files=tiny_files('stl10-20x150.train'))\n"
        "import bench.readings, bench.harness.faults, bench.reference.bcpnn\n"
        "print(runner.forbidden_modules())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    tops = {n.split(".")[0] for n in ("repro_torch.core", "repro.core", "jax.numpy")}
    assert sorted(t for t in tops if t in runner.FORBIDDEN) == ["jax", "repro"]


def test_reference_imports_nothing_of_the_program():
    src = (ROOT / "bench" / "reference" / "bcpnn.py").read_text()
    assert "repro" not in src.replace("reproduction", "") and "jax" not in src


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "bench/run.py", "--workload", "stl10-20x150.score",
                          "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


# ------------------------------------------------------------- on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA device of compute capability 9.0 or above")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_a_small_cell_on_the_card(card, cell):
    """A traced run of each cell at a small size through the kernels: correct,
    its launches as the schedule lists them, its rooflines read."""
    result, _ = runner.run(ROOT, SPEC, cell, 2**31 + 3, 0.2, True, card, time.perf_counter(),
                           files=tiny_files(cell))
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert any(k.startswith("masked_matmul_roofline") for k in result["metrics"])
