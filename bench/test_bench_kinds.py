"""Kinds of cell as files of their own, and launches that count themselves:
a new kind runs with new files only, the two cells' counts and readers give
what they gave before kinds were files, and each launch's operations go
against the peak of its own precision.  CPU, small sizes."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import NamedTuple

import pytest

from bench.harness import counts, kinds, readers, runner, schedule
from bench.harness.counts import Forward

ROOT = Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
BF16_RATE = 989.4e12


# --------------------------------------------- a new kind adds files only
TOY_KIND = '''"""``toy``: a bf16 product of fresh rows with one weight matrix, a closed loop.

Its control is the same product with the operands rounded to fp8 (e4m3),
one precision below bf16; its program attaches no tracer.
"""
import time
from types import SimpleNamespace
from typing import NamedTuple

import torch

from bench.harness.cells import sync


class Matmul(NamedTuple):
    rows: int
    width: int
    precision = "bf16"

    def cost(self):
        r, w = self
        return 2.0 * r * w * w, 2.0 * (2 * r * w + w * w)


class ToyCell:
    kind = "toy"
    trace_key = "trace_units"
    kernels = ("toy_matmul",)
    faults = {}
    compared = ("rel_gap",)
    control_key, control_margin = "rel_gap", 4.0

    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.rows, self.width = cfg["rows"], cfg["width"]
        self.marks = []

    @staticmethod
    def tiny(cfg, traffic):
        return dict(cfg), dict(traffic)

    @staticmethod
    def tiny_spans(cfg, traffic, units):
        return {}

    def setup(self):
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        self.w = torch.randn((self.width, self.width), generator=g, device=self.device)
        self.x = torch.randn((self.rows, self.width), generator=g, device=self.device)
        self.out = self.unit_out()
        sync(self.device)
        self.marks.append(("warm", time.perf_counter()))

    def unit_out(self):
        return (self.x.bfloat16() @ self.w.bfloat16()).float()

    def unit(self):
        self.out = self.unit_out()
        return {}

    def after_window(self):
        pass

    def totals(self, units):
        return dict(samples=units * self.rows)

    def launches(self, units):
        return [("toy_matmul", Matmul(self.rows, self.width))] * units

    def release(self):
        pass

    def check_units(self, units):
        return units

    def control(self):
        fp8 = torch.float8_e4m3fn
        return SimpleNamespace(out=self.x.to(fp8).float() @ self.w.to(fp8).float())

    def numbers(self, observed=None):
        want = self.x.double() @ self.w.double()
        gap = ((observed or self).out.double() - want).abs().max() / want.abs().max()
        return dict(rel_gap=float(gap))

    def failed_units(self, limits):
        return 0
'''

# rel_gap on ten seeds: the program 0.0026-0.0045, the fp8 control
# 0.027-0.051 (6.9-14 times the program's)
TOY_LIMIT = 0.012
TOY_FILES = {
    "kinds/toy.py": TOY_KIND,
    "configs/toy-64.json": json.dumps(dict(name="toy-64", rows=64, width=96)),
    "traffic/toy_loop.json": json.dumps(dict(kind="toy", trace_units=3)),
    "workloads/toy-64.loop.json": json.dumps(dict(limits=dict(rel_gap=TOY_LIMIT))),
    # the window's operations over the H100's rate at their precision, in
    # seconds (on the CPU a run has no peaks of its own)
    "metrics/toy.rated_s.py": "from bench.harness import counts, readers\n\n\ndef read(run):\n"
                              "    h100 = dict(run, peaks=counts.H100)\n"
                              "    return readers.mfu(h100) * run['window']['window_s'] / 100\n",
}
TOY_ENTRIES = dict(
    configs=dict(name="toy-64", source="https://example.org/toy",
                 file="bench/configs/toy-64.json", reduced=[], why="a toy"),
    workloads=dict(name="toy-64.loop", config="toy-64", traffic="toy_loop", chips=1,
                   why="a toy"),
    per_layer=dict(name="toy.rated_s", unit="s", better="lower", source="host_clock",
                   layer="whole step", moves="train_samples_per_s", workloads=["toy-64.loop"]))

TOY_RUN = """
import json, sys, time
from pathlib import Path
import torch
import bench
from bench.harness import runner
assert Path(bench.__file__).resolve().parent == Path('bench').resolve(), bench.__file__
spec = json.loads(Path('BENCHMARK.json').read_text())
for trace_on in (False, True):
    result, lines = runner.run(Path('.'), spec, 'toy-64.loop', 2**31 + 17, 0.2, trace_on,
                               torch.device('cpu'), time.perf_counter())
    print(json.dumps(result))
"""


def _hashes(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _toy_checkout(tmp_path: Path, copied=("bench",)):
    """A copy of ``copied`` (paths from the repository's root) and
    ``BENCHMARK.json``, with the toy kind, its configuration, traffic,
    limits and reader added as new files, and its entries added to
    ``BENCHMARK.json``, ``toy-64.loop`` among the workloads of
    ``train_samples_per_s``.  Returns the copy's root and the hashes of
    what was copied, taken before the toy went in."""
    root = tmp_path / "checkout"
    for rel in copied + ("BENCHMARK.json",):
        if (ROOT / rel).is_dir():
            shutil.copytree(ROOT / rel, root / rel, ignore=shutil.ignore_patterns("__pycache__"))
        else:
            (root / rel).parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(ROOT / rel, root / rel)
    before = _hashes(root)
    assert before == {k: v for k, v in _hashes(ROOT).items() if k in before}
    for rel, text in TOY_FILES.items():
        path = root / "bench" / rel
        assert not path.exists(), rel
        path.write_text(text)
    spec = json.loads(json.dumps(SPEC))
    for group, entry in TOY_ENTRIES.items():
        spec[group].append(entry)
    for m in spec["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("toy-64.loop")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, before


def _env(root: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(root), str(ROOT / "src")])
    return env


def _only_new_files(root: Path, before):
    """No file of the copy changed but ``BENCHMARK.json``, which gained the
    toy's entries alone, and the new files are the toy's."""
    after = _hashes(root)
    assert {k for k in before if after.get(k) != before[k]} == {"BENCHMARK.json"}
    assert set(after) - set(before) == {f"bench/{rel}" for rel in TOY_FILES}
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for group, entry in TOY_ENTRIES.items():
        spec[group].remove(entry)
    for m in spec["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].remove("toy-64.loop")
    assert spec == SPEC


def test_a_new_kind_runs_with_new_files_only(tmp_path):
    """A toy kind, its bf16 shape, configuration, traffic, limits and a
    reader added as new files beside a copy of the harness: the copy's
    runner runs it with and without the trace, and no file of the copy
    changed."""
    root, before = _toy_checkout(tmp_path)
    out = subprocess.run([sys.executable, "-c", TOY_RUN], cwd=root, env=_env(root),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    for result in (plain, traced):
        assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
        assert list(result)[-1] == "check" and set(result["check"]) == {"rel_gap"}
        assert result["check"]["rel_gap"]["limit"] == TOY_LIMIT
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert set(plain["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert plain["metrics"]["train_samples_per_s"]["value"] > 0
    assert set(traced["metrics"]) == {"toy.rated_s"}
    assert {"busy_s", "window_s"} <= set(traced["device"]) and "breakdown" in traced
    # the window's operations went against the bf16 rate, 989.4 TFLOP/s
    flops = 2.0 * 64 * 96 * 96
    want = traced["attempted"] * flops / BF16_RATE
    assert traced["metrics"]["toy.rated_s"]["value"] == pytest.approx(want, rel=1e-9)
    _only_new_files(root, before)


# the tests that run once for each cell of BENCHMARK.json, and those that
# loop over every cell
PER_CELL = ("test_control_comes_out_not_correct", "test_numbers_are_what_the_kind_compares",
            "test_spans_window_of_a_small_cell", "test_a_small_cell_on_the_card")
ALL_CELLS = ("test_limits_name_every_compared_number", "test_every_metric_has_a_reader_and_a_cell")


def test_a_new_kind_passes_every_per_cell_test(tmp_path):
    """The toy cell added as new files only beside a copy of the harness and
    its tests: ``pytest`` on the copy's ``bench/`` collects a case of every
    per-cell test for it, and each such case and each test over every cell
    passes (the card's skips on the CPU); no file of the copy changed."""
    root, before = _toy_checkout(tmp_path, ("bench", "tools/span_breakdown.py", "pytest.ini"))
    base = [sys.executable, "-m", "pytest", "-p", "no:cacheprovider", "-p", "no:randomly"]
    out = subprocess.run(base + ["--collect-only", "-q", "bench"], cwd=root, env=_env(root),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    own = "test_a_new_kind_passes_every_per_cell_test"
    chosen = [i for i in out.stdout.splitlines() if "::" in i and own not in i
              and ("toy-64.loop" in i.partition("[")[2] or i.rpartition("::")[2] in ALL_CELLS)]
    names = [i.rpartition("::")[2] for i in chosen]
    for test in PER_CELL:
        assert any(n.startswith(test + "[") for n in names), (test, names)
    xml = tmp_path / "toy.xml"
    out = subprocess.run(base + ["-q", f"--junitxml={xml}"] + chosen, cwd=root, env=_env(root),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    outcome = {c.get("name"): [e.tag for e in c if e.tag in ("failure", "error", "skipped")]
               for c in ET.parse(xml).getroot().iter("testcase")}
    assert sorted(outcome) == sorted(names)
    card = "test_a_small_cell_on_the_card[toy-64.loop]"  # skips without a card
    assert all(tags in ([], ["skipped"]) if name == card else tags == []
               for name, tags in outcome.items()), outcome
    _only_new_files(root, before)


def test_a_kind_names_what_it_lacks(tmp_path):
    """A kind's class without an attribute the runner or the tests read
    stops the loader, which names the file and what is missing; the BCPNN
    kinds declare them all."""
    body = TOY_KIND.replace('    compared = ("rel_gap",)\n', "").replace(
        "    @staticmethod\n    def tiny_spans(cfg, traffic, units):\n        return {}\n", "")
    assert "compared" not in body and "tiny_spans" not in body
    (tmp_path / "toy.py").write_text(body)
    with pytest.raises(SystemExit, match=r"toy\.py: class ToyCell lacks compared, tiny_spans "):
        kinds.load(tmp_path, "toy")
    for name in ("train", "score"):
        cls = kinds.load(ROOT / "bench" / "kinds", name)
        assert all(hasattr(cls, a) for a in kinds.RUNNER + kinds.TESTS), name


def test_an_unknown_kind_names_the_file_it_looked_for():
    files = dict(traffic=dict(kind="no_such_kind"))
    with pytest.raises(SystemExit, match=r"bench/kinds/no_such_kind\.py"):
        runner.Cell(ROOT, SPEC, "stl10-20x150.train", files)


def test_the_bcpnn_kinds_declare_what_the_runner_reads():
    for cell, key in (("stl10-20x150.train", "trace_iterations"),
                      ("stl10-20x150.score", "trace_requests")):
        c = runner.Cell(ROOT, SPEC, cell)
        assert c.generator.kind == c.traffic["kind"] and c.generator.trace_key == key
        assert c.generator.kernels == schedule.KERNELS
        assert set(c.generator.faults) == {"half", "unchanged", "answer"}
        assert c.generator is kinds.load(ROOT / "bench" / "kinds", c.traffic["kind"])


# -------------------------- the two cells read as before kinds were files
# Each cell's window and traced window on a fixed record: units, lengths,
# host times and the profiler's per-kernel seconds made up, every launch
# listed by the cell's own schedule at its full size.
FIXED = {
    "stl10-20x150.train": dict(units=23, traced=2, window_s=51.377123, seconds=dict(
        masked_matmul=0.0455566, hcu_softmax=0.0016113, bcpnn_update=0.6147723),
        busy_s=0.9243, traced_window_s=0.98112, device_ops=4321),
    "stl10-20x150.score": dict(units=64123, traced=64, window_s=51.000417, seconds=dict(
        masked_matmul=0.0360345, hcu_softmax=0.0008247),
        busy_s=0.0384, traced_window_s=0.07061, device_ops=517),
}

# What the readers, counts.totals and counts.bound_s gave on that record
# before kinds and launches counted themselves (computed once by that code).
WANT_READERS = {
    "stl10-20x150.train": {
        "train_samples_per_s": 13408.613791005775, "setup_s": 13.4821,
        "engine.enqueue_ms_per_batch.train": 0.35598290598290594,
        "layer.device_ops_per_batch.train": 9.232905982905983,
        "masked_matmul_roofline.train": 30.730147306342378,
        "bcpnn_update_roofline.train": 40.695228283100185,
        "device.idle_share.train": 5.791340508806265, "mfu.train": 5.911549254227121},
    "stl10-20x150.score": {
        "score_rows_per_s": 1287478.7278700094, "score_p95_ms": 0.85538, "setup_s": 13.4821,
        "masked_matmul_roofline.score": 34.02368319083924,
        "device.idle_share.score": 45.6167681631497, "mfu.score": 23.75696102476615},
}
WANT_TOTALS = {
    "stl10-20x150.train": {
        "masked_matmul": dict(launches=5773, flops=10742068120000.0, bytes=355610039840.0,
                              bound_s=0.1609955183092539),
        "hcu_softmax": dict(launches=5773, flops=10484320000.0, bytes=20968640000.0,
                            bound_s=0.006259295522387744),
        "bcpnn_update": dict(launches=5382, flops=192738770973840.0, bytes=9075750953880.0,
                             bound_s=2.87710439542233)},
    "stl10-20x150.score": {
        "masked_matmul": dict(launches=128246, flops=810991425771520.0,
                              bytes=17828069982488.0, bound_s=12.28382681451595),
        "hcu_softmax": dict(launches=128246, flops=790569902080.0, bytes=1581139804160.0,
                            bound_s=0.47198203109260745)},
}
WANT_BOUND_S = {
    "Forward(rows=1024, features=3000, units=10, kept=3000, mask=0)": 3.7161194029850745e-06,
    "Forward(rows=1024, features=55296, units=3000, kept=2048, mask=552960)":
        0.00018785050746268658,
    "Forward(rows=128, features=55296, units=3000, kept=2048, mask=552960)":
        2.3481313432835822e-05,
    "Forward(rows=8, features=55296, units=3000, kept=2048, mask=552960)": 8.556809552238806e-06,
    "Forward(rows=832, features=3000, units=10, kept=3000, mask=0)": 3.026065671641791e-06,
    "Forward(rows=832, features=55296, units=3000, kept=2048, mask=552960)":
        0.00015262853731343284,
    "Softmax(rows=1024, units=10)": 2.4453731343283583e-08,
    "Softmax(rows=1024, units=3000)": 7.3361194029850746e-06,
    "Softmax(rows=128, units=3000)": 9.170149253731343e-07,
    "Softmax(rows=8, units=3000)": 5.7313432835820895e-08,
    "Softmax(rows=832, units=10)": 1.986865671641791e-08,
    "Softmax(rows=832, units=3000)": 5.960597014925373e-06,
    "Update(rows=128, pre=3000, post=10, mask=0)": 5.746985074626865e-07,
    "Update(rows=128, pre=55296, post=3000, mask=552960)": 0.0006413799087761194,
}


def synthetic_record(cell: str, gen):
    f = FIXED[cell]
    if cell.endswith("train"):
        records = [dict(unit_s=2.21 + 1e-3 * i,
                        history=[dict(host_s=0.011 + 3e-4 * j) for j in range(7)])
                   for i in range(f["units"])]
    else:
        records = [dict(unit_s=7.9e-4, latency_s=7.5e-4 + ((i * 7919) % 1009) * 1.1e-7)
                   for i in range(f["units"])]
    traced = gen.launches(f["traced"])
    expected = schedule.counted(traced)
    kernels = {k: dict(launches=expected.get(k, 0), seconds=f["seconds"].get(k, 0.0))
               for k in schedule.KERNELS}
    summary = dict(window_s=f["traced_window_s"], busy_s=f["busy_s"],
                   device_ops=f["device_ops"], kernels=kernels)
    return dict(
        kind=gen.kind, setup_s=13.4821, peaks=counts.H100,
        window=dict(units=f["units"], window_s=f["window_s"], records=records,
                    launches=gen.launches(f["units"]), **gen.totals(f["units"])),
        traced=dict(units=f["traced"], summary=summary, launches=traced, expected=expected,
                    counted=dict(expected), launches_match=True, **gen.totals(f["traced"])))


@pytest.mark.parametrize("cell", list(FIXED))
def test_the_two_cells_read_as_before(cell):
    """Bit for bit: every reader of the cell, the window's totals by kernel,
    and each launch's bound."""
    c = runner.Cell(ROOT, SPEC, cell)
    run = synthetic_record(cell, c.build(7, "cpu"))
    got = {name: reader.read(run) for name, (_, _, reader) in c.metrics.items()}
    assert got == WANT_READERS[cell]
    assert counts.totals(run["window"]["launches"], counts.H100) == WANT_TOTALS[cell]
    for _, shape in run["window"]["launches"]:
        assert shape.precision == "f32"
        assert counts.bound_s(shape, counts.H100) == WANT_BOUND_S[repr(shape)]


# ------------------------------------------- each launch at its own rate
class Bf16Matmul(NamedTuple):
    m: int
    k: int
    n: int
    precision = "bf16"

    def cost(self):
        m, k, n = self
        return 2.0 * m * k * n, 2.0 * (m * k + k * n + m * n)


def test_mfu_divides_each_launch_by_the_rate_of_its_precision():
    f32 = Forward(rows=128, features=4096, units=1024, kept=2048)
    bf16 = Bf16Matmul(4096, 4096, 4096)
    launches = [("masked_matmul", f32)] * 3 + [("toy_matmul", bf16)] * 2
    run = dict(peaks=counts.H100, window=dict(window_s=2.0, launches=launches))
    want = 100.0 * (3 * f32.cost()[0] / 67e12 + 2 * bf16.cost()[0] / BF16_RATE) / 2.0
    assert readers.mfu(run) == pytest.approx(want, rel=1e-12)
    one_rate = 100.0 * (3 * f32.cost()[0] + 2 * bf16.cost()[0]) / (2.0 * 67e12)
    assert readers.mfu(run) < one_rate / 10
    flops, nbytes = bf16.cost()
    assert counts.bound_s(bf16, counts.H100) == max(flops / BF16_RATE, nbytes / 3.35e12)


def test_the_peaks_table():
    h = counts.H100
    assert (h.flops, h.bytes) == (67e12, 3.35e12)
    assert {p: h.rate(p) for p in ("f32", "tf32", "bf16", "fp16", "fp8")} == dict(
        f32=67e12, tf32=494.7e12, bf16=989.4e12, fp16=989.4e12, fp8=1978.9e12)
    with pytest.raises(KeyError):
        h.rate("int4")
    assert counts.Peaks(100.0, 10.0).rate("f32") == 100.0
