"""One run of one cell: set-up, the measured window, the traced window (with
``--trace 1``), the check, and the result line.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, the configuration file it names, ``bench/traffic/
<traffic>.json`` (read by the generator of its ``kind``,
``bench/kinds/<kind>.py``, :mod:`bench.harness.kinds`), ``bench/workloads/
<cell>.json`` (the limits of its compared numbers) and ``bench/metrics/
<metric>.py`` (one reader a metric).  Adding a cell, a kind, a configuration
or a per-layer metric adds files only.
"""
from __future__ import annotations

import gc
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from bench.harness import cells, counts, kinds, readers, schedule, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, whole


def load_json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


class Cell:
    """A cell's files, resolved from ``BENCHMARK.json``."""

    def __init__(self, root: Path, spec: Dict, name: str, files: Optional[Dict] = None):
        """``files`` replaces any of ``cfg``, ``traffic`` and ``limits`` (the
        tests run a cell at a small size this way)."""
        entry = [w for w in spec["workloads"] if w["name"] == name]
        if len(entry) != 1:
            raise SystemExit(f"no cell named {name!r} in BENCHMARK.json")
        self.entry = entry[0]
        files = files or {}
        config = [c for c in spec["configs"] if c["name"] == self.entry["config"]]
        bench = root / "bench"
        self.cfg = files.get("cfg") or load_json(root / config[0]["file"])
        self.traffic = files.get("traffic") or load_json(
            bench / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = files.get("limits") or load_json(
            bench / "workloads" / f"{name}.json")["limits"]
        self.generator = kinds.load(bench / "kinds", self.traffic["kind"])
        self.metrics = {}  # name -> (spec entry, reader), the ones this cell reports
        for group in ("end_to_end", "per_layer"):
            for m in spec[group]:
                if name in m.get("workloads", [name]):
                    self.metrics[m["name"]] = (group, m, readers.load(bench / "metrics" /
                                                                      f"{m['name']}.py"))

    def build(self, seed: int, device):
        """The cell's traffic generator at ``seed``, before its set-up."""
        return self.generator(self.cfg, self.traffic, seed, device)


def forbidden_modules() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def measured_window(cell, seconds: float, device: torch.device) -> Dict:
    """Whole units (iterations or requests) back to back until ``seconds``
    have passed; the window ends at a synchronize."""
    records = []
    cells.sync(device)
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        records.append(dict(cell.unit(), unit_s=time.perf_counter() - t))
        if time.perf_counter() - t0 >= seconds:
            break
    cells.sync(device)
    window_s = time.perf_counter() - t0
    units = len(records)
    return dict(units=units, window_s=window_s, records=records, launches=cell.launches(units),
                **cell.totals(units))


def traced_window(cell, units: int, device: torch.device) -> Dict:
    """``units`` more units under ``torch.profiler``, the kernels' launch
    counters reset before them, and the trace's summary."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.kernels import ops

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    cells.sync(device)
    ops.reset_launches()
    with profile(activities=activities) as prof:
        with record_function(trace.WINDOW):
            records = [cell.unit() for _ in range(units)]
            cells.sync(device)
    counted = ops.launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(path)
        summary = trace.summarize(path, cell.kernels)
    launches = cell.launches(units)
    expected = schedule.counted(launches)
    match = all(counted.get(k, 0) == expected.get(k, 0) for k in cell.kernels)
    if not match:
        seen = {k: counted.get(k) for k in cell.kernels}
        print(f"launch counts {json.dumps(seen)} differ from the "
              f"schedule's {json.dumps(expected)}: no roofline read", file=sys.stderr)
    return dict(units=units, records=records, summary=summary, launches=launches,
                expected=expected, counted=counted, launches_match=match,
                **cell.totals(units))


def run(root: Path, spec: Dict, name: str, seed: int, seconds: float, trace_on: bool,
        device: torch.device, t_start: float, files: Optional[Dict] = None,
        window_threads: Optional[int] = None) -> Tuple[Dict, List[str]]:
    """One run; returns the result object and the compared numbers' lines.
    ``window_threads`` sets the host's intra-op threads once set-up is done:
    set-up's host work (the initial state) takes every core, the windows'
    host path runs steadier from run to run on one thread."""
    c = Cell(root, spec, name, files)
    gen = c.build(seed, device)
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    peaks = counts.peaks_for(kind) if on_card else None
    marks = [("imports", time.perf_counter())]
    if on_card:
        torch.zeros(1, device=device)  # the context, before its peak is reset
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("context", time.perf_counter()))
    gen.setup()
    cells.sync(device)
    record: Dict = dict(kind=gen.kind, setup_s=time.perf_counter() - t_start)
    parts, last = [], t_start
    for part, t in marks + gen.marks:
        parts.append(f"{part}_s {t - last:.3f}")
        last = t
    print("setup_parts " + " ".join(parts), file=sys.stderr)
    if window_threads:
        torch.set_num_threads(window_threads)
    record["window"] = measured_window(gen, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    record["peaks"] = peaks
    if trace_on:
        record["traced"] = traced_window(gen, c.traffic[gen.trace_key], device)
    attempted = record["window"]["units"]
    gen.after_window()
    gen.release()
    gc.collect()
    if on_card:
        cells.sync(device)
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = gen.numbers()
    unit_s = sorted(r["unit_s"] for r in record["window"]["records"])
    halves = [record["window"]["records"][:attempted // 2],
              record["window"]["records"][attempted // 2:]]
    mean_s = [sum(r["unit_s"] for r in h) / max(len(h), 1) for h in halves]
    print(f"setup_s {record['setup_s']:.3f} window_s {record['window']['window_s']:.3f} "
          f"units {attempted} unit_s min {unit_s[0]:.4f} median {unit_s[len(unit_s) // 2]:.4f} "
          f"max {unit_s[-1]:.4f} halves_mean_s {mean_s[0]:.5f} {mean_s[1]:.5f} "
          f"check_s {time.perf_counter() - t_check:.3f}", file=sys.stderr)
    failed = gen.failed_units(c.limits)
    correct = all(k in c.limits and v <= c.limits[k] for k, v in numbers.items())
    group = "per_layer" if trace_on else "end_to_end"
    metrics = {}
    for mname, (g, m, reader) in c.metrics.items():
        if g != group:
            continue
        value = reader.read(record)
        if value is not None:
            metrics[mname] = {"value": float(value), "unit": m["unit"]}
    dev = dict(platform="gpu" if on_card else "cpu", kind=kind, count=1, memory_peak_bytes=peak)
    result = dict(correct=correct, attempted=attempted, failed=failed, metrics=metrics, device=dev)
    if trace_on:
        s = record["traced"]["summary"]
        dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
        result["breakdown"] = dict(device_ops=trace.top(s["ops_by_name"]),
                                   idle_gaps=trace.top(s["idle_by_host_op"]))
    result["check"] = {k: {"value": v, "limit": c.limits.get(k)} for k, v in numbers.items()}
    lines = [f"check {k} {v!r} limit {c.limits.get(k)!r}" for k, v in numbers.items()]
    return result, lines
