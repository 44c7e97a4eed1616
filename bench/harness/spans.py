"""The spans window: the program's own spans beside the device trace.

A spans window is ``units`` more units of a cell under ``torch.profiler``,
inside one ``bench.window`` annotation, with the program's tracer attached
for the window only (``compiled.tracing()``).  While the profiler records,
each span of the program (``repro_torch.runtime.trace``) is also a
``record_function`` of its name, so it lands in the profiler's trace as a
``user_annotation`` on the profiler's clock, beside the kernels.
:func:`attribute` then puts the window's device time and idle time down to
those spans:

* each device operation (kernel, copy, fill) goes, through its
  ``correlation`` id, to the CUDA runtime or driver call that launched it,
  and that call to the innermost program span enclosing it on the
  launching thread (``(no span)`` where none does);
* each idle gap of the window is named by the innermost program span that
  covers it longest on the host, as :func:`bench.harness.trace.name_gaps`
  names gaps by operator.

The same window without the tracer (``spans=False``) is the traced window
of :mod:`bench.harness.runner` timed unit by unit, so the two give the cost
of tracing when it is on.  :data:`METRICS` reads a run record holding a
spans window under ``"spans"``; each reader returns None without one (a
program without ``compiled.tracing()`` gives none).
"""
from __future__ import annotations

import contextlib
import json
import statistics
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from bench.harness import cells, trace

SPAN_CAT = "user_annotation"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no span)"


def profiled_window(cell, units: int, device, spans: bool) -> Optional[Dict]:
    """``units`` units of ``cell`` under the profiler, each timed on the
    host, with the program's tracer attached when ``spans``; their trace
    attributed (:func:`attribute`) and, with ``spans``, the program's
    counters and the activation store's stats, both as increases over the
    window.  None when ``spans`` and the program cannot attach a tracer."""
    from torch.profiler import ProfilerActivity, profile, record_function

    compiled = getattr(cell, "compiled", None)
    if spans and not hasattr(compiled, "tracing"):
        return None
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    store = getattr(compiled, "activations", None)
    before = dict(store.stats) if store is not None else {}
    cells.sync(device)
    unit_s: List[float] = []
    with (compiled.tracing() if spans else contextlib.nullcontext()) as tracer:
        with profile(activities=activities) as prof:
            with record_function(trace.WINDOW):
                for _ in range(units):
                    t = time.perf_counter()
                    cell.unit()
                    unit_s.append(time.perf_counter() - t)
                cells.sync(device)
    counters = dict(tracer.counters()) if tracer is not None else {}
    if store is not None:
        counters.update({f"store.{k}": v - before.get(k, 0) for k, v in store.stats.items()})
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(path)
        out = attribute(path)
    return dict(out, units=units, unit_s=unit_s, spans_on=spans, counters=counters)


def measure(root: Path, spec: Dict, name: str, seed: int, device, rounds: int,
            files: Optional[Dict] = None) -> Dict:
    """Set-up of cell ``name`` at ``seed``, then ``rounds`` pairs of profiled
    windows of its traced size (the traffic's ``trace_key`` units), without
    and with the program's tracer, the order turning each round: their unit
    times, the last spans window (None where the kind's program attaches no
    tracer), the port's kernel launches in it, and the :data:`METRICS` of
    the cell's kind read from it."""
    import torch

    from bench.harness import runner
    from repro_torch.kernels import ops

    c = runner.Cell(root, spec, name, files)
    gen = c.build(seed, device)
    torch.zeros(1, device=device)
    t0 = time.perf_counter()
    gen.setup()
    cells.sync(device)
    setup_s = time.perf_counter() - t0
    torch.set_num_threads(1)
    units = c.traffic[gen.trace_key]
    unit_s: Dict[bool, List[float]] = {False: [], True: []}
    last, launches = None, {}
    for r in range(rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            before = ops.launch_counts()
            window = profiled_window(gen, units, device, spans=on)
            if window is None:
                continue
            unit_s[on] += window["unit_s"]
            if on:
                last = window
                launches = {k: v - before.get(k, 0) for k, v in ops.launch_counts().items()
                            if v != before.get(k, 0)}
    medians = {on: statistics.median(v) if v else None for on, v in unit_s.items()}
    metrics = {m: fn(dict(spans=last)) for m, (fn, kind) in METRICS.items() if kind == gen.kind}
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    cost = medians[True] / medians[False] if last is not None else None
    return dict(workload=name, kind=gen.kind, seed=seed, device=card, setup_s=setup_s,
                units=units, unit_s_median=dict(traced=medians[False], spans=medians[True]),
                tracing_cost=cost, unit_s=dict(traced=unit_s[False], spans=unit_s[True]),
                metrics=metrics, launches=launches, spans=last)


def _innermost(starts: np.ndarray, ends: np.ndarray, lo: float, hi: float,
               skip: int = -1) -> int:
    """Index of the innermost interval holding ``[lo, hi]`` (the latest
    start, then the earliest end), other than ``skip``; -1 if none."""
    inside = (starts <= lo) & (ends >= hi)
    if 0 <= skip < len(inside):
        inside[skip] = False
    cand = np.flatnonzero(inside)
    if not len(cand):
        return -1
    best = cand[starts[cand] == starts[cand].max()]
    return int(best[np.argmin(ends[best])])


def attribute(path: str) -> Dict:
    """A profiler trace's window, its device time and its idle time by
    program span (seconds).  ``by_span[name]`` holds ``count``, ``host_s``
    (the spans' summed length), ``self_host_s`` (less their child spans),
    ``median_s`` (the median length), ``device_s`` (device time launched
    inside the span or its children), ``self_device_s`` (launched in it
    and in no child), ``idle_s`` (idle time it covers longest) and
    ``lead_median_s`` (the median, over the spans that launched any, of
    the first such operation's device start less the span's start).
    ``coverage`` is the share of the busy time launched inside some span;
    ``unattributed`` names what is left, by operation."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    windows = [e for e in xs if e.get("name") == trace.WINDOW and e.get("cat") == SPAN_CAT]
    if len(windows) != 1:
        raise ValueError(f"trace holds {len(windows)} {trace.WINDOW} annotations, want 1")
    lo = float(windows[0]["ts"])
    hi = lo + float(windows[0]["dur"])
    spans = [e for e in xs if e.get("cat") == SPAN_CAT and e is not windows[0]
             and lo <= float(e["ts"]) < hi]
    names = [e["name"] for e in spans]
    starts = np.array([float(e["ts"]) for e in spans])
    ends = starts + np.array([float(e["dur"]) for e in spans])
    threads = [(e.get("pid"), e.get("tid")) for e in spans]
    by_thread: Dict = {}
    for i, k in enumerate(threads):
        by_thread.setdefault(k, []).append(i)
    by_thread = {k: np.array(v) for k, v in by_thread.items()}

    def enclosing(thread, t0: float, t1: float, skip: int = -1) -> int:
        idx = by_thread.get(thread)
        if idx is None:
            return -1
        local_skip = int(np.flatnonzero(idx == skip)[0]) if skip >= 0 else -1
        j = _innermost(starts[idx], ends[idx], t0, t1, local_skip)
        return int(idx[j]) if j >= 0 else -1

    parent = [enclosing(threads[i], starts[i], ends[i], skip=i) for i in range(len(spans))]
    child_s = np.zeros(len(spans))
    for i, p in enumerate(parent):
        if p >= 0:
            child_s[p] += ends[i] - starts[i]

    device = [e for e in xs if e.get("cat") in trace.DEVICE_CATS
              and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    launches = {e["args"]["correlation"]: e for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device_s = np.zeros(len(spans))
    self_device_s = np.zeros(len(spans))
    first_op = np.full(len(spans), np.inf)
    attributed, unattributed = [], {}
    for e in device:
        call = launches.get(e.get("args", {}).get("correlation"))
        i = -1
        if call is not None:
            t = float(call["ts"])
            i = enclosing((call.get("pid"), call.get("tid")), t, t)
        dur, ts = float(e["dur"]), float(e["ts"])
        if i < 0:
            unattributed[e["name"]] = unattributed.get(e["name"], 0.0) + dur * 1e-6
            continue
        attributed.append((ts, ts + dur))
        self_device_s[i] += dur
        seen = set()
        while i >= 0:
            if names[i] not in seen:  # a name nested in itself counts once
                seen.add(names[i])
                device_s[i] += dur
            first_op[i] = min(first_op[i], ts)
            i = parent[i]

    intervals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device]
    busy_s = trace.busy(intervals, lo, hi) * 1e-6
    idle = trace.name_gaps(trace.gaps(intervals, lo, hi),
                           [(starts[i], ends[i], names[i]) for i in range(len(spans))])
    idle_by_span = {(NO_SPAN if k == trace.NO_OP else k): v * 1e-6 for k, v in idle.items()}
    by_span: Dict[str, Dict] = {}
    lengths: Dict[str, List[float]] = {}
    leads: Dict[str, List[float]] = {}
    for i, name in enumerate(names):
        row = by_span.setdefault(name, dict(count=0, host_s=0.0, self_host_s=0.0,
                                            device_s=0.0, self_device_s=0.0))
        length = ends[i] - starts[i]
        row["count"] += 1
        row["host_s"] += float(length) * 1e-6
        row["self_host_s"] += float(length - child_s[i]) * 1e-6
        row["device_s"] += float(device_s[i]) * 1e-6
        row["self_device_s"] += float(self_device_s[i]) * 1e-6
        lengths.setdefault(name, []).append(float(length) * 1e-6)
        if np.isfinite(first_op[i]):
            leads.setdefault(name, []).append(float(first_op[i] - starts[i]) * 1e-6)
    for name, row in by_span.items():
        row["median_s"] = statistics.median(lengths[name])
        row["lead_median_s"] = statistics.median(leads[name]) if name in leads else None
        row["idle_s"] = idle_by_span.get(name, 0.0)
    return dict(
        window_s=(hi - lo) * 1e-6,
        busy_s=busy_s,
        device_ops=len(device),
        coverage=(trace.busy(attributed, lo, hi) * 1e-6 / busy_s) if busy_s > 0 else None,
        by_span=by_span,
        idle_by_span=idle_by_span,
        unattributed=unattributed,
    )


def _span(run: Dict, name: str, device: bool = True) -> Optional[Dict]:
    """The spans window's row of ``name``; None without one, and, where the
    metric reads device time, when no device operation ran in it."""
    s = run.get("spans")
    if not s or (device and not s["busy_s"]):
        return None
    return s["by_span"].get(name)


def unit_mask_share(run: Dict) -> Optional[float]:
    """Percent of the spans window's device busy time launched inside
    ``layer.unit_mask`` spans (the per-batch mask expansion)."""
    row = _span(run, "layer.unit_mask")
    return 100.0 * row["device_s"] / run["spans"]["busy_s"] if row else None


def rewire_ms(run: Dict) -> Optional[float]:
    """Device milliseconds launched inside ``layer.rewire`` spans, per
    rewiring counted by ``layer.rewires``."""
    row = _span(run, "layer.rewire")
    n = run["spans"]["counters"].get("layer.rewires") if row else None
    return 1e3 * row["device_s"] / n if n else None


def store_project_ms_per_iteration(run: Dict) -> Optional[float]:
    """Device milliseconds launched inside ``store.project`` spans (their
    mask expansions included), per unit of the window."""
    row = _span(run, "store.project")
    return 1e3 * row["device_s"] / run["spans"]["units"] if row else None


def predict_enqueue_ms(run: Dict) -> Optional[float]:
    """The median host length of the window's ``predict`` spans, which
    end before the caller's read back: the host's enqueue time."""
    row = _span(run, "predict", device=False)
    return 1e3 * row["median_s"] if row else None


def predict_lead_ms(run: Dict) -> Optional[float]:
    """The median, over requests, of the first device operation a
    ``predict`` span launched, less the span's start (ms)."""
    row = _span(run, "predict")
    if row is None or row["lead_median_s"] is None:
        return None
    return 1e3 * row["lead_median_s"]


# name -> (reader, the cell kind whose spans window it reads)
METRICS = {
    "layer.unit_mask_share.train": (unit_mask_share, "train"),
    "layer.rewire_ms.train": (rewire_ms, "train"),
    "store.project_ms_per_iteration.train": (store_project_ms_per_iteration, "train"),
    "predict.enqueue_ms.score": (predict_enqueue_ms, "score"),
    "predict.lead_ms.score": (predict_lead_ms, "score"),
}
