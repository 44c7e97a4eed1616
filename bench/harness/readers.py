"""What the metric readers under ``bench/metrics/`` share.

A reader is ``read(run) -> float or None``; ``run`` is the record
:mod:`bench.harness.runner` builds (the set-up time, the measured window,
the traced window's summary and launches).  A reader that finds nothing to
read returns None and the metric is left out of the line.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, Optional

from bench.harness import counts


def load(path: Path, prefix: str = "bench_metric_"):
    """The reader module in ``path`` (its file name is the metric's name)."""
    name = prefix + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def window_rate(run: Dict, key: str) -> Optional[float]:
    w = run.get("window")
    if not w or not w.get(key) or w["window_s"] <= 0:
        return None
    return w[key] / w["window_s"]


def roofline(run: Dict, kernel: str) -> Optional[float]:
    """A kernel's share of its roofline in the traced window, in percent:
    the summed bound of its launches over its summed profiled time.  None
    when the traced window ran none of it, when the card has no peaks in
    the table, or when the launches the profile and the counters saw differ
    from the schedule's list (then the bound would be of other work)."""
    t, peaks = run.get("traced"), run.get("peaks")
    if not t or peaks is None or not t["launches_match"]:
        return None
    seen = t["summary"]["kernels"].get(kernel)
    if not seen or not seen["launches"] or seen["seconds"] <= 0:
        return None
    if seen["launches"] != t["expected"].get(kernel):
        return None
    total = counts.totals(t["launches"], peaks).get(kernel)
    return 100.0 * total["bound_s"] / seen["seconds"]


def idle_share(run: Dict) -> Optional[float]:
    """Percent of the traced window in which no device operation ran."""
    t = run.get("traced")
    if not t or t["summary"]["window_s"] <= 0 or not t["summary"]["device_ops"]:
        return None
    s = t["summary"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def mfu(run: Dict) -> Optional[float]:
    """The measured window's counted operations, each launch's over the
    card's peak at its own precision, over the window's length, in percent."""
    w, peaks = run.get("window"), run.get("peaks")
    if not w or peaks is None or w["window_s"] <= 0:
        return None
    flops: Dict[str, float] = {}  # by precision
    for _, shape in w["launches"]:
        flops[shape.precision] = flops.get(shape.precision, 0) + counts.cost(shape)[0]
    return sum(100.0 * f / (w["window_s"] * peaks.rate(p)) for p, f in flops.items())
