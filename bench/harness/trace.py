"""Reading a ``torch.profiler`` Chrome trace of the traced window.

The window is the ``bench.window`` annotation the harness records around
the traced work.  Device operations are the trace's kernels, copies and
fills.  Busy time is the length of the union of their intervals inside the
window (kernels that overlap count once), so the idle share is one minus
busy over the window.  Each idle gap is named by the host operator that
overlaps it the longest (the innermost one among equals), or
``(no operator)`` where the host ran Python between operators.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NO_OP = "(no operator)"
LABELLED_GAPS = 4000  # the longest gaps named; the rest summed unnamed
SHORT_GAPS = "(shorter gaps)"


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of ``(start, end)`` intervals, sorted and disjoint."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy(intervals: Sequence[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    total = 0.0
    for s, e in merge(intervals):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            total += e - s
    return total


def gaps(intervals: Sequence[Tuple[float, float]], lo: float, hi: float):
    """The idle ``(start, end)`` gaps of ``[lo, hi]`` outside the union."""
    out, t = [], lo
    for s, e in merge(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def name_gaps(idle: Sequence[Tuple[float, float]], host: Sequence[Tuple[float, float, str]]
              ) -> Dict[str, float]:
    """Idle time by the host operator that fills each gap the longest."""
    out: Dict[str, float] = {}
    if not idle:
        return out
    order = sorted(idle, key=lambda g: g[0] - g[1])  # longest first
    named, rest = order[:LABELLED_GAPS], order[LABELLED_GAPS:]
    if host:
        hs = np.array([h[0] for h in host])
        he = np.array([h[1] for h in host])
        length = he - hs
    for g0, g1 in named:
        label = NO_OP
        if host:
            overlap = np.minimum(he, g1) - np.maximum(hs, g0)
            best = overlap.max()
            if best > 0:
                # the innermost (shortest) operator among those overlapping most
                cand = np.flatnonzero(overlap >= best)
                label = host[int(cand[np.argmin(length[cand])])][2]
        out[label] = out.get(label, 0.0) + (g1 - g0)
    if rest:
        out[SHORT_GAPS] = sum(g1 - g0 for g0, g1 in rest)
    return out


def summarize(path: str, kernels: Sequence[str]) -> Dict:
    """The window's length, busy time, device operations, the named idle
    time and, for each name in ``kernels``, its launches and summed time
    (a kernel matches by its symbol ``<name>_kernel``).  Seconds."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    windows = [e for e in spans if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(windows) != 1:
        raise ValueError(f"trace holds {len(windows)} {WINDOW} annotations, want 1")
    lo = float(windows[0]["ts"])
    hi = lo + float(windows[0]["dur"])
    # every device operation that overlaps the window (its timestamps come
    # from the device's clock, aligned to the host's, so one may start or
    # end a microsecond past an edge); busy time is clipped to the window
    device = [e for e in spans if e.get("cat") in DEVICE_CATS
              and float(e["ts"]) < hi and float(e["ts"]) + float(e["dur"]) > lo]
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in spans
            if e.get("cat") == "cpu_op" and float(e["ts"]) < hi
            and float(e["ts"]) + float(e["dur"]) > lo]
    by_name: Dict[str, float] = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    ours = {}
    for k in kernels:
        pattern = re.compile(rf"\b{k}_kernel\b")
        mine = [e for e in device if e.get("cat") == "kernel" and pattern.search(e["name"])]
        ours[k] = dict(launches=len(mine), seconds=sum(float(e["dur"]) for e in mine) * 1e-6)
    idle = name_gaps(gaps(intervals, lo, hi), host)
    return dict(
        window_s=(hi - lo) * 1e-6,
        busy_s=busy(intervals, lo, hi) * 1e-6,
        device_ops=len(device),
        ops_by_name=by_name,
        idle_by_host_op={k: v * 1e-6 for k, v in idle.items()},
        kernels=ours,
    )


def top(table: Dict[str, float], n: int = 10) -> List[List]:
    """The ``n`` largest entries as ``[name, seconds]``, names cut to 120
    characters (a kernel's template arguments run long)."""
    rows = sorted(table.items(), key=lambda kv: -kv[1])[:n]
    return [[k[:120], v] for k, v in rows]
