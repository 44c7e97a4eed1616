"""The spans window on the CPU: attribution of a hand-built profiler trace
to nested program spans, the span metrics' readers, and a spans window of
each cell at a small size."""
import json
import sys
from pathlib import Path

import pytest
import torch

from bench.harness import spans, trace
from bench.test_bench_harness import SPEC, tiny_files

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

import span_breakdown  # noqa: E402


def _trace(tmp_path, events):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _span(name, ts, dur, tid=1):
    return dict(ph="X", cat="user_annotation", name=name, ts=ts, dur=dur, pid=1, tid=tid)


def _launch(corr, ts, tid=1):
    return dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=ts, dur=2, pid=1,
                tid=tid, args=dict(correlation=corr))


def _op(cat, name, ts, dur, corr=None):
    args = {} if corr is None else dict(correlation=corr)
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=0, tid=7, args=args)


def test_device_time_goes_to_the_innermost_launching_span(tmp_path):
    ev = [
        _span(trace.WINDOW, 0, 200),
        _span("fit", 0, 150),
        _span("layer.step", 10, 50),
        _span("layer.unit_mask", 12, 8),
        _span("predict", 160, 30),
        _launch(1, 15),  # inside layer.unit_mask
        _op("kernel", "mask_expand", 30, 10, corr=1),
        _launch(2, 50),  # inside layer.step, after its child
        _op("gpu_memcpy", "Memcpy DtoD", 55, 10, corr=2),
        _op("kernel", "stray", 100, 10),  # launched by no call in the trace
        _launch(3, 170),
        _op("kernel", "head", 175, 10, corr=3),
    ]
    s = spans.attribute(_trace(tmp_path, ev))
    us = pytest.approx
    assert s["window_s"] == us(200e-6) and s["busy_s"] == us(40e-6) and s["device_ops"] == 4
    by = s["by_span"]
    assert by["layer.unit_mask"]["device_s"] == us(10e-6)
    assert by["layer.step"]["device_s"] == us(20e-6)  # the memcpy and its child's kernel
    assert by["layer.step"]["self_device_s"] == us(10e-6)
    assert by["fit"]["device_s"] == us(20e-6) and by["fit"]["self_device_s"] == 0
    assert by["predict"]["device_s"] == us(10e-6)
    assert by["fit"]["host_s"] == us(150e-6) and by["fit"]["self_host_s"] == us(100e-6)
    assert by["layer.step"]["self_host_s"] == us(42e-6)
    assert by["predict"]["lead_median_s"] == us(15e-6)  # first op at 175, span at 160
    assert by["fit"]["lead_median_s"] == us(30e-6)
    assert by["predict"]["median_s"] == us(30e-6) and by["layer.step"]["count"] == 1
    assert s["coverage"] == us(0.75)
    assert s["unattributed"] == {"stray": us(10e-6)}
    # a whole gap goes to the span that covers it longest: 0-30, 65-100 and
    # 110-175 to fit, 40-55 (covered by fit and layer.step alike) to the
    # inner one, 185-200 to predict
    idle = s["idle_by_span"]
    assert idle == {"fit": us(130e-6), "layer.step": us(15e-6), "predict": us(15e-6)}
    assert by["fit"]["idle_s"] == us(130e-6) and by["layer.unit_mask"]["idle_s"] == 0


def test_a_launch_belongs_to_the_spans_of_its_own_thread(tmp_path):
    ev = [
        _span(trace.WINDOW, 0, 100),
        _span("predict", 0, 100, tid=2),  # another thread
        _span("fit", 5, 20),
        _launch(1, 40),  # on thread 1, outside fit
        _op("kernel", "k", 50, 10, corr=1),
        _launch(2, 10),
        _op("gpu_memset", "Memset", 30, 5, corr=2),
    ]
    s = spans.attribute(_trace(tmp_path, ev))
    assert s["by_span"]["predict"]["device_s"] == 0
    assert s["by_span"]["fit"]["device_s"] == pytest.approx(5e-6)
    assert s["unattributed"] == {"k": pytest.approx(10e-6)}
    # idle time is named by the spans of every thread: here the longest cover
    assert s["idle_by_span"] == {"predict": pytest.approx(85e-6)}


def test_a_window_without_device_operations_has_no_coverage(tmp_path):
    s = spans.attribute(_trace(tmp_path, [_span(trace.WINDOW, 0, 10), _span("fit", 1, 2)]))
    assert s["busy_s"] == 0 and s["coverage"] is None and s["device_ops"] == 0
    assert s["idle_by_span"] == {"fit": pytest.approx(10e-6)}
    s = spans.attribute(_trace(tmp_path, [_span(trace.WINDOW, 0, 10)]))
    assert s["idle_by_span"] == {spans.NO_SPAN: pytest.approx(10e-6)} and s["by_span"] == {}
    with pytest.raises(ValueError):
        spans.attribute(_trace(tmp_path, [_span("fit", 1, 2)]))


def _row(**kw):
    return dict(dict(count=1, host_s=0.0, self_host_s=0.0, median_s=0.0, device_s=0.0,
                     self_device_s=0.0, idle_s=0.0, lead_median_s=None), **kw)


@pytest.mark.parametrize("metric,by_span,counters,want", [
    ("layer.unit_mask_share.train", {"layer.unit_mask": _row(device_s=0.2)}, {}, 10.0),
    ("layer.rewire_ms.train", {"layer.rewire": _row(device_s=0.02)}, {"layer.rewires": 20}, 1.0),
    ("layer.rewire_ms.train", {"layer.rewire": _row(device_s=0.02)}, {}, None),
    ("store.project_ms_per_iteration.train", {"store.project": _row(device_s=0.3)}, {}, 150.0),
    ("predict.enqueue_ms.score", {"predict": _row(median_s=4e-4)}, {}, 0.4),
    ("predict.lead_ms.score", {"predict": _row(lead_median_s=5e-4)}, {}, 0.5),
    ("predict.lead_ms.score", {"predict": _row()}, {}, None),
])
def test_span_metric_readers(metric, by_span, counters, want):
    reader = spans.METRICS[metric][0]
    run = dict(spans=dict(busy_s=2.0, units=2, counters=counters, by_span=by_span))
    got = reader(run)
    assert got == (pytest.approx(want) if want is not None else None)
    assert reader({}) is None  # no spans window
    assert reader(dict(spans=dict(busy_s=2.0, units=2, counters={}, by_span={}))) is None
    idle = reader(dict(spans=dict(run["spans"], busy_s=0.0)))  # no device operation ran
    assert idle is None or metric == "predict.enqueue_ms.score"


def test_a_program_without_tracing_gives_no_spans_window():
    class Cell:
        compiled = object()

    assert spans.profiled_window(Cell(), 1, torch.device("cpu"), spans=True) is None


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_spans_window_of_a_small_cell(cell):
    """On the CPU: both windows run, the counters agree with the code (the
    tiny train cell rewires every 4 of its 20 hidden batches an iteration
    and projects twice: the training rows at the readout, the test rows at
    evaluate), and no metric that reads device time finds any."""
    files = tiny_files(cell)
    out = span_breakdown.measure(SPEC, cell, 2**31 + 5, torch.device("cpu"), 1, files=files)
    units = out["units"]
    assert len(out["unit_s"]["traced"]) == len(out["unit_s"]["spans"]) == units
    assert out["device"] == "cpu" and out["tracing_cost"] > 0
    s = out["spans"]
    assert s["spans_on"] and s["busy_s"] == 0 and s["coverage"] is None
    host_only = {"predict.enqueue_ms.score"}  # a host length, read on any device
    assert all(v is None for k, v in out["metrics"].items() if k not in host_only)
    net = files["cfg"]["network"]
    mask_bytes = 2 * net["input_features"] * net["hidden_hcu"] * net["hidden_mcu"] * 4
    if out["spans"]["by_span"].get("fit"):
        assert s["counters"]["layer.rewires"] == 5 * units
        assert s["counters"]["store.projections"] == 2 * units
        assert s["by_span"]["layer.rewire"]["count"] == 5 * units
        assert s["by_span"]["store.project"]["count"] == 2 * units
        assert set(out["metrics"]) == {m for m, (_, k) in spans.METRICS.items() if k == "train"}
    else:
        chunks = -(-files["traffic"]["request_rows"] // files["traffic"]["predict_chunk"])
        assert s["by_span"]["predict"]["count"] == units
        assert s["by_span"]["predict.chunk"]["count"] == units * chunks
        assert s["counters"] == {"layer.unit_mask_bytes": units * chunks * mask_bytes}
        assert set(out["metrics"]) == {m for m, (_, k) in spans.METRICS.items() if k == "score"}
