#!/usr/bin/env python3
"""Where a benchmark cell's device and idle time go, by program span.

    python3 tools/span_breakdown.py --workload <cell> --seed <n> [--rounds 2]

from the root of a checkout, on a CUDA device.  It sets the cell up as
``bench/run.py`` does, then runs profiled windows of the cell's traced
size (``trace_iterations`` or ``trace_requests`` units) in turns, without
and with the program's tracer (off, on, on, off, ... for ``--rounds``), and
prints one JSON line: each window's unit seconds, the last spans window's
attribution (``bench.harness.spans.attribute``: device, host and idle
seconds by span, the coverage, what no span launched), the program's
counters over that window beside its kernel launches by
``ops.launch_counts()`` (``masked_matmul.gathered`` in both), and the five
span metrics of ``bench.harness.spans.METRICS`` for the cell's kind.  The whole record is
also written to ``chiprun_out/spans/<cell>-<seed>.json``.  Without CUDA it
exits 2 and prints nothing.
"""
import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def measure(spec, name: str, seed: int, device, rounds: int, files=None) -> dict:
    """Set-up of cell ``name`` at ``seed``, then ``rounds`` pairs of
    profiled windows (without and with the tracer, the order turning each
    round); their unit times, the last spans window, and its metrics."""
    import torch

    from bench.harness import cells, runner, spans
    from repro_torch.kernels import ops

    c = runner.Cell(ROOT, spec, name, files)
    gen = cells.KINDS[c.traffic["kind"]](c.cfg, c.traffic, seed, device)
    torch.zeros(1, device=device)
    t0 = time.perf_counter()
    gen.setup()
    cells.sync(device)
    setup_s = time.perf_counter() - t0
    torch.set_num_threads(1)
    units = c.traffic["trace_iterations" if gen.kind == "train" else "trace_requests"]
    unit_s = {False: [], True: []}
    last, launches = None, {}
    for r in range(rounds):
        for on in ((False, True) if r % 2 == 0 else (True, False)):
            before = ops.launch_counts()
            window = spans.profiled_window(gen, units, device, spans=on)
            unit_s[on] += window["unit_s"]
            if on:
                last = window
                launches = {k: v - before[k] for k, v in ops.launch_counts().items()
                            if v != before[k]}
    medians = {k: statistics.median(v) for k, v in unit_s.items()}
    metrics = {m: fn(dict(spans=last)) for m, (fn, kind) in spans.METRICS.items()
               if kind == gen.kind}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return dict(workload=name, seed=seed, device=kind, setup_s=setup_s, units=units,
                unit_s_median=dict(traced=medians[False], spans=medians[True]),
                tracing_cost=medians[True] / medians[False], unit_s=dict(
                    traced=unit_s[False], spans=unit_s[True]),
                metrics=metrics, launches=launches, spans=last)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("span_breakdown needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = measure(spec, args.workload, args.seed, torch.device("cuda", 0), args.rounds)
    path = ROOT / "chiprun_out" / "spans" / f"{args.workload}-{args.seed}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    s = out["spans"]
    top = sorted(s["by_span"].items(), key=lambda kv: -kv[1]["device_s"])
    print(json.dumps(dict(
        {k: out[k] for k in ("workload", "seed", "device", "setup_s", "units",
                             "unit_s_median", "tracing_cost", "metrics")},
        window_s=s["window_s"], busy_s=s["busy_s"], coverage=s["coverage"],
        counters=s["counters"], launches=out["launches"], by_span={k: v for k, v in top},
        idle_by_span=sorted(s["idle_by_span"].items(), key=lambda kv: -kv[1])[:10],
        unattributed=sorted(s["unattributed"].items(), key=lambda kv: -kv[1])[:10])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
