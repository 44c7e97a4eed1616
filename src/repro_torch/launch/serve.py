"""Serving launcher for the port: the LM zoo's decoder-only families (dense,
MoE, SSM, hybrid, VLM), and the BCPNN classifier through the continual
tier.

    python -m repro_torch.launch.serve --arch gemma3-1b --requests 8
    python -m repro_torch.launch.serve --arch gemma3-1b --full --requests 8 --max-batch 4 --max-seq 1024
    python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --full --requests 8 --max-batch 4 --max-seq 1024
    python -m repro_torch.launch.serve --arch mamba2-1.3b --full --requests 8 --max-batch 4 --max-seq 1024
    python -m repro_torch.launch.serve --arch zamba2-2.7b --full --requests 8 --max-batch 4 --max-seq 1024
    python -m repro_torch.launch.serve --arch internvl2-1b --full --requests 8 --max-batch 4 --max-seq 1024
    python -m repro_torch.launch.serve --arch gemma3-1b --requests 8 --async
    python -m repro_torch.launch.serve --fleet 2 --tenants free:1,paid:4 --deadline-s 0.5
    python -m repro_torch.launch.serve --online

The port of the JAX package's ``repro/launch/serve.py``, with its flags
and output lines.  It routes through the serving API: ``serve_model``
binds the model to an ``InferenceService`` whose DecodePlan advances all
decode slots in one fused step.  ``--async`` serves through the
AsyncEngine (futures and continuous batching: requests are admitted into
freed slots mid-flight); both modes print the latency telemetry (queue
wait / prefill / per-token decode percentiles).  ``--fleet N`` serves
through the Router instead: N decode engines over the one shared model,
requests spread across ``--tenants name:weight,...`` with per-tenant
fair-share scheduling and an optional ``--deadline-s`` SLO.  ``--smoke``
(the default) uses the reduced config; ``--full`` the published one, on
the one card, refused (naming the bytes) when its parameters do not fit
the card's memory (moonshot-v1-16b-a3b, 56.8 GB in bf16, loads on an
80 GB card; deepseek-v2-236b, 471.5 GB, is refused).  The weights are
random, from ``torch.Generator`` seed 0.  The dense, MoE, SSM (mamba2),
hybrid (zamba2) and VLM (internvl2, text prompts) families serve; the
SSM and hybrid families prefill at exact length (no prompt buckets: a
recurrent state would fold the pad tokens in).  The encoder-decoder
family is refused by the decode plan, as the reference's is: its model's
own functions (``prefill``, then ``decode_step``) serve it.

``--online`` serves a small BCPNN classifier through the continual tier
instead: labeled ``Feedback`` interleaves with inference on the engine
thread, micro-batches apply as Hebbian updates, adapters merge into the
shared base every ``--merge-every`` micro-batches, and a
``--drift-window`` prequential accuracy window drives drift detection
with snapshot/rollback (an injected mid-stream label flip exercises the
whole safety loop).

Observability (every mode): ``--metrics-port N`` serves the live
telemetry as OpenMetrics text on ``http://127.0.0.1:N/metrics`` (0 picks
an ephemeral port; the launcher self-scrapes and validates the
exposition before exiting), ``--metrics-dump FILE`` writes the final
exposition (``python -m repro_torch.runtime.export FILE`` checks it),
``--metrics-json`` prints the raw snapshot as JSON.  ``--trace-json FILE``
enables per-request tracing and writes the Chrome ``trace_event`` dump;
``--journal FILE`` streams typed operational events as JSONL.

Everything runs on ``--device`` (the card unless ``--device cpu``).
``--strict`` turns on the hot-path guard (``repro_torch.analysis.strict``)
in every mode: ``ServiceConfig(strict=True)`` for the service, and
``ExecutionConfig(strict=True)`` for the ``--online`` classifier's fit.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core.compiled import resolve_device
from repro_torch.models import build_model
from repro_torch.models.common import cdtype
from repro_torch.runtime import (
    Request,
    RouterConfig,
    ServiceConfig,
    TenantConfig,
    format_latency_line,
    serve_fleet,
    serve_model,
)


def trace_config(args):
    """A TraceConfig when any tracing flag asks for one, else None (every
    span site stays a dead check)."""
    if args.trace_json is None and args.journal is None:
        return None
    from repro_torch.runtime import TraceConfig

    return TraceConfig(journal_path=args.journal)


def maybe_metrics_server(args, collect, tracer):
    """Start the stdlib OpenMetrics endpoint when ``--metrics-port`` was
    given (0 = ephemeral port)."""
    if args.metrics_port is None:
        return None
    from repro_torch.runtime import MetricsServer

    server = MetricsServer(collect, tracer=tracer, port=args.metrics_port)
    print(f"[metrics] serving OpenMetrics at {server.url}/metrics")
    return server


def finish_observability(args, collect, tracer, server, expect_tids=()):
    """End-of-run observability: self-scrape + validate the /metrics
    endpoint (or render directly), honor the dump/json flags, write the
    Chrome trace — asserting every submitted request's trace id made it
    into the dump — and shut the server down."""
    from repro_torch.runtime import parse_openmetrics, render_openmetrics

    if server is not None:
        from urllib.request import urlopen

        with urlopen(f"{server.url}/metrics", timeout=10) as resp:
            text = resp.read().decode("utf-8")
        source = f"scraped {server.url}/metrics"
    else:
        text = render_openmetrics(collect())
        source = "rendered exposition"
    families = parse_openmetrics(text)
    samples = sum(len(f["samples"]) for f in families.values())
    print(
        f"[metrics] {source}: {len(families)} families, {samples} samples "
        "(valid OpenMetrics)"
    )
    if args.metrics_dump is not None:
        with open(args.metrics_dump, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"[metrics] wrote exposition to {args.metrics_dump}")
    if args.metrics_json:
        print(json.dumps(collect(), indent=2, sort_keys=True, default=str))
    if tracer is not None and args.trace_json is not None:
        trace = tracer.chrome_trace()
        got = {
            e["args"]["trace_id"]
            for e in trace["traceEvents"]
            if e.get("ph") == "X" and "trace_id" in e.get("args", {})
        }
        missing = sorted(t for t in expect_tids if t not in got)
        if missing:
            raise SystemExit(
                f"[trace] submitted trace ids missing from dump: {missing}"
            )
        with open(args.trace_json, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        print(
            f"[trace] wrote {len(trace['traceEvents'])} events covering "
            f"{len(got)} trace ids to {args.trace_json}"
        )
    if tracer is not None:
        tracer.close()
    if server is not None:
        server.close()


def parse_tenants(spec):
    """``"free:1,paid:4"`` -> {name: TenantConfig(weight=...)}."""
    out = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, weight = part.partition(":")
        out[name] = TenantConfig(weight=float(weight) if weight else 1.0)
    if not out:
        raise ValueError(f"no tenants in spec {spec!r}")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=list(ARCH_NAMES), default="gemma3-1b")
    ap.add_argument("--device", default="cuda",
                    help="where the model (or the network) lives: 'cuda' (default) or 'cpu'")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--buckets", type=int, nargs="*", default=None,
                    help="prompt-length padding buckets (bounds the prefill shapes)")
    ap.add_argument("--policy", choices=("fcfs", "sjf"), default="fcfs",
                    help="queue admission order")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="serve through the AsyncEngine (futures, continuous batching)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded inbox/queue depth (backpressure)")
    ap.add_argument("--fleet", type=int, default=1,
                    help="serve through the Router with N decode engines over the one "
                         "shared model (implies the futures API)")
    ap.add_argument("--tenants", default="default:1",
                    help="tenant spec name:weight,... — requests round-robin across "
                         "tenants; weights set the DRR fair share")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request SLO budget; expired requests shed with "
                         "DeadlineExceeded before dispatch (fleet mode)")
    ap.add_argument("--routing", choices=("p95", "round_robin"), default="p95",
                    help="fleet engine selection: telemetry-driven p95 queue-wait "
                         "(default) or naive round-robin")
    ap.add_argument("--online", action="store_true",
                    help="serve a small BCPNN classifier through the continual tier "
                         "(online Hebbian updates from Feedback under live traffic, "
                         "drift detection + rollback)")
    ap.add_argument("--feedback", type=int, default=96,
                    help="number of labeled feedback samples to stream (online mode)")
    ap.add_argument("--merge-every", type=int, default=2,
                    help="adapter->base merges every N applied micro-batches (online mode)")
    ap.add_argument("--drift-window", type=int, default=16,
                    help="prequential accuracy window driving drift detection (online mode)")
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--smoke", dest="smoke", action="store_true",
                      help="reduced config (default)")
    size.add_argument("--full", dest="smoke", action="store_false",
                      help="the published architecture config, on one card")
    ap.add_argument("--strict", action="store_true",
                    help="strict verification: the dispatch guard on every plan dispatch "
                         "plus a recompile sentinel over the plan's callables")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics (OpenMetrics), /metrics.json and /trace.json on "
                         "this port while requests run (0 = ephemeral port); the "
                         "launcher self-scrapes and validates the exposition on exit")
    ap.add_argument("--metrics-dump", default=None,
                    help="write the final OpenMetrics exposition to this file")
    ap.add_argument("--metrics-json", action="store_true",
                    help="print the final telemetry snapshot as JSON")
    ap.add_argument("--trace-json", default=None,
                    help="enable per-request tracing and write the Chrome trace_event "
                         "dump here (open in Perfetto / chrome://tracing)")
    ap.add_argument("--journal", default=None,
                    help="JSONL sink for typed operational events (implies tracing)")
    ap.set_defaults(smoke=True)
    return ap


def load_model(cfg, device: torch.device):
    """The model for ``cfg`` on ``device`` with random weights from
    ``torch.Generator`` seed 0; refuses a model whose parameters do not fit
    the card, before allocating them."""
    if device.type == "cuda":
        need = cfg.param_count() * cdtype(cfg).itemsize
        have = torch.cuda.get_device_properties(device).total_memory
        if need > have:
            raise SystemExit(
                f"{cfg.name}: its parameters take {need} bytes in {cfg.dtype}, more than "
                f"the card's {have} bytes ({torch.cuda.get_device_name(device)})"
            )
    model = build_model(cfg, device)
    return model.init(torch.Generator(device=device).manual_seed(0))


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.online:
        serve_online(args, device)
        return
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = load_model(cfg, device)
    if args.fleet > 1:
        serve_via_router(model, cfg, args)
        return
    serve_one(model, cfg, args)


def _requests(cfg, args):
    rng = np.random.default_rng(0)
    return [
        Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                max_new_tokens=args.max_new)
        for i in range(args.requests)
    ]


def serve_one(model, cfg, args):
    """The sync and ``--async`` paths: one decode service."""
    service = serve_model(
        model,
        ServiceConfig(
            max_batch=args.max_batch,
            max_seq=args.max_seq,
            buckets=tuple(args.buckets) if args.buckets else None,
            policy=args.policy,
            max_queue=args.max_queue,
            async_mode=args.async_mode,
            strict=args.strict,
            trace=trace_config(args),
        ),
    )
    server = maybe_metrics_server(args, lambda: service.stats["telemetry"], service.tracer)
    reqs = _requests(cfg, args)
    expect_tids = []
    t0 = time.perf_counter()
    if args.async_mode:
        futures = [service.submit(r) for r in reqs]
        done = [f.result() for f in futures]
        expect_tids = [t for t in (getattr(f, "trace_id", None) for f in futures) if t is not None]
        service.drain_and_stop()
    else:
        for r in reqs:
            service.submit(r)
        done = service.drain()
    dt = time.perf_counter() - t0
    tot = sum(len(c.tokens) for c in done)
    st = service.stats
    mode = "async" if args.async_mode else "sync"
    print(
        f"[serve/{mode}] {args.arch}: {len(done)} reqs, {tot} tokens, "
        f"{tot/dt:.1f} tok/s ({st['fused_steps']} fused steps, "
        f"mean occupancy {st['mean_occupancy']:.2f})"
    )
    print("[telemetry] " + format_latency_line(
        st["telemetry"], "queue_wait_s", "prefill_s", "decode_step_s", "e2e_s"))
    finish_observability(args, lambda: service.stats["telemetry"], service.tracer, server,
                         expect_tids=expect_tids)


def serve_online(args, device):
    """The ``--online`` path: a small BCPNN classifier served through the
    continual tier — prequential feedback, micro-batch Hebbian updates,
    adapter merges every ``--merge-every`` micro-batches, and a
    ``--drift-window`` accuracy window with snapshot/rollback.  A label
    flip injected mid-stream exercises drift detection end to end."""
    from repro_torch.core import (
        DenseLayer,
        ExecutionConfig,
        Network,
        StructuralPlasticityLayer,
        UnitLayout,
        onehot_layout,
    )
    from repro_torch.data import complementary_code, mnist_like
    from repro_torch.runtime import ContinualConfig, Feedback

    n_classes = 4
    ds = mnist_like(
        n_train=256, n_test=64, n_features=32, seed=0, n_classes=n_classes,
        prototypes_per_class=2, noise=0.05, informative_fraction=1.0,
    )
    x, layout = complementary_code(ds.x_train)
    xs = np.asarray(x, np.float32)
    hidden = UnitLayout(4, 8)
    net = Network(seed=0).add(
        StructuralPlasticityLayer(layout, hidden, fan_in=16, lam=0.05, gain=4.0)
    ).add(DenseLayer(hidden, onehot_layout(n_classes), lam=0.05))
    compiled = net.compile(ExecutionConfig(device=str(device), strict=args.strict))
    compiled.fit((xs, ds.y_train), epochs_hidden=4, epochs_readout=4, batch_size=64)
    service = compiled.serve(
        ServiceConfig(
            async_mode=True,
            strict=args.strict,
            trace=trace_config(args),
            continual=ContinualConfig(
                update_batch=4,
                merge_every=args.merge_every,
                drift_window=args.drift_window,
                drift_min_samples=max(4, args.drift_window // 2),
                drift_threshold=0.4,
                merge_strategy="replace",
            ),
        )
    )
    server = maybe_metrics_server(args, lambda: service.stats["telemetry"], service.tracer)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, xs.shape[0], args.feedback)
    # Clean traffic, then a burst of flipped labels (the injected shift),
    # then clean again: the window should detect, roll back, and recover.
    lo = args.feedback // 2
    hi = lo + max(8, args.feedback // 6)
    futures = []
    t0 = time.perf_counter()
    for k, i in enumerate(idx):
        y = int(ds.y_train[i])
        if lo <= k < hi:
            y = (y + 1) % n_classes
        futures.append(service.submit(Feedback(xs[i], y)))
        if k % 3 == 0:
            futures.append(service.submit(xs[i]))  # interleaved inference
    acks = [f.result() for f in futures]
    expect_tids = [t for t in (getattr(f, "trace_id", None) for f in futures) if t is not None]
    service.drain_and_stop()
    dt = time.perf_counter() - t0
    learned = [a for a in acks if isinstance(a, dict)]
    snap = service.stats["telemetry"]
    drift = snap["drift"]
    baseline = drift["baseline_accuracy"]
    print(
        f"[serve/online] {len(learned)} feedback + "
        f"{len(acks) - len(learned)} inference in {dt:.2f}s; window acc "
        f"{drift['accuracy']:.3f}"
        + (f" (baseline {baseline:.3f})" if baseline is not None else "")
    )
    print("[telemetry] " + format_latency_line(snap, "queue_wait_s", "update_s", "e2e_s"))
    finish_observability(args, lambda: service.stats["telemetry"], service.tracer, server,
                         expect_tids=expect_tids)


def serve_via_router(model, cfg, args):
    """The ``--fleet N`` path: N decode engines behind one Router."""
    from repro_torch.runtime import DeadlineExceeded

    tenants = parse_tenants(args.tenants)
    router = serve_fleet(
        model,
        ServiceConfig(
            max_batch=args.max_batch,
            max_seq=args.max_seq,
            buckets=tuple(args.buckets) if args.buckets else None,
            max_queue=args.max_queue,
            strict=args.strict,
            trace=trace_config(args),
            router=RouterConfig(tenants=tenants, routing=args.routing),
        ),
        fleet=args.fleet,
    )
    server = maybe_metrics_server(args, router.metrics.snapshot, router.tracer)
    names = list(tenants)
    t0 = time.perf_counter()
    futures = [
        router.submit(r, tenant=names[i % len(names)], deadline_s=args.deadline_s)
        for i, r in enumerate(_requests(cfg, args))
    ]
    expect_tids = [t for t in (getattr(f, "trace_id", None) for f in futures) if t is not None]
    done, shed = [], 0
    for f in futures:
        try:
            done.append(f.result())
        except DeadlineExceeded:
            shed += 1
    router.drain_and_stop()
    dt = time.perf_counter() - t0
    tot = sum(len(c.tokens) for c in done)
    snap = router.metrics.snapshot()
    print(
        f"[serve/fleet] {args.arch}: {args.fleet} engines ({args.routing}), "
        f"{len(done)} reqs done, {shed} shed, {tot} tokens, {tot/dt:.1f} "
        f"tok/s, {snap['restarts']} restarts"
    )
    for name in names:
        tm = snap["tenants"].get(name)
        if tm is None:
            continue
        print(
            f"[tenant {name}] submitted={tm['submitted']} "
            f"completed={tm['completed']} shed_deadline={tm['shed_deadline']} "
            f"shed_queue_full={tm['shed_queue_full']} | "
            + format_latency_line(tm, "sched_wait_s", "e2e_s")
        )
    for name, eng in snap["engines"].items():
        print(f"[engine {name}] " + format_latency_line(eng, "queue_wait_s", "e2e_s"))
    print("[fleet] " + format_latency_line(snap["fleet"], "queue_wait_s", "e2e_s"))
    finish_observability(args, router.metrics.snapshot, router.tracer, server,
                         expect_tids=expect_tids)


if __name__ == "__main__":
    main()
