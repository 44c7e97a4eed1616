"""OpenMetrics export: exposition-format rendering, a stdlib validator,
and an ``http.server`` scrape endpoint.

The in-process snapshot dicts (``ServiceMetrics.snapshot()`` /
``RouterMetrics.snapshot()``) are great for tests and CLI summaries but
invisible to a scrape-based monitoring stack.  This module renders them
as OpenMetrics text (the Prometheus exposition format, versioned flavor:
https://prometheus.io/docs/specs/om/open_metrics_spec/):

* counters  -> ``repro_submitted_total 42``
* gauges    -> ``repro_queue_depth 3``
* histogram snapshots -> OpenMetrics *summary* families:
  ``repro_e2e_seconds{quantile="0.95"} 0.012`` + ``_count``/``_sum``
* router snapshots fan out with ``tenant=``/``engine=`` labels, plus the
  fabric-wide ``repro_fleet_*`` roll-up series.

Deliberately **pure stdlib** (no numpy, no torch): the renderer and
:func:`parse_openmetrics` run anywhere.  A copy of the JAX package's
``repro/runtime/export.py``; its ``checkmetrics`` command line is
:func:`main` here (``python -m repro_torch.runtime.export FILE
[--require FAMILY] [--trace TRACE.json --expect-trace-id ID]``), which
validates a scraped or dumped payload.

:class:`MetricsServer` wraps ``ThreadingHTTPServer`` around a snapshot
callable:

* ``GET /metrics``       -> OpenMetrics text (scrape target)
* ``GET /metrics.json``  -> the raw snapshot dict as JSON
* ``GET /trace.json``    -> Chrome trace_event JSON (when a tracer is
  attached; load in Perfetto)

Collection cost is paid by the scraper's request thread, never by the
serving hot path (no host transfers can even appear here; there is no
numpy or torch).
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = [
    "render_openmetrics", "parse_openmetrics", "OpenMetricsError",
    "MetricsServer", "main",
]

_QUANTILES = (("p50", "0.5"), ("p95", "0.95"), ("p99", "0.99"))

# ServiceMetrics.ONLINE_COUNTERS, spelled out so this module stays pure
# stdlib (importing metrics would pull numpy in).
_ONLINE_COUNTERS = (
    "online_updates", "updates_shed", "merges", "rollbacks", "drift_events",
)

# Histogram snapshot names end in `_s`; exported seconds-unit families
# spell it out per Prometheus naming conventions.
_SECONDS_SUFFIX = re.compile(r"_s$")

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

_TYPES = {"counter", "gauge", "summary", "histogram", "info", "unknown"}
# Legal sample-name suffixes per family type.
_TYPE_SUFFIXES = {
    "counter": ("_total", "_created"),
    "gauge": ("",),
    "summary": ("", "_count", "_sum", "_created"),
    "histogram": ("_bucket", "_count", "_sum", "_created"),
    "info": ("_info",),
    "unknown": ("",),
}


# --------------------------------------------------------------------------
# Rendering.
# --------------------------------------------------------------------------
def _fmt(v: Any) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items())
    )
    return "{" + body + "}"


class _Families:
    """Accumulates samples grouped by family so each family renders one
    ``# TYPE`` line followed by all its samples (OpenMetrics requires
    family grouping)."""

    def __init__(self):
        self._order: List[str] = []
        self._fams: Dict[str, Tuple[str, List[str]]] = {}

    def add(self, family: str, ftype: str, suffix: str,
            labels: Dict[str, str], value: Any) -> None:
        if family not in self._fams:
            self._fams[family] = (ftype, [])
            self._order.append(family)
        self._fams[family][1].append(
            f"{family}{suffix}{_labels(labels)} {_fmt(value)}"
        )

    def counter(self, family, value, **labels):
        self.add(family, "counter", "_total", labels, value)

    def gauge(self, family, value, **labels):
        self.add(family, "gauge", "", labels, value)

    def summary(self, snap: Dict[str, Any], family: str, **labels):
        """A metrics.Histogram snapshot dict as an OpenMetrics summary."""
        for key, q in _QUANTILES:
            self.add(family, "summary", "",
                     dict(labels, quantile=q), snap.get(key, 0.0))
        count = snap.get("count", 0)
        self.add(family, "summary", "_count", labels, count)
        # snapshot() reports mean, not sum; reconstruct (exact: mean=sum/n).
        self.add(family, "summary", "_sum", labels,
                 snap.get("mean", 0.0) * count)

    def render(self) -> str:
        out: List[str] = []
        for family in self._order:
            ftype, samples = self._fams[family]
            out.append(f"# TYPE {family} {ftype}")
            out.extend(samples)
        out.append("# EOF")
        return "\n".join(out) + "\n"


def _hist_family(ns: str, prefix: str, name: str) -> str:
    return f"{ns}_{prefix}{_SECONDS_SUFFIX.sub('_seconds', name)}"


def _render_service(fams: _Families, snap: Dict[str, Any], ns: str,
                    **labels) -> None:
    """One ServiceMetrics snapshot (optionally engine-labelled)."""
    for key in ("submitted", "completed", "rejected"):
        if key in snap:
            fams.counter(f"{ns}_{key}", snap[key], **labels)
    if "queue_depth" in snap:
        fams.gauge(f"{ns}_queue_depth", snap["queue_depth"], **labels)
    for key in _ONLINE_COUNTERS:
        if key in snap:
            fams.counter(f"{ns}_{key}", snap[key], **labels)
    for name, h in snap.items():
        if isinstance(h, dict) and "p95" in h and "count" in h:
            fams.summary(h, _hist_family(ns, "", name), **labels)
    drift = snap.get("drift")
    if isinstance(drift, dict):
        for key in ("accuracy", "baseline_accuracy", "confidence",
                    "samples"):
            if drift.get(key) is not None:
                fams.gauge(f"{ns}_drift_{key}", drift[key], **labels)
        fams.gauge(f"{ns}_drifted", 1.0 if drift.get("drifted") else 0.0,
                   **labels)


def render_openmetrics(snapshot: Dict[str, Any], namespace: str = "repro") -> str:
    """Render a ``ServiceMetrics.snapshot()`` or ``RouterMetrics.snapshot()``
    dict as OpenMetrics exposition text (terminated by ``# EOF``)."""
    fams = _Families()
    is_router = "tenants" in snapshot or "engines" in snapshot
    if not is_router:
        _render_service(fams, snapshot, namespace)
        return fams.render()

    if "dispatched" in snapshot:
        fams.counter(f"{namespace}_router_dispatched", snapshot["dispatched"])
    if "restarts" in snapshot:
        fams.counter(f"{namespace}_router_restarts", snapshot["restarts"])
    for tenant, tsnap in sorted(snapshot.get("tenants", {}).items()):
        for key, value in tsnap.items():
            if isinstance(value, dict) and "p95" in value:
                fams.summary(value, _hist_family(namespace, "tenant_", key),
                             tenant=tenant)
            elif key == "queue_depth":
                fams.gauge(f"{namespace}_tenant_queue_depth", value,
                           tenant=tenant)
            elif isinstance(value, (int, float)):
                fams.counter(f"{namespace}_tenant_{key}", value,
                             tenant=tenant)
    for engine, esnap in sorted(snapshot.get("engines", {}).items()):
        _render_service(fams, esnap, namespace, engine=engine)
    for name, h in sorted(snapshot.get("fleet", {}).items()):
        if isinstance(h, dict) and "p95" in h:
            fams.summary(h, _hist_family(namespace, "fleet_", name))
    return fams.render()


# --------------------------------------------------------------------------
# Validation (the `checkmetrics` parser).
# --------------------------------------------------------------------------
class OpenMetricsError(ValueError):
    """The payload is not valid OpenMetrics text."""


def _parse_labels(body: str, lineno: int) -> Dict[str, str]:
    labels: Dict[str, str] = {}
    rest = body
    while rest:
        m = _LABEL_RE.match(rest)
        if m is None:
            raise OpenMetricsError(
                f"line {lineno}: malformed label set near {rest!r}"
            )
        labels[m.group(1)] = m.group(2)
        rest = rest[m.end():]
        if rest.startswith(","):
            rest = rest[1:]
        elif rest:
            raise OpenMetricsError(
                f"line {lineno}: junk after label pair: {rest!r}"
            )
    return labels


def parse_openmetrics(text: str) -> Dict[str, Dict[str, Any]]:
    """Validate OpenMetrics exposition text; returns
    ``{family: {"type": ..., "samples": [(name, labels, value), ...]}}``.
    Raises :exc:`OpenMetricsError` on any syntax violation: missing
    ``# EOF`` terminator, samples without a declared family, duplicate
    ``# TYPE`` lines, bad metric names, unparseable values."""
    families: Dict[str, Dict[str, Any]] = {}
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    if not lines or lines[-1].strip() != "# EOF":
        raise OpenMetricsError("payload must end with '# EOF'")
    for lineno, line in enumerate(lines, 1):
        if not line.strip():
            raise OpenMetricsError(f"line {lineno}: blank line not allowed")
        if line.strip() == "# EOF":
            if lineno != len(lines):
                raise OpenMetricsError(
                    f"line {lineno}: content after '# EOF'"
                )
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 2 and parts[1] in ("TYPE", "HELP", "UNIT"):
                if parts[1] == "TYPE":
                    if len(parts) != 4:
                        raise OpenMetricsError(
                            f"line {lineno}: '# TYPE <name> <type>' expected"
                        )
                    _, _, fam, ftype = parts
                    if not _NAME_RE.match(fam):
                        raise OpenMetricsError(
                            f"line {lineno}: bad family name {fam!r}"
                        )
                    if ftype not in _TYPES:
                        raise OpenMetricsError(
                            f"line {lineno}: unknown type {ftype!r}"
                        )
                    if fam in families:
                        raise OpenMetricsError(
                            f"line {lineno}: duplicate TYPE for {fam!r}"
                        )
                    families[fam] = {"type": ftype, "samples": []}
                continue
            raise OpenMetricsError(f"line {lineno}: unrecognized comment")
        # Sample line: name[{labels}] value [timestamp]
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)"
                     r"(\s+\S+)?$", line)
        if m is None:
            raise OpenMetricsError(f"line {lineno}: malformed sample {line!r}")
        name, _, labelbody, value, _ = m.groups()
        labels = _parse_labels(labelbody, lineno) if labelbody else {}
        try:
            fvalue = float(value)
        except ValueError:
            raise OpenMetricsError(
                f"line {lineno}: unparseable value {value!r}"
            ) from None
        fam = _family_of(name, families)
        if fam is None:
            raise OpenMetricsError(
                f"line {lineno}: sample {name!r} has no '# TYPE' family"
            )
        families[fam]["samples"].append((name, labels, fvalue))
    return families


def _family_of(sample: str, families: Dict[str, Dict[str, Any]]) -> Optional[str]:
    """Longest declared family whose type-legal suffixes produce ``sample``."""
    best = None
    for fam, info in families.items():
        for suffix in _TYPE_SUFFIXES[info["type"]]:
            if sample == fam + suffix:
                if best is None or len(fam) > len(best):
                    best = fam
    return best


# --------------------------------------------------------------------------
# The scrape endpoint.
# --------------------------------------------------------------------------
_OM_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


class MetricsServer:
    """Tiny stdlib scrape endpoint.  ``collect`` is a zero-arg callable
    returning the snapshot dict (called per scrape, on the scraper's
    thread).  ``port=0`` binds an ephemeral port (see ``.port``)."""

    def __init__(self, collect: Callable[[], Dict[str, Any]],
                 tracer: Optional[Any] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 namespace: str = "repro"):
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):            # noqa: N802 (http.server API)
                try:
                    if self.path.split("?")[0] == "/metrics":
                        body = render_openmetrics(
                            outer.collect(), namespace=outer.namespace
                        ).encode("utf-8")
                        ctype = _OM_CONTENT_TYPE
                    elif self.path.split("?")[0] == "/metrics.json":
                        body = json.dumps(
                            outer.collect(), default=str
                        ).encode("utf-8")
                        ctype = "application/json"
                    elif (self.path.split("?")[0] == "/trace.json"
                          and outer.tracer is not None):
                        body = json.dumps(
                            outer.tracer.chrome_trace(), default=str
                        ).encode("utf-8")
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:   # collection failed: surface as 500
                    self.send_error(500, explain=str(e))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                pass                     # scrapes should not spam stdout

        self.collect = collect
        self.tracer = tracer
        self.namespace = namespace
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="metrics-server",
            daemon=True,
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        """Base URL (no path): append /metrics, /metrics.json, /trace.json."""
        host = self._server.server_address[0]
        return f"http://{host}:{self.port}"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)


# --------------------------------------------------------------------------
# CLI (checkmetrics).
# --------------------------------------------------------------------------
def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="checkmetrics",
        description="validate OpenMetrics exposition text (stdlib parser)",
    )
    ap.add_argument("path", help="file to validate ('-' for stdin)")
    ap.add_argument(
        "--require", action="append", default=[],
        help="family that must be present with >= 1 sample (repeatable)",
    )
    ap.add_argument(
        "--trace", default=None,
        help="Chrome trace JSON file to cross-check (optional)",
    )
    ap.add_argument(
        "--expect-trace-id", type=int, action="append", default=[],
        help="trace_id that must appear in --trace span args (repeatable)",
    )
    args = ap.parse_args(argv)

    if args.path == "-":
        text = sys.stdin.read()
    else:
        with open(args.path, encoding="utf-8") as f:
            text = f.read()
    try:
        families = parse_openmetrics(text)
    except OpenMetricsError as e:
        print(f"checkmetrics: INVALID: {e}", file=sys.stderr)
        return 1
    n_samples = sum(len(f["samples"]) for f in families.values())
    missing = [
        r for r in args.require
        if r not in families or not families[r]["samples"]
    ]
    if missing:
        print(f"checkmetrics: missing required families: {missing}",
              file=sys.stderr)
        return 1
    print(f"checkmetrics: OK ({len(families)} families, "
          f"{n_samples} samples)")

    if args.trace is not None:
        with open(args.trace, encoding="utf-8") as f:
            trace = json.load(f)
        events = trace.get("traceEvents", [])
        seen = {
            e.get("args", {}).get("trace_id")
            for e in events if e.get("ph") == "X"
        }
        missing_ids = [t for t in args.expect_trace_id if t not in seen]
        if missing_ids:
            print(f"checkmetrics: trace ids {missing_ids} absent from "
                  f"{args.trace}", file=sys.stderr)
            return 1
        print(f"checkmetrics: trace OK ({len(events)} events, "
              f"{len(seen - {None})} trace ids)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
