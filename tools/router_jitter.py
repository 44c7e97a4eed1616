#!/usr/bin/env python3
"""How often thread timing changes a Router's dispatch order.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/router_jitter.py port|reference [RUNS]

Runs the scripted schedule of ``tests/test_torch_router.py``
(``SCHEDULE``: three tenants at weights 4:1:1, priorities, deadlines, one
engine with an inbox of one) once as it is, then RUNS times (default 60)
with random sleeps of up to 10 ms injected into a third of the engine's
``submit``, ``_claim`` and ``_complete`` calls (a seeded
``random.Random(0)``), and prints, for each drive, how many runs served
the items, shed them or counted them differently from the first.  Both
routers run the test's drives: ``stepped``, the test thread dispatching
one pick at a time and the engine serving each item between two picks
(``drive_stepped``), and ``threaded``, the router's own scheduler thread
with the engine running free.  ``port`` drives
``repro_torch.runtime.Router``; ``reference`` the JAX package's, whose
pick reads each engine's inbox depth live at every tenant of the scan, so
its threaded drive can differ.  On the CPU; each run takes about 0.1 s.
"""
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import test_torch_router as T  # noqa: E402


def main(argv) -> int:
    which = argv[0] if argv else "port"
    runs = int(argv[1]) if len(argv) > 1 else 60
    if which == "port":
        from repro_torch.runtime import Router, RouterConfig, ServiceConfig, TenantConfig
        from repro_torch.runtime import engine

        def factory(served):
            return T.sleepy_factory(delay_s=0.001, served=served)
    elif which == "reference":
        from repro.runtime import Router, RouterConfig, ServiceConfig, TenantConfig
        from repro.runtime import engine

        def factory(served):
            return lambda config, metrics: T._RecordingJaxPlan(config, metrics, served)
    else:
        raise SystemExit(f"want 'port' or 'reference', got {which!r}")
    rng = random.Random(0)

    def jittered(fn):
        def call(*args, **kw):
            if rng.random() < 0.3:
                time.sleep(rng.random() * 0.01)
            return fn(*args, **kw)

        return call

    def run(stepped):
        return T._run_schedule(Router, RouterConfig, TenantConfig, ServiceConfig, factory,
                               stepped=stepped)

    drives = {"stepped": True, "threaded": False}
    first = {name: run(stepped) for name, stepped in drives.items()}
    for name in ("submit", "_claim", "_complete"):
        setattr(engine.AsyncEngine, name, jittered(getattr(engine.AsyncEngine, name)))
    differ = {name: sum(run(stepped) != first[name] for _ in range(runs))
              for name, stepped in drives.items()}
    print(json.dumps({"router": which, "runs": runs, "differ": differ,
                      "stepped_equals_threaded_unjittered": first["stepped"] == first["threaded"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
