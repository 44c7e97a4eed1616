"""Run one cell of the port's benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, its traffic, the
limits of its check and its metrics are found by name from
``BENCHMARK.json`` (see ``bench/harness/runner.py``).  The last line of
standard output is the result, one JSON object; the compared numbers, each
beside its limit, are the last lines of standard error.  Without CUDA, or
with fewer devices than the cell asks for, it exits 2 and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = [w for w in spec["workloads"] if w["name"] == args.workload]
    if len(chips) != 1:
        print(f"no cell named {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips[0]["chips"]:
        print(f"cell {args.workload} needs {chips[0]['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench.harness import runner

    device = torch.device("cuda", 0)
    result, lines = runner.run(ROOT, spec, args.workload, args.seed, args.seconds,
                               bool(args.trace), device, T_START, window_threads=1)
    found = runner.forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark must not load: {found}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
