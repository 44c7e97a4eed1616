"""The readings that the limits of a cell's check are set from.

    python3 bench/readings.py --workload <cell> --seeds 1 2 3 [--units 8] [--faults half answer]

For each seed it runs the cell's set-up on the card (the program trains or
fits exactly as in a benchmark run), ``--units`` units of the window (a
training cell's iterations; a scoring cell serves one request of each batch
of its pool) and what a run does once its window has closed, then prints one JSON line of the compared numbers of the program (``sound``) and
of the control (the kind's ``control()``: for the BCPNN kinds the plain
reference in TF32 put in the program's place), on the same inputs; then, for
each fault named (one of the kind's ``faults``: ``half``, ``unchanged``,
``answer`` for the BCPNN kinds), a line of the numbers of a run with that
fault planted in the program.  The benchmark's own runs never run
this.
"""
import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--units", type=int, default=0, help="training iterations of the window")
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--no-sound", action="store_true", help="only the faults' runs")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from bench.harness import runner

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    c = runner.Cell(ROOT, spec, args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        for variant in ([] if args.no_sound else ["sound"]) + args.faults:
            t0 = time.perf_counter()
            gen = c.build(seed, device)
            with gen.faults[variant]() if variant != "sound" else contextlib.nullcontext():
                gen.setup()
                for _ in range(gen.check_units(args.units)):
                    gen.unit()
                gen.after_window()
            gen.release()
            gc.collect()
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            line = dict(workload=args.workload, seed=seed, variant=variant,
                        numbers=gen.numbers())
            if variant == "sound":
                line["control"] = gen.numbers(gen.control())
            line["seconds"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
            del gen
            gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
