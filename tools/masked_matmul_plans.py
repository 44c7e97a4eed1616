#!/usr/bin/env python3
"""Time every launch plan of the Hopper ``masked_matmul`` kernel at the
main path's shapes, beside the plan that ``masked_matmul.plan`` picks and
the one PyTorch call computing the same function.

    python3 tools/masked_matmul_plans.py

Needs a CUDA device and ``nvcc``; times are device ms per call, measured
as ``chip_smoke.py`` measures them (CUDA-graph replays, L2 flushed before
each call).  Prints one line per (shape, tile configuration, CL) and the
card's name and power limit.
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import masked_matmul as mk  # noqa: E402

SHAPES = [(128, 1568, 3000, True), (1024, 1568, 3000, True), (1024, 3000, 10, False)]


def main() -> int:
    if not torch.cuda.is_available():
        print("masked_matmul_plans: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"card: {chip_smoke.nvidia_smi()}")
    n_sm = mk.n_sm(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    for m, k, n, masked in SHAPES:
        x = torch.rand(m, k, generator=g, device=dev)
        w = torch.randn(k, n, generator=g, device=dev)
        b = torch.randn(n, generator=g, device=dev)
        mask = (torch.rand(k, n, generator=g, device=dev) > 0.5).float() if masked else None
        out = torch.empty(m, n, device=dev)
        want = torch.matmul(x, w * mask if masked else w) + b
        lib = chip_smoke.device_ms(
            torch, (lambda: torch.matmul(x, w * mask) + b) if masked
            else (lambda: torch.matmul(x, w) + b), flush)
        chosen = mk.plan(m, k, n, n_sm)
        print(f"shape ({m},{k},{n}) mask={masked}: library_ms={lib:.5f} plan picks "
              f"{chosen.config} CL={chosen.cl}")
        for name, cfg in mk.CONFIGS.items():
            if (name == "narrow") != (n <= mk.NARROW_MAX_N):
                continue
            for cl in range(1, mk.MAX_CLUSTER + 1):
                kslice = mk.kslice_for(k, cl, cfg.bk)
                if cl > 1 and (cl - 1) * kslice >= k:
                    continue
                p = mk.Plan(name, cl, kslice, mk._cdiv(m, cfg.bm), mk._cdiv(n, cfg.bn))
                run = lambda p=p: mk.launch_planned(x, w, b, mask, out, p)  # noqa: E731
                run()
                err = float((out - want).abs().max())
                ms = chip_smoke.device_ms(torch, run, flush)
                mark = " <- plan" if p == chosen else ""
                print(f"  {name:6s} CL={cl} ctas={p.ctas:5d} kslice={kslice:5d} "
                      f"ms={ms:.5f} max_abs_err={err:.2e}{mark}")
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
