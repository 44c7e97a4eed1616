#!/usr/bin/env python3
"""Time every launch plan of the Hopper ``masked_matmul`` kernel at the
main path's shapes, beside the plan that ``masked_matmul.plan`` picks and
the one PyTorch call computing the same function.

    python3 tools/masked_matmul_plans.py

Needs a CUDA device and ``nvcc``; times are device ms per call, measured
as ``chip_smoke.py`` measures them (CUDA-graph replays, L2 flushed before
each call).  Prints one line per (shape, tile configuration, CL) and the
card's name and power limit: first the dense tiles on a unit mask, then,
for a mask per hypercolumn pair at the MNIST and STL-10 widths, the dense
tiles on its expanded mask and the gathered variant at every CL.  The
gathered rows also go to ``chiprun_out/masked_matmul_plans.json``, the
rows ``plan``'s cost model is set from.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import masked_matmul as mk  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

SHAPES = [(128, 1568, 3000, True), (1024, 1568, 3000, True), (1024, 3000, 10, False)]
# (rows, n_pre_hcu, pre_mcu, n_post_hcu, post_mcu, fan_in): Listing 1's
# hidden layer at the MNIST and the STL-10 width
HCU_SHAPES = [
    (128, 784, 2, 30, 100, 392), (1024, 784, 2, 30, 100, 392),
    (128, 27648, 2, 20, 150, 1024), (1024, 27648, 2, 20, 150, 1024),
]


def dense_plans(m, k, n):
    """Every dense plan of an (m, k) @ (k, n) product."""
    for name, cfg in mk.CONFIGS.items():
        if (name == "narrow") != (n <= mk.NARROW_MAX_N):
            continue
        for cl in range(1, mk.MAX_CLUSTER + 1):
            kslice = mk.kslice_for(k, cl, cfg.bk)
            if cl > 1 and (cl - 1) * kslice >= k:
                continue
            yield mk.Plan(name, cl, kslice, mk._cdiv(m, cfg.bm), mk._cdiv(n, cfg.bn))


def gathered_plans(m, kept, n_post, post_mcu):
    """Every gathered plan: each CL that leaves no slice of the kept list empty."""
    cfg = mk.GATHERED
    for cl in range(1, mk.MAX_CLUSTER + 1):
        kslice = mk.kslice_for(kept, cl, cfg.bk)
        if cl > 1 and (cl - 1) * kslice >= kept:
            continue
        yield mk.Plan("gathered", cl, kslice, mk._cdiv(m, cfg.bm),
                      mk.gathered_tiles_n(n_post, post_mcu))


def main() -> int:
    if not torch.cuda.is_available():
        print("masked_matmul_plans: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = chip_smoke.nvidia_smi()
    print(f"card: {card}")
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
        for p in dense_plans(m, k, n):
            run = lambda p=p: mk.launch_planned(x, w, b, mask, out, p)  # noqa: E731
            run()
            err = float((out - want).abs().max())
            ms = chip_smoke.device_ms(torch, run, flush)
            mark = " <- plan" if p == chosen else ""
            print(f"  {p.config:6s} CL={p.cl} ctas={p.ctas:5d} kslice={p.kslice:5d} "
                  f"ms={ms:.5f} max_abs_err={err:.2e}{mark}")
    rows = []
    for m, n_pre, pre_mcu, n_post, post_mcu, fan_in in HCU_SHAPES:
        k, n, kept = n_pre * pre_mcu, n_post * post_mcu, fan_in * pre_mcu
        x = torch.rand(m, k, generator=g, device=dev)
        w = 0.1 * torch.randn(k, n, generator=g, device=dev)
        b = 0.1 * torch.randn(n, generator=g, device=dev)
        hm = torch.stack([torch.randperm(n_pre, generator=g, device=dev) < fan_in
                          for _ in range(n_post)]).T.float().contiguous()
        mask = ref.unit_mask(hm, pre_mcu, post_mcu).contiguous()
        out = torch.empty(m, n, device=dev)
        want = torch.matmul(x, w * mask) + b
        lib = chip_smoke.device_ms(torch, lambda: torch.matmul(x, w * mask) + b, flush)
        chosen = mk.plan(m, k, n, n_sm, kept, post_mcu)
        print(f"hcu shape rows={m} K={k} N={n} kept={kept} n_mcu={post_mcu}: "
              f"library_ms={lib:.5f} plan picks {chosen.config} CL={chosen.cl}")
        runs = [(p, lambda p=p: mk.launch_planned(x, w, b, mask, out, p))
                for p in dense_plans(m, k, n)]
        runs += [(p, lambda p=p: mk.launch_gathered(x, w, b, hm, pre_mcu, post_mcu, out, p))
                 for p in gathered_plans(m, kept, n_post, post_mcu)]
        for p, run in runs:
            run()
            err = float((out - want).abs().max())
            ms = chip_smoke.device_ms(torch, run, flush)
            mark = " <- plan" if p == chosen else ""
            print(f"  {p.config:8s} CL={p.cl} ctas={p.ctas:5d} kslice={p.kslice:5d} "
                  f"ms={ms:.5f} max_abs_err={err:.2e}{mark}")
            rows.append(dict(rows=m, k=k, n=n, kept=kept, n_mcu=post_mcu, config=p.config,
                             cl=p.cl, ctas=p.ctas, kslice=p.kslice, ms=ms, max_abs_err=err,
                             library_ms=lib, chosen=p == chosen))
        del x, w, mask, want
        torch.cuda.empty_cache()
    path = ROOT / "chiprun_out" / "masked_matmul_plans.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(card=card, rows=rows), indent=1))
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
