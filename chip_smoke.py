#!/usr/bin/env python3
"""On-card smoke run of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA device of compute capability 9.0 or above and ``nvcc``; it
imports nothing of JAX or of the JAX package.  Phases, each of which fails
the run with a non-zero exit:

1. print the card's name and power limit, build the Hopper kernels from the
   sources in this checkout (one ``nvcc`` per source, in parallel);
2. switch TF32 off, so the plain versions run in full f32;
3. hold each kernel against its plain version at the shapes the main path
   gives it, and time the kernel, the plain version and, where one exists,
   a single PyTorch library call computing the same function;
4. drive the main path, the paper's Listing 1 at MNIST width (784
   complementary-coded features -> 30x100 hidden -> 10 classes), through
   ``Network`` -> ``compile`` -> ``fit`` -> ``evaluate`` on the card with
   every launch counter reset just before, then the same fit on the CPU
   through the plain versions; the card's accuracy must be >= 0.5 and
   within 0.03 of the CPU's;
5. print one ``{"kernels": [...]}`` line, then, last, the ``{"ok": true,
   ...}`` line.

Without a CUDA device, or away from the rest of the repository, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet, at its 700 W limit):
# HBM3 bandwidth and f32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

B, N_FEATURES, HIDDEN, N_CLASSES = 128, 784, (30, 100), 10
FAN_IN = 392  # half the input HCUs: rewiring runs every 30 batches
REPS = 20


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, flush) -> float:
    """Device time of one call of ``fn``, without the host's launch overhead.

    REPS calls, each after an L2 flush (a read of 64 MB: the main path meets
    every kernel with a mostly cold 50 MB L2, since the update between two
    forwards moves ~78 MB), are captured in one CUDA graph; the graph is
    replayed between CUDA events, and the time of the same graph of flushes
    alone is subtracted.  The host overhead of an eager call shows in the
    main path's ``host_s`` instead.
    """
    def graph(with_fn: bool):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm up outside the capture
            for _ in range(2):
                flush.sum()
                fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(REPS):
                flush.sum()
                if with_fn:
                    fn()
        return g

    def replay_ms(g) -> float:
        g.replay()  # first replay uploads the graph
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(5):
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    both, flushes = graph(True), graph(False)
    return max(replay_ms(both) - replay_ms(flushes), 0.0) / REPS


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = n_flops / PEAK_F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(torch, got, want, rtol: float, atol_rel: float):
    """Max abs error, and max rel error over elements at least 1e-3 of the
    output's scale; fails unless every element has
    |got - want| <= rtol * |want| + atol_rel * max|want| (per output)."""
    max_abs = max_rel = 0.0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), "kernel output is not finite")
        diff = (g - w).abs()
        scale = float(w.abs().max())
        max_abs = max(max_abs, float(diff.max()))
        big = w.abs() >= 1e-3 * scale  # relative error where it means something
        if bool(big.any()):
            max_rel = max(max_rel, float((diff[big] / w.abs()[big]).max()))
        limit = rtol * w.abs() + atol_rel * scale
        check(bool((diff <= limit).all()), f"error {float(diff.max())} beyond tolerance")
    return max_abs, max_rel


def kernel_checks(torch, ops, ref, dev):
    """Phase 3: each kernel against its plain version at the main path's
    shapes; returns one record per kernel, timed at the hidden-layer shape."""
    g = torch.Generator(device=dev).manual_seed(0)
    F, H = 2 * N_FEATURES, HIDDEN[0] * HIDDEN[1]
    n_hcu, n_mcu = HIDDEN

    def uniform(*shape):
        return torch.rand(*shape, generator=g, device=dev)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def codes(rows, hcu, mcu):  # activations that sum to one per HCU
        return torch.softmax(4 * normal(rows, hcu, mcu), -1).reshape(rows, hcu * mcu)

    def unit_mask(pre_hcu, pre_mcu, post_hcu, post_mcu, fan_in):
        cols = torch.stack([
            torch.randperm(pre_hcu, generator=g, device=dev) < fan_in for _ in range(post_hcu)
        ]).T.float()
        return cols.repeat_interleave(pre_mcu, 0).repeat_interleave(post_mcu, 1).contiguous()

    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)  # 64 MB
    x = uniform(B, F)
    h = codes(B, n_hcu, n_mcu)
    mask = unit_mask(N_FEATURES, 2, n_hcu, n_mcu, FAN_IN)
    w_h, b_h = normal(F, H), 0.1 * normal(H)
    w_r, b_r = normal(H, N_CLASSES), 0.1 * normal(N_CLASSES)
    s_h, s_r = 4 * normal(B, H), 4 * normal(B, N_CLASSES)
    ci_h, cj_h = 0.25 + 0.5 * uniform(F), 0.005 + 0.01 * uniform(H)
    cij_h = (ci_h[:, None] * cj_h[None, :]) * torch.exp(normal(F, H))
    onehot = torch.nn.functional.one_hot(
        torch.randint(0, N_CLASSES, (B,), generator=g, device=dev), N_CLASSES
    ).float()
    ci_r, cj_r = 0.005 + 0.01 * uniform(H), 0.1 + 0.01 * uniform(N_CLASSES)
    cij_r = (ci_r[:, None] * cj_r[None, :]) * torch.exp(normal(H, N_CLASSES))
    lam, k_b = 0.02, 1.0

    def update(fn, ai, aj, ci, cj, cij, m):
        return lambda: fn(ai, aj, ci, cj, cij, lam, k_b=k_b, mask=m)

    from repro_torch.kernels import bcpnn_update as bk
    specs = [
        dict(
            name="masked_matmul",
            source="src/repro_torch/kernels/csrc/masked_matmul.cu",
            replaces="src/repro/kernels/masked_matmul.py:47 (masked_matmul; pallas_call :80)",
            tol=(1e-4, 1e-5),
            cases=[
                (f"x({B},{F}) @ w({F},{H})*mask + b",
                 lambda: ops.masked_matmul(x, w_h, b_h, mask=mask),
                 lambda: ref.masked_matmul(x, w_h, b_h, mask=mask),
                 lambda: torch.matmul(x, w_h * mask) + b_h,
                 4 * (B * F + 2 * F * H + H + B * H), 2 * B * F * H + F * H),
                (f"h({B},{H}) @ w({H},{N_CLASSES}) + b",
                 lambda: ops.masked_matmul(h, w_r, b_r),
                 lambda: ref.masked_matmul(h, w_r, b_r),
                 lambda: torch.matmul(h, w_r) + b_r,
                 4 * (B * H + H * N_CLASSES + N_CLASSES + B * N_CLASSES),
                 2 * B * H * N_CLASSES),
            ],
        ),
        dict(
            name="hcu_softmax",
            source="src/repro_torch/kernels/csrc/hcu_softmax.cu",
            replaces="src/repro/kernels/hcu_softmax.py:34 (hcu_softmax; pallas_call :62)",
            tol=(1e-5, 1e-6),
            cases=[
                (f"s({B},{n_hcu}x{n_mcu})",
                 lambda: ops.hcu_softmax(s_h, n_hcu, n_mcu),
                 lambda: ref.hcu_softmax(s_h, n_hcu, n_mcu),
                 lambda: torch.softmax(s_h.view(B, n_hcu, n_mcu), -1),
                 8 * B * H, 5 * B * H),
                (f"s({B},1x{N_CLASSES})",
                 lambda: ops.hcu_softmax(s_r, 1, N_CLASSES),
                 lambda: ref.hcu_softmax(s_r, 1, N_CLASSES),
                 lambda: torch.softmax(s_r.view(B, 1, N_CLASSES), -1),
                 8 * B * N_CLASSES, 5 * B * N_CLASSES),
            ],
        ),
        dict(
            name="bcpnn_update",
            source="src/repro_torch/kernels/csrc/bcpnn_update.cu",
            replaces="src/repro/kernels/bcpnn_update.py:138 (bcpnn_update_fused; pallas_call :192)",
            tol=(1e-4, 1e-5),
            cases=[
                (f"ai({B},{F}) aj({B},{H}) cij({F},{H}) masked",
                 update(bk.bcpnn_update, x, h, ci_h, cj_h, cij_h, mask),
                 update(ref.bcpnn_update, x, h, ci_h, cj_h, cij_h, mask),
                 None,
                 4 * (B * F + B * H + 2 * F + 3 * H + 4 * F * H),
                 2 * B * F * H + 7 * F * H),
                (f"ai({B},{H}) aj({B},{N_CLASSES}) cij({H},{N_CLASSES})",
                 update(bk.bcpnn_update, h, onehot, ci_r, cj_r, cij_r, None),
                 update(ref.bcpnn_update, h, onehot, ci_r, cj_r, cij_r, None),
                 None,
                 4 * (B * H + B * N_CLASSES + 2 * H + 3 * N_CLASSES + 3 * H * N_CLASSES),
                 2 * B * H * N_CLASSES + 6 * H * N_CLASSES),
            ],
        ),
    ]
    records = []
    for spec in specs:
        rtol, atol_rel = spec["tol"]
        worst_abs = 0.0
        timed = None
        for label, kernel, plain, library, n_bytes, n_flops in spec["cases"]:
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            max_abs, max_rel = compare(torch, got, want, rtol, atol_rel)
            worst_abs = max(worst_abs, max_abs)
            ms = device_ms(torch, kernel, flush)
            plain_ms = device_ms(torch, plain, flush)
            library_ms = device_ms(torch, library, flush) if library is not None else None
            bms, bound_by = bound_ms(n_bytes, n_flops)
            print(
                f"check {spec['name']} {label}: max_abs_err={max_abs:.3e} "
                f"max_rel_err={max_rel:.3e} (tol rtol={rtol} + {atol_rel}*max|ref|) "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
                f"{'null' if library_ms is None else f'{library_ms:.4f}'} "
                f"bound_ms={bms:.4f} ({bound_by})"
            )
            if timed is None:  # the first case is the hidden layer's shape
                timed = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bound_by,
                             library_ms=library_ms, at=label)
        records.append(dict(
            name=spec["name"], route="cuda", source=spec["source"],
            replaces=spec["replaces"], max_abs_err=worst_abs, **timed,
        ))
    return records


def main_path(torch, ops, core, data, devices=("cuda", "cpu")):
    """Phase 4: Listing 1 at MNIST width on the card, then on the CPU."""
    ds = data.mnist_like(n_train=8192, n_test=2048, n_features=N_FEATURES, seed=0)
    x, in_layout = data.complementary_code(ds.x_train)
    xt, _ = data.complementary_code(ds.x_test)
    hidden = core.UnitLayout(*HIDDEN)
    net = core.Network(seed=0)
    net.add(core.StructuralPlasticityLayer(
        in_layout, hidden, fan_in=FAN_IN, lam=0.02, gain=4.0, init_jitter=1.0
    ))
    net.add(core.DenseLayer(hidden, core.onehot_layout(N_CLASSES), lam=0.02))
    fit_kw = dict(epochs_hidden=2, epochs_readout=2, batch_size=B)

    runs = {}
    for i, device in enumerate(devices):
        compiled = net.compile(core.ExecutionConfig(engine="scan", device=device))
        if i == 0:
            ops.reset_launches()
        t0 = time.perf_counter()
        result = compiled.fit((x, ds.y_train), **fit_kw)
        scores = compiled.predict(xt)
        acc = compiled.evaluate((xt, ds.y_test))
        if i == 0:
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        wall = time.perf_counter() - t0
        check(tuple(scores.shape) == (len(xt), N_CLASSES), f"scores shape {tuple(scores.shape)}")
        check(bool(torch.isfinite(scores).all()), f"non-finite scores on {device}")
        runs[device if i == 0 else "cpu"] = dict(acc=acc, fit_s=result.wall_time_s, fit_evaluate_s=wall,
                            history=result.history)
        print(f"main path [{device}]: accuracy={acc:.4f} fit_wall_s={result.wall_time_s:.4f} "
              f"fit+evaluate_s={wall:.4f}")
        for h in result.history:
            print(f"  {device} {h['phase']}" + (f" epoch {h['epoch']}" if "epoch" in h else "")
                  + f": host_s={h['host_s']:.4f} device_wait_s={h['device_wait_s']:.4f}")
    print(f"main path launches: {json.dumps(launches)} ({len(x) // B} batches per epoch)")
    gpu_acc, cpu_acc = runs[devices[0]]["acc"], runs["cpu"]["acc"]
    check(gpu_acc >= 0.5, f"accuracy on the card {gpu_acc} < 0.5")
    check(abs(gpu_acc - cpu_acc) <= 0.03, f"card {gpu_acc} vs CPU {cpu_acc}: off by more than 0.03")
    for name, count in launches.items():
        check(count > 0, f"{name} was not launched on the main path")
    return launches, runs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import core, data
    from repro_torch.kernels import _build, ops, ref

    # Phase 1: the card, then the kernels' build.
    card = nvidia_smi()
    print(f"card: {card}")
    cap = torch.cuda.get_device_capability()
    check(cap >= (9, 0), f"compute capability {cap} < (9, 0)")
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({len(logs)} sources compiled)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # Phase 2: full-f32 plain versions.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # Phase 3: each kernel against its plain version.
    records = kernel_checks(torch, ops, ref, torch.device("cuda", torch.cuda.current_device()))

    # Phase 4: the main path, launches counted from zero.
    launches, runs = main_path(torch, ops, core, data)

    # Phase 5: the records.
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "at")
    kernels = [{k: rec[k] for k in keys} for rec in records]
    check(all(math.isfinite(k["ms"]) for k in kernels), "non-finite kernel time")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "main_path": {d: {k: v for k, v in r.items() if k != "history"} for d, r in runs.items()},
    }))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
