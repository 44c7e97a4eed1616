#!/usr/bin/env python3
"""Where the Hopper ``bcpnn_phase`` kernel spends its time, phase by phase,
at the main path's shape (B = 128, F = 1568, 30x100 hypercolumns, a unit
mask of half the input hypercolumns), with f32 and with bf16 state.

    python3 tools/bcpnn_phase_profile.py

Needs a CUDA device and ``nvcc``.  It runs the kernel's profiling variant
(``bcpnn_phase.profile``: the same kernel instantiated with a barrier and a
``%globaltimer`` read at each phase boundary, behind its own C entry point)
and prints, per state format, each phase's median and maximum ns over the
CTAs (averaged over the repetitions), the span from the first CTA's start
to the last CTA's end, and the device time of the main path's variant as
``chip_smoke.py`` measures it.  The last line before the card's is one JSON
object with the same numbers.
"""
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import bcpnn_phase as pk  # noqa: E402

B, N_FEATURES, N_HCU, N_MCU, FAN_IN = 128, 784, 30, 100, 392
REPS = 10


def inputs(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    F, H = 2 * N_FEATURES, N_HCU * N_MCU
    x = torch.rand(B, F, generator=g, device=dev)
    cols = torch.stack([
        torch.randperm(N_FEATURES, generator=g, device=dev) < FAN_IN for _ in range(N_HCU)
    ]).T.float()
    mask = cols.repeat_interleave(2, 0).repeat_interleave(N_MCU, 1).contiguous()
    w = torch.randn(F, H, generator=g, device=dev) * mask
    b = 0.1 * torch.randn(H, generator=g, device=dev)
    ci = 0.25 + 0.5 * torch.rand(F, generator=g, device=dev)
    cj = 0.005 + 0.01 * torch.rand(H, generator=g, device=dev)
    cij = (ci[:, None] * cj[None, :]) * torch.exp(torch.randn(F, H, generator=g, device=dev))
    return x, w, b, mask, (ci, cj, cij)


def phase_profile(dev, reps: int = REPS):
    """{state format: {phase: {"median_ns", "max_ns"}, "span_ns", "ctas",
    "kernel_ms"}} at the main path's shape."""
    x, w, b, mask, state = inputs(dev)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)  # 64 MB, as chip_smoke
    formats = {
        "f32": (state, {}),
        "bf16": (tuple(t.bfloat16() for t in state),
                 dict(state_mantissa=7, state_dtype=torch.bfloat16)),
    }
    out = {}
    for name, (st, kw) in formats.items():
        args = (x, w, b, *st, 0.02, N_HCU, N_MCU)
        kw = dict(kw, k_b=1.0, gain=4.0, mask=mask)
        rows = []
        for r in range(reps + 1):
            flush.sum()
            _, prof = pk.profile(*args, **kw)
            torch.cuda.synchronize()
            if r:  # the first call builds and warms up
                rows.append(prof.cpu())
        rec = {}
        for p, phase in enumerate(pk.PHASES):
            col = [rw[:, 2 + p].double() for rw in rows]
            rec[phase] = dict(
                median_ns=statistics.mean(float(c.median()) for c in col),
                max_ns=statistics.mean(float(c.max()) for c in col),
            )
        rec["span_ns"] = statistics.mean(float(rw[:, 1].max() - rw[:, 0].min()) for rw in rows)
        rec["ctas"] = int(rows[0].shape[0])
        rec["kernel_ms"] = chip_smoke.device_ms(
            torch, lambda: pk.bcpnn_phase(*args, **kw), flush)
        out[name] = rec
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bcpnn_phase_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"card: {chip_smoke.nvidia_smi()}")
    prof = phase_profile(dev)
    for name, rec in prof.items():
        print(f"bcpnn_phase {name} state, B={B} F={2 * N_FEATURES} {N_HCU}x{N_MCU}: "
              f"{rec['ctas']} CTAs, span {rec['span_ns'] / 1e3:.2f} us (profiling variant), "
              f"kernel_ms={rec['kernel_ms']:.5f} (main path's variant)")
        for phase in pk.PHASES:
            print(f"  {phase:15s} median {rec[phase]['median_ns'] / 1e3:8.2f} us  "
                  f"max {rec[phase]['max_ns'] / 1e3:8.2f} us")
    print(json.dumps({"bcpnn_phase_profile": prof}))
    print(chip_smoke.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
