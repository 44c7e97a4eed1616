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
   gives it (``bcpnn_phase`` also against the three-kernel composition it
   replaces, ``bf_round`` bit for bit, special values included, also at
   each shape where the reduced datapath rounds a stage), and time the
   kernel, the plain version and, where one exists, a single PyTorch
   library call computing the same function (the forward pair at each of
   its main-path shapes: a training batch or projection chunk of B rows,
   predict's chunk of P rows through the hidden layer and the head, and
   every row count phase 5 gives a kernel (``serving_rows``: the batched
   plan's padded chunks, single rows, the streaming flushes of 16 rows and
   the 10-row tail), and the 8-row feedback micro-batch of phase 6
   (``continual_rows``); ``bcpnn_update`` at the hidden and the readout
   shape, each labelled with its launch plan, at the streaming flushes and
   at the 8-row continual update of each layer; ``bcpnn_phase`` also at the
   flushes and the continual update with bf16 state, and with f32 traces
   in (an adapter forked after a merge); ``bf_round`` also at the served
   chunks through both layers); then print where
   ``bcpnn_phase``'s time goes, phase by phase
   (``tools/bcpnn_phase_profile.py``);
4. drive the main paths, the paper's Listing 1 at MNIST width (784
   complementary-coded features -> 30x100 hidden -> 10 classes), through
   ``Network`` -> ``compile`` -> ``fit`` -> ``evaluate``: the unfused f32
   path; the fused path with bf16 state (``ExecutionConfig(fused_phase=True,
   precision=PrecisionPolicy.named("fp32", state_format="bf16"))``); the
   reduced datapath at bf20 (``ExecutionConfig(precision="bf20")``, every
   algebraic stage rounded); and the hybrid SGD readout
   (``fit(readout="sgd")``, f32, unfused).  Each runs on the card with
   every launch counter reset just before its compile, then on the CPU
   through the plain versions, timing ``fit``, ``predict`` and
   ``evaluate`` apart; on each path the card's accuracy must be >= 0.5 and
   within 0.03 of the CPU's, and the launch counts must be exactly those of
   the path (one ``masked_matmul`` and one ``hcu_softmax`` per forward
   pass; on the fused path one ``bcpnn_phase`` per hidden batch, one
   ``bcpnn_update`` per readout batch, ``bf_round`` at compile; on the
   datapath one ``bf_round`` per rounded stage and no update kernel; on
   the SGD path no BCPNN kernel in the readout epochs).  Then the card
   alone fits the datapath at fp32, bf16 and bf14 and prints the accuracy
   cliff, and again at bf14 ... fp32 at the e2e test's configuration
   (``tools/precision_cliff.py``; both printed, not gated); one datapath
   training batch of each layer is held on the card against the CPU from
   the same state, stage by stage, each stage within one format ulp of the
   CPU's and at most 1% of its elements that far; and the staging of one
   hidden epoch's input is timed alone, the host time every path shares;
5. serve the networks phase 4 trained on the card, at full width: the
   batched plan (``compiled.serve(ServiceConfig(plan="batched",
   buckets=(4, 16, 64)))``) on all four, each request size of ``SERVE_NS``
   held against ``compiled.predict`` (the GEMM tolerance of phase 3, argmax
   equal on every row not near a tie), a repeated 32-row batch leaving the
   store's projections unchanged; the async batched service on the unfused
   network, four client threads submitting the 2,048 test rows, every
   future resolved, the served accuracy equal to ``evaluate``'s; the
   streaming plan on the unfused and the fused bf16-state networks, 378
   training rows in flushes of 16 (the last 10 on close) across a rewiring
   step, then 64 single-row inferences through the async engine, the state
   adopted and held against a CPU twin fed the same rows (masks equal but
   for one hidden HCU on the bf16-state network, the unfused traces within
   1e-3 relative and w and b within 3e-3, accuracy >= 0.5 and within
   0.03).  Every serving
   run counts its launches from zero and checks them exactly once its
   engine has stopped;
6. the serving fabric, from phase 4's trained states: the continual tier
   through the async engine (``ServiceConfig(continual=ContinualConfig(
   update_batch=8, ...))``, two tenants, 384 feedback rows with labels
   flipped on rows 192-255, a test row inferred after every third) in three
   runs: the unfused network adapting its hidden layer (merge strategy
   "trace") and its readout through the frozen prefix ("replace"), the
   fused bf16-state network adapting its hidden layer ("trace").  Each run
   must resolve every future, merge, detect drift and roll back; its ack
   sequence must equal a CPU twin's fed the same stream through the sync
   drain (``correct`` apart only on near-ties), its adopted base must
   meet phase 5's rules against the twin's (on the fused network, whose
   updates round the traces to bf16, traces within 2^-6 relative and w and
   b within 3 x 2^-6), each rollback must restore the last-good base bit
   for bit (against a host copy taken when that base was adopted), the
   newest snapshot must reload through
   ``load_adapters`` bit for bit, each inference must agree with
   ``compiled.predict`` on the state it ran on, and its launches must be
   exactly those its acks imply.  Then the router fleet: two batched and
   two continual engines, each over its own network loaded from the unfused
   network's checkpoint, tenants free (weight 1) and paid (weight 4), p95
   routing, four clients submitting the 2,048 test rows (a quarter of the
   free rows with a 5 ms deadline), 256 feedback rows to the continual
   pool, the first batched engine to reach its 100th row crashing once:
   every future resolves to a value or a typed error, one hot restart,
   each tenant's feedback on one continual engine, the served scores
   against ``compiled.predict``, the forward pair checked after the run at
   every micro-batch size the engines formed.  Rates, latencies, the DRR
   share and the sheds are printed, not gated;
7. print one ``{"kernels": [...]}`` line, then, last, the ``{"ok": true,
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
P = 1024  # predict's and evaluate's chunk (CompiledNetwork.predict batch_size)
FAN_IN = 392  # half the input HCUs: rewiring runs every 30 batches
DATAPATH_MANTISSA = 11  # bf20, the gated datapath of phase 4
# bf_round launches of the reduced datapath's stages (precision/policy.py):
# quantized_forward rounds a_i, w, b, the support and a_j, plus s * gain
# when the gain is not 1; quantized_learning_cycle rounds a_i, a_j, m_i,
# m_j, m_ij, c_i, c_j, c_ij, w and the bias.
Q_FORWARD, Q_GAIN, Q_CYCLE = 5, 1, 10
REPS = 20
# The serving phase (phase 5): request sizes of the batched plan, through
# padding buckets of 4/16/64 rows; the async clients; the streaming plan's
# micro-batch and feed.  Phase 3 checks each kernel at every row count these
# give it (``serving_rows``); the async engine's micro-batches, whose sizes
# depend on timing, are checked after its run.  The feed starts at the
# trained step 128: 23 full flushes reach step 150, a rewiring step (every
# 30 batches), and 10 rows are left for the flush on close.
SERVE_NS = (1, 2, 3, 4, 5, 15, 16, 17, 33, 64, 100, 128)
SERVE_BUCKETS = (4, 16, 64)
ASYNC_CLIENTS = 4
STREAM_BATCH, STREAM_ROWS, STREAM_INFERS = 16, 23 * 16 + 10, 64
GEMM_TOL = (1e-4, 1e-5)  # phase 3's tolerance of the forward pair
SOFTMAX_TOL = (1e-5, 1e-6)  # ... and of hcu_softmax
# The serving fabric (phase 6).  The continual tier: 384 labeled feedback
# rows from two alternating tenants (48 micro-batches of 8), labels flipped
# (y + 1 mod 10) on rows 192-255, one test row inferred after every third
# feedback row; three runs (path, adapted layer, merge strategy).  The
# adapted hidden layer starts at the trained step 128, so its updates cross
# the rewiring step 150.  The fleet: two batched and two continual engines
# behind one Router, four clients, a quarter of the free tenant's rows with
# a 5 ms deadline, one batched engine crashing once at its 100th row.
CONT_BATCH, CONT_ROWS, CONT_BURST, CONT_INFER_EVERY = 8, 384, (192, 256), 3
CONT_KW = dict(update_batch=CONT_BATCH, update_budget=32, merge_every=4, drift_window=64,
               drift_min_samples=16, drift_threshold=0.25)
CONT_RUNS = (("unfused_f32", 0, "trace"), ("unfused_f32", -1, "replace"),
             ("fused_bf16", 0, "trace"))
FLEET_CLIENTS, FLEET_FEEDBACK, FLEET_DEADLINE_S, FLEET_CRASH_AT = 4, 256, 0.005, 100
# The unfused streamed state against its CPU twin.  Each flush's a_j may be
# 1e-3 apart, relative, on the two devices (phase 3's rule for a_j after
# the gain, ``bcpnn_phase`` against the three kernels); an EWMA of
# non-negative terms each that close stays that close, so the traces are
# held to 1e-3 relative (above the logs' floor EPS), and w and b, sums of
# up to three logs of them, to 3e-3.  Read on an H100 at 700 W: w 1.6e-5
# apart after 16 flushes, 1.0e-4 after 24 across a rewiring step.
STREAM_EPS = 1e-8  # core/learning.py EPS
STREAM_TRACE_RTOL, STREAM_W_TOL = 1e-3, 3e-3
# The rewiring is a discrete argmax over mutual-information scores.  With
# f32 state the card's masks must equal the twin's; with bf16 state a
# trace one bf16 ulp apart can flip the choice between two near-tied input
# HCUs, so one hidden HCU of the fused network may rewire otherwise (read
# on an H100 at 700 W: 2 entries of one hidden HCU's column).
STREAM_MASK_COLUMNS = dict(unfused_f32=0, fused_bf16=1)
# The fused bf16-state continual run against its CPU twin.  Every
# bcpnn_phase update rounds the adapter's traces to bf16's 8 significant
# bits (the merge then averages them into f32 base traces), so a value the
# card and the CPU round to neighbours lands one bf16 ulp apart, at most
# 2^-7 relative.  The traces are held to two such ulps, 2^-6, and w and b,
# sums of up to three logs of them, to 3 x 2^-6, as STREAM_W_TOL is derived.
# Read on an H100 at 700 W, equal in three runs: traces 9.990e-3 relative,
# w 7.135e-3, b 2.906e-3.
CONT_FUSED_TRACE_RTOL = 2.0 ** -6
CONT_FUSED_W_TOL = 3 * CONT_FUSED_TRACE_RTOL


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


def compare(torch, got, want, tol):
    """Max abs error, and max rel error over elements at least 1e-3 of the
    output's scale; fails unless every element has
    |got - want| <= rtol * |want| + atol_rel * max|want| + atol (per
    output).  ``tol`` is one (rtol, atol_rel[, atol]) for every output or a
    list of them, one per output.  Outputs are compared in f32 (bf16
    traces are widened, exactly)."""
    tols = tol if isinstance(tol, list) else [tol] * len(got)
    max_abs = max_rel = 0.0
    for g, w, t in zip(got, want, tols):
        rtol, atol_rel, atol = (*t, 0.0)[:3]
        check(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        g, w = g.float(), w.float()
        check(bool(torch.isfinite(g).all()), "kernel output is not finite")
        diff = (g - w).abs()
        scale = float(w.abs().max())
        max_abs = max(max_abs, float(diff.max()))
        big = w.abs() >= 1e-3 * scale  # relative error where it means something
        if bool(big.any()):
            max_rel = max(max_rel, float((diff[big] / w.abs()[big]).max()))
        limit = rtol * w.abs() + atol_rel * scale + atol
        check(bool((diff <= limit).all()), f"error {float(diff.max())} beyond tolerance")
    return max_abs, max_rel


def bit_exact(torch, got, want):
    """Fails unless every output equals its reference bit for bit (f32
    compared as int32, so NaNs and signed zeros count)."""
    for g, w in zip(got, want):
        check(g.shape == w.shape and g.dtype == w.dtype == torch.float32, "bf_round output type")
        check(torch.equal(g.view(torch.int32), w.view(torch.int32)), "bf_round is not bit-exact")
    return 0.0, 0.0


def kernel_checks(torch, ops, ref, dev):
    """Phase 3: each kernel against its plain version at the main path's
    shapes; returns one record per kernel, its top-level times those of the
    hidden-layer shape and every case's times under ``cases``."""
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
    # predict's chunk: the hidden projection and the readout head at P rows
    x_p, h_p = uniform(P, F), codes(P, n_hcu, n_mcu)
    s_p, s_r = 4 * normal(P, H), 4 * normal(P, N_CLASSES)
    mask = unit_mask(N_FEATURES, 2, n_hcu, n_mcu, FAN_IN)
    w_h, b_h = normal(F, H), 0.1 * normal(H)
    w_r, b_r = normal(H, N_CLASSES), 0.1 * normal(N_CLASSES)
    s_h = 4 * normal(B, H)
    ci_h, cj_h = 0.25 + 0.5 * uniform(F), 0.005 + 0.01 * uniform(H)
    cij_h = (ci_h[:, None] * cj_h[None, :]) * torch.exp(normal(F, H))
    onehot = torch.nn.functional.one_hot(
        torch.randint(0, N_CLASSES, (B,), generator=g, device=dev), N_CLASSES
    ).float()
    ci_r, cj_r = 0.005 + 0.01 * uniform(H), 0.1 + 0.01 * uniform(N_CLASSES)
    cij_r = (ci_r[:, None] * cj_r[None, :]) * torch.exp(normal(H, N_CLASSES))
    lam, k_b, gain = 0.02, 1.0, 4.0
    bf = [t.bfloat16() for t in (ci_h, cj_h, cij_h)]      # the bf16 state tier
    bf_r = [t.bfloat16() for t in (ci_r, cj_r, cij_r)]
    w_hm = w_h * mask  # the cached weights carry the mask, as on the main path
    f32 = 4  # bytes
    specials = torch.tensor(
        [0.0, -0.0, 1e-40, -1e-40, math.inf, -math.inf, math.nan, 3.4028234663852886e38,
         -3.4028234663852886e38, 1.9999999, 0.99999994, 1.0 + 2**-8, 3.9999998, 1.5],
        device=dev,
    )
    a_r = codes(B, 1, N_CLASSES)  # the readout's a_j at a training batch
    # The serving path's rows (phase 5): bucket-padded chunks, single rows
    # and streaming flushes, each a view at an odd row offset of a larger
    # block.
    rows, cont = serving_rows(), continual_rows()
    hidden_rows = sorted(set(rows["hidden"]) | set(cont["hidden"]))
    most = max(hidden_rows)
    x_s = uniform(most + 1, F)[1:]
    h_s = codes(most, n_hcu, n_mcu)
    s_sh, s_sr = 4 * normal(most, H), 4 * normal(most, N_CLASSES)

    def mm_case(a, w, b, m):
        (rows, k), n = a.shape, w.shape[1]
        p = mk.plan(rows, k, n, mk.n_sm(dev))
        masked = "*mask" if m is not None else ""
        return (f"x({rows},{k}) @ w({k},{n}){masked} + b "
                f"[plan {p.config} CL={p.cl} {p.ctas} CTAs]",
                lambda: ops.masked_matmul(a, w, b, mask=m),
                lambda: ref.masked_matmul(a, w, b, mask=m),
                (lambda: torch.matmul(a, w * m) + b) if m is not None
                else (lambda: torch.matmul(a, w) + b),
                f32 * (rows * k + (2 if m is not None else 1) * k * n + n + rows * n),
                2 * rows * k * n + (k * n if m is not None else 0))

    def sm_case(s, hcu, mcu):
        rows = s.shape[0]
        return (f"s({rows},{hcu}x{mcu})",
                lambda: ops.hcu_softmax(s, hcu, mcu),
                lambda: ref.hcu_softmax(s, hcu, mcu),
                lambda: torch.softmax(s.view(rows, hcu, mcu), -1),
                2 * f32 * rows * hcu * mcu, 5 * rows * hcu * mcu)

    def update(fn, ai, aj, ci, cj, cij, m, **kw):
        return lambda: fn(ai, aj, ci, cj, cij, lam, k_b=k_b, mask=m, **kw)

    def up_plan(ai, aj):
        p = bk.plan(ai.shape[0], ai.shape[1], aj.shape[1], mk.n_sm(dev))
        return f" [plan {p.config} CL={p.cl} {p.ctas} CTAs]"

    def phase(fn, state, xb=x, **kw):
        return lambda: fn(xb, w_hm, b_h, *state, lam, n_hcu, n_mcu, k_b=k_b, gain=gain,
                          mask=mask, **kw)

    def composition():  # the unfused path: three kernels and the gain multiply
        s = ops.masked_matmul(x, w_hm, b_h, mask=mask) * gain
        aj = ops.hcu_softmax(s, n_hcu, n_mcu)
        ci, cj, cij, w, bias = bk.bcpnn_update(x, aj, ci_h, cj_h, cij_h, lam, k_b=k_b, mask=mask)
        return aj, ci, cj, cij, w, bias

    def round_cases(m):
        return lambda: (bfk.bf_round(cij_h, m), bfk.bf_round(specials, m)), \
            lambda: (ref.bf_round(cij_h, m), ref.bf_round(specials, m))

    def datapath_round(label, t):
        # The datapath's stage boundaries at bf20 (mantissa 11); integer
        # operations, so the bound counts bytes alone.
        return (f"{label} {tuple(t.shape)}, mantissa {DATAPATH_MANTISSA} (datapath)",
                lambda: bfk.bf_round(t, DATAPATH_MANTISSA),
                lambda: ref.bf_round(t, DATAPATH_MANTISSA),
                None, 8 * t.numel(), 0)

    # One bf16 ulp of a trace is at most 2^-7 of it; w and bias are logs of
    # traces, so one ulp moves them by at most ~2^-7 each.
    trace_tol = (2.0**-7, 0.0)
    log_tol = (0.0, 0.0, 2.0**-5)
    def phase_bytes(rows=B):
        return f32 * (rows * F + rows * H + 5 * F * H + 2 * F + 4 * H)

    def phase_bytes_bf16(rows=B):
        return f32 * (rows * F + rows * H + 3 * F * H + 2 * H) + 2 * (2 * F * H + 2 * F + 2 * H)

    def phase_flops(rows=B):
        return 4 * rows * F * H + 8 * F * H + 5 * rows * H

    def update_case(rows, tail=""):  # the hidden update of `rows` rows, f32
        return (f"ai({rows},{F}) aj({rows},{H}) cij({F},{H}) masked{tail}" + up_plan(x[:rows], h),
                update(bk.bcpnn_update, x[:rows], h[:rows], ci_h, cj_h, cij_h, mask),
                update(ref.bcpnn_update, x[:rows], h[:rows], ci_h, cj_h, cij_h, mask),
                None,
                4 * (rows * F + rows * H + 2 * F + 3 * H + 4 * F * H),
                2 * rows * F * H + 7 * F * H)

    def phase_bf16_case(rows, tail=""):
        return (f"x({rows},{F}) {n_hcu}x{n_mcu}, bf16 state, mantissa 7{tail}",
                phase(pk.bcpnn_phase, bf, xb=x[:rows], state_mantissa=7,
                      state_dtype=torch.bfloat16),
                phase(ref.bcpnn_phase, bf, xb=x[:rows], state_mantissa=7),
                None, phase_bytes_bf16(rows), phase_flops(rows),
                [(1e-4, 1e-5)] + [trace_tol] * 3 + [log_tol] * 2, "bf16")

    def phase_merged_case(rows):  # a bf16-state adapter forked after a merge: f32 traces in
        f32_state = (ci_h, cj_h, cij_h)
        return (f"x({rows},{F}) {n_hcu}x{n_mcu}, f32 traces in, bf16 out, mantissa 7, "
                "continual update after a merge",
                phase(pk.bcpnn_phase, f32_state, xb=x[:rows], state_mantissa=7,
                      state_dtype=torch.bfloat16),
                phase(ref.bcpnn_phase, f32_state, xb=x[:rows], state_mantissa=7),
                None, phase_bytes(rows) - 2 * (F * H + F + H), phase_flops(rows),
                [(1e-4, 1e-5)] + [trace_tol] * 3 + [log_tol] * 2, "bf16")

    def readout_case(rows, tail=""):  # the readout's update, f32, one-hot a_j
        a, oh = h[:rows], onehot[:rows]
        return (f"ai({rows},{H}) aj({rows},{N_CLASSES}) cij({H},{N_CLASSES}){tail}"
                + up_plan(a, oh),
                update(bk.bcpnn_update, a, oh, ci_r, cj_r, cij_r, None),
                update(ref.bcpnn_update, a, oh, ci_r, cj_r, cij_r, None),
                None,
                4 * (rows * H + rows * N_CLASSES + 2 * H + 3 * N_CLASSES + 3 * H * N_CLASSES),
                2 * rows * H * N_CLASSES + 6 * H * N_CLASSES)
    from repro_torch.kernels import bcpnn_phase as pk
    from repro_torch.kernels import bcpnn_update as bk
    from repro_torch.kernels import bf_round as bfk
    from repro_torch.kernels import masked_matmul as mk
    pp = pk.plan(B, F, n_hcu, n_mcu)
    round7, plain7 = round_cases(7)
    round11, plain11 = round_cases(11)
    specs = [
        dict(
            name="masked_matmul",
            source="src/repro_torch/kernels/csrc/masked_matmul.cu",
            replaces="src/repro/kernels/masked_matmul.py:47 (masked_matmul; pallas_call :80)",
            tol=(1e-4, 1e-5),
            cases=[mm_case(*c) for c in (
                (x, w_h, b_h, mask), (x_p, w_h, b_h, mask), (h_p, w_r, b_r, None),
                *((x_s[:m], w_h, b_h, mask) for m in hidden_rows),
                *((h_s[:m], w_r, b_r, None) for m in rows["head"]))],
        ),
        dict(
            name="hcu_softmax",
            source="src/repro_torch/kernels/csrc/hcu_softmax.cu",
            replaces="src/repro/kernels/hcu_softmax.py:34 (hcu_softmax; pallas_call :62)",
            tol=SOFTMAX_TOL,
            cases=[sm_case(*c) for c in (
                (s_h, n_hcu, n_mcu), (s_p, n_hcu, n_mcu), (s_r, 1, N_CLASSES),
                *((s_sh[:m], n_hcu, n_mcu) for m in hidden_rows),
                *((s_sr[:m], 1, N_CLASSES) for m in rows["head"]))],
        ),
        dict(
            name="bcpnn_update",
            source="src/repro_torch/kernels/csrc/bcpnn_update.cu",
            replaces="src/repro/kernels/bcpnn_update.py:138 (bcpnn_update_fused; pallas_call :192)",
            tol=(1e-4, 1e-5),
            cases=[
                update_case(B),
                readout_case(B),
                (f"ai({B},{F}) aj({B},{H}) cij({F},{H}) masked, bf16 state, mantissa 7"
                 + up_plan(x, h),
                 update(bk.bcpnn_update, x, h, *bf, mask, state_mantissa=7,
                        state_dtype=torch.bfloat16),
                 update(ref.bcpnn_update, x, h, *bf, mask, state_mantissa=7),
                 None,
                 f32 * (B * F + B * H + 2 * F * H + 2 * H) + 2 * (2 * F * H + 2 * F + 2 * H),
                 2 * B * F * H + 7 * F * H,
                 [trace_tol] * 3 + [log_tol] * 2, "bf16"),
                (f"ai({B},{H}) aj({B},{N_CLASSES}) cij({H},{N_CLASSES}), bf16 state, mantissa 7"
                 + up_plan(h, onehot),
                 update(bk.bcpnn_update, h, onehot, *bf_r, None, state_mantissa=7,
                        state_dtype=torch.bfloat16),
                 update(ref.bcpnn_update, h, onehot, *bf_r, None, state_mantissa=7),
                 None,
                 f32 * (B * H + B * N_CLASSES + H * N_CLASSES + N_CLASSES)
                 + 2 * (2 * H * N_CLASSES + 2 * H + 2 * N_CLASSES),
                 2 * B * H * N_CLASSES + 6 * H * N_CLASSES,
                 [trace_tol] * 3 + [log_tol] * 2, "bf16"),
                # streaming flushes of the unfused path (phase 5)
                *(update_case(m, ", streaming flush") for m in rows["update"]),
                # the continual tier's feedback micro-batch (phase 6)
                *(update_case(m, ", continual update") for m in cont["update"]),
                *(readout_case(m, ", continual update") for m in cont["readout_update"]),
            ],
        ),
        dict(
            name="bcpnn_phase",
            source="src/repro_torch/kernels/csrc/bcpnn_phase.cu",
            replaces="src/repro/kernels/bcpnn_phase.py:190 (bcpnn_phase_fused; pallas_call :265)",
            tol=(1e-4, 1e-5),
            cases=[
                (f"x({B},{F}) w,mask,cij({F},{H}) {n_hcu}x{n_mcu} gain {gain} [plan G={pp.g} "
                 f"CL={pp.cl} FS={pp.fslice} {pp.ctas} CTAs]",
                 phase(pk.bcpnn_phase, (ci_h, cj_h, cij_h)),
                 phase(ref.bcpnn_phase, (ci_h, cj_h, cij_h)),
                 None, phase_bytes(), phase_flops()),
                phase_bf16_case(B),
                # a_j = softmax(gain * s): the two paths sum s (|s| ~ 100,
                # 1568 terms) in other orders, ~1e-4 apart, and the gain
                # carries that into a_j as a relative error of ~4e-4.
                (f"x({B},{F}) {n_hcu}x{n_mcu} against the three-kernel composition",
                 phase(pk.bcpnn_phase, (ci_h, cj_h, cij_h)), composition,
                 None, phase_bytes(), phase_flops(), [(1e-3, 1e-5)] + [(1e-4, 1e-5)] * 5,
                 "three_kernels"),
                # streaming flushes of the fused path (phase 5)
                *(phase_bf16_case(m, ", streaming flush") for m in rows["flush"]),
                # the continual tier's feedback micro-batch (phase 6), before
                # and after a merge
                *(phase_bf16_case(m, ", continual update") for m in cont["flush"]),
                *(phase_merged_case(m) for m in cont["flush"]),
            ],
        ),
        dict(
            name="bf_round",
            source="src/repro_torch/kernels/csrc/bf_round.cu",
            replaces="src/repro/kernels/bf_round.py:42 (bf_round; pallas_call :63)",
            tol="bit-exact",
            cases=[
                # Integer operations, a handful per element: far below the
                # bytes' time, so the bound counts bytes alone.
                (f"cij({F},{H}) and {len(specials)} specials, mantissa 7",
                 round7, plain7, lambda: cij_h.to(torch.bfloat16),
                 8 * (F * H + len(specials)), 0),
                (f"cij({F},{H}) and {len(specials)} specials, mantissa 11",
                 round11, plain11, None, 8 * (F * H + len(specials)), 0),
                # Every other shape the datapath rounds at: a training
                # batch or projection chunk (B rows), the readout's update,
                # and predict's chunk (P rows) through both layers.
                *(datapath_round(*c) for c in (
                    ("a_i", x), ("s, a_j", s_h), ("m_i, c_i", ci_h), ("b, m_j, c_j, bias", cj_h),
                    ("readout w, m_ij, c_ij", w_r), ("readout b, m_j, c_j, bias", b_r),
                    ("readout a_j", a_r), ("predict a_i", x_p),
                    ("predict s, a_j; head a_i", s_p), ("predict head s, a_j", s_r),
                    ("served a_i", x_s[:1]))),
                # ... and at every chunk the batched plan serves the
                # datapath network at.
                *(datapath_round(*c) for m in rows["datapath"] for c in (
                    ("served a_i", x_s[:m]), ("served s, a_j; head a_i", s_sh[:m]),
                    ("served head s, a_j", s_sr[:m]))),
            ],
        ),
    ]
    records = []
    for spec in specs:
        worst_abs = 0.0
        timed, extra, cases = None, {}, []
        for label, kernel, plain, library, n_bytes, n_flops, *opt in spec["cases"]:
            # opt: [per-output tolerances (None: the spec's), timing key]
            tol = opt[0] if opt and opt[0] is not None else spec["tol"]
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            if tol == "bit-exact":
                max_abs, max_rel = bit_exact(torch, got, want)
            else:
                max_abs, max_rel = compare(torch, got, want, tol)
            if opt[1:] == ["bf16"]:  # the traces come back in their storage dtype
                n_bf16 = sum(t.dtype == torch.bfloat16 for t in got)
                check(n_bf16 == 3, f"{spec['name']}: {n_bf16} bf16 outputs, want the 3 traces")
            worst_abs = max(worst_abs, max_abs)
            ms = device_ms(torch, kernel, flush)
            plain_ms = device_ms(torch, plain, flush)
            library_ms = device_ms(torch, library, flush) if library is not None else None
            bms, bound_by = bound_ms(n_bytes, n_flops)
            print(
                f"check {spec['name']} {label}: max_abs_err={max_abs:.3e} "
                f"max_rel_err={max_rel:.3e} (tol {tol}) "
                f"kernel_ms={ms:.5f} versus_ms={plain_ms:.5f} library_ms="
                f"{'null' if library_ms is None else f'{library_ms:.5f}'} "
                f"bound_ms={bms:.5f} ({bound_by})"
            )
            case = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=bound_by,
                        library_ms=library_ms, at=label)
            cases.append(dict(case, max_abs_err=max_abs, max_rel_err=max_rel))
            if timed is None:  # the first case is the main path's shape
                timed = case
            elif opt[1:] == ["three_kernels"]:  # fused and composition, same inputs
                extra.update(three_kernels_ms=plain_ms, fused_vs_three_kernels_ms=ms)
            elif len(opt) > 1:  # a second timing of note: the bf16 tier, at
                extra.setdefault(f"{opt[1]}_ms", ms)  # the first (hidden) shape
        records.append(dict(
            name=spec["name"], route="cuda", source=spec["source"],
            replaces=spec["replaces"], max_abs_err=worst_abs, **timed, **extra, cases=cases,
        ))
    return records


def epoch_staging_s(torch, stack_epoch, x, n, device) -> float:
    """Median host seconds to stage one hidden epoch of the raw input as the
    scan plan does on both paths: a shuffled gather on the host and a copy
    into the reused epoch buffer on the card (level 0 is not cached there)."""
    g = torch.Generator().manual_seed(0)
    buf = torch.empty((n // B, B, x.shape[1]), dtype=torch.float32, device=device)
    times = []
    for _ in range(5):
        idx = torch.randperm(len(x), generator=g)[:n].numpy()
        t0 = time.perf_counter()
        stack_epoch(x, idx, B, device, out=buf)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def fit_once(torch, core, net, data_split, device, cfg, fit_kw, on_card):
    """compile -> fit -> predict -> evaluate on ``device``, timed apart."""
    x, y, xt, yt = data_split
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    compiled = net.compile(core.ExecutionConfig(engine="scan", device=device, **cfg))
    result = compiled.fit((x, y), **fit_kw)
    t1 = time.perf_counter()
    scores = compiled.predict(xt)
    sync()
    t2 = time.perf_counter()
    acc = compiled.evaluate((xt, yt))
    sync()
    t3 = time.perf_counter()
    check(tuple(scores.shape) == (len(xt), N_CLASSES), f"scores shape {tuple(scores.shape)}")
    check(bool(torch.isfinite(scores).all()), f"non-finite scores on {device}")
    dtypes = sorted({str(t.dtype) for t in compiled.state.layers[0].marginals})
    return compiled, dict(
        acc=acc, fit_s=result.wall_time_s, predict_s=t2 - t1, evaluate_s=t3 - t2,
        compile_fit_evaluate_s=t3 - t0, hidden_trace_dtypes=dtypes, history=result.history,
    )


def batch_device_ms(torch, card_nets, x, y, dev):
    """Device ms of one training batch of each path (``device_ms``: CUDA
    graph replays with an L2 flush before each), on the trained card
    network's states at the main path's shapes: the hidden layer's
    ``train_batch`` and, for the datapath, the readout's.  The hidden
    step counters are past a rewiring batch, so no rewiring is timed."""
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    xb = torch.as_tensor(x[:B], device=dev)
    yb = torch.as_tensor(y[:B], device=dev)
    out = {}
    for path in ("unfused_f32", "fused_bf16", "datapath_bf20"):
        net = card_nets[path]
        (hidden, readout), (hs, rs) = net.layers, net.state.layers
        check(hs.host_step % hidden.mask_update_every != 0, f"{path}: a rewiring batch")
        out[f"{path}/hidden"] = device_ms(torch, lambda: hidden.train_batch(hs, xb), flush)
        if path == "datapath_bf20":
            hb = hidden.forward(hs, xb)
            out[f"{path}/readout"] = device_ms(torch, lambda: readout.train_batch(rs, hb, yb), flush)
    return out


def stage_rule(torch, label, got, want, mantissa, tol):
    """The card's output of one datapath stage against the CPU's on the same
    inputs, by the rule of ``tests/test_torch_datapath.py``: every element
    within one ulp of the format at |want| plus the stage's f32 tolerance
    (rtol * |want| + atol_rel * max|want|), and at most 1% of the elements
    (at least one) beyond the f32 tolerance, i.e. rounded to a neighbour
    after an f32 sum in another order.  Returns that count and the size."""
    g, w = got.detach().to("cpu", torch.float64), want.detach().to(torch.float64)
    check(g.shape == w.shape, f"datapath stage {label}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    check(bool(torch.isfinite(g).all()), f"datapath stage {label}: not finite on the card")
    rtol, atol_rel = tol
    diff = (g - w).abs()
    f32 = rtol * w.abs() + atol_rel * float(w.abs().max())
    exponent = torch.frexp(torch.maximum(g.abs(), w.abs())).exponent
    ulp = torch.ldexp(torch.ones_like(w), exponent - 1 - mantissa)
    bad = diff > ulp + f32
    n_bad = int(bad.sum())
    check(n_bad == 0, f"datapath stage {label}: {n_bad} elements beyond one ulp + tolerance, "
          f"worst {float(diff[bad].max()) if n_bad else 0.0:.3e}")
    apart = int((diff > f32).sum())
    check(apart <= max(1, 0.01 * diff.numel()),
          f"datapath stage {label}: {apart} of {diff.numel()} elements a format ulp apart")
    return apart, diff.numel()


def datapath_stages(torch, ops, policy, compiled, x, y, dev):
    """One datapath training batch of each layer, hidden then readout, on
    the card against the same on the CPU from the card's trained state,
    stage by stage: each stage gets the CPU's output of the stage before it
    on both sides, so a difference is the stage's own.  The stages are
    those of ``precision/policy.py``: the support (product, bias, gain),
    the softmax, the learning cycle's traces, and w and bias, the last held
    against the CPU's stage on the card's own traces.  The readout's
    support and softmax are those predict runs, here at B rows."""
    cpu = torch.device("cpu")
    (hidden, readout), (hs, rs) = compiled.layers, compiled.state.layers
    mask = hs.plast.unit_mask(hidden.spec.pre, hidden.spec.post)
    xb = torch.as_tensor(x[:B], dtype=torch.float32)
    onehot = torch.nn.functional.one_hot(torch.as_tensor(y[:B]).long(), N_CLASSES).float()
    support_tol, softmax_tol, trace_tol, log_tol = (1e-4, 1e-5), (1e-5, 1e-6), (1e-5, 1e-8), (1e-5, 1e-6)
    out = {}

    def both(fn, *args):  # None stays None (no mask)
        card = fn(*(None if a is None else a.to(dev) for a in args))
        torch.cuda.synchronize()
        return card, fn(*(None if a is None else a.to(cpu) for a in args))

    def held(label, got, want, mantissa, tol):
        apart, n = stage_rule(torch, label, got, want, mantissa, tol)
        out[label] = dict(ulp_apart=apart, elements=n)
        print(f"datapath stage {label} {tuple(want.shape)} [card vs cpu]: {apart} of {n} "
              f"elements a format ulp apart (mantissa {mantissa}, f32 tol {tol})")

    ai = xb
    for name, layer, st, m, aj_target in (("hidden", hidden, hs, mask, None),
                                          ("readout", readout, rs, None, onehot)):
        spec, pol = layer.spec, layer.spec.precision
        mant = pol.fmt.mantissa_bits
        layout = spec.post
        s_card, s_cpu = both(lambda a, w, b, mm: policy.quantized_support(
            a, w, b, pol, mask=mm, gain=spec.gain), ai, st.w, st.b, m)
        held(f"{name} support", s_card, s_cpu, mant, support_tol)
        a_card, a_cpu = both(lambda s: pol.q(ops.hcu_softmax(s, layout.n_hcu, layout.n_mcu)), s_cpu)
        held(f"{name} softmax", a_card, a_cpu, mant, softmax_tol)
        aj = a_cpu if aj_target is None else aj_target
        (st_card, w_card, b_card), (st_cpu, _, _) = both(
            lambda marg, a, j, mm: policy.quantized_learning_cycle(
                marg, a, j, spec.lam, pol, spec.k_b, mask=mm), st.marginals, ai, aj, m)
        for trace, got, want in zip(("c_i", "c_j", "c_ij"), st_card, st_cpu):
            held(f"{name} {trace}", got, want, mant, trace_tol)
        _, w_cpu, b_cpu = policy.state_quantized_cycle(
            st_card.to(cpu), pol, k_b=spec.k_b, mask=None if m is None else m.to(cpu))
        held(f"{name} w", w_card, pol.q(w_cpu), mant, log_tol)
        held(f"{name} bias", b_card, pol.q(b_cpu), mant, log_tol)
        ai = a_cpu  # the readout learns from the hidden codes
    return out


def main_path(torch, ops, core, data, policy, devices=("cuda", "cpu")):
    """Phase 4: Listing 1 at MNIST width on four paths, each on the card
    (launches counted from zero at its compile) and then on the CPU, then
    the card alone at three more datapath formats."""
    ds = data.mnist_like(n_train=8192, n_test=2048, n_features=N_FEATURES, seed=0)
    x, in_layout = data.complementary_code(ds.x_train)
    xt, _ = data.complementary_code(ds.x_test)
    split = (x, ds.y_train, xt, ds.y_test)
    hidden = core.UnitLayout(*HIDDEN)
    net = core.Network(seed=0)
    net.add(core.StructuralPlasticityLayer(
        in_layout, hidden, fan_in=FAN_IN, lam=0.02, gain=4.0, init_jitter=1.0
    ))
    net.add(core.DenseLayer(hidden, core.onehot_layout(N_CLASSES), lam=0.02))
    fit_kw = dict(epochs_hidden=2, epochs_readout=2, batch_size=B)
    batches = len(x) // B
    # path -> (ExecutionConfig options, fit options)
    paths = {
        "unfused_f32": (dict(), dict()),
        "fused_bf16": (dict(fused_phase=True,
                            precision=policy.PrecisionPolicy.named("fp32", state_format="bf16")),
                       dict()),
        "datapath_bf20": (dict(precision="bf20"), dict()),
        "sgd_readout": (dict(), dict(readout="sgd")),
    }

    launches, runs, card_nets = {}, {}, {}
    for path, (cfg, extra) in paths.items():
        for i, device in enumerate(devices):
            on_card = i == 0
            if on_card:
                ops.reset_launches()
            compiled, run = fit_once(torch, core, net, split, device, cfg, {**fit_kw, **extra},
                                     on_card)
            if on_card:
                launches[path] = ops.launch_counts()
                card_nets[path] = compiled
            runs[f"{path}/{'card' if on_card else 'cpu'}"] = run
            print(f"main path {path} [{device}]: accuracy={run['acc']:.4f} fit_wall_s="
                  f"{run['fit_s']:.4f} predict_s={run['predict_s']:.4f} evaluate_s="
                  f"{run['evaluate_s']:.4f} compile+fit+predict+evaluate_s="
                  f"{run['compile_fit_evaluate_s']:.4f} hidden traces {run['hidden_trace_dtypes']}")
            for h in run["history"]:
                print(f"  {path} {device} {h['phase']}"
                      + (f" epoch {h['epoch']}" if "epoch" in h else "")
                      + f": host_s={h['host_s']:.4f} device_wait_s={h['device_wait_s']:.4f}")
        print(f"main path {path} launches: {json.dumps(launches[path])} ({batches} batches per epoch)")
        card_acc, cpu_acc = runs[f"{path}/card"]["acc"], runs[f"{path}/cpu"]["acc"]
        check(card_acc >= 0.5, f"{path}: accuracy on the card {card_acc} < 0.5")
        check(abs(card_acc - cpu_acc) <= 0.03,
              f"{path}: card {card_acc} vs CPU {cpu_acc}: off by more than 0.03")
    print(f"readouts on the card: sgd accuracy={runs['sgd_readout/card']['acc']:.4f} "
          f"beside bcpnn accuracy={runs['unfused_f32/card']['acc']:.4f} (same hidden path)")

    unfused, fused = launches["unfused_f32"], launches["fused_bf16"]
    datapath, sgd = launches["datapath_bf20"], launches["sgd_readout"]
    for name in ("masked_matmul", "hcu_softmax", "bcpnn_update"):
        check(unfused[name] > 0, f"{name} was not launched on the unfused path")
    # The forward pair runs once per call of the layers' forward: per hidden
    # training batch (not on the fused path), per projection chunk of the
    # training set (B rows), per predict chunk of the test set (P rows)
    # through the hidden layer, and per readout head call in predict and
    # evaluate (none on the SGD path: its head is one plain product).
    test_chunks = -(-len(xt) // P)
    hidden_batches = fit_kw["epochs_hidden"] * batches
    readout_batches = fit_kw["epochs_readout"] * batches
    forwards = {
        "unfused_f32": hidden_batches + batches + 3 * test_chunks,
        "fused_bf16": batches + 3 * test_chunks,
        "datapath_bf20": hidden_batches + batches + 3 * test_chunks,
        "sgd_readout": hidden_batches + batches + test_chunks,
    }
    for path, counts in launches.items():
        for name in ("masked_matmul", "hcu_softmax"):
            want = forwards[path]
            check(counts[name] == want, f"{path}: {name} launched {counts[name]} times, want {want}")
    check(unfused["bcpnn_phase"] == 0 and unfused["bf_round"] == 0,
          f"the unfused f32 path launched bcpnn_phase/bf_round: {unfused}")
    check(fused["bcpnn_phase"] == hidden_batches,
          f"bcpnn_phase launched {fused['bcpnn_phase']} times, want {hidden_batches}")
    check(fused["bcpnn_update"] == readout_batches,
          f"bcpnn_update launched {fused['bcpnn_update']} times, want {readout_batches}")
    check(fused["bf_round"] >= 1, "bf_round was not launched at compile")
    for name in ("masked_matmul", "hcu_softmax"):
        check(fused[name] > 0, f"{name} was not launched on the fused path")
    check(runs["fused_bf16/card"]["hidden_trace_dtypes"] == ["torch.bfloat16"],
          f"hidden traces after fit: {runs['fused_bf16/card']['hidden_trace_dtypes']}")
    # The datapath: every stage rounded, no update kernel (it would round
    # m_ij after its EWMA) and no fused phase.  The hidden forwards have
    # gain 4, the readout head gain 1.
    hidden_fwd = Q_FORWARD + Q_GAIN
    want_rounds = (hidden_batches * (hidden_fwd + Q_CYCLE) + batches * hidden_fwd
                   + readout_batches * Q_CYCLE + test_chunks * hidden_fwd
                   + 2 * test_chunks * Q_FORWARD)
    check(datapath["bcpnn_update"] == 0 and datapath["bcpnn_phase"] == 0,
          f"the datapath launched an update kernel: {datapath}")
    check(datapath["bf_round"] == want_rounds,
          f"datapath: bf_round launched {datapath['bf_round']} times, want {want_rounds}")
    # The SGD readout: the hidden epochs' bcpnn_update and nothing else of
    # BCPNN, so its readout epochs launched no BCPNN kernel.
    check(sgd["bcpnn_update"] == hidden_batches and sgd["bcpnn_phase"] == 0
          and sgd["bf_round"] == 0, f"sgd readout path launches: {sgd}")

    # Paper Fig. 3 at MNIST width, on the card only: printed, not gated.
    cliff = {"bf20": runs["datapath_bf20/card"]["acc"]}
    for name in ("fp32", "bf16", "bf14"):
        _, run = fit_once(torch, core, net, split, devices[0], dict(precision=name), fit_kw, True)
        cliff[name] = run["acc"]
        print(f"precision cliff {name} [card]: accuracy={run['acc']:.4f} "
              f"fit_wall_s={run['fit_s']:.4f}")
    print(f"precision cliff at MNIST width (card): {json.dumps(cliff)}")
    # ... and at the e2e test's configuration, where the cliff shows.
    import precision_cliff

    cliff_e2e = precision_cliff.sweep(devices[0])
    print(f"precision cliff at the e2e configuration (card, tools/precision_cliff.py): "
          f"{json.dumps(cliff_e2e)}")

    stages = datapath_stages(torch, ops, policy, card_nets["datapath_bf20"], x, ds.y_train,
                             torch.device(devices[0]))

    per_batch = batch_device_ms(torch, card_nets, x, ds.y_train, torch.device(devices[0]))
    for key, ms in per_batch.items():
        print(f"device ms of one training batch, {key}: {ms:.5f}")

    from repro_torch.runtime.epoch_engine import stack_epoch

    stage_s = epoch_staging_s(torch, stack_epoch, x, batches * B, torch.device(devices[0]))
    print(f"main path epoch staging (host gather + copy of {batches * B}x{x.shape[1]} f32, "
          f"{batches * B * x.shape[1] * 4 / 1e6:.1f} MB, part of each hidden epoch's host_s): "
          f"{stage_s:.4f} s")
    cliffs = dict(mnist_width=cliff, e2e=cliff_e2e)
    trained = dict(net=net, split=split, nets=card_nets, configs={p: c for p, (c, _) in paths.items()},
                   device=devices[0])
    return launches, runs, stage_s, cliffs, per_batch, stages, trained


def serving_rows():
    """The row counts phase 5 gives each kernel, by use: the batched plan's
    padded chunks (through the hidden layer and the head, and on the
    datapath network through ``bf_round``), single-row inference and the
    streaming flushes, full and the tail on close (through the hidden
    layer; ``bcpnn_update`` on the unfused network, ``bcpnn_phase`` on the
    fused one).  One row is also taken through the head and the update: the
    smallest micro-batch the async engine forms and the smallest flush."""
    chunks = {padded for _, _, padded in served_chunks(SERVE_NS + (32, 32), SERVE_BUCKETS)}
    tail = STREAM_ROWS % STREAM_BATCH
    flushes = {STREAM_BATCH} | ({tail} if tail else set())
    return dict(hidden=sorted(chunks | flushes | {1}), head=sorted(chunks | {1}),
                datapath=sorted(chunks), update=sorted(flushes | {1}), flush=sorted(flushes))


def continual_rows():
    """The row counts phase 6 gives each kernel beyond ``serving_rows``: the
    feedback micro-batch of CONT_BATCH rows through the hidden forward (an
    unfused hidden update's forward, the readout update's frozen prefix),
    through ``bcpnn_update`` at the hidden and the readout shape, and
    through ``bcpnn_phase`` (bf16 traces in, and f32 traces in after a
    merge).  The single rows of the prequential view and of each inference
    through both layers are ``serving_rows``' already; the fleet's batched
    micro-batches depend on timing and are checked after its run."""
    return dict(hidden=[CONT_BATCH], update=[CONT_BATCH], readout_update=[CONT_BATCH],
                flush=[CONT_BATCH])


def served_chunks(ns, buckets):
    """Each chunk the batched plan serves for requests of ``ns`` rows (the
    first rows of one array), as (start, stop, padded rows).  Chunks with
    equal keys hold equal bytes: the first projects through the hidden
    layer, a repeat hits the canonical anchor's cached projection."""
    cap, chunks = buckets[-1], []
    for n in ns:
        for i in range(0, n, cap):
            rows = min(cap, n - i)
            chunks.append((i, i + rows, next(b for b in buckets if b >= rows)))
    return chunks


def forward_launches(path, projections, heads):
    """Launches of ``projections`` hidden forwards and ``heads`` readout-head
    calls on ``path``: one forward pair each (the SGD head is one plain
    product), and on the datapath one bf_round per rounded stage."""
    head_pairs = heads if path != "sgd_readout" else 0
    pairs = projections + head_pairs
    rounds = 0
    if path == "datapath_bf20":
        rounds = projections * (Q_FORWARD + Q_GAIN) + head_pairs * Q_FORWARD
    return dict(masked_matmul=pairs, hcu_softmax=pairs, bcpnn_update=0, bcpnn_phase=0,
                bf_round=rounds)


def scores_agree(torch, label, got, want, tol=GEMM_TOL):
    """Served scores against ``compiled.predict``'s: every element within
    ``compare``'s tolerance, and the same argmax on every row whose top-two
    margin is above twice that tolerance.  Returns the rows left out."""
    compare(torch, [got.float()], [want.float()], tol)
    rtol, atol_rel = tol
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * (rtol * top2[:, 0].abs() + atol_rel * float(want.abs().max()))
    check(torch.equal(got.argmax(-1)[clear], want.argmax(-1)[clear]),
          f"{label}: served argmax differs from predict's")
    return int((~clear).sum())


def percentiles(snap, *names):
    return {n: {q: snap[n][q] for q in ("p50", "p99")} for n in names}


def serve_batched(torch, ops, ServiceConfig, path, compiled, x, card):
    """The batched plan over one trained card network: every request size
    of SERVE_NS through padding buckets, then a repeated 32-row batch; launch
    counts exact from the served chunks; scores against ``predict``."""
    import numpy as np

    store = compiled.activations
    ops.reset_launches()
    svc = compiled.serve(ServiceConfig(plan="batched", buckets=SERVE_BUCKETS))
    t0 = time.perf_counter()
    served = [svc.predict(x[:n]) for n in SERVE_NS]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    p0 = store.stats["projections"]
    first = svc.predict(x[:32])
    p1, hits1 = store.stats["projections"], svc.plan.stats["projection_reuse_hits"]
    again = svc.predict(np.array(x[:32]))  # a fresh array, the same bytes
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    stats = svc.plan.stats
    check(p1 == p0 + 1 and store.stats["projections"] == p1,
          f"serve {path}: the repeated batch projected again ({p0}, {p1}, {store.stats})")
    check(stats["projection_reuse_hits"] == hits1 + 1, f"serve {path}: no projection reuse hit")
    check(torch.equal(first, again), f"serve {path}: the repeated batch scored differently")
    chunks = served_chunks(SERVE_NS + (32, 32), SERVE_BUCKETS)
    want = forward_launches(path, len(set(chunks)), len(chunks))
    check(counts == want, f"serve {path}: launches {counts}, want {want}")
    check(stats["padded_rows"] > 0, f"serve {path}: no padded rows")
    check(stats["projection_reuse_hits"] == len(chunks) - len(set(chunks)),
          f"serve {path}: {stats['projection_reuse_hits']} reuse hits, want "
          f"{len(chunks) - len(set(chunks))}")
    unclear = 0
    for n, got in zip(SERVE_NS, served):
        check(tuple(got.shape) == (n, N_CLASSES) and got.device == compiled.device,
              f"serve {path}: scores of {n} rows {tuple(got.shape)} on {got.device}")
        unclear += scores_agree(torch, f"serve {path} n={n}", got, compiled.predict(x[:n]))
    rows = sum(SERVE_NS)
    print(f"serve batched {path} [{card}]: {len(SERVE_NS)} requests, {rows} rows in "
          f"{serve_s:.4f} s ({rows / serve_s:.1f} rows/s), chunks {len(chunks)} "
          f"(projected {len(set(chunks))}), padded_rows={stats['padded_rows']}, "
          f"reuse hits={stats['projection_reuse_hits']}, rows near a tie={unclear}, "
          f"launches {json.dumps(counts)}")
    return counts, dict(rows_per_s=rows / serve_s, serve_s=serve_s, chunks=len(chunks),
                        projections=len(set(chunks)), near_ties=unclear, **stats)


def forward_pair_at(torch, ops, ref, compiled, x, sizes):
    """The forward pair at ``sizes`` rows through both layers of the served
    network, on its own weights and the first rows of ``x``, held against
    the plain version at phase 3's tolerances; returns each kernel's worst
    absolute error."""
    worst = dict(masked_matmul=0.0, hcu_softmax=0.0)
    for k in sizes:
        a = torch.as_tensor(x[:k], device=compiled.device)
        for layer, st in zip(compiled.layers, compiled.state.layers):
            spec = layer.spec
            mask = None if st.plast is None else st.plast.unit_mask(spec.pre, spec.post)
            s = ref.masked_matmul(a, st.w, st.b, mask=mask)
            err, _ = compare(torch, [ops.masked_matmul(a, st.w, st.b, mask=mask)], [s], GEMM_TOL)
            worst["masked_matmul"] = max(worst["masked_matmul"], err)
            s = s * spec.gain
            a = ref.hcu_softmax(s, spec.post.n_hcu, spec.post.n_mcu)
            err, _ = compare(torch, [ops.hcu_softmax(s, spec.post.n_hcu, spec.post.n_mcu)], [a],
                             SOFTMAX_TOL)
            worst["hcu_softmax"] = max(worst["hcu_softmax"], err)
    return worst


def serve_async(torch, ops, ref, ServiceConfig, compiled, xt, yt, card):
    """The async batched service over the unfused card network: ASYNC_CLIENTS
    threads submit the test rows; every future must resolve to a value.
    The engine's micro-batches form at sizes that depend on timing: each
    size phase 3 did not take is checked against the plain version after
    the run."""
    import threading

    import numpy as np

    ops.reset_launches()
    svc = compiled.serve(ServiceConfig(plan="batched", max_batch=64, max_wait_s=0.002,
                                       max_queue=4096, async_mode=True))
    sizes, plan_predict = [], svc.plan.predict

    def recorded(xb):  # the engine's micro-batches, by size
        sizes.append(len(xb))
        return plan_predict(xb)

    svc.plan.predict = recorded
    n = len(xt)
    per = n // ASYNC_CLIENTS
    results, errors = [None] * n, []

    def client(t):
        try:
            futs = [(i, svc.submit(xt[i])) for i in range(t * per, (t + 1) * per)]
            for i, f in futs:
                results[i] = f.result(timeout=60)
        except BaseException as e:  # reported below: the run fails on it
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(ASYNC_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    wall = time.perf_counter() - t0
    svc.drain_and_stop()
    counts = ops.launch_counts()
    check(not any(t.is_alive() for t in threads), "serve async: a client thread hangs")
    check(not errors, f"serve async: a future failed: {errors[:1]!r}")
    check(all(r is not None for r in results[: per * ASYNC_CLIENTS]), "serve async: a row unserved")
    scores = np.stack(results[: per * ASYNC_CLIENTS])
    check(bool(np.isfinite(scores).all()), "serve async: non-finite scores")
    served_acc = float(np.mean(scores.argmax(-1) == np.asarray(yt[: len(scores)])))
    eval_acc = compiled.evaluate((xt, yt))
    check(served_acc == eval_acc, f"serve async: accuracy {served_acc} != evaluate's {eval_acc}")
    batches, tele = svc.engine.batches, svc.stats["telemetry"]
    hits = svc.plan.stats["projection_reuse_hits"]
    check(batches >= 32, f"serve async: {batches} micro-batches, want >= 32")
    check(tele["completed"] == len(scores), f"serve async: completed {tele['completed']}")
    want = forward_launches("unfused_f32", batches - hits, batches)
    check(counts == want, f"serve async: launches {counts}, want {want}")
    check(len(sizes) == batches, f"serve async: {len(sizes)} micro-batches seen, {batches} counted")
    rows = serving_rows()
    unseen = sorted(set(sizes) - (set(rows["hidden"]) & set(rows["head"])))
    worst = forward_pair_at(torch, ops, ref, compiled, xt, unseen)
    lat = percentiles(tele, "queue_wait_s", "batch_s", "e2e_s")
    print(f"serve async batched unfused_f32 [{card}]: {len(scores)} rows from {ASYNC_CLIENTS} "
          f"clients in {wall:.4f} s ({len(scores) / wall:.1f} rows/s), {batches} micro-batches "
          f"of {json.dumps(sorted(set(sizes)))} rows (checked against the plain version after "
          f"the run: {json.dumps(unseen)}, max_abs_err {json.dumps(worst)}), "
          f"accuracy={served_acc:.4f} (evaluate {eval_acc:.4f}), latency s {json.dumps(lat)}, "
          f"launches {json.dumps(counts)}")
    return counts, dict(rows=len(scores), wall_s=wall, rows_per_s=len(scores) / wall,
                        batches=batches, batch_rows=sorted(set(sizes)), checked_after=unseen,
                        checked_after_max_abs_err=worst, accuracy=served_acc, evaluate=eval_acc,
                        latency_s=lat)


def serve_streaming(torch, ops, core, ServiceConfig, trained, path, card):
    """The streaming plan over one trained card network: STREAM_ROWS training
    rows in flushes of STREAM_BATCH (the tail on close), across a rewiring
    step, then STREAM_INFERS single-row inferences through the async engine;
    a CPU twin from the same pre-stream state takes the same feed, and the
    masks must come out equal (on the fused network, but for
    STREAM_MASK_COLUMNS hidden HCUs; on the unfused network the traces
    within STREAM_TRACE_RTOL, w and b within STREAM_W_TOL)."""
    import numpy as np

    compiled = trained["nets"][path]
    x, _, xt, yt = trained["split"]
    dev = compiled.device
    pre = compiled.state
    twin = trained["net"].compile(core.ExecutionConfig(engine="scan", device="cpu",
                                                       **trained["configs"][path]))
    twin.state = pre._replace(layers=tuple(s.to("cpu") for s in pre.layers))
    rows = x[:STREAM_ROWS]
    full, tail = divmod(STREAM_ROWS, STREAM_BATCH)
    flushes = full + (tail > 0)
    step0 = pre.layers[0].host_step
    every = compiled.layers[0].mask_update_every
    rewires = [step for step in range(step0, step0 + flushes) if step % every == 0]
    check(bool(rewires), f"stream {path}: steps {step0}..{step0 + flushes - 1} cross no "
                         f"rewiring step (every {every})")
    mask0 = twin.state.layers[0].plast.hcu_mask.clone()

    ops.reset_launches()
    svc = compiled.serve(ServiceConfig(plan="streaming", max_batch=STREAM_BATCH, cache_size=4))
    t0 = time.perf_counter()
    for r in rows:
        svc.feed(r)
    fed = svc.stats["flushes"]
    svc.close()
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    train_counts = ops.launch_counts()
    st = compiled.state.layers[0]
    check(fed == full and svc.stats["flushes"] == flushes,
          f"stream {path}: {fed} then {svc.stats['flushes']} flushes, want {full} then {flushes}")
    check(st is svc.plan.session.state, f"stream {path}: the session's state was not adopted")
    check(st.host_step == step0 + flushes and int(st.step) == step0 + flushes,
          f"stream {path}: step {int(st.step)}/{st.host_step}, want {step0 + flushes}")
    fused = path == "fused_bf16"
    want = dict(masked_matmul=0 if fused else flushes, hcu_softmax=0 if fused else flushes,
                bcpnn_update=0 if fused else flushes, bcpnn_phase=flushes if fused else 0,
                bf_round=0)
    check(train_counts == want, f"stream {path}: launches {train_counts}, want {want}")

    ops.reset_launches()
    isvc = compiled.serve(ServiceConfig(plan="streaming", max_batch=STREAM_BATCH, cache_size=4,
                                        async_mode=True))
    t0 = time.perf_counter()
    futs = [isvc.submit(r) for r in xt[:STREAM_INFERS]]
    outs = [f.result(timeout=60) for f in futs]
    infer_s = time.perf_counter() - t0
    isvc.close()
    torch.cuda.synchronize()
    infer_counts = ops.launch_counts()
    tele = isvc.stats["telemetry"]
    want = dict(masked_matmul=STREAM_INFERS, hcu_softmax=STREAM_INFERS, bcpnn_update=0,
                bcpnn_phase=0, bf_round=0)
    check(infer_counts == want, f"stream {path} infer: launches {infer_counts}, want {want}")
    layer = compiled.layers[0]
    batch = layer.forward(compiled.state.layers[0], torch.as_tensor(xt[:STREAM_INFERS], device=dev))
    got = torch.from_numpy(np.stack(outs))
    compare(torch, [got], [batch.cpu()], GEMM_TOL)
    sums = got.view(STREAM_INFERS, *HIDDEN).sum(-1)
    check(bool(((sums - 1).abs() <= 1e-4).all()), f"stream {path}: an HCU does not sum to 1")

    tsvc = twin.serve(ServiceConfig(plan="streaming", max_batch=STREAM_BATCH, cache_size=4))
    for r in rows:
        tsvc.feed(r)
    tsvc.close()
    tw = twin.state.layers[0]
    mask_ne = st.plast.hcu_mask.cpu() != tw.plast.hcu_mask
    mask_diff, mask_cols = int(mask_ne.sum()), int(mask_ne.any(0).sum())
    rewired = int((tw.plast.hcu_mask != mask0).sum())
    w_err = (st.w.cpu() - tw.w).abs()
    w_diff, b_diff = float(w_err.max()), float((st.b.cpu() - tw.b).abs().max())
    w_far = float((w_err > 2.0**-5).float().mean())  # one bf16 ulp of a log, as in phase 3
    trace_rel = max(  # the traces' largest relative difference, above the logs' floor
        float(((g.cpu().float() - t.float()).abs() / t.float().abs().clamp_min(STREAM_EPS)).max())
        for g, t in zip(st.marginals, tw.marginals))
    card_acc, twin_acc = compiled.evaluate((xt, yt)), twin.evaluate((xt, yt))
    lat = percentiles(tele, "queue_wait_s", "batch_s", "e2e_s")
    print(f"serve streaming {path} [{card}]: fed {STREAM_ROWS} rows in {flushes} flushes, "
          f"{feed_s:.4f} s (steps {step0}..{step0 + flushes - 1}, rewiring at {rewires}, "
          f"{rewired} mask entries rewired); {STREAM_INFERS} single-row inferences "
          f"{infer_s:.4f} s, latency s {json.dumps(lat)}; accuracy after close={card_acc:.4f} "
          f"(CPU twin {twin_acc:.4f}), mask entries differing from the twin={mask_diff} "
          f"(in {mask_cols} hidden HCUs), "
          f"max |w - w_twin|={w_diff:.3e} (share above 2^-5: {w_far:.3e}), "
          f"max |b - b_twin|={b_diff:.3e}, traces' max relative difference={trace_rel:.3e}; "
          f"launches train {json.dumps(train_counts)} infer {json.dumps(infer_counts)}")
    check(mask_cols <= STREAM_MASK_COLUMNS[path],
          f"stream {path}: {mask_diff} mask entries in {mask_cols} hidden HCUs differ from the "
          f"CPU twin's (at most {STREAM_MASK_COLUMNS[path]} HCUs allowed)")
    if not fused:
        check(trace_rel <= STREAM_TRACE_RTOL,
              f"stream {path}: traces {trace_rel:.3e} apart, relative, > {STREAM_TRACE_RTOL:.0e}")
        check(w_diff <= STREAM_W_TOL and b_diff <= STREAM_W_TOL,
              f"stream {path}: max |w - w_twin| {w_diff:.3e}, |b - b_twin| {b_diff:.3e} "
              f"> {STREAM_W_TOL:.0e}")
    check(card_acc >= 0.5, f"stream {path}: accuracy on the card {card_acc} < 0.5")
    check(abs(card_acc - twin_acc) <= 0.03,
          f"stream {path}: card {card_acc} vs CPU twin {twin_acc}: off by more than 0.03")
    return train_counts, infer_counts, dict(
        feed_s=feed_s, flushes=flushes, rewiring_steps=rewires, mask_entries_rewired=rewired,
        infer_s=infer_s, latency_s=lat, accuracy=card_acc, twin_accuracy=twin_acc,
        mask_entries_differing=mask_diff, mask_hcus_differing=mask_cols, max_w_diff=w_diff, w_share_above_2e_5=w_far,
        max_b_diff=b_diff, trace_max_rel_diff=trace_rel,
    )


def serving(torch, ops, ref, core, trained, card):
    """Phase 5: serve the networks phase 4 trained on the card, launches
    counted from zero for each run and checked exactly once its engine has
    stopped."""
    from repro_torch.runtime import ServiceConfig

    _, _, xt, yt = trained["split"]
    launches, report = {}, {}
    for path, compiled in trained["nets"].items():
        launches[f"serve_batched/{path}"], report[f"batched/{path}"] = serve_batched(
            torch, ops, ServiceConfig, path, compiled, xt, card)
    launches["serve_async/unfused_f32"], report["async/unfused_f32"] = serve_async(
        torch, ops, ref, ServiceConfig, trained["nets"]["unfused_f32"], xt, yt, card)
    for path in ("unfused_f32", "fused_bf16"):
        train, infer, report[f"streaming/{path}"] = serve_streaming(
            torch, ops, core, ServiceConfig, trained, path, card)
        launches[f"serve_stream/{path}"], launches[f"serve_infer/{path}"] = train, infer
    for name in ops.KERNELS:
        check(any(c[name] > 0 for c in launches.values()), f"{name} not launched by the serving phase")
    return launches, report


def continual_stream():
    """Phase 6's feedback stream, in arrival order: ("fb", row, label,
    tenant) for each labeled training row (labels flipped inside
    CONT_BURST, tenants alternating) and ("x", test row) after every
    CONT_INFER_EVERY-th one."""
    items = []
    for k in range(CONT_ROWS):
        items.append(("fb", k, CONT_BURST[0] <= k < CONT_BURST[1], ("t0", "t1")[k % 2]))
        if (k + 1) % CONT_INFER_EVERY == 0:
            items.append(("x", k // CONT_INFER_EVERY))
    return items


def _layer_bits_equal(torch, got, want) -> bool:
    """Two LayerStates (any devices) equal bit for bit, mask and step too."""
    pairs = list(zip((*got.marginals, got.w, got.b, got.step),
                     (*want.marginals, want.w, want.b, want.step)))
    if got.plast is not None or want.plast is not None:
        pairs.append((got.plast.hcu_mask, want.plast.hcu_mask))
    return all(a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()) for a, b in pairs)


def _instrument(plan):
    """Host-side probes on a ContinualPlan (no kernel launch): the score row
    of every prequential evaluation, the state each inference ran on, every
    merged base by merge sequence with a host copy taken when it was made
    (a device-to-host copy, so it syncs the engine thread once a merge),
    and the last-good base and the adopted base around every rollback."""
    probe = dict(view_rows=[], infer_states=[], merged={}, merged_host={}, rollbacks=[])
    view, infer, merge, rollback = plan._view_fwd, plan.infer, plan._merge, plan._rollback

    def view_fn(states, readout, xd):
        scores = view(states, readout, xd)
        probe["view_rows"].append(scores[0])
        return scores

    def infer_fn(sample):
        probe["infer_states"].append(plan.compiled.state)
        return infer(sample)

    def merge_fn(**kw):
        merge(**kw)
        merged = plan.compiled.state.layers[plan._li]
        probe["merged"][plan._merge_seq] = merged
        probe["merged_host"][plan._merge_seq] = merged._map(lambda t: t.to("cpu", copy=True))

    def rollback_fn(**kw):
        last_good = plan._last_good[0]
        rollback(**kw)
        probe["rollbacks"].append((last_good, plan.compiled.state.layers[plan._li]))

    plan._view_fwd, plan.infer, plan._merge, plan._rollback = view_fn, infer_fn, merge_fn, rollback_fn
    return probe


def continual_run(torch, ops, core, trained, path, layer, strategy, card):
    """One continual run (phase 6a): the async engine over a card network
    on phase 4's trained state, fed ``continual_stream()``; a CPU twin from
    the same state takes the same stream through the sync drain.  Gates:
    every future resolves; a merge, a drift event and a rollback happen;
    the acks equal the twin's (``correct`` may differ only on near-ties);
    the adopted base against the twin's under phase 5's rules (the fused
    network's traces, rounded to bf16, under CONT_FUSED_*); each
    rollback restores the last-good base bit for bit; the newest snapshot
    reloads through ``load_adapters`` bit for bit; inference scores agree
    with ``compiled.predict`` on the state they ran on; launch counts
    exact, from the acks."""
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import latest_checkpoint, load_adapters, load_network
    from repro_torch.runtime import ContinualConfig, Feedback, ServiceConfig

    x, y, xt, _ = trained["split"]
    pre = trained["states"][path]
    cfg = trained["configs"][path]
    compiled = trained["net"].compile(core.ExecutionConfig(engine="scan", device=trained["device"], **cfg))
    compiled.state = pre
    twin = trained["net"].compile(core.ExecutionConfig(engine="scan", device="cpu", **cfg))
    twin.state = pre._replace(layers=tuple(s.to("cpu") for s in pre.layers))
    li = layer if layer >= 0 else len(compiled.layers) + layer
    pre_host = pre.layers[li].to("cpu")
    fused = path == "fused_bf16"
    flipped = (np.asarray(y) + 1) % N_CLASSES
    items = continual_stream()

    def item(kind, k, flip=False, tenant=None):
        if kind == "x":
            return xt[k]
        return Feedback(x[k], int(flipped[k] if flip else y[k]), tenant=tenant)

    with tempfile.TemporaryDirectory() as snap_dir:
        cc = ContinualConfig(layer=layer, merge_strategy=strategy, snapshot_dir=snap_dir, **CONT_KW)
        store = compiled.activations
        p0 = store.stats["projections"]
        ops.reset_launches()
        svc = compiled.serve(ServiceConfig(continual=cc, async_mode=True))
        probe = _instrument(svc.plan)
        t0 = time.perf_counter()
        futs = [svc.submit(item(*it)) for it in items]
        outs = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
        svc.drain_and_stop()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        projections = store.stats["projections"] - p0
        tele = svc.stats["telemetry"]
        # The newest snapshot: base and every adapter equal that merge's
        # base as it was copied to the host when the merge made it, bit for
        # bit (the adapters re-fork from it before it is written).
        seq, snap = latest_checkpoint(snap_dir)
        adapters = load_adapters(snap, compiled.state.layers[li], device="cpu")
        snap_layers, _, _ = load_network(snap, list(compiled.state.layers), device="cpu")
        newest = probe["merged_host"][seq]
        check(sorted(adapters) == ["t0", "t1"], f"continual {path} layer {layer}: adapters "
              f"{sorted(adapters)} in the newest snapshot")
        check(all(_layer_bits_equal(torch, a, newest) for a in adapters.values())
              and _layer_bits_equal(torch, snap_layers[li], newest),
              f"continual {path} layer {layer}: snapshot {seq} does not reload bit for bit")

    acks = [o for o in outs if isinstance(o, dict)]
    rows = [o for o in outs if not isinstance(o, dict)]
    check(len(acks) == CONT_ROWS and len(rows) == len(items) - CONT_ROWS,
          f"continual {path}: {len(acks)} acks and {len(rows)} score rows")
    check(all(r.shape == (N_CLASSES,) and np.isfinite(r).all() for r in rows),
          f"continual {path}: a score row is malformed")
    n = {k: sum(a[k] for a in acks) for k in ("applied", "shed", "merged", "rolled_back")}
    check(n["merged"] >= 1 and n["rolled_back"] >= 1 and tele["drift_events"] >= 1,
          f"continual {path} layer {layer}: acks {n}, drift events {tele['drift_events']}")
    check(tele["merges"] == n["merged"] and tele["rollbacks"] == n["rolled_back"]
          and tele["online_updates"] == n["applied"], f"continual {path}: telemetry {tele}")

    # Each rollback restored the last-good base: the same object, and bit
    # for bit the host copy taken when it was adopted (phase 4's state, or
    # a merged base copied to the host by the merge that made it), so an
    # in-place write into the base after its adoption fails the gate.
    rolled_to_merged = 0
    for last_good, adopted in probe["rollbacks"]:
        seqs = [s for s, m in probe["merged"].items() if m is last_good]
        want = pre_host if not seqs else probe["merged_host"][seqs[0]]
        rolled_to_merged += bool(seqs)
        check(adopted is last_good and _layer_bits_equal(torch, adopted, want),
              f"continual {path} layer {layer}: a rollback did not restore the last-good base")

    # Launches, exact: a two-layer view forward per feedback row, a
    # projection (when the row is new to the store) and a head per
    # inference, and per applied update the hidden layer's forward pair and
    # bcpnn_update (bcpnn_phase on the fused network) or the readout's
    # prefix pair and bcpnn_update; a merge launches nothing.
    n_infer = len(rows)
    fused_update = fused and li == 0
    pairs = 2 * CONT_ROWS + projections + n_infer + (0 if fused_update else n["applied"])
    want = dict(masked_matmul=pairs, hcu_softmax=pairs,
                bcpnn_update=0 if fused_update else n["applied"],
                bcpnn_phase=n["applied"] if fused_update else 0, bf_round=0)
    check(projections == n_infer, f"continual {path}: {projections} projections for {n_infer} rows")
    check(counts == want, f"continual {path} layer {layer}: launches {counts}, want {want}")

    # Inference scores against predict on the state each ran on.
    unclear = 0
    final = compiled.state
    by_state = {}
    infer_items = [it for it in items if it[0] == "x"]
    for (_, k), out, st in zip(infer_items, rows, probe["infer_states"]):
        by_state.setdefault(id(st), (st, []))[1].append((k, out))
    for st, served in by_state.values():
        compiled.state = st
        idx = [k for k, _ in served]
        unclear += scores_agree(torch, f"continual {path} inference",
                                torch.from_numpy(np.stack([o for _, o in served])),
                                compiled.predict(xt[idx]).cpu())
    compiled.state = final

    # The CPU twin: the same stream through the sync drain.
    tsvc = twin.serve(ServiceConfig(continual=ContinualConfig(
        layer=layer, merge_strategy=strategy, **CONT_KW)))
    tprobe = _instrument(tsvc.plan)
    for it in items:
        tsvc.submit(item(*it))
    touts = tsvc.drain()
    tacks = [o for o in touts if isinstance(o, dict)]
    flags = ("tenant", "applied", "shed", "merged", "rolled_back")
    check([tuple(a[f] for f in flags) for a in acks] == [tuple(a[f] for f in flags) for a in tacks],
          f"continual {path} layer {layer}: the ack sequence differs from the CPU twin's")
    near = 0
    for a, ta, trow in zip(acks, tacks, tprobe["view_rows"]):
        if a["correct"] != ta["correct"]:
            top2 = trow.topk(2).values
            margin = float(top2[0] - top2[1])
            tol = 2 * (GEMM_TOL[0] * float(top2[0].abs()) + GEMM_TOL[1] * float(trow.abs().max()))
            check(margin <= tol, f"continual {path}: a prequential prediction differs off a tie")
            near += 1
    st, tw = compiled.state.layers[li], twin.state.layers[li]
    check(st.host_step == tw.host_step == int(st.step), f"continual {path}: steps differ")
    mask_cols = 0
    if st.plast is not None:
        mask_cols = int((st.plast.hcu_mask.cpu() != tw.plast.hcu_mask).any(0).sum())
    w_diff = float((st.w.cpu() - tw.w).abs().max())
    b_diff = float((st.b.cpu() - tw.b).abs().max())
    trace_rel = max(
        float(((g.cpu().float() - t.float()).abs() / t.float().abs().clamp_min(STREAM_EPS)).max())
        for g, t in zip(st.marginals, tw.marginals))
    lat = percentiles(tele, "queue_wait_s", "update_s", "e2e_s")
    dtypes = sorted({str(t.dtype) for t in st.marginals})
    print(f"continual {path} layer {layer} ({strategy}) [{card}]: {len(items)} items "
          f"({CONT_ROWS} feedback, {n_infer} inferences) in {wall:.4f} s "
          f"({len(items) / wall:.1f} items/s); acks {json.dumps(n)}, drift events "
          f"{tele['drift_events']}, steps {pre.layers[li].host_step}..{st.host_step}, traces "
          f"{dtypes}; twin: acks equal, correct apart on {near} near-ties, mask HCUs differing "
          f"{mask_cols}, max |w - w_twin| {w_diff:.3e}, |b - b_twin| {b_diff:.3e}, traces "
          f"{trace_rel:.3e} relative; rollbacks to a merged base {rolled_to_merged} of "
          f"{len(probe['rollbacks'])}; inference rows near a tie {unclear}; latency s "
          f"{json.dumps(lat)}; launches {json.dumps(counts)}")
    check(mask_cols <= STREAM_MASK_COLUMNS[path],
          f"continual {path}: masks differ from the twin's in {mask_cols} hidden HCUs")
    trace_tol, w_tol = ((CONT_FUSED_TRACE_RTOL, CONT_FUSED_W_TOL) if fused
                        else (STREAM_TRACE_RTOL, STREAM_W_TOL))
    check(trace_rel <= trace_tol and w_diff <= w_tol and b_diff <= w_tol,
          f"continual {path} layer {layer}: traces {trace_rel:.3e} (bound {trace_tol:.3e}), "
          f"w {w_diff:.3e}, b {b_diff:.3e} (bound {w_tol:.3e}) from the twin")
    return counts, dict(items=len(items), wall_s=wall, items_per_s=len(items) / wall, acks=n,
                        drift_events=tele["drift_events"], latency_s=lat, trace_dtypes=dtypes,
                        near_ties=near, mask_hcus_differing=mask_cols, max_w_diff=w_diff,
                        max_b_diff=b_diff, trace_max_rel_diff=trace_rel,
                        rollbacks_to_merged=rolled_to_merged)


class _Crash(BaseException):
    """Escapes the engine's per-batch Exception handler: kills its loop."""


def fleet_run(torch, ops, ref, core, trained, card):
    """Phase 6b: the Router over two batched engines and two continual
    engines (each over its own network loaded from the unfused network's
    checkpoint), tenants free (weight 1) and paid (weight 4), p95 routing.
    FLEET_CLIENTS threads submit the test rows, two threads a tenant (so a
    client backing off from its tenant's full queue never holds back the
    other tenant), a quarter of the free rows with a FLEET_DEADLINE_S
    deadline; a feedback thread
    sends FLEET_FEEDBACK labeled rows (the same flipped burst) to the
    continual pool.  The batched engine that first reaches its
    FLEET_CRASH_AT-th row crashes, once.  Gates: every future resolves to a value or a
    typed error; exactly one restart; each tenant's feedback on one
    continual engine; served scores against ``compiled.predict``; the
    forward pair at every micro-batch size the engines formed."""
    import tempfile
    import threading

    import numpy as np

    from repro_torch.checkpoint import save_network
    from repro_torch.runtime import (
        BatchedPlan, ContinualConfig, ContinualPlan, DeadlineExceeded, DriftDetected, Feedback,
        Router, RouterConfig, RouterError, ServiceConfig, TenantConfig, TenantQueueFull)

    x, y, xt, _ = trained["split"]
    flipped = (np.asarray(y) + 1) % N_CLASSES
    with tempfile.TemporaryDirectory() as ckpt_dir:
        path = save_network(ckpt_dir, 0, trained["states"]["unfused_f32"])
        nets = [trained["net"].compile(core.ExecutionConfig(engine="scan", device=trained["device"])).load(path)
                for _ in range(4)]
    # The first batched engine to reach its FLEET_CRASH_AT-th row crashes,
    # once (p95 routing decides which engine gets more rows).
    sizes, armed, seen = [], {"on": True}, {}

    def batched_factory(compiled, name):
        def factory(config, metrics):
            plan = BatchedPlan(compiled, config, metrics)
            predict = plan.predict

            def recorded(xb):
                sizes.append(len(xb))
                seen[name] = seen.get(name, 0) + len(xb)
                if seen[name] >= FLEET_CRASH_AT and armed.pop("on", None):
                    raise _Crash(f"injected crash in {name} at row {seen[name]}")
                return predict(xb)

            plan.predict = recorded
            return plan
        return factory

    def continual_factory(compiled):
        return lambda config, metrics: ContinualPlan(compiled, config, metrics)

    ops.reset_launches()
    router = Router(RouterConfig(tenants={"free": TenantConfig(weight=1),
                                          "paid": TenantConfig(weight=4)}, routing="p95"))
    batched_cfg = ServiceConfig(plan="batched", max_batch=64, max_wait_s=0.002, max_queue=64)
    cont_cfg = ServiceConfig(max_queue=8, continual=ContinualConfig(layer=0, **CONT_KW))
    for i in range(2):
        router.add_engine(f"batched{i}", batched_factory(nets[i], f"batched{i}"), batched_cfg)
    router.add_engine("continual0", continual_factory(nets[2]), cont_cfg)
    router.add_engine("continual1", continual_factory(nets[3]), cont_cfg)

    n = len(xt) - len(xt) % FLEET_CLIENTS
    results, fb_results, errors = [None] * n, [None] * FLEET_FEEDBACK, []
    bounced = {"free": 0, "paid": 0}
    samples, done = [], threading.Event()

    def submit(item, **kw):
        while True:  # a client backs off while its tenant's queue is full
            try:
                return router.submit(item, **kw)
            except TenantQueueFull as e:
                bounced[e.tenant] += 1
                time.sleep(0.001)

    def outcome(fut):
        try:
            return fut.result(timeout=300)
        except (RouterError, DriftDetected) as e:
            return e

    def client(t):  # clients 0, 2 are the free tenant's, 1, 3 the paid tenant's
        try:
            futs = []
            for i in range(t, n, FLEET_CLIENTS):
                tenant = ("free", "paid")[i % 2]
                deadline = FLEET_DEADLINE_S if tenant == "free" and i % 8 == 0 else None
                futs.append((i, submit(xt[i], tenant=tenant, deadline_s=deadline)))
            for i, f in futs:
                results[i] = outcome(f)
        except BaseException as e:  # reported below: the run fails on it
            errors.append(e)

    def feeder():
        try:
            futs = []
            for k in range(FLEET_FEEDBACK):
                label = int(flipped[k] if CONT_BURST[0] <= k < CONT_BURST[1] else y[k])
                tenant = ("free", "paid")[k % 2]
                futs.append((k, submit(Feedback(x[k], label, tenant=tenant), tenant=tenant,
                                       pool="continual")))
            for k, f in futs:
                fb_results[k] = outcome(f)
        except BaseException as e:  # reported below
            errors.append(e)

    def monitor():  # DRR share while both tenants are backlogged
        while not done.is_set():
            st = router.stats["tenants"]
            tm = router.metrics.tenants
            samples.append({t: (st[t]["depth"] if t in st else 0,
                                tm[t].sched_wait_s.count if t in tm else 0)
                            for t in ("free", "paid")})
            time.sleep(0.002)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(FLEET_CLIENTS)]
    threads.append(threading.Thread(target=feeder))
    mon = threading.Thread(target=monitor)
    t0 = time.perf_counter()
    router.start()
    mon.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    router.drain_and_stop(timeout=300)
    done.set()
    mon.join(30)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(not any(t.is_alive() for t in threads) and not mon.is_alive(), "fleet: a thread hangs")
    check(not errors, f"fleet: a client failed: {errors[:1]!r}")
    typed = (RouterError, DriftDetected)
    check(all(r is not None for r in results) and all(r is not None for r in fb_results),
          "fleet: a future did not resolve")
    bad = [r for r in results + fb_results if isinstance(r, BaseException) and not isinstance(r, typed)]
    check(not bad, f"fleet: an untyped failure {bad[:1]!r}")
    stats = router.stats
    restarts = {name: e["restarts"] for name, e in stats["engines"].items()}
    check(sum(restarts.values()) == 1 and restarts["batched0"] + restarts["batched1"] == 1
          and stats["telemetry"]["restarts"] == 1 and not armed, f"fleet: restarts {restarts}")
    pinned = {t: [name for name, slot in router._slots.items()
                  if slot.pool == "continual" and t in slot.engine.plan.stats["tenants"]]
              for t in ("free", "paid")}
    check(all(len(v) == 1 for v in pinned.values()), f"fleet: feedback spread over {pinned}")

    served = [(i, r) for i, r in enumerate(results) if not isinstance(r, BaseException)]
    idx = [i for i, _ in served]
    got = torch.from_numpy(np.stack([r for _, r in served]))
    unclear = scores_agree(torch, "fleet", got, nets[0].predict(xt[idx]).cpu())
    rows = serving_rows()
    unseen = sorted(set(sizes) - (set(rows["hidden"]) & set(rows["head"])))
    worst = forward_pair_at(torch, ops, ref, nets[0], xt, unseen)

    shed = {t: {k: stats["telemetry"]["tenants"][t][k]
                for k in ("shed_deadline", "shed_drift", "requeued", "failed", "completed")}
            for t in ("free", "paid")}
    drift_shed = sum(isinstance(r, DriftDetected) for r in fb_results)
    deadline_shed = sum(isinstance(r, DeadlineExceeded) for r in results)
    both, d_free, d_paid = 0, 0, 0
    for a, b in zip(samples, samples[1:]):
        if a["free"][0] > 0 and a["paid"][0] > 0:
            both += 1
            d_free += b["free"][1] - a["free"][1]
            d_paid += b["paid"][1] - a["paid"][1]
    share = d_paid / d_free if d_free else None
    tenants = {t: percentiles(stats["telemetry"]["tenants"][t], "sched_wait_s", "e2e_s")
               for t in ("free", "paid")}
    cont = {name: stats["telemetry"]["engines"][name] for name in ("continual0", "continual1")}
    update = {name: {q: c["update_s"][q] for q in ("p50", "p99")} for name, c in cont.items()}
    online = {k: sum(c[k] for c in cont.values())
              for k in ("online_updates", "updates_shed", "merges", "rollbacks", "drift_events")}
    print(f"fleet [{card}]: {len(served)} of {n} rows served by 2 batched engines in {wall:.4f} s "
          f"({len(served) / wall:.1f} rows/s), {deadline_shed} shed by their {FLEET_DEADLINE_S} s "
          f"deadline; {FLEET_FEEDBACK} feedback rows to 2 continual engines, pinned "
          f"{json.dumps(pinned)}, {drift_shed} shed on drift; restarts {json.dumps(restarts)}; "
          f"micro-batches {len(sizes)} of {json.dumps(sorted(set(sizes)))} rows (checked after "
          f"the run: {json.dumps(unseen)}, max_abs_err {json.dumps(worst)}); rows near a tie "
          f"{unclear}; router queue wait and end to end s {json.dumps(tenants)}; update_s "
          f"{json.dumps(update)}; online {json.dumps(online)}; sheds {json.dumps(shed)}; "
          f"submits bounced off a full tenant queue {json.dumps(bounced)}; DRR dispatches paid:free "
          f"while both backlogged {d_paid}:{d_free} over {both} samples "
          f"(share {'null' if share is None else f'{share:.3f}'}); launches {json.dumps(counts)}")
    return counts, dict(rows=n, served=len(served), wall_s=wall, rows_per_s=len(served) / wall,
                        deadline_shed=deadline_shed, drift_shed=drift_shed, pinned=pinned,
                        restarts=restarts, batch_rows=sorted(set(sizes)), checked_after=unseen,
                        checked_after_max_abs_err=worst, near_ties=unclear, tenants_latency_s=tenants,
                        update_s=update, online=online, sheds=shed, bounced=bounced,
                        drr_paid_to_free=share, drr_samples=both)


def fabric(torch, ops, ref, core, trained, card):
    """Phase 6: the continual tier (three runs) and the router fleet, at
    full width, on phase 4's trained states."""
    launches, report = {}, {}
    for path, layer, strategy in CONT_RUNS:
        key = f"continual/{path}/layer{layer}"
        launches[key], report[key] = continual_run(torch, ops, core, trained, path, layer,
                                                   strategy, card)
    launches["fleet"], report["fleet"] = fleet_run(torch, ops, ref, core, trained, card)
    for name in ("masked_matmul", "hcu_softmax", "bcpnn_update", "bcpnn_phase"):
        check(any(c[name] > 0 for c in launches.values()), f"{name} not launched by the fabric phase")
    return launches, report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import core, data
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.precision import policy

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

    # Phase 3: each kernel against its plain version, then where
    # bcpnn_phase's time goes (tools/bcpnn_phase_profile.py, its profiling
    # variant: per-CTA %globaltimer stamps of each phase).
    dev = torch.device("cuda", torch.cuda.current_device())
    records = kernel_checks(torch, ops, ref, dev)
    sys.path.insert(0, str(ROOT / "tools"))
    import bcpnn_phase_profile

    profile = bcpnn_phase_profile.phase_profile(dev, reps=5)
    for fmt, rec in profile.items():
        print(f"bcpnn_phase profile ({fmt} state, {rec['ctas']} CTAs): "
              + " ".join(f"{p}={rec[p]['median_ns'] / 1e3:.2f}us" for p in bcpnn_phase_profile.pk.PHASES)
              + f" (median over CTAs) span={rec['span_ns'] / 1e3:.2f}us")
    print(json.dumps({"bcpnn_phase_profile": profile}))

    # Phase 4: the main paths, launches counted from zero on each.
    launches, runs, stage_s, cliffs, per_batch, stages, trained = main_path(
        torch, ops, core, data, policy)

    # Phase 5: serve the networks phase 4 trained, launches counted from
    # zero on each serving run.  Phase 6 starts again from the trained
    # states (states are never written in place, so holding them suffices).
    trained["states"] = {path: net.state for path, net in trained["nets"].items()}
    serve_launches, served = serving(torch, ops, ref, core, trained, card)
    launches.update(serve_launches)

    # Phase 6: the serving fabric, the continual tier and the router fleet.
    t0 = time.perf_counter()
    fabric_launches, fabric_report = fabric(torch, ops, ref, core, trained, card)
    launches.update(fabric_launches)
    fabric_report["wall_s"] = time.perf_counter() - t0
    print(f"phase 6 (the serving fabric) wall: {fabric_report['wall_s']:.2f} s")

    # Phase 7: the records.
    for rec in records:
        rec["launches_by_path"] = {path: counts[rec["name"]] for path, counts in launches.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "at", "launches_by_path")
    kernels = [
        {**{k: rec[k] for k in keys}, **{k: v for k, v in rec.items() if k not in keys}}
        for rec in records
    ]
    check(all(math.isfinite(k["ms"]) for k in kernels), "non-finite kernel time")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "main_path": {d: {k: v for k, v in r.items() if k != "history"} for d, r in runs.items()},
        "epoch_staging_s": stage_s,
        "precision_cliff_card": cliffs,
        "datapath_stages_card_vs_cpu": stages,
        "batch_device_ms": per_batch,
        "serving": served,
        "fabric": fabric_report,
    }))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
