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
   replaces, ``bf_round`` bit for bit, special values included, at the
   shapes of the state tier's traces), and time the
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
   in (an adapter forked after a merge); the forward pair and
   ``bcpnn_update`` also at the shapes of the launcher's ``--online``
   classifier, ``online_rows``: F = 64, H = 32, 64 / 4 / 1 rows, the head
   32x4); each datapath mode (the reduced datapath's stages rounded inside
   the kernel: ``masked_matmul`` and ``hcu_softmax`` with
   ``round_mantissa``, ``bcpnn_update`` with ``datapath_mantissa``) is held
   against its plain version by ``stage_rule`` (one format ulp plus the
   f32 tolerance, at most 1% of the elements apart) at every shape phases
   4-5 launch it (``datapath_rows``) and timed beside the same kernel's
   f32 mode on the same inputs; the forward pair also at phase 9's model
   shard (H / 2 units); ``masked_matmul``'s gathered variant (``hcu_mask=``,
   the receptive fields per hypercolumn pair) at the STL-10 width, 27,648
   two-unit input HCUs -> 20x150 with 1,024 kept a hidden HCU, at B and P
   rows, against the plain product over the expanded mask, and its kept
   lists (``masked_matmul.kept_lists``) against ``ref.kept_lists``; and
   ``bcpnn_update``'s reduced-means mode (phase 9's learning cycle: the
   EWMA and the weights from all-reduced batch means) against its plain
   version at the hidden layer, a model rank's half of it and the readout,
   timed beside the f32 update from the batch on the same traces; then print where ``bcpnn_phase``'s time
   goes, phase by phase (``tools/bcpnn_phase_profile.py``);
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
   datapath the forward pair in its rounding mode, one ``bcpnn_update``
   in its datapath mode per learning cycle and no ``bf_round``, so three
   launches a hidden batch; on the SGD path no BCPNN kernel in the readout
   epochs).  Then the card
   alone fits the datapath at fp32, bf16 and bf14 and prints the accuracy
   cliff, and again at bf14 ... fp32 at the e2e test's configuration
   (``tools/precision_cliff.py``; both printed, not gated); one datapath
   training batch of each layer is held on the card against the CPU from
   the same state, stage by stage through the datapath modes, each stage
   within one format ulp of the CPU's and at most 1% of its elements that
   far; one training batch of each path is timed on the device and its
   launches counted (the repository's kernels by their counters, every
   CUDA kernel by ``torch.profiler``); and the staging of one hidden
   epoch's input is timed alone, the host time every path shares;
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
7. the LM zoo's dense decoder at full width: gemma3-1b as published
   (26 layers, vocab 262144, a 512 window, bf16, random weights from
   ``torch.Generator`` seed 0) through ``serve_model`` with four slots,
   eight prompts of 5-700 tokens, 16 new tokens each: every request
   completes; its tokens equal a single-slot plan's up to its first
   near-tie, and the slot-batched logits are within NEAR_TIE / 2 of the
   single-slot ones on every row of the same inputs; prefill + decode
   logits within DEC_FORWARD_TOL x std of ``forward``'s over the whole
   sequence (prompts 60 and 700); bucketed and exact-length prefills give
   the same first token off near-ties; an EOS request ends where its
   token is; prefill ms per bucket and decode-step ms at 1, 2 and 4 slots
   (device from graph replays, host apart) against the bytes' bound.  Then
   the same width at depth 6 in f32, the card against the CPU (weights
   carried through the flat arrays; logits within 1e-4 relative + 1e-4 x
   std, tokens equal up to the first near-tie); the async engine (four
   client threads, 16 requests) and a fleet of two decode engines over the
   one model (two tenants, deadlines, one crash and restart, one copy of
   the weights in memory); and the launcher as a user runs it
   (``python -m repro_torch.launch.serve --full ...`` and ``--online``),
   the ``--online`` path once more in this process with its launches
   counted and each launch's shape among phase 3's.  The decode path
   launches none of the five kernels;
8. the hot-path guard (``repro_torch.analysis.strict``), at MNIST width on
   the card: (a) each of phase 4's four paths twice without strict and once
   with ``ExecutionConfig(strict=True)``, two fit and evaluate rounds each
   (evaluated at the training batch size): the sentinel watched something,
   every entry at 1 (the callables and, after ``>``, each kernel's launch
   plan and library build), the strict state and accuracies equal to the
   plain run's bit for bit (phase 4's rule if two plain runs already
   differ), and the strict overhead per epoch printed; (b) four seeded
   faults raise their typed errors: a ``.item()`` inside a projection
   chunk's guarded dispatch (``HostTransferError``), a hidden trace moved
   to the CPU (``HostTransferError``, no launch and no plain-version run),
   a ``partial_fit`` with a new batch size (``RecompileError``), NaN in w
   (``NonFiniteError``); (c) a caller thread's read back while another
   thread's guard is open does not raise (and the guarded thread's does),
   then the batched and streaming plans through the async engine and the
   continual lifecycle, strict against a plain twin, two rounds each with
   equal results and the sentinel still after round one, a caller thread
   reading back throughout, and gemma3-1b at full width, cut to depth 6,
   through ``serve_model(strict=True)``, tokens equal to the plain
   service's; (d) an unfused and a fused fit under ``profile_dir``: each
   repository kernel in the Chrome trace as often as its launch counter
   says, its summed device time, the device's idle share and the longest
   gaps between kernels printed; (e) the unfused fit with
   ``use_kernels=False``: no launch of ours in the counters or the trace,
   accuracy within 0.03 of the kernel path;
9. distribution, the paper's MPI backend, on phase 4's configuration
   through ``ExecutionConfig(trainer=DataParallelTrainer(make_host_mesh(),
   mode))``: (a) one rank over NCCL in this process, shard_map mode on the
   scan and on the batch engine and pjit mode on the scan engine with the
   fused bf16-state config, each at phase 4's accuracy rule against the
   same path's single-device card fit, its launches exactly phase 4's
   (shard_map: every ``bcpnn_update`` in the reduced-means mode), its
   all-reduces counted, one hidden and one readout batch from the trained
   state against the single-device steps (the reference's data-parallel
   tolerance: w rtol 2e-4 / atol 2e-5, C_ij rtol 2e-4 / atol 1e-7), and
   one all-reduce of the packed means timed; (b) two ranks on the one card
   (two processes, gloo with CUDA tensors), shard_map on the scan engine
   at meshes (2, 1) and (1, 2): both ranks end with the same global state
   bit for bit, each at (a)'s rules with its exact launches; fit wall
   time, time in all-reduce and per-batch ms printed, not gated;
10. the MoE family with MLA attention at full width, with phase 7's slots,
   buckets, prompts and gates: (a) moonshot-v1-16b-a3b as the repository
   configures it (64 experts top-6 + 2 shared, GQA, bf16, random weights
   from seed 0), cut to 24 of its 48 layers (MOE_SERVE_LAYERS; the
   launcher serves it whole); (b) deepseek-v2-236b at its published
   width cut to 4 layers (MLA with 128 heads, 160 experts).  The forward
   and bucketed-versus-exact checks run on the same weights under a
   capacity factor of E / k, which drops nothing (a bucketed MoE prefill
   equals an exact one only while nothing drops), each replaying the
   routing of the path it is held to; the slot gates leave out the rows
   whose own token the two bf16 orders routed differently.  Every routing
   difference must be a near-tie of the router's probabilities
   (MOE_BF16_ROUTE_RTOL).
   The dropped assignments of each bucketed prefill at the configured 1.25
   are printed, and prefill and decode-step times against the bytes the
   step reads (the routed experts it chose, counted from its routing).
   Then (d) the async engine and a fleet of two engines over moonshot,
   strict serving of moonshot at depth 4 (tokens equal to the plain
   service's), the launcher (``--arch moonshot-v1-16b-a3b --full`` serves,
   ``--arch deepseek-v2-236b --full`` is refused by its bytes), and (c)
   moonshot's width at depth 3 in f32, the card against the CPU at the
   configured capacity: every routing call equal but at near-ties of the
   CPU's probabilities (1e-5 relative), kept slots equal, logits within
   1e-4 relative + 1e-4 x std where no flip reached, tokens equal up to
   the first near-tie.  The path launches none of the five kernels;
11. the state-space and front-end families at full width, with phase 7's
   slots, prompts and gates, bf16, random weights from seed 0: (a)
   mamba2-1.3b (d 2048, state 128) and (b) zamba2-2.7b (Mamba-2 layers and
   one shared attention block after every 6), each cut to 24 of its 48 and
   54 layers (SSM_SERVE_LAYERS; the launcher serves them whole), each prefilled at exact length (the plan's prefill cells one
   per prompt length, none evicted) with a 1- and a 2-token prompt beside
   phase 7's eight, prefill + decode against ``forward`` on prompts 2, 60
   and 700 (within the larger of DEC_FORWARD_TOL x std and
   SSM_DRIFT_FACTOR x the model's own drift between two prefill shapes),
   and in f32 at full width and depth within 1e-4 relative + 1e-4 x std
   (the bf16 forward's distance from the f32 one printed), and one
   8000-token prompt (31 chunks of 256 and a ragged tail of 64): its
   prefill's device ms, served to 16 tokens at max_seq 8192 and held
   against ``forward``, a slot's state bytes equal to a 2-token prompt's;
   (c) internvl2-1b with phase 7's gates, and one batch of 1024
   patch embeddings and 32 tokens through prefill and 8 decode steps, held
   against ``forward``; the decode-step device ms against the bytes the
   step moves (the weights once, the hybrid's shared block at each of its
   9 applications, each slot's f32 state read and written and its k/v up
   to its length); (e) strict serving of zamba2 at depth 12 (tokens equal
   to the plain service's, the sentinel still) and the launcher
   (``--arch <each> --full``); (d) each arch's width cut in depth (4, 12,
   4) in f32, the card against the CPU, the short prompts included
   (logits within 1e-4 relative + 1e-4 x std, tokens equal up to the first
   near-tie).  The paths launch none of the five kernels;
12. the enc-dec family served and the LM zoo's training path: (a)
   seamless-m4t-large-v2 at full width and depth (24 + 24 layers, bf16,
   random weights from seed 0), four requests of 1,024 source frames and
   prompts of 1-64 tokens, 16 new tokens each, served through the model's
   own functions at 1 and 4 slots: prefill + decode against ``forward``
   (DEC_FORWARD_TOL x std), slot-batched logits against single-slot ones
   (NEAR_TIE / 2, tokens equal up to the first near-tie), f32 at depth
   4 + 4 against the CPU (DEC_F32_TOL), the decode step's device and host
   ms against its bytes' bound, the prefill's device ms, peak memory; (b)
   gemma3-1b trained at full width and depth (f32 masters, bf16 compute,
   remat, AdamW under warmup_cosine, 10 steps of 8 x 1024 tokens from
   ``token_stream`` in 2 microbatches): every loss finite, the last below
   the first, the accumulated step against the full batch (TRAIN_*), step
   host ms, a profiled step's device busy ms, tokens/s, model FLOPs and
   their share of the bf16 peak, peak memory; (c) one train step of
   gemma3-1b at full width, depth 2, and of seamless-m4t at full width,
   depth 2 + 2, on the card against the CPU from the same f32 masters: in
   f32 the loss, gradients and updated params, in bf16 (``matmul_f32``'s
   autograd function on the card) the loss and gradients (TWIN_*), and
   that autograd function's backward alone at 12b's logits and attention
   shapes against the CPU's f32 products, a planted bf16-cotangent
   backward failing the same rules (BWD_F32_RTOL); (d)
   ``train_loop`` on the card with a failure before and one after its
   first checkpoint, and a run resumed by a second: the final params of
   each equal an uninterrupted run's bit for bit; (e) ``python -m
   repro_torch.launch.train --arch gemma3-1b --full --steps 20`` and
   ``--arch seamless-m4t-large-v2 --smoke``, each exiting 0 with a
   falling loss.  The paths launch none of the five kernels;
13. the tooling slice: (a) the dry run (``repro_torch.launch.dryrun``, on
   the ``meta`` device) of 13b's cells, TOOL_DECODE whole and TOOL_CUT cut
   in batch (those two counted in a niced background process, started
   before phase 10, that sees no card), each under 72 GB, and
   ``dryrun_bcpnn`` on the pod and multipod meshes, each record and its
   roofline at the H100's peaks printed; (b) each cell's step on the card:
   its ``FlopCounterMode`` count equal to the dry run's (at the dry run's
   depths where it extrapolated), its peak memory at least its arguments'
   bytes and at most TOOL_MEM_SLACK x the dry run's peak, its device time
   at least the roofline's bound / TOOL_SHARE_MAX; (c) one rank of
   bcpnn_xl (55,296 x 8,192, hypercolumns 256 wide) at the pod rank's 1,024
   rows and the multipod rank's 512, one shard_map hidden step through a
   one-rank NCCL group against the same step with ``use_kernels=False``,
   timed against the dry run's per-device terms, and each of its three
   kernels against its plain version at its shape, timed beside its
   bound and the library call; (d) the deprecated ``ServeSession`` on
   13b's gemma3-1b: its tokens equal ``DecodePlan``'s up to the first
   near-tie; (e) the deprecated ``Network.fit(engine="scan")`` on phase 4's
   configuration, 1 + 1 epochs: states, scores and accuracy equal the
   compiled fit's bit for bit;
14. print one ``{"kernels": [...]}`` line, then, last, the ``{"ok": true,
   ...}`` line.

Without a CUDA device, or away from the rest of the repository, it exits
non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import shutil
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
STATE_MANTISSA = 7  # bf16, the state tier of the fused path
REPS = 20
# Phase 3's gathered masked_matmul: the hidden product at the STL-10 width
# (27,648 two-unit input HCUs, 20 x 150 hidden, 1,024 input HCUs kept a
# hidden HCU) at a training batch's and predict's rows.
STL_PRE_HCU, STL_HIDDEN, STL_FAN_IN, STL_ROWS = 27648, (20, 150), 1024, (B, P)
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
# The launcher's --online path (phase 7d, repro_torch/launch/serve.py:
# serve_online): 32 features complementary-coded (F = 64) -> 4x8 hidden
# with fan_in 16 -> 4 classes.  It trains in batches and projection chunks
# of 64 rows, adapts the readout through the frozen hidden layer in
# feedback micro-batches of 4 rows, and infers one row at a time.
ONLINE_F, ONLINE_HIDDEN, ONLINE_FAN_IN, ONLINE_CLASSES = 64, (4, 8), 16, 4
# Phase 7: the LM zoo's dense decoder, gemma3-1b as published (26 layers,
# d_model 1152, 4 q heads over one kv head of 256, geglu 6912, vocab
# 262144, a local window of 512 with every 6th layer global), bf16, random
# weights from torch.Generator seed 0, prompts from default_rng(7).  The
# 520 and 700 prompts cross the window.
DEC_ARCH = "gemma3-1b"
DEC_MAX_BATCH, DEC_MAX_SEQ, DEC_NEW, DEC_EOS_STEP = 4, 1024, 16, 5
DEC_BUCKETS = (64, 128, 256, 512, 768)
DEC_LENGTHS = (5, 17, 60, 64, 130, 300, 520, 700)
DEC_FORWARD_CHECK = (60, 700)  # prompts whose decode logits are held against forward's
DEC_STEP_SLOTS = (1, 2, 4)  # a step's slots, all active (idle slots ride along all the same)
DEC_REPS = 5  # graph replays of a prefill or a decode step, each milliseconds long
# Near-ties: two computations of the same logits in other orders (other
# GEMM shapes: one slot or four, a padded prompt or an exact one, the card
# or the CPU) whose logits differ by at most E can pick different tokens
# only where a run's top-two logits are closer than 2E.  Tokens are
# compared up to the first step closer than NEAR_TIE, and the slot-batched
# logits are held within NEAR_TIE / 2 of the single-slot ones on every row
# of the same inputs, so the token gate is sound.  bf16 orders were read
# 0.027 apart at most on an H100 (PERF.md §6).
NEAR_TIE = 2.0 ** -3
# MoE routing in bf16 (phase 10): two orders of one bf16 model (other GEMM
# shapes) route a token differently only at a near-tie of its router
# probabilities.  A router logit near 1 moves by a bf16 ulp (2^-7) at each
# rounding, and a relative gap between two probabilities is about the gap
# between their logits, so a flip's gap stays within a few ulps;
# MOE_BF16_ROUTE_RTOL bounds it with room.  A flipped token's row leaves
# the logit gates (``route_diffs``).
MOE_BF16_ROUTE_RTOL = 2.0 ** -4
# ... and where the model's own bf16 drift is larger (moonshot's 48 layers:
# two prefills of one prompt at other GEMM shapes, routing replayed, land
# 0.15 apart in the logits and 0.10 apart in the router's probabilities, on
# an H100), the MoE forward check's bounds are MOE_DRIFT_FACTOR x that
# drift: the decode path may be no further from forward than twice what
# the model's own GEMM shapes move it.
MOE_DRIFT_FACTOR = 2.0
# prefill + decode logits against forward's over the whole sequence, bf16:
# max |difference| at most this share of the logits' standard deviation.
DEC_FORWARD_TOL = 2.0 ** -3
# matmul_f32 on the card against the f32 product of widened operands:
# |difference| at most this share of |a| @ |b| (f32 sums of at most 1152
# exact products in another order: ~sqrt(1152) x 2^-24 ~ 2e-6 typical).
MATMUL_F32_RTOL = 1e-5
# 7b: depth 6 at full width in f32, the card against the CPU.
DEC_F32_LAYERS, DEC_F32_LENGTHS, DEC_F32_NEW, DEC_F32_TOL = 6, (60, 520, 700), 8, 1e-4
DEC_ASYNC_CLIENTS, DEC_ASYNC_REQUESTS = 4, 16
DEC_FLEET_REQUESTS, DEC_FLEET_CRASH_AT = 16, 4


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def launches_equal(counts, want) -> bool:
    """Exact launch counts: ``want`` names some of ``ops.launch_counts()``'s
    counters (a kernel, or a kernel's datapath mode as "<kernel>.datapath");
    every counter it leaves out must be 0."""
    return set(want) <= set(counts) and all(counts[k] == want.get(k, 0) for k in counts)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, flush, reps: int = REPS) -> float:
    """Device time of one call of ``fn``, without the host's launch overhead.

    ``reps`` calls, each after an L2 flush (a read of 64 MB: the main path meets
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
            for _ in range(reps):
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
    return max(replay_ms(both) - replay_ms(flushes), 0.0) / reps


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
    # The serving path's rows (phase 5): bucket-padded chunks, single rows
    # and streaming flushes, each a view at an odd row offset of a larger
    # block.
    rows, cont = serving_rows(), continual_rows()
    hidden_rows = sorted(set(rows["hidden"]) | set(cont["hidden"]))
    most = max(hidden_rows)
    x_s = uniform(most + 1, F)[1:]
    h_s = codes(most, n_hcu, n_mcu)
    s_sh, s_sr = 4 * normal(most, H), 4 * normal(most, N_CLASSES)
    # The --online launcher's shapes (phase 7d), each a view at an odd row
    # offset of a larger block.
    on, (hcu_o, mcu_o) = online_rows(), ONLINE_HIDDEN
    F_o, H_o, C_o = ONLINE_F, hcu_o * mcu_o, ONLINE_CLASSES
    most_o = max(on["hidden"])
    x_o = uniform(most_o + 1, F_o)[1:]
    h_o = codes(most_o, hcu_o, mcu_o)
    s_o, s_or = 4 * normal(most_o, H_o), 4 * normal(most_o, C_o)
    mask_o = unit_mask(F_o // 2, 2, hcu_o, mcu_o, ONLINE_FAN_IN)
    w_om, b_o = normal(F_o, H_o) * mask_o, 0.1 * normal(H_o)
    w_or, b_or = normal(H_o, C_o), 0.1 * normal(C_o)
    ci_o, cj_o = 0.25 + 0.5 * uniform(F_o), 0.02 + 0.04 * uniform(H_o)
    cij_o = (ci_o[:, None] * cj_o[None, :]) * torch.exp(normal(F_o, H_o))
    ci_or, cj_or = 0.02 + 0.04 * uniform(H_o), 0.2 + 0.05 * uniform(C_o)
    cij_or = (ci_or[:, None] * cj_or[None, :]) * torch.exp(normal(H_o, C_o))
    onehot_o = torch.nn.functional.one_hot(
        torch.randint(0, C_o, (most_o,), generator=g, device=dev), C_o).float()

    def half(*ts):  # a model rank's columns of phase 9's (1, 2) mesh
        return [t[..., :t.shape[-1] // 2].contiguous() for t in ts]

    def means_case(ai, aj, ci, cj, cij, m, tail):
        # The reduced-means mode: the means of the batch (on one rank of
        # phase 9, the all-reduced means), against its plain version and
        # beside the f32 update from the batch itself on the same traces.
        (rows, f), h = ai.shape, aj.shape[1]
        mi, mj = ai.mean(0), aj.mean(0)
        mij = (ai.T @ aj) / rows
        mp = bk.means_plan(f, h, mk.n_sm(dev))
        return dict(
            label=(f"means mi({f}) mj({h}) mij({f},{h}){' masked' if m is not None else ''}{tail} "
                   f"[plan TH={mp.th} TR={mp.tr} {mp.ctas} CTAs]"),
            kernel=lambda: bk.bcpnn_update_means(mi, mj, mij, ci, cj, cij, lam, k_b=k_b, mask=m),
            plain=lambda: ref.bcpnn_update_means(mi, mj, mij, ci, cj, cij, lam, k_b=k_b, mask=m),
            f32=update(bk.bcpnn_update, ai, aj, ci, cj, cij, m),
            n_bytes=4 * ((5 if m is not None else 4) * f * h + 3 * f + 4 * h),
            n_flops=(7 if m is not None else 6) * f * h)

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

    def gm_case(a, w, b, hm, um):
        # the gathered variant against the plain product over the expanded
        # mask; its bound counts what bench/harness/counts.py:Forward counts
        # (x once, the kept rows of w, the HCU mask, the bias, the output)
        (rows, k), n = a.shape, w.shape[1]
        (n_pre, n_post), mcu, kept = hm.shape, n // hm.shape[1], 2 * STL_FAN_IN
        p = mk.plan(rows, k, n, mk.n_sm(dev), kept, mcu)
        kw = dict(hcu_mask=hm, pre_mcu=2, post_mcu=mcu, fan_in=STL_FAN_IN)
        return (f"x({rows},{k}) @ w({k},{n}) kept {kept} of {k} a hidden HCU "
                f"[plan {p.config} CL={p.cl} {p.ctas} CTAs]",
                lambda: ops.masked_matmul(a, w, b, **kw),
                lambda: ref.masked_matmul(a, w, b, um),
                lambda: torch.matmul(a, w * um) + b,
                f32 * (rows * k + kept * n + n + n_pre * n_post + rows * n),
                2 * rows * kept * n + rows * n)

    def stl_inputs():
        n_hcu_s, n_mcu_s = STL_HIDDEN
        hm = torch.stack([torch.randperm(STL_PRE_HCU, generator=g, device=dev) < STL_FAN_IN
                          for _ in range(n_hcu_s)]).T.float().contiguous()
        um = ref.unit_mask(hm, 2, n_mcu_s).contiguous()
        w = normal(2 * STL_PRE_HCU, n_hcu_s * n_mcu_s) * um
        b = 0.1 * normal(n_hcu_s * n_mcu_s)
        return [(uniform(m, 2 * STL_PRE_HCU), w, b, hm, um) for m in STL_ROWS]

    def lists_case(hm):
        # the gathered variant's kept lists, built on the device from the
        # STL-10 mask as a rewiring's new mask builds them (the cache
        # forgotten first): each list's head against the plain version (the
        # kernel leaves the tail unwritten), then the build timed, its
        # counts checked; the bound counts the mask read, the heads and
        # the counts written
        def build():
            mk._kept.clear()
            return mk.kept_lists(hm)

        kept, counts = build()
        want_kept, want_counts = ref.kept_lists(hm)
        head = torch.arange(kept.shape[1], device=dev)[None, :] < counts[:, None]
        check(torch.equal(counts, want_counts)
              and torch.equal(torch.where(head, kept, 0), want_kept),
              "masked_matmul: the kept lists differ from ref.kept_lists")
        (n_pre, n_post), kept_n = hm.shape, int(counts.sum())
        return (f"kept lists of hcu_mask({n_pre},{n_post}), {kept_n // n_post} a hidden HCU",
                lambda: build()[1], lambda: ref.kept_lists(hm)[1], None,
                f32 * (n_pre * n_post + kept_n + n_post), 0, (0.0, 0.0))

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

    def state_round(label, t):
        # The state tier's rounding of an initial trace at compile (bf16,
        # mantissa 7); integer operations, so the bound counts bytes alone.
        return (f"{label} {tuple(t.shape)}, mantissa {STATE_MANTISSA} (state tier, compile)",
                lambda: bfk.bf_round(t, STATE_MANTISSA),
                lambda: ref.bf_round(t, STATE_MANTISSA),
                None, 8 * t.numel(), 0)

    # The datapath modes at bf20: each against its plain version by
    # stage_rule, timed beside the same kernel's f32 mode on the same inputs.
    dm, dp_rows = DATAPATH_MANTISSA, datapath_rows()
    dp_trace_tol, dp_log_tol = (1e-5, 1e-8), (1e-5, 1e-6)

    def at_rows(m):  # (hidden a_i, head a_i, hidden s, head s) of m rows
        if m == B:
            return x, h, s_h, s_r[:B]
        if m == P:
            return x_p, h_p, s_p, s_r
        return x_s[:m], h_s[:m], s_sh[:m], s_sr[:m]

    def mode(case, kernel, plain, f32_mode, stages):
        label, _, _, _, n_bytes, n_flops = case[:6]
        return dict(label=f"{label}, datapath mode, mantissa {dm}", kernel=kernel, plain=plain,
                    f32=f32_mode, n_bytes=n_bytes, n_flops=n_flops, stages=stages)

    def mm_mode(a, w, b, m, gain_):
        return mode(mm_case(a, w, b, m),
                    lambda: ops.masked_matmul(a, w, b, mask=m, round_mantissa=dm, gain=gain_),
                    lambda: ref.masked_matmul(a, w, b, mask=m, round_mantissa=dm, gain=gain_),
                    lambda: ops.masked_matmul(a, w, b, mask=m),
                    lambda got, want: [stage_rule(torch, f"support, gain {gain_}", got[0],
                                                  want[0], dm, GEMM_TOL)])

    def sm_mode(s, hcu, mcu):
        return mode(sm_case(s, hcu, mcu),
                    lambda: ops.hcu_softmax(s, hcu, mcu, round_mantissa=dm),
                    lambda: ref.hcu_softmax(s, hcu, mcu, round_mantissa=dm),
                    lambda: ops.hcu_softmax(s, hcu, mcu),
                    lambda got, want: [stage_rule(torch, "softmax", got[0], want[0], dm,
                                                  SOFTMAX_TOL)])

    def update_stages(got, want, m, trace_mantissa):
        # The traces by the rule; w and bias by it too, with what traces
        # that rounded apart carry into their logs.
        out = [stage_rule(torch, name, g, w, trace_mantissa, dp_trace_tol)
               for name, g, w in zip(("c_i", "c_j", "c_ij"), got, want)]
        dlog = [(torch.log(g.double().clamp_min(STREAM_EPS))
                 - torch.log(w.double().clamp_min(STREAM_EPS))).abs().cpu()
                for g, w in zip(got[:3], want[:3])]
        carry_w = dlog[2] + dlog[0][:, None] + dlog[1][None, :]
        if m is not None:
            carry_w = carry_w * m.double().cpu()
        out.append(stage_rule(torch, "w", got[3], want[3], dm, dp_log_tol, carry=carry_w))
        out.append(stage_rule(torch, "bias", got[4], want[4], dm, dp_log_tol, carry=k_b * dlog[1]))
        return out

    def up_mode(case, ai, aj, ci, cj, cij, m, state=None):
        kw = {} if state is None else dict(state_mantissa=state, state_dtype=torch.bfloat16)
        plain_kw = {} if state is None else dict(state_mantissa=state)
        return mode(case,
                    update(bk.bcpnn_update, ai, aj, ci, cj, cij, m, datapath_mantissa=dm, **kw),
                    update(ref.bcpnn_update, ai, aj, ci, cj, cij, m, datapath_mantissa=dm,
                           **plain_kw),
                    update(bk.bcpnn_update, ai, aj, ci, cj, cij, m, **kw),
                    lambda got, want: update_stages(got, want, m, min(dm, state or 23)))

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

    def update_at(ai, aj, ci, cj, cij, m, tail):  # any f32 update, masked or not
        (rows, f), h = ai.shape, aj.shape[1]
        return (f"ai({rows},{f}) aj({rows},{h}) cij({f},{h}){' masked' if m is not None else ''}"
                f"{tail}" + up_plan(ai, aj),
                update(bk.bcpnn_update, ai, aj, ci, cj, cij, m),
                update(ref.bcpnn_update, ai, aj, ci, cj, cij, m),
                None,
                4 * (rows * f + rows * h + 2 * f + 3 * h + (4 if m is not None else 3) * f * h),
                2 * rows * f * h + (7 if m is not None else 6) * f * h)

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
    stl = stl_inputs()
    specs = [
        dict(
            name="masked_matmul",
            source="src/repro_torch/kernels/csrc/masked_matmul.cu",
            replaces="src/repro/kernels/masked_matmul.py:47 (masked_matmul; pallas_call :80)",
            tol=(1e-4, 1e-5),
            cases=[mm_case(*c) for c in (
                (x, w_h, b_h, mask), (x_p, w_h, b_h, mask), (h_p, w_r, b_r, None),
                *((x_s[:m], w_h, b_h, mask) for m in hidden_rows),
                *((h_s[:m], w_r, b_r, None) for m in rows["head"]),
                # the --online launcher (phase 7d)
                *((x_o[:m], w_om, b_o, mask_o) for m in on["hidden"]),
                *((h_o[:m], w_or, b_or, None) for m in on["head"]),
                # phase 9's model-rank shard, H / 2 units (a batch rank's
                # B / 2 = 64 rows are a served chunk above)
                (x, *half(w_hm, b_h, mask)))]
            # the gathered variant at the STL-10 width, and its kept lists
            + [gm_case(*c) for c in stl] + [lists_case(stl[0][3])],
            # the datapath's support through both layers (gain 4 on the
            # hidden layer, 1 on the head) at every row count it takes
            modes=[mm_mode(*c) for m in dp_rows["forward"] for c in (
                (at_rows(m)[0], w_h, b_h, mask, gain), (at_rows(m)[1], w_r, b_r, None, 1.0))],
        ),
        dict(
            name="hcu_softmax",
            source="src/repro_torch/kernels/csrc/hcu_softmax.cu",
            replaces="src/repro/kernels/hcu_softmax.py:34 (hcu_softmax; pallas_call :62)",
            tol=SOFTMAX_TOL,
            cases=[sm_case(*c) for c in (
                (s_h, n_hcu, n_mcu), (s_p, n_hcu, n_mcu), (s_r, 1, N_CLASSES),
                *((s_sh[:m], n_hcu, n_mcu) for m in hidden_rows),
                *((s_sr[:m], 1, N_CLASSES) for m in rows["head"]),
                # the --online launcher (phase 7d)
                *((s_o[:m], hcu_o, mcu_o) for m in on["hidden"]),
                *((s_or[:m], 1, C_o) for m in on["head"]),
                # phase 9's model-rank shard
                (half(s_h)[0], n_hcu // 2, n_mcu))],
            modes=[sm_mode(*c) for m in dp_rows["forward"] for c in (
                (at_rows(m)[2], n_hcu, n_mcu), (at_rows(m)[3], 1, N_CLASSES))],
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
                # the --online launcher (phase 7d): its hidden layer's fit, its
                # readout's fit and continual update
                *(update_at(x_o[:m], h_o[:m], ci_o, cj_o, cij_o, mask_o, ", --online")
                  for m in on["update"]),
                *(update_at(h_o[:m], onehot_o[:m], ci_or, cj_or, cij_or, None, ", --online")
                  for m in on["readout_update"]),
            ],
            # the reduced-means mode (phase 9's learning cycle) at the hidden
            # layer, a model rank's half of it and the readout
            means=[
                means_case(x, h, ci_h, cj_h, cij_h, mask, ""),
                means_case(x, half(h)[0], ci_h, *half(cj_h, cij_h, mask), ", a model rank's half"),
                means_case(h, onehot, ci_r, cj_r, cij_r, None, ", readout"),
            ],
            # the datapath's learning cycle of both layers at a training
            # batch; the hidden one also with the bf16 state tier (off the
            # main path)
            modes=[
                up_mode(update_case(B), x, h, ci_h, cj_h, cij_h, mask),
                up_mode((f"ai({B},{F}) aj({B},{H}) cij({F},{H}) masked, bf16 state, mantissa 7",
                         None, None, None,
                         f32 * (B * F + B * H + 2 * F * H + 2 * H) + 2 * (2 * F * H + 2 * F + 2 * H),
                         2 * B * F * H + 7 * F * H),
                        x, h, *bf, mask, state=STATE_MANTISSA),
                up_mode(readout_case(B), h, onehot, ci_r, cj_r, cij_r, None),
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
                (f"cij({F},{H}), mantissa {STATE_MANTISSA}",
                 lambda: bfk.bf_round(cij_h, STATE_MANTISSA),
                 lambda: ref.bf_round(cij_h, STATE_MANTISSA), lambda: cij_h.to(torch.bfloat16),
                 8 * F * H, 0),
                (f"cij({F},{H}), mantissa {DATAPATH_MANTISSA}",
                 lambda: bfk.bf_round(cij_h, DATAPATH_MANTISSA),
                 lambda: ref.bf_round(cij_h, DATAPATH_MANTISSA), None, 8 * F * H, 0),
                (f"{len(specials)} specials, mantissa {STATE_MANTISSA} and {DATAPATH_MANTISSA}",
                 lambda: (bfk.bf_round(specials, STATE_MANTISSA),
                          bfk.bf_round(specials, DATAPATH_MANTISSA)),
                 lambda: (ref.bf_round(specials, STATE_MANTISSA),
                          ref.bf_round(specials, DATAPATH_MANTISSA)),
                 None, 2 * 8 * len(specials), 0),
                # The other traces the state tier rounds at compile.
                *(state_round(*c) for c in (
                    ("c_i", ci_h), ("c_j", cj_h), ("readout c_ij", cij_r), ("readout c_i", ci_r),
                    ("readout c_j", cj_r))),
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
        rec = dict(name=spec["name"], route="cuda", source=spec["source"],
                   replaces=spec["replaces"], max_abs_err=worst_abs, **timed, **extra, cases=cases)
        if "modes" in spec:
            rec["modes"] = {"datapath": mode_checks(torch, spec["name"], spec["modes"], flush)}
        if "means" in spec:
            rec["modes"]["means"] = means_checks(torch, spec["name"], spec["means"], flush)
        records.append(rec)
    return records


def means_checks(torch, name, cases, flush):
    """Phase 3 for the update's reduced-means mode: each case against its
    plain version at the f32 update's tolerance (the same means in; the
    EWMA and the logs in another order of operations), then the mode, the
    plain version and the f32 update from the batch on the same traces
    timed.  No single PyTorch call computes it (library_ms null)."""
    out = []
    for c in cases:
        got, want = c["kernel"](), c["plain"]()
        torch.cuda.synchronize()
        max_abs, max_rel = compare(torch, got, want, (1e-4, 1e-5))
        ms = device_ms(torch, c["kernel"], flush)
        plain_ms = device_ms(torch, c["plain"], flush)
        f32_ms = device_ms(torch, c["f32"], flush)
        bms, bound_by = bound_ms(c["n_bytes"], c["n_flops"])
        print(f"check {name} {c['label']}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
              f"(tol (1e-4, 1e-5)) kernel_ms={ms:.5f} f32_update_ms={f32_ms:.5f} "
              f"versus_ms={plain_ms:.5f} library_ms=null bound_ms={bms:.5f} ({bound_by})")
        out.append(dict(ms=ms, f32_update_ms=f32_ms, plain_ms=plain_ms, bound_ms=bms,
                        bound_by=bound_by, library_ms=None, at=c["label"], max_abs_err=max_abs,
                        max_rel_err=max_rel))
    return dict(out[0], cases=out)


def mode_checks(torch, name, modes, flush):
    """Phase 3 for a kernel's datapath mode: each case against its plain
    version by its stages' ``stage_rule``, then the mode, the plain version
    and the same kernel's f32 mode on the same inputs timed.  Returns the
    first (the main path's) case's figures and every case's."""
    cases = []
    for c in modes:
        got, want = c["kernel"](), c["plain"]()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        held = c["stages"](got, want)
        apart, n = sum(a for a, _ in held), sum(n for _, n in held)
        max_abs = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        ms = device_ms(torch, c["kernel"], flush)
        plain_ms = device_ms(torch, c["plain"], flush)
        f32_ms = device_ms(torch, c["f32"], flush)
        bms, bound_by = bound_ms(c["n_bytes"], c["n_flops"])
        print(f"check {name} {c['label']}: {apart} of {n} elements a format ulp apart "
              f"(stage_rule), max_abs_err={max_abs:.3e} kernel_ms={ms:.5f} "
              f"f32_mode_ms={f32_ms:.5f} versus_ms={plain_ms:.5f} library_ms=null "
              f"bound_ms={bms:.5f} ({bound_by})")
        cases.append(dict(ms=ms, f32_mode_ms=f32_ms, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=bound_by, library_ms=None, at=c["label"],
                          max_abs_err=max_abs, ulp_apart=apart, elements=n))
    return dict(cases[0], cases=cases)


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
    compiled = net.compile(core.ExecutionConfig(**{"engine": "scan", "device": device, **cfg}))
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


def batch_launches(torch, ops, fn):
    """What one call of ``fn`` launches on the card: the repository's
    kernels by their counters (modes included), and every device operation
    (CUDA kernels, copies and fills) as ``torch.profiler`` records it, None
    when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    ops.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    ours = sum(v for k, v in counts.items() if "." not in k)
    device_ops = sum(e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events())
    return dict(kernels=ours, device_ops=device_ops or None)


def batch_device_ms(torch, ops, card_nets, x, y, dev):
    """Device ms of one training batch of each path (``device_ms``: CUDA
    graph replays with an L2 flush before each), on the trained card
    network's states at the main path's shapes: the hidden layer's
    ``train_batch`` and, for the datapath, the readout's; and what each such
    batch launches (``batch_launches``).  The hidden step counters are past
    a rewiring batch, so no rewiring is timed."""
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    xb = torch.as_tensor(x[:B], device=dev)
    yb = torch.as_tensor(y[:B], device=dev)
    out, launched = {}, {}
    for path in ("unfused_f32", "fused_bf16", "datapath_bf20"):
        net = card_nets[path]
        (hidden, readout), (hs, rs) = net.layers, net.state.layers
        check(hs.host_step % hidden.mask_update_every != 0, f"{path}: a rewiring batch")
        steps = {"hidden": lambda: hidden.train_batch(hs, xb)}
        if path == "datapath_bf20":
            hb = hidden.forward(hs, xb)
            steps["readout"] = lambda: readout.train_batch(rs, hb, yb)
        for layer, fn in steps.items():
            out[f"{path}/{layer}"] = device_ms(torch, fn, flush)
            launched[f"{path}/{layer}"] = batch_launches(torch, ops, fn)
    return out, launched


def stage_rule(torch, label, got, want, mantissa, tol, carry=0.0):
    """A datapath stage's output against another computation of it on the
    same inputs (the card's against the CPU's, or a kernel's datapath mode
    against its plain version), by the rule of
    ``tests/test_torch_datapath.py``: every element within one ulp of the
    format at |want| plus the stage's f32 tolerance (rtol * |want| +
    atol_rel * max|want|) plus ``carry`` (what inputs that rounded apart
    carry into it, per element), and at most 1% of the elements (at least
    one) without a carry beyond the f32 tolerance, i.e. rounded to a
    neighbour after an f32 sum in another order.  Returns that count and
    the size."""
    g = got.detach().to("cpu", torch.float64)
    w = want.detach().to("cpu", torch.float64)
    check(g.shape == w.shape, f"datapath stage {label}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    check(bool(torch.isfinite(g).all()), f"datapath stage {label}: not finite on the card")
    rtol, atol_rel = tol
    carry = torch.as_tensor(carry, dtype=torch.float64).expand_as(w)
    diff = (g - w).abs()
    f32 = rtol * w.abs() + atol_rel * float(w.abs().max())
    exponent = torch.frexp(torch.maximum(g.abs(), w.abs())).exponent
    ulp = torch.ldexp(torch.ones_like(w), exponent - 1 - mantissa)
    bad = diff > ulp + f32 + carry
    n_bad = int(bad.sum())
    check(n_bad == 0, f"datapath stage {label}: {n_bad} elements beyond one ulp + tolerance, "
          f"worst {float(diff[bad].max()) if n_bad else 0.0:.3e}")
    apart = int(((diff > f32) & (carry == 0)).sum())
    check(apart <= max(1, 0.01 * diff.numel()),
          f"datapath stage {label}: {apart} of {diff.numel()} elements a format ulp apart")
    return apart, diff.numel()


def datapath_stages(torch, ops, policy, compiled, x, y, dev):
    """One datapath training batch of each layer, hidden then readout, on
    the card against the same on the CPU from the card's trained state,
    stage by stage: each stage gets the CPU's output of the stage before it
    on both sides, so a difference is the stage's own.  The stages are
    those of ``precision/policy.py``, on the card through the kernels'
    datapath modes: the support (product, bias, gain; ``masked_matmul``),
    the softmax (``hcu_softmax``), the learning cycle's traces, and w and
    bias (one ``bcpnn_update``), the last two held against the CPU's stage
    on the card's own traces.  The readout's
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
        a_card, a_cpu = both(lambda s: ops.hcu_softmax(s, layout.n_hcu, layout.n_mcu,
                                                       round_mantissa=mant), s_cpu)
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


def listing1(core, data, policy):
    """The paper's Listing 1 at MNIST width: the data split, the network,
    the fit options and the four paths (path -> (ExecutionConfig options,
    fit options)) of phases 4 and 8."""
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
    paths = {
        "unfused_f32": (dict(), dict()),
        "fused_bf16": (dict(fused_phase=True,
                            precision=policy.PrecisionPolicy.named("fp32", state_format="bf16")),
                       dict()),
        "datapath_bf20": (dict(precision="bf20"), dict()),
        "sgd_readout": (dict(), dict(readout="sgd")),
    }
    return net, split, fit_kw, paths


def main_path(torch, ops, core, data, policy, devices=("cuda", "cpu")):
    """Phase 4: Listing 1 at MNIST width on four paths, each on the card
    (launches counted from zero at its compile) and then on the CPU, then
    the card alone at three more datapath formats."""
    net, split, fit_kw, paths = listing1(core, data, policy)
    x, y, xt, _ = split
    batches = len(x) // B

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
    for path, counts in launches.items():
        modes = {k: v for k, v in counts.items() if k.endswith(".datapath")}
        check(path == "datapath_bf20" or not any(modes.values()),
              f"{path} launched a datapath mode: {modes}")
    check(fused["bcpnn_phase"] == hidden_batches,
          f"bcpnn_phase launched {fused['bcpnn_phase']} times, want {hidden_batches}")
    check(fused["bcpnn_update"] == readout_batches,
          f"bcpnn_update launched {fused['bcpnn_update']} times, want {readout_batches}")
    check(fused["bf_round"] >= 1, "bf_round was not launched at compile")
    for name in ("masked_matmul", "hcu_softmax"):
        check(fused[name] > 0, f"{name} was not launched on the fused path")
    check(runs["fused_bf16/card"]["hidden_trace_dtypes"] == ["torch.bfloat16"],
          f"hidden traces after fit: {runs['fused_bf16/card']['hidden_trace_dtypes']}")
    # The datapath: every stage rounded inside the kernel that makes it.
    # Every forward pair runs in its rounding mode (the gain inside
    # masked_matmul), every learning cycle (one a batch of each layer) is
    # one bcpnn_update in its datapath mode, and nothing else launches: no
    # bf_round (no state tier) and no fused phase.
    cycles = hidden_batches + readout_batches
    want_dp = {"masked_matmul": forwards["datapath_bf20"], "hcu_softmax": forwards["datapath_bf20"],
               "masked_matmul.datapath": forwards["datapath_bf20"],
               "hcu_softmax.datapath": forwards["datapath_bf20"],
               "bcpnn_update": cycles, "bcpnn_update.datapath": cycles}
    check(launches_equal(datapath, want_dp),
          f"datapath: launches {json.dumps(datapath)}, want {json.dumps(want_dp)}")
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

    stages = datapath_stages(torch, ops, policy, card_nets["datapath_bf20"], x, y,
                             torch.device(devices[0]))

    per_batch, per_batch_launches = batch_device_ms(torch, ops, card_nets, x, y,
                                                    torch.device(devices[0]))
    for key, ms in per_batch.items():
        print(f"device ms of one training batch, {key}: {ms:.5f}; launches "
              f"{json.dumps(per_batch_launches[key])}")
    per_batch = dict(device_ms=per_batch, launches=per_batch_launches)

    from repro_torch.runtime.epoch_engine import stack_epoch

    stage_s = epoch_staging_s(torch, stack_epoch, x, batches * B, torch.device(devices[0]))
    print(f"main path epoch staging (host gather + copy of {batches * B}x{x.shape[1]} f32, "
          f"{batches * B * x.shape[1] * 4 / 1e6:.1f} MB, part of each hidden epoch's host_s): "
          f"{stage_s:.4f} s")
    cliffs = dict(mnist_width=cliff, e2e=cliff_e2e)
    trained = dict(net=net, split=split, nets=card_nets, configs={p: c for p, (c, _) in paths.items()},
                   device=devices[0], fit_kw=fit_kw)
    return launches, runs, stage_s, cliffs, per_batch, stages, trained


def serving_rows():
    """The row counts phase 5 gives each kernel, by use: the batched plan's
    padded chunks (through the hidden layer and the head, on the datapath
    network in the forward pair's rounding mode), single-row inference and the
    streaming flushes, full and the tail on close (through the hidden
    layer; ``bcpnn_update`` on the unfused network, ``bcpnn_phase`` on the
    fused one).  One row is also taken through the head and the update: the
    smallest micro-batch the async engine forms and the smallest flush."""
    chunks = {padded for _, _, padded in served_chunks(SERVE_NS + (32, 32), SERVE_BUCKETS)}
    tail = STREAM_ROWS % STREAM_BATCH
    flushes = {STREAM_BATCH} | ({tail} if tail else set())
    return dict(hidden=sorted(chunks | flushes | {1}), head=sorted(chunks | {1}),
                datapath=sorted(chunks), update=sorted(flushes | {1}), flush=sorted(flushes))


def datapath_rows():
    """The row counts at which phases 4-5 launch the datapath modes: the
    forward pair at a training batch or projection chunk (B rows), at
    predict's chunk (P rows), at the batched plan's padded chunks
    (``serving_rows()["datapath"]``) and at one row, through both layers;
    the learning cycle at a training batch of each layer."""
    served = sorted(set(serving_rows()["datapath"]) | {1})
    return dict(forward=[B, P, *served], update=[B])


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


def online_rows():
    """The row counts the --online launcher gives each kernel (phase 7d):
    64-row training batches and projection chunks, 4-row feedback
    micro-batches and single rows through the hidden forward; single rows
    through the head; ``bcpnn_update`` on the hidden layer at 64 rows and
    on the readout at 64 (fit) and 4 (the continual update)."""
    return dict(hidden=[64, 4, 1], head=[1], update=[64], readout_update=[64, 4])


def online_keys():
    """(kernel, shape) of every launch phase 3 holds at the --online shapes,
    in the keys ``record_shapes`` gives."""
    rows, (n_hcu, n_mcu) = online_rows(), ONLINE_HIDDEN
    H = n_hcu * n_mcu
    keys = {("masked_matmul", (m, ONLINE_F, H, True)) for m in rows["hidden"]}
    keys |= {("masked_matmul", (m, H, ONLINE_CLASSES, False)) for m in rows["head"]}
    keys |= {("hcu_softmax", (m, n_hcu, n_mcu)) for m in rows["hidden"]}
    keys |= {("hcu_softmax", (m, 1, ONLINE_CLASSES)) for m in rows["head"]}
    keys |= {("bcpnn_update", (m, ONLINE_F, H)) for m in rows["update"]}
    keys |= {("bcpnn_update", (m, H, ONLINE_CLASSES)) for m in rows["readout_update"]}
    return keys


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
    product), on the datapath in the pair's rounding mode."""
    head_pairs = heads if path != "sgd_readout" else 0
    pairs = projections + head_pairs
    want = dict(masked_matmul=pairs, hcu_softmax=pairs)
    if path == "datapath_bf20":
        want.update({"masked_matmul.datapath": pairs, "hcu_softmax.datapath": pairs})
    return want


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
    check(launches_equal(counts, want), f"serve {path}: launches {counts}, want {want}")
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
    check(launches_equal(counts, want), f"serve async: launches {counts}, want {want}")
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
                bcpnn_update=0 if fused else flushes, bcpnn_phase=flushes if fused else 0)
    check(launches_equal(train_counts, want), f"stream {path}: launches {train_counts}, want {want}")

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
    want = dict(masked_matmul=STREAM_INFERS, hcu_softmax=STREAM_INFERS)
    check(launches_equal(infer_counts, want),
          f"stream {path} infer: launches {infer_counts}, want {want}")
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
    # Every kernel and mode the serving phase runs: the forward pair (in its
    # rounding mode on the datapath network) and the two update kernels.
    for name in ("masked_matmul", "hcu_softmax", "bcpnn_update", "bcpnn_phase",
                 "masked_matmul.datapath", "hcu_softmax.datapath"):
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
                bcpnn_phase=n["applied"] if fused_update else 0)
    check(projections == n_infer, f"continual {path}: {projections} projections for {n_infer} rows")
    check(launches_equal(counts, want),
          f"continual {path} layer {layer}: launches {counts}, want {want}")

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


# ------------------------------------------------------------------ phase 7
class LogitRecorder:
    """Stands for a model in a plain ``DecodePlan``: passes ``prefill`` and
    ``decode_step`` through to it and keeps, on the device, every call's
    logits beside its inputs.  The plan runs its own code unchanged;
    :meth:`logits` then finds each completion's rows by its inputs alone: its
    prefill by its prompt, its steps as the run of consecutive fused steps
    in which one slot was fed its tokens at its positions."""

    def __init__(self, torch, model):
        self.torch, self.model, self.device, self.cfg = torch, model, model.device, model.cfg
        self.prefills, self.steps = [], []
        self.placed = {}  # rid -> (its first fused step, its slot), set by logits()
        self.current = None  # the call in progress: ("prefill", i) or ("step", j)

    def cache_shapes(self, batch, seq):
        return self.model.cache_shapes(batch, seq)

    def init_cache(self, batch, seq):
        return self.model.init_cache(batch, seq)

    def prefill(self, batch):
        self.current = ("prefill", len(self.prefills))
        logits, cache = self.model.prefill(batch)
        self.prefills.append((batch["tokens"][0, :batch["last_pos"] + 1], logits[0]))
        return logits, cache

    def decode_step(self, cache, token, cur_len):
        self.current = ("step", len(self.steps))
        logits, cache = self.model.decode_step(cache, token, cur_len)
        self.steps.append((token[:, 0], cur_len, logits))
        return logits, cache

    def logits(self, done, prompts):
        """rid -> (tokens, logits (steps, V) f32) of the completions, each
        row the one its token was the argmax of."""
        import numpy as np

        torch = self.torch
        feeds = [(t.cpu().numpy(), c.cpu().numpy()) for t, c, _ in self.steps]
        out = {}
        for c in done:
            p = np.asarray(prompts[c.rid], np.int64)
            pre = [lg for t, lg in self.prefills
                   if len(t) == len(p) and np.array_equal(t.cpu().numpy(), p)]
            n_steps = len(c.tokens) - 1  # the first token is the prefill's
            runs = [(j, s) for j in range(len(feeds) - n_steps + 1)
                    for s in range(len(feeds[j][0]))
                    if all(feeds[j + k][1][s] == len(p) + k and feeds[j + k][0][s] == c.tokens[k]
                           for k in range(n_steps))]
            check(len(pre) == 1 and len(runs) == 1,
                  f"request {c.rid}: {len(pre)} prefills and {len(runs)} runs of steps fed it")
            j, s = runs[0]
            self.placed[c.rid] = (j, s)
            lg = torch.stack([pre[0]] + [self.steps[j + k][2][s] for k in range(n_steps)]).float()
            check(torch.equal(lg.argmax(-1).cpu(), torch.from_numpy(c.tokens).long()),
                  f"request {c.rid}: its tokens are not its logits' argmax")
            out[c.rid] = (c.tokens, lg)
        return out


def same_input_rows(a_tokens, b_tokens) -> int:
    """The logits rows two runs computed from the same inputs: up to and
    including the first step whose tokens differ."""
    import numpy as np

    differ = np.nonzero(np.asarray(a_tokens) != np.asarray(b_tokens))[0]
    return int(differ[0]) + 1 if len(differ) else len(a_tokens)


def first_tie(logits) -> int:
    """The first step whose top-two logit margin is under NEAR_TIE (the
    number of steps when none is)."""
    top2 = logits.topk(2, dim=-1).values
    ties = ((top2[:, 0] - top2[:, 1]) < NEAR_TIE).nonzero()
    return int(ties[0, 0]) if len(ties) else logits.shape[0]


def dec_requests(Request, prompts, new, n=None):
    """``n`` requests (one a prompt by default) cycling over ``prompts``."""
    n = len(prompts) if n is None else n
    return [Request(rid=i, prompt=prompts[i % len(prompts)], max_new_tokens=new)
            for i in range(n)]


def wall_ms(torch, fn, n=10):
    """Host clock per eager call, each synchronised: a served step's latency."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def enqueue_ms(torch, fn, n=10):
    """Host clock per eager call without a synchronise: the enqueue alone."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e3


def matmul_f32_on_card(torch, model, cfg, dev):
    """``matmul_f32``'s card branch (``torch.mm``/``torch.bmm`` with
    ``out_dtype=torch.float32`` on bf16 operands) against the f32 product of
    the widened operands, at the shapes phase 7 gives it: the logits of four
    slots (the tied table), the decode scores and PV of four slots over the
    whole cache, and the prefill's score and PV tiles at the 768 bucket.
    Both sum exact products in f32, so they differ by the order of the sums
    alone: |difference| <= MATMUL_F32_RTOL x (|a| @ |b|) elementwise, where
    an output rounded to bf16 would be off by up to 2^-9 of |a @ b|."""
    from repro_torch.models.common import matmul_f32

    g = torch.Generator(device=dev).manual_seed(3)
    kh, grp, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    qc, kc = min(cfg.q_chunk, DEC_BUCKETS[-1]), min(cfg.kv_chunk, DEC_BUCKETS[-1])

    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    def probs(*shape):  # p, as the products meet it: a softmax cast to bf16
        return torch.softmax(torch.randn(shape, generator=g, device=dev), -1).bfloat16()

    cases = {
        "logits (the tied table)": (rand(DEC_MAX_BATCH, 1, cfg.d_model),
                                        model.embed.table.T),
        "decode scores": (rand(DEC_MAX_BATCH, kh, grp, d), rand(DEC_MAX_BATCH, kh, d, DEC_MAX_SEQ)),
        "decode PV": (probs(DEC_MAX_BATCH, kh, grp, DEC_MAX_SEQ),
                      rand(DEC_MAX_BATCH, kh, DEC_MAX_SEQ, d)),
        "prefill score tile": (rand(1, kh, grp * qc, d), rand(1, kh, d, kc)),
        "prefill PV tile": (probs(1, kh, grp * qc, kc), rand(1, kh, kc, d)),
    }
    out = {}
    for name, (a, b) in cases.items():
        got = matmul_f32(a, b)
        want = torch.matmul(a.float(), b.float())
        scale = torch.matmul(a.float().abs(), b.float().abs())
        err = (got - want).abs()
        rel = float((err / scale.clamp_min(1e-30)).max())
        out[name] = dict(shape=[list(a.shape), list(b.shape)], max_abs=float(err.max()),
                         max_rel_to_abs_sum=rel)
        check(got.dtype == torch.float32 and rel <= MATMUL_F32_RTOL,
              f"7a: matmul_f32 {name} ({got.dtype}) {rel} of |a| @ |b| from the f32 product")
        del got, want, scale, err
    return out


class RouteLog:
    """While open, records every top-k routing of ``repro_torch.models.moe``
    (each MoE layer of a prefill or a decode step calls ``_topk`` once):
    the call in progress of ``rec`` (a LogitRecorder, or None), the full
    probabilities and the chosen ids, on the host.  Reading them back syncs
    the device, so only correctness runs and byte counts use it."""

    def __init__(self, rec=None):
        from repro_torch.models import moe

        self.moe, self.rec, self.calls = moe, rec, []

    def __enter__(self):
        real = self.real = self.moe._topk

        def logged(probs, k):
            top_p, top_i = real(probs, k)
            self.calls.append((self.rec.current if self.rec else None,
                               probs.detach().float().cpu(), top_i.cpu()))
            return top_p, top_i

        self.moe._topk = logged
        return self

    def __exit__(self, *exc):
        self.moe._topk = self.real


def routes(log, rec, prompts, n_steps):
    """A recorded plan's routing by request and logits row: (rid, row) ->
    [(ids (T, k), probabilities (T, E)) per MoE layer], row 0 holding the
    prefill's prompt tokens (pad tokens cut), row r >= 1 decode step r's
    token of that request (idle slots dropped)."""
    import numpy as np

    by = {}
    for call, probs, ids in log.calls:
        kind, i = call
        if kind == "prefill":
            toks = rec.prefills[i][0].cpu().numpy()
            rid = next(r for r, p in enumerate(prompts)
                       if len(p) == len(toks) and np.array_equal(p, toks))
            by.setdefault((rid, 0), []).append((ids[:len(toks)], probs[:len(toks)]))
            continue
        for rid, (j0, slot) in rec.placed.items():
            if j0 <= i < j0 + n_steps:
                by.setdefault((rid, i - j0 + 1), []).append(
                    (ids[slot:slot + 1], probs[slot:slot + 1]))
    return by


def route_gap(probs, chosen, other) -> float:
    """How far apart, relative, two top-k choices are in ``probs`` (E,):
    at the first place where the ids differ, the probability of the expert
    ``chosen`` took less that of the one ``other`` took, over the first.
    0 for an exact tie; negative when ``other``'s is the larger there."""
    j = int((chosen != other).nonzero()[0, 0])
    p_c, p_o = float(probs[chosen[j]]), float(probs[other[j]])
    return (p_c - p_o) / p_c


class RouteReplay:
    """While open, every top-k routing of ``repro_torch.models.moe`` takes
    the expert ids given for its call (``ids[i]``, (T', k) for the call's
    first T' tokens; later tokens keep their own choice), with this run's
    own probabilities of those experts.  Two computations of one model can
    then be compared with the same discrete routing: ``gaps`` records, for
    every token whose own choice differed, how near a tie the two choices
    were in this run's probabilities (``route_gap``)."""

    def __init__(self, ids):
        from repro_torch.models import moe

        self.moe, self.ids, self.calls, self.gaps = moe, list(ids), 0, []

    def __enter__(self):
        real = self.real = self.moe._topk

        def replay(probs, k):
            _, own = real(probs, k)
            want = own.clone()
            given = self.ids[self.calls].to(own.device)
            want[:len(given)] = given
            for t in (own != want).any(-1).nonzero()[:, 0].tolist():
                self.gaps.append(dict(call=self.calls, token=t, own=own[t].tolist(),
                                      replayed=want[t].tolist(),
                                      rel_gap=route_gap(probs[t], own[t], want[t])))
            self.calls += 1
            return probs.gather(-1, want), want

        self.moe._topk = replay
        return self

    def __exit__(self, *exc):
        self.moe._topk = self.real
        check(exc[0] is not None or self.calls == len(self.ids),
              f"replayed {self.calls} routing calls of {len(self.ids)}")


def route_diffs(torch, a, b, rtol, label, own_row=True, same=None):
    """Hold run a's routing against run b's, (rid, row) by (rid, row), as
    ``routes`` maps them, on the rows both runs fed the same tokens
    (``same``: rid -> that number of rows, ``same_input_rows``; all when
    None).  Where a token's expert ids differ, the two choices must be a
    near-tie in b's probabilities (``route_gap`` under ``rtol``), else the
    check fails.  Returns (the
    flips, rid -> the logits rows a flip excludes).  ``own_row``: a row is
    excluded when its own token flipped (row 0: the prompt's last token);
    otherwise a request's rows from its first flip on, wherever in the
    prompt or its steps that flip was (and the rest of that row's layers
    go unchecked: their inputs differ)."""
    flips, excluded = [], {}
    for key in sorted(a):
        rid, row = key
        if same is not None and row >= same[rid]:
            continue
        if not own_row and rid in excluded and row >= min(excluded[rid]):
            continue
        check(key in b and len(a[key]) == len(b[key]),
              f"{label}: request {rid} row {row} routed in one run only")
        for layer, ((ia, _), (ib, pb)) in enumerate(zip(a[key], b[key])):
            if own_row and row == 0:
                ia, ib, pb = ia[-1:], ib[-1:], pb[-1:]
            differ = (ia != ib).any(-1).nonzero()
            if len(differ) == 0:
                continue
            t = int(differ[0, 0])
            gap = route_gap(pb[t], ib[t], ia[t])
            check(gap < rtol, f"{label}: request {rid} row {row} MoE layer {layer} token {t}: "
                              f"experts {ia[t].tolist()} against {ib[t].tolist()}, "
                              f"{gap:.3g} apart (relative)")
            flips.append(dict(rid=rid, row=row, layer=layer, token=t, a=ia[t].tolist(),
                              b=ib[t].tolist(), rel_gap=gap))
            excluded.setdefault(rid, set()).add(row)
            break
    if not own_row:  # every row from the first flip on
        end = max(row for _, row in a) + 1
        excluded = {rid: set(range(min(rows), end)) for rid, rows in excluded.items()}
    return flips, excluded


def kept_rows(n, excluded):
    """The logits rows below n that no routing flip excluded."""
    return [r for r in range(n) if r not in excluded]


def forward_check(torch, model, prompts, sc, dev, new):
    """Each prompt through a single-slot plan over ``model`` (its prefill,
    then new - 1 decode steps), then one ``forward`` over the prompt and its
    decoded tokens that replays the plan's routing (each MoE layer's ids of
    the prompt, then of each decoded token; ``RouteReplay``): bf16 routing
    near-ties are dense enough that over 47 MoE layers every row flips
    somewhere, and one flip moves a row's logits by several percent of
    their spread.  Returns (prompt length, the plan's logits (new, V), the
    forward's at the same positions, the replay's gaps) a prompt."""
    import numpy as np

    from repro_torch.runtime import DecodePlan, Request, ServiceConfig

    rec = LogitRecorder(torch, model)
    with RouteLog(rec) as log:
        done = DecodePlan(rec, ServiceConfig(max_batch=1, **sc)).generate(
            dec_requests(Request, prompts, new))
    runs, routed = rec.logits(done, prompts), routes(log, rec, prompts, new - 1)
    out = []
    for rid, p in enumerate(prompts):
        toks, lg = runs[rid]
        n = len(p)
        seq = np.concatenate([p, toks[:-1]]).astype(np.int64)
        layers = len(routed.get((rid, 0), ()))
        ids = [torch.cat([routed[(rid, r)][layer][0] for r in range(len(toks))])
               for layer in range(layers)]
        with RouteReplay(ids) as replay:
            full, _ = model({"tokens": torch.from_numpy(seq)[None].to(dev)})
        out.append((n, lg, full[0, n - 1:].float().clone(), replay.gaps))
        del full
    return out


def gqa_step_bytes(model, cfg):
    """(S, the step) -> the bytes a dense GQA decode step of S slots reads at least:
    every weight (the tied table is the unembedding) and each slot's whole
    k/v cache (the step masks over all ``max_seq`` positions)."""
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cache_slot_bytes = 2 * cfg.n_layers * DEC_MAX_SEQ * cfg.n_kv_heads * cfg.d_head * 2
    return lambda S, step: weight_bytes + S * cache_slot_bytes


def decode_width(torch, model, cfg, dev, card, label="7a", twin=None, step_bytes=None,
                 host_reps=20, lengths=DEC_LENGTHS, forward_lengths=DEC_FORWARD_CHECK,
                 drift_factor=None):
    """Phase 7a (and 10a-b, 11a-c): a decoder at its published width,
    bf16, through ``serve_model``: the slot-batched plan against a
    single-slot plan, the decode against ``forward`` over the whole
    sequence (prompts ``forward_lengths``), bucketed against exact-length
    prefills, an EOS exit; then the prefill and decode-step times against
    the bytes' bound (``step_bytes(S)``).  ``twin`` (default: the model)
    serves the forward and bucketed checks: the same weights under a
    config whose MoE layers drop nothing; each replays the routing of the
    computation it is held to (``RouteReplay``), every replayed choice a
    near-tie of its own.  The plans keep a prefill cell for each prompt
    length (``cache_size``), so none is evicted.  ``drift_factor`` bounds
    the forward check by that many times the model's own drift between
    two prefill shapes where it is the larger (an MoE twin's is
    MOE_DRIFT_FACTOR)."""
    import numpy as np

    from repro_torch.runtime import DecodePlan, Request, ServiceConfig, serve_model

    twin = model if twin is None else twin
    step_bytes = step_bytes or gqa_step_bytes(model, cfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]
    sc = dict(plan="decode", max_seq=DEC_MAX_SEQ, buckets=DEC_BUCKETS,
              cache_size=max(8, len(lengths)))
    serve_model(model, ServiceConfig(max_batch=DEC_MAX_BATCH, **sc)).generate(
        dec_requests(Request, prompts, 2, n=1))  # warm-up: cuBLAS handles, the allocator
    svc = serve_model(model, ServiceConfig(max_batch=DEC_MAX_BATCH, **sc))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batched = sorted(svc.generate(dec_requests(Request, prompts, DEC_NEW)), key=lambda c: c.rid)
    wall = time.perf_counter() - t0
    n_tokens = sum(len(c.tokens) for c in batched)
    check([c.rid for c in batched] == list(range(len(prompts))),
          f"{label}: a request did not complete")
    for c in batched:
        check(c.prefill_len == len(prompts[c.rid]) and c.steps == DEC_NEW
              and len(c.tokens) == DEC_NEW, f"{label}: request {c.rid} completed as {c}")

    # The same slot-batched schedule and a single-slot plan, every logit
    # kept: plain plans over a recorder of the model's calls.  The recorded
    # slot-batched run repeats the served run's calls, so its tokens too.
    # An MoE layer's routing is discrete: where the two runs' bf16 orders
    # route a token differently (a near-tie, ``route_diffs``), that row's
    # logits are left out of the slot gates and the token gate stops there.
    runs, routed = {}, {}
    for name, slots in (("batched", DEC_MAX_BATCH), ("single", 1)):
        rec = LogitRecorder(torch, model)
        with RouteLog(rec) as log:
            done = DecodePlan(rec, ServiceConfig(max_batch=slots, **sc)).generate(
                dec_requests(Request, prompts, DEC_NEW))
        runs[name] = rec.logits(done, prompts)
        routed[name] = routes(log, rec, prompts, DEC_NEW - 1)
        del rec, done, log
    single = runs["single"]
    repeatable = all(np.array_equal(c.tokens, runs["batched"][c.rid][0]) for c in batched)
    check(repeatable, f"{label}: the recorded slot-batched run's tokens differ from the served run's")
    same = {rid: same_input_rows(runs["batched"][rid][0], single[rid][0]) for rid in single}
    slot_flips, slot_out = route_diffs(torch, routed["batched"], routed["single"],
                                       MOE_BF16_ROUTE_RTOL, label, same=same)
    ties = {rid: first_tie(lg) for rid, (_, lg) in single.items()}
    ends = {rid: min([ties[rid], *slot_out.get(rid, ())]) for rid in ties}
    slot_err, rows_compared = 0.0, 0
    for c in batched:
        k = ends[c.rid]
        check(np.array_equal(c.tokens[:k], single[c.rid][0][:k]),
              f"{label}: request {c.rid}: slot-batched tokens {c.tokens[:k]} != single-slot "
              f"{single[c.rid][0][:k]} before its first near-tie or routing flip (step {k})")
        (bt, bl), (st, sl) = runs["batched"][c.rid], single[c.rid]
        rows = kept_rows(same_input_rows(bt, st), slot_out.get(c.rid, ()))
        if rows:
            slot_err = max(slot_err, float((bl[rows] - sl[rows]).abs().max()))
        rows_compared += len(rows)
    check(slot_err <= NEAR_TIE / 2,
          f"{label}: slot-batched logits {slot_err} from single-slot ones, over NEAR_TIE / 2")
    compared = sum(min(ends[r], DEC_NEW) for r in ends)

    # bucketed against exact-length prefills, the bucketed one replaying
    # the exact one's routing: the first token equal off near-ties.  They
    # are two prefills of one prompt at other GEMM shapes, so how far apart
    # their logits and routing probabilities land is the model's own bf16
    # drift: the yardstick of the MoE forward check below.
    bucket_err, bucket_gap, bucket_ties, bucket_replayed = 0.0, 0.0, 0, 0
    for rid, p in enumerate(prompts):
        t = torch.from_numpy(p.astype(np.int64))[None].to(dev)
        m = next(b for b in DEC_BUCKETS if b >= len(p))
        padded = torch.nn.functional.pad(t, (0, m - len(p)))
        with RouteLog() as exact_log:
            exact = twin.prefill({"tokens": t})[0][0].float()
        with RouteReplay([ids for _, _, ids in exact_log.calls]) as replay:
            bucketed = twin.prefill({"tokens": padded, "last_pos": len(p) - 1})[0][0].float()
        bucket_replayed += len(replay.gaps)
        bucket_gap = max([bucket_gap] + [g["rel_gap"] for g in replay.gaps])
        bucket_err = max(bucket_err, float((bucketed - exact).abs().max()))
        top2 = exact.topk(2).values
        if float(top2[0] - top2[1]) < NEAR_TIE:
            bucket_ties += 1
            continue
        check(int(exact.argmax()) == int(bucketed.argmax()),
              f"{label}: prompt {len(p)}: the bucketed prefill's first token differs from the "
              "exact one")

    # prefill + decode steps against forward over the whole sequence, on
    # the twin.  An MoE model's bound is the larger of DEC_FORWARD_TOL x
    # std and MOE_DRIFT_FACTOR x the drift above (a Mamba-2 stack's,
    # SSM_DRIFT_FACTOR x it), and every replayed choice a near-tie of
    # forward's own within the larger of MOE_BF16_ROUTE_RTOL and
    # MOE_DRIFT_FACTOR x the prefills' largest gap.
    factor = MOE_DRIFT_FACTOR if twin is not model else drift_factor
    fwd_err = {}
    sub = [prompts[lengths.index(n)] for n in forward_lengths]
    for n, lg, want, gaps in forward_check(torch, twin, sub, sc, dev, DEC_NEW):
        err, std = float((lg - want).abs().max()), float(want.std())
        gap = max((g["rel_gap"] for g in gaps), default=0.0)
        tol = max(DEC_FORWARD_TOL * std, factor * bucket_err if factor else 0.0)
        gap_tol = max(MOE_BF16_ROUTE_RTOL, MOE_DRIFT_FACTOR * bucket_gap)
        fwd_err[n] = dict(max_abs=err, logit_std=std, ratio=err / std, tol=tol,
                          replayed_tokens=len(gaps), max_rel_gap=gap, gap_tol=gap_tol)
        check(gap < gap_tol, f"{label}: prompt {n}: a replayed routing {gap} apart from "
                             f"forward's own choice, over {gap_tol}")
        check(err <= tol, f"{label}: prompt {n}: prefill + decode logits {err} from forward's "
                          f"(std {std}, bound {tol})")

    # EOS: the token a request's undisturbed single-slot run first emits
    # at DEC_EOS_STEP (or the nearest step with a token new there) ends the
    # same request, served again by a single-slot plan (the same shapes, so
    # the same logits), at that step.
    cands = [(abs(k - DEC_EOS_STEP), rid, k, int(toks[k])) for rid, (toks, _) in single.items()
             for k in range(1, len(toks)) if toks[k] not in toks[:k]]
    check(bool(cands), f"{label}: no request emits a second distinct token")
    _, rid, step, tok = min(cands)
    done = serve_model(model, ServiceConfig(max_batch=1, **sc)).generate(
        [Request(rid=rid, prompt=prompts[rid], max_new_tokens=DEC_NEW, eos_id=tok)])
    check(len(done) == 1 and np.array_equal(done[0].tokens, single[rid][0][:step + 1])
          and done[0].steps == step + 1, f"{label}: the EOS request ended as {done}")

    # Times.  Device: CUDA-graph replays (device_ms); host: eager calls.
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    prefill_ms = {}
    for m in DEC_BUCKETS:
        t = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, m))).to(dev)

        def fn(t=t, m=m):
            return model.prefill({"tokens": t, "last_pos": m - 1})

        prefill_ms[m] = dict(device_ms=device_ms(torch, fn, flush, reps=DEC_REPS),
                             wall_ms=wall_ms(torch, fn, 5))
    step_ms = {}
    for S in DEC_STEP_SLOTS:
        caches = model.init_cache(S, DEC_MAX_SEQ)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (S, 1))).to(dev)
        cur = torch.full((S,), DEC_MAX_SEQ // 2, device=dev)

        def fn(caches=caches, toks=toks, cur=cur):
            return model.decode_step(caches, toks, cur)

        n_bytes = step_bytes(S, fn)
        dev_ms, host = device_ms(torch, fn, flush, reps=DEC_REPS), wall_ms(torch, fn, host_reps)
        bound = n_bytes / PEAK_BYTES_PER_S * 1e3
        step_ms[S] = dict(device_ms=dev_ms, wall_ms=host,
                          enqueue_ms=enqueue_ms(torch, fn, host_reps), bound_ms=bound,
                          bound_by="bytes", bytes=n_bytes, device_share=dev_ms / host,
                          tokens_per_s_at_wall=S / host * 1e3)
        del caches
    report = dict(
        card=card, params=cfg.param_count(),
        weight_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
        requests=len(prompts), prompt_lengths=list(lengths), new_tokens=DEC_NEW,
        generate_wall_s=wall, tokens=n_tokens, tokens_per_s=n_tokens / wall,
        stats={k: v for k, v in svc.stats.items() if k != "telemetry"},
        first_near_tie=ties, steps_compared=compared, near_tie=NEAR_TIE,
        slot_batched_vs_single_max_abs=slot_err, logit_rows_compared=rows_compared,
        repeatable=repeatable, slot_batched_routing_flips=slot_flips,
        forward_vs_decode=fwd_err, bucketed_vs_exact_max_abs=bucket_err,
        bucketed_max_rel_gap=bucket_gap,
        bucketed_near_ties=bucket_ties, bucketed_replayed_tokens=bucket_replayed, eos=dict(rid=rid, step=step, token=tok),
        prefill_ms=prefill_ms, decode_step=step_ms,
    )
    print(f"{label} [{card}] {cfg.name} full width, {cfg.n_layers} layers, bf16: "
          f"{len(prompts)} requests x {DEC_NEW} tokens "
          f"in {wall:.3f} s ({n_tokens / wall:.1f} tok/s, {svc.stats['fused_steps']} fused "
          f"steps); tokens equal the single-slot plan's over {compared} steps before near-ties "
          f"{json.dumps(ties)}, logits {slot_err:.4g} apart over {rows_compared} rows of the "
          f"same inputs (the recorded rerun repeats the tokens); routing flips slot-batched "
          f"{json.dumps(slot_flips)}; forward vs decode (routing replayed) "
          f"{json.dumps(fwd_err)}; bucketed vs exact "
          f"prefill max_abs {bucket_err:.4g} ({bucket_ties} near-ties, {bucket_replayed} tokens "
          f"routed as the exact prefill routed them, gaps up to {bucket_gap:.4g}); EOS at step "
          f"{step} of "
          f"request {rid}; prefill ms {json.dumps(prefill_ms)}; decode step ms "
          f"{json.dumps(step_ms)}")
    return report, prompts, {c.rid: c.tokens for c in batched}, ties


def decode_f32_twin(torch, cfg, dev, card, layers=DEC_F32_LAYERS, lengths=DEC_F32_LENGTHS,
                    label="7b"):
    """Phase 7b (and 11d): the card against the CPU, full width at depth
    ``layers`` (gemma3-1b's 6: five local layers, then one global), f32,
    the card's weights carried to the CPU through the flat arrays; a
    request a prompt length, all in one slot batch."""
    import dataclasses

    import numpy as np

    from repro_torch.checkpoint import lm_params_from_flat, flat_from_lm
    from repro_torch.models import build_model
    from repro_torch.runtime import DecodePlan, Request, ServiceConfig

    cfg32 = dataclasses.replace(cfg, n_layers=layers, dtype="float32")
    card_m = build_model(cfg32, dev).init(torch.Generator(device=dev).manual_seed(0))
    cpu_m = lm_params_from_flat(cfg32, flat_from_lm(card_m), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lengths]
    runs, walls = {}, {}
    for name, m in (("card", card_m), ("cpu", cpu_m)):
        rec = LogitRecorder(torch, m)
        plan = DecodePlan(rec, ServiceConfig(plan="decode", max_batch=len(prompts),
                                             max_seq=DEC_MAX_SEQ, buckets=DEC_BUCKETS))
        t0 = time.perf_counter()
        done = sorted(plan.generate(dec_requests(Request, prompts, DEC_F32_NEW)), key=lambda c: c.rid)
        walls[name] = time.perf_counter() - t0
        runs[name] = rec.logits(done, prompts)
    worst, compared = {}, 0
    for rid in range(len(prompts)):
        (ct, cl), (pt, pl) = runs["card"][rid], runs["cpu"][rid]
        k = first_tie(pl)
        check(np.array_equal(ct[:k], pt[:k]),
              f"{label}: request {rid}: card tokens {ct[:k]} != CPU tokens {pt[:k]} before "
              f"step {k}")
        rows = same_input_rows(ct, pt)
        got, want = cl[:rows].cpu(), pl[:rows]
        std = float(want.std())
        err = (got - want).abs()
        check(bool((err <= DEC_F32_TOL * want.abs() + DEC_F32_TOL * std).all()),
              f"{label}: request {rid}: card logits {float(err.max())} from the CPU's (std {std})")
        worst[lengths[rid]] = dict(max_abs=float(err.max()), logit_std=std, steps=rows,
                                   first_near_tie=k)
        compared += rows
    print(f"{label} [{card}] {cfg.name} full width, depth {layers}, f32: card against CPU over "
          f"{compared} steps of {len(prompts)} requests: {json.dumps(worst)}; generate wall s "
          f"{json.dumps(walls)}")
    del card_m
    return dict(per_prompt=worst, steps_compared=compared, generate_wall_s=walls)


class _Crash(BaseException):
    """Escapes the engine's per-request Exception handler: kills its loop."""


def decode_async_fleet(torch, model, prompts, batched, ties, dev, card, label="7c"):
    """Phase 7c (and 10d): the async engine (four client threads, 16 requests) and a
    fleet of two decode engines over the one model (tenants free:1 and
    paid:4, a 5 ms deadline on a quarter of the free requests, one engine
    crashing at its 4th request)."""
    import threading

    import numpy as np

    from repro_torch.runtime import (
        Completion,
        EngineStopped,
        Request,
        RouterConfig,
        RouterError,
        ServiceConfig,
        TenantConfig,
        serve_fleet,
        serve_model,
    )

    sc = dict(plan="decode", max_batch=DEC_MAX_BATCH, max_seq=DEC_MAX_SEQ, buckets=DEC_BUCKETS)

    def agrees(c) -> bool:
        i = c.rid % len(prompts)
        k = min(ties[i], DEC_NEW)
        return np.array_equal(c.tokens[:k], batched[i][:k])

    reqs = dec_requests(Request, prompts, DEC_NEW, n=DEC_ASYNC_REQUESTS)
    svc = serve_model(model, ServiceConfig(async_mode=True, **sc))
    results, errors = {}, []

    def client(t):
        try:
            futs = [svc.submit(r) for r in reqs[t::DEC_ASYNC_CLIENTS]]
            for f in futs:
                c = f.result(timeout=300)
                results[c.rid] = c
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(DEC_ASYNC_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    svc.drain_and_stop()
    check(not errors and sorted(results) == list(range(len(reqs))), f"{label} async: {errors[:1]!r}")
    check(all(agrees(c) for c in results.values()), f"{label} async: tokens differ off near-ties")
    tel = svc.stats["telemetry"]
    check(tel["prefill_s"]["count"] == len(reqs) and tel["decode_step_s"]["count"] > 0,
          f"{label} async: prefill_s / decode_step_s not recorded")
    n_tok = sum(len(c.tokens) for c in results.values())
    async_report = dict(
        requests=len(reqs), wall_s=wall, tokens_per_s=n_tok / wall,
        admitted=svc.engine.admitted, mean_occupancy=svc.stats["mean_occupancy"],
        latency_s=percentiles(tel, "queue_wait_s", "prefill_s", "decode_step_s", "e2e_s"))

    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    router = serve_fleet(model, ServiceConfig(**sc, router=RouterConfig(tenants={
        "free": TenantConfig(weight=1), "paid": TenantConfig(weight=4)})), fleet=2)
    # The first engine to reach its DEC_FLEET_CRASH_AT-th request crashes, once.
    armed, seen = {"on": True}, {}
    for name in ("decode0", "decode1"):
        plan = router._slots[name].engine.plan

        def crash_at(prompt, name=name, real=plan._prefill_one):
            seen[name] = seen.get(name, 0) + 1
            if seen[name] == DEC_FLEET_CRASH_AT and armed.pop("on", None):
                raise _Crash(f"injected crash in {name} at its request {seen[name]}")
            return real(prompt)

        plan._prefill_one = crash_at
    futs = []
    t0 = time.perf_counter()
    for i, r in enumerate(dec_requests(Request, prompts, DEC_NEW, n=DEC_FLEET_REQUESTS)):
        free = i % 2 == 0
        deadline = FLEET_DEADLINE_S if free and (i // 2) % 4 == 0 else None
        futs.append(router.submit(r, tenant="free" if free else "paid", deadline_s=deadline))
    outcomes = []
    for f in futs:
        try:
            outcomes.append(f.result(timeout=300))
        except (RouterError, EngineStopped) as e:
            outcomes.append(e)
    wall_f = time.perf_counter() - t0
    torch.cuda.synchronize()
    during = torch.cuda.memory_allocated(dev)
    router.drain_and_stop(timeout=300)
    stats = router.stats
    done = [o for o in outcomes if isinstance(o, Completion)]
    check(len(outcomes) == DEC_FLEET_REQUESTS, f"{label} fleet: a future did not resolve")
    check(stats["telemetry"]["restarts"] == 1 and not armed,
          f"{label} fleet: restarts {stats['telemetry']['restarts']}, requests by engine {seen}")
    check(all(agrees(c) for c in done), f"{label} fleet: tokens differ off near-ties")
    check(during - before < weight_bytes // 2,
          f"{label} fleet: {during - before} bytes more after the fleet started: a second copy "
          f"of the {weight_bytes} bytes of weights?")
    n_tok = sum(len(c.tokens) for c in done)
    fleet_report = dict(
        requests=DEC_FLEET_REQUESTS, completed=len(done),
        typed_errors=sorted({type(o).__name__ for o in outcomes if not isinstance(o, Completion)}),
        restarts=stats["telemetry"]["restarts"], wall_s=wall_f, tokens_per_s=n_tok / wall_f,
        memory_before=before, memory_during=during, weight_bytes=weight_bytes)
    print(f"{label} [{card}] async: {len(reqs)} requests from {DEC_ASYNC_CLIENTS} threads in "
          f"{wall:.3f} s ({async_report['tokens_per_s']:.1f} tok/s, occupancy "
          f"{async_report['mean_occupancy']:.2f}), latency s "
          f"{json.dumps(async_report['latency_s'])}; fleet of 2: {len(done)} of "
          f"{DEC_FLEET_REQUESTS} completed, errors {fleet_report['typed_errors']}, "
          f"{fleet_report['restarts']} restart, {fleet_report['tokens_per_s']:.1f} tok/s, "
          f"memory {before} -> {during} bytes (weights {weight_bytes})")
    return dict(async_engine=async_report, fleet=fleet_report)


def record_shapes(mods):
    """Wrap each kernel module's wrapper to count its calls by shape, keyed
    as ``online_keys`` names them; returns (the counts, a function restoring
    the wrappers)."""
    import collections

    shapes, saved = collections.Counter(), []

    def wrap(mod, name, key):
        real = getattr(mod, name)

        def recorded(*a, **kw):
            shapes[(name, key(*a, **kw))] += 1
            return real(*a, **kw)

        saved.append((mod, name, real))
        setattr(mod, name, recorded)

    mk, sk, bk = mods
    wrap(mk, "masked_matmul",
         lambda x, w, b, mask=None, **kw: (x.shape[0], *w.shape, mask is not None))
    wrap(sk, "hcu_softmax", lambda s, n_hcu, n_mcu, **kw: (s.shape[0], n_hcu, n_mcu))
    wrap(bk, "bcpnn_update", lambda ai, aj, *a, **kw: (ai.shape[0], ai.shape[1], aj.shape[1]))

    def restore():
        for mod, name, real in saved:
            setattr(mod, name, real)

    return shapes, restore


def launcher_runs(specs, label, card):
    """``python -m repro_torch.launch.serve ARGS`` as a user runs it, once a
    spec (name, args, ok): an ok run exits 0 and prints its telemetry
    line; another exits non-zero naming the bytes it would need."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = {}
    for name, args, ok in specs:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                           capture_output=True, text=True, timeout=600, env=env, cwd=ROOT)
        wall = time.perf_counter() - t0
        lines = [ln for ln in r.stdout.splitlines() if ln.startswith(("[serve", "[telemetry]"))]
        if ok:
            check(r.returncode == 0 and any(ln.startswith("[telemetry]") for ln in lines),
                  f"{label} {name}: rc {r.returncode}: {r.stderr[-2000:]}")
        else:
            check(r.returncode != 0 and "bytes" in r.stderr,
                  f"{label} {name}: not refused: {r.stderr[-2000:]}")
            lines = r.stderr.strip().splitlines()[-1:]
        runs[name] = dict(rc=r.returncode, wall_s=wall, lines=lines)
        for ln in lines:
            print(f"{label} [{card}] {name}: {ln}")
    return runs


def decode_launcher(torch, ops, card):
    """Phase 7d: ``python -m repro_torch.launch.serve`` on the card as a
    user runs it (the published gemma3-1b; the --online classifier); then
    the --online path once more in this process, its launches counted from
    zero and each launch's shape held to those phase 3 checked."""
    import contextlib
    import io

    from repro_torch.kernels import bcpnn_update as bk
    from repro_torch.kernels import hcu_softmax as sk
    from repro_torch.kernels import masked_matmul as mk
    from repro_torch.launch import serve

    runs = launcher_runs((
        ("full", ["--arch", DEC_ARCH, "--full", "--requests", "8", "--max-batch", "4",
                  "--max-seq", "1024"], True),
        ("online", ["--online"], True),
    ), "7d", card)
    ops.reset_launches()
    shapes, restore = record_shapes((mk, sk, bk))
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            serve.main(["--online"])
    finally:
        restore()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    unchecked = sorted(set(shapes) - online_keys())
    check(not unchecked, f"7d: --online launched shapes phase 3 did not check: {unchecked}")
    check(all(counts[k] > 0 for k in ("masked_matmul", "hcu_softmax", "bcpnn_update"))
          and counts["bcpnn_phase"] == counts["bf_round"] == 0
          and not any(v for k, v in counts.items() if k.endswith(".datapath")),
          f"7d: --online launches {counts}")
    check(all(counts[k] == sum(n for (name, _), n in shapes.items() if name == k)
              for k in ("masked_matmul", "hcu_softmax", "bcpnn_update")),
          f"7d: --online launches {counts} against calls by shape {dict(shapes)}")
    by_shape = {f"{name} {key}": n for (name, key), n in sorted(shapes.items())}
    print(f"7d [{card}] --online in this process: launches {json.dumps(counts)}, by shape "
          f"{json.dumps(by_shape)}, every shape checked in phase 3")
    return counts, dict(runs=runs, online_launches=counts, online_launches_by_shape=by_shape)


def decoder(torch, ops, card, dev, cfg=None):
    """Phase 7: the LM zoo's dense decoder at full width (7a-7d); the
    decode path launches none of the five kernels, the --online launcher
    the three of the forward and the update."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = cfg if cfg is not None else get_config(DEC_ARCH)
    ops.reset_launches()
    t0 = time.perf_counter()
    model = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)  # the peak from here on, weights included
    report, prompts, batched, ties = decode_width(torch, model, cfg, dev, card)
    report["matmul_f32"] = matmul_f32_on_card(torch, model, cfg, dev)
    print(f"7a [{card}] matmul_f32 on the card against the f32 product "
          f"{json.dumps(report['matmul_f32'])}")
    report["init_s"] = init_s
    report["f32_twin"] = decode_f32_twin(torch, cfg, dev, card)
    report.update(decode_async_fleet(torch, model, prompts, batched, ties, dev, card))
    torch.cuda.synchronize()
    decode_counts = ops.launch_counts()
    check(not any(decode_counts.values()), f"7: the decode path launched {decode_counts}")
    report["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    del model
    online_counts, report["launcher"] = decode_launcher(torch, ops, card)
    print(f"7 [{card}] peak memory {report['max_memory_allocated']} bytes")
    return {"decode": decode_counts, "online": online_counts}, report


# ------------------------------------------------------------- phase 8
GUARD_ROUNDS = 2  # fit + evaluate rounds, and serving rounds, of phase 8
GUARD_SERVE_ROWS = 512  # test rows per batched round (eight micro-batches of 64)
GUARD_STREAM_ROWS, GUARD_STREAM_INFERS = 64, 16  # per streaming round
GUARD_CONT_ROWS, GUARD_CONT_INFER_EVERY = 24, 3  # per continual round
GUARD_CONT_KW = dict(update_batch=4, update_budget=16, merge_every=2, drift_window=16,
                     drift_min_samples=8, drift_threshold=0.4, merge_strategy="replace")
GUARD_DEC_LAYERS, GUARD_DEC_LENGTHS, GUARD_DEC_NEW = 6, (5, 60, 130), 6
GUARD_GAPS = 5  # host-side gaps printed per profiled fit
GUARD_KERNELS = ("masked_matmul", "hcu_softmax", "bcpnn_update", "bcpnn_phase", "bf_round")
GUARD_KERNEL_RE = r"\b{name}_kernel\b"  # the kernels' C++ symbols in a profile


def state_leaves(state) -> dict:
    """path -> tensor for every leaf of a NetworkState or LayerState."""
    from repro_torch.analysis.strict import walk

    return dict(walk(state))


def states_equal(torch, a, b) -> bool:
    la, lb = state_leaves(a), state_leaves(b)
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)


def guard_fits(core, net, split, cfg, fit_kw, strict, dev):
    """Compile on the card, then GUARD_ROUNDS x (fit, evaluate): the
    accuracies and every epoch's wall seconds.  Evaluated at the training
    batch size, so the projection meets the shape training gave it."""
    x, y, xt, yt = split
    compiled = net.compile(core.ExecutionConfig(device=str(dev), strict=strict, **cfg))
    accs, epochs = [], []
    for _ in range(GUARD_ROUNDS):
        result = compiled.fit((x, y), **fit_kw)
        epochs += [h["seconds"] for h in result.history if "epoch" in h]
        accs.append(compiled.evaluate((xt, yt), batch_size=B))
    return compiled, accs, epochs


def strict_fits(torch, core, net, split, fit_kw, paths, card, dev):
    """8a: each Listing-1 path twice without strict and once with it; the
    strict run's sentinel must have watched something, every entry at 1,
    and its state and accuracies must equal the plain run's bit for bit
    (phase 4's rule, accuracy within 0.03, when two plain runs already
    differ)."""
    plain_nets, strict_nets, report = {}, {}, {}
    for path, (cfg, extra) in paths.items():
        kw = {**fit_kw, **extra}
        plain, acc_p, _ = guard_fits(core, net, split, cfg, kw, False, dev)
        again, acc_a, ep_a = guard_fits(core, net, split, cfg, kw, False, dev)
        strict, acc_s, ep_s = guard_fits(core, net, split, cfg, kw, True, dev)
        sizes = strict._sentinel.sizes()
        check(bool(sizes), f"8a {path}: the sentinel watched nothing")
        check(all(v == 1 for v in sizes.values()), f"8a {path}: sentinel sizes {sizes}")
        check(dev.type != "cuda" or any(">" in k for k in sizes),
              f"8a {path}: no kernel launch plan watched: {sizes}")
        deterministic = states_equal(torch, plain.state, again.state) and acc_p == acc_a
        if deterministic:
            check(states_equal(torch, strict.state, plain.state),
                  f"8a {path}: the strict state differs from the plain run's")
            check(acc_s == acc_p, f"8a {path}: strict accuracy {acc_s} != plain {acc_p}")
        else:
            print(f"8a {path}: two plain runs differ ({acc_p} vs {acc_a}); phase 4's rule holds")
            check(all(abs(a - b) <= 0.03 for a, b in zip(acc_s, acc_p)),
                  f"8a {path}: strict accuracy {acc_s} vs plain {acc_p}: off by more than 0.03")
        # The overhead against the second plain run, the first pays the
        # path's first-call costs.
        overhead = statistics.median(ep_s) - statistics.median(ep_a)
        report[path] = dict(acc_plain=acc_p, acc_strict=acc_s, bitwise=deterministic,
                            epoch_s_plain=statistics.median(ep_a),
                            epoch_s_strict=statistics.median(ep_s),
                            strict_overhead_s_per_epoch=overhead, sentinel=sizes)
        print(f"8a [{card}] strict fit {path}: accuracy {acc_s} (plain {acc_p}, bit for bit "
              f"{deterministic}); median epoch s plain={statistics.median(ep_a):.5f} "
              f"strict={statistics.median(ep_s):.5f} overhead={overhead:.5f}; "
              f"sentinel {json.dumps(sizes)}")
        plain_nets[path], strict_nets[path] = plain, strict
    return plain_nets, strict_nets, report


def seeded_violations(torch, ops, ref, core, net, split, fit_kw, dev):
    """8b: four seeded faults on a strict unfused network, each its typed
    error: a .item() in a projection chunk's guarded dispatch, a hidden
    trace moved to the CPU (the guard refuses it before anything runs: no
    kernel and no plain version), a partial_fit with a new batch size, and
    NaN in w."""
    from repro_torch.analysis.strict import HostTransferError, NonFiniteError, RecompileError

    x, y, xt, _ = split
    compiled = net.compile(core.ExecutionConfig(device=str(dev), strict=True))
    compiled.fit((x, y), **fit_kw)
    seen = {}

    def expect(name, error, fn):
        try:
            fn()
        except error as e:
            seen[name] = f"{type(e).__name__}: {str(e)[:160]}"
            print(f"8b seeded {name}: {seen[name]}")
            return
        raise SmokeFailure(f"8b seeded {name}: no {error.__name__}")

    layer = compiled.layers[0]
    forward = layer.forward

    def syncing_forward(state, xb):
        out = forward(state, xb)
        out.sum().item()
        return out

    layer.forward = syncing_forward  # the projection reads layer.forward at each chunk
    try:
        expect("item", HostTransferError, lambda: compiled.predict(xt.copy(), batch_size=B))
    finally:
        del layer.forward
    good = compiled.state
    s0 = good.layers[0]
    away = "cpu" if dev.type == "cuda" else "meta"  # the meta device stands in off the card
    compiled.state = good._replace(layers=(
        s0._replace(marginals=s0.marginals._replace(cij=s0.marginals.cij.to(away))),
    ) + good.layers[1:])
    plain_runs = {"n": 0}
    originals = {name: getattr(ref, name) for name in GUARD_KERNELS}

    def counting(fn):
        def run(*a, **k):
            plain_runs["n"] += 1
            return fn(*a, **k)
        return run

    for name, fn in originals.items():
        setattr(ref, name, counting(fn))
    ops.reset_launches()
    try:
        expect("cpu_leaf", HostTransferError, lambda: compiled.partial_fit((x, y), batch_size=B))
    finally:
        for name, fn in originals.items():
            setattr(ref, name, fn)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(plain_runs["n"] == 0, f"8b cpu_leaf: {plain_runs['n']} plain-version runs")
    check(not any(counts.values()), f"8b cpu_leaf: kernels launched {counts}")
    compiled.state = good
    expect("batch_size", RecompileError, lambda: compiled.partial_fit((x, y), batch_size=B // 2))
    compiled = net.compile(core.ExecutionConfig(device=str(dev), strict=True))
    compiled.fit((x, y), **fit_kw)
    s0 = compiled.state.layers[0]
    w = s0.w.clone()
    w[0, 0] = float("nan")
    compiled.state = compiled.state._replace(layers=(s0._replace(w=w),) + compiled.state.layers[1:])
    expect("nan_w", NonFiniteError, lambda: compiled.partial_fit((x, y), batch_size=B))
    return seen


def thread_scoped(torch, dev):
    """The guard's verdict belongs to the thread that dispatches: a caller
    thread's read back while another thread's guard is open must not
    raise, the guarded thread's own must."""
    import threading

    from repro_torch.analysis.strict import HostTransferError, dispatch_guard

    t = torch.arange(1024, device=dev, dtype=torch.float32)
    outcome = {}

    def reader():
        try:
            outcome["mode"] = torch.cuda.get_sync_debug_mode()
            outcome["value"] = t.sum().item()
        except Exception as e:  # noqa: BLE001 - reported as the failure
            outcome["error"] = repr(e)

    with dispatch_guard(True, dev):
        th = threading.Thread(target=reader)
        th.start()
        th.join(timeout=60)
    check(not th.is_alive(), "8c: the reader thread hangs")
    check("error" not in outcome, f"8c: a caller thread's read back raised: {outcome}")
    check(outcome.get("mode") == 1, f"8c: the reader saw sync debug mode {outcome.get('mode')}")
    try:
        with dispatch_guard(True, dev):
            t.sum().item()
    except HostTransferError:
        pass
    else:
        raise SmokeFailure("8c: a guarded thread's .item() did not raise")
    check(torch.cuda.get_sync_debug_mode() == 0, "8c: the sync debug mode was not restored")
    return outcome


class ReadBack:
    """A caller thread reading device tensors back in a loop while engine
    threads dispatch under their guards: it must never raise."""

    def __init__(self, torch, dev):
        import threading

        self.torch, self.t = torch, torch.arange(4096, device=dev, dtype=torch.float32)
        self.reads = self.during_guard = 0
        self.errors = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            try:
                mode = self.torch.cuda.get_sync_debug_mode()
                self.t.sum().item()
                self.reads += 1
                self.during_guard += mode == 1
            except Exception as e:  # noqa: BLE001 - reported as the failure
                self.errors.append(repr(e))
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=60)
        check(not self._thread.is_alive(), "8c: the read-back thread hangs")
        check(not self.errors, f"8c: a caller thread's read back raised: {self.errors[:1]}")
        check(self.reads > 0, "8c: the read-back thread read nothing")


def async_round(service, items):
    """One deterministic async round: every item queued before the engine
    runs (so its micro-batches are the same in every run), then drained."""
    service.start(run=False)
    futures = [service.submit(item) for item in items]
    service.start()
    out = [f.result(timeout=600) for f in futures]
    service.drain_and_stop()
    return out


def stable_sentinel(label, plan, before):
    """The plan's sentinel after the second round: nothing grew past round
    one (the sentinel would have raised), every plan-owned entry at most 1."""
    sizes = plan._sentinel.sizes()
    check(bool(sizes), f"8c {label}: the sentinel watched nothing")
    check(sizes == before, f"8c {label}: sizes moved between rounds: {before} -> {sizes}")
    return sizes


def strict_serving(torch, plain_nets, strict_nets, split, card):
    """8c: the batched and streaming plans through the async engine and the
    continual lifecycle, each strict against a plain twin of the same state
    (8a made them bit for bit equal), GUARD_ROUNDS rounds each, results
    equal, the sentinel still after round one; a caller thread reads back
    throughout."""
    import numpy as np

    from repro_torch.runtime import ContinualConfig, Feedback, ServiceConfig

    x, y, xt, _ = split
    dev = strict_nets["unfused_f32"].device
    report = {"thread_scoped": thread_scoped(torch, dev)}
    plain, strict = plain_nets["unfused_f32"], strict_nets["unfused_f32"]
    rows = [xt[i] for i in range(GUARD_SERVE_ROWS)]
    with ReadBack(torch, dev) as rb:
        outs, sizes = {}, None
        for name, c in (("plain", plain), ("strict", strict)):
            svc = c.serve(ServiceConfig(plan="batched", buckets=SERVE_BUCKETS, max_batch=64,
                                        strict=name == "strict"))
            outs[name] = [np.stack(async_round(svc, rows)) for _ in range(GUARD_ROUNDS)]
            if name == "strict":
                sizes = svc.plan._sentinel.sizes()
                check(sizes.get("head") == 1, f"8c batched: head sizes {sizes}")
        for r in range(GUARD_ROUNDS):
            check(np.array_equal(outs["plain"][r], outs["strict"][r]),
                  f"8c batched round {r}: strict scores differ from plain")
        report["batched"] = dict(sentinel=sizes, rows=GUARD_SERVE_ROWS)

        stream_out, stream_sizes = {}, None
        for name, c in (("plain", plain), ("strict", strict)):
            svc = c.serve(ServiceConfig(plan="streaming", max_batch=STREAM_BATCH,
                                        strict=name == "strict"))
            got, before = [], None
            for r in range(GUARD_ROUNDS):
                lo = r * GUARD_STREAM_ROWS
                for i in range(lo, lo + GUARD_STREAM_ROWS):
                    svc.feed(x[i])
                svc.flush()
                got += async_round(svc, [xt[i] for i in range(lo, lo + GUARD_STREAM_INFERS)])
                if name == "strict" and r == 0:
                    before = svc.plan._sentinel.sizes()
            state = svc.plan.session.close()
            stream_out[name] = (np.stack(got), state)
            if name == "strict":
                stream_sizes = stable_sentinel("streaming", svc.plan, before)
        check(np.array_equal(stream_out["plain"][0], stream_out["strict"][0]),
              "8c streaming: strict activations differ from plain")
        check(states_equal(torch, stream_out["plain"][1], stream_out["strict"][1]),
              "8c streaming: strict session state differs from plain")
        report["streaming"] = dict(sentinel=stream_sizes)

        acks, cont_sizes = {}, None
        for name, c in (("plain", plain), ("strict", strict)):
            svc = c.serve(ServiceConfig(strict=name == "strict",
                                        continual=ContinualConfig(**GUARD_CONT_KW)))
            plan, got, before = svc.plan, [], None
            for r in range(GUARD_ROUNDS):
                for k in range(r * GUARD_CONT_ROWS, (r + 1) * GUARD_CONT_ROWS):
                    got.append(plan.learn(Feedback(x[k], int(y[k]))))
                    if k % GUARD_CONT_INFER_EVERY == 0:
                        got.append(plan.infer(xt[k]).cpu().numpy())
                if name == "strict" and r == 0:
                    before = plan._sentinel.sizes()
            acks[name] = got
            if name == "strict":
                reg = plan._strict_registry()
                check({"continual_update", "continual_view", "continual_prefix"} <= set(reg),
                      f"8c continual: registry {sorted(reg)}")
                check(any(n.startswith("continual_merge[") for n in reg),
                      f"8c continual: no merge watched: {sorted(reg)}")
                check(plan.metrics.merges.value >= 1, "8c continual: no merge ran")
                cont_sizes = stable_sentinel("continual", plan, before)
        for a, b in zip(acks["plain"], acks["strict"]):
            same = np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
            check(same, f"8c continual: strict {b} != plain {a}")
        report["continual"] = dict(sentinel=cont_sizes, results=len(acks["strict"]))
    report["read_back"] = dict(reads=rb.reads, during_a_guard=rb.during_guard)
    print(f"8c [{card}] strict serving: batched {json.dumps(report['batched'])}; streaming "
          f"{json.dumps(report['streaming'])}; continual {json.dumps(report['continual'])}; "
          f"caller read backs {rb.reads} ({rb.during_guard} while a guard was open)")
    return report


def strict_decoder(torch, dev, card, cfg=None, layers=GUARD_DEC_LAYERS, label="8c"):
    """8c (and 10a): a decoder at its published width (gemma3-1b unless
    ``cfg`` says otherwise), cut to depth ``layers`` (6: phase 7b's twin,
    to keep the time limit), bf16, through serve_model with strict on and
    off: two rounds of the same requests, tokens equal, the sentinel still
    after round one, fused_step and each prefill bucket at one signature.
    The guard would raise on a host sync inside the decode step."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import Request, ServiceConfig, serve_model

    cfg = cfg if cfg is not None else get_config(DEC_ARCH)
    cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in GUARD_DEC_LENGTHS]
    tokens, sizes, before = {}, None, None
    for name in ("plain", "strict"):
        svc = serve_model(model, ServiceConfig(max_batch=len(prompts), max_seq=DEC_MAX_SEQ,
                                               buckets=DEC_BUCKETS, strict=name == "strict"))
        rounds = []
        for r in range(GUARD_ROUNDS):
            done = svc.generate(dec_requests(Request, prompts, GUARD_DEC_NEW))
            rounds.append([c.tokens for c in sorted(done, key=lambda c: c.rid)])
            if name == "strict" and r == 0:
                before = svc.plan._sentinel.sizes()
        tokens[name] = rounds
        if name == "strict":
            sizes = stable_sentinel("decode", svc.plan, before)
            check(sizes.get("fused_step") == 1, f"{label} decode: sizes {sizes}")
            check(all(v == 1 for k, v in sizes.items() if k.startswith("prefill[")),
                  f"{label} decode: sizes {sizes}")
    for r in range(GUARD_ROUNDS):
        for a, b in zip(tokens["plain"][r], tokens["strict"][r]):
            check(np.array_equal(a, b), f"{label} decode round {r}: strict tokens {b} != plain {a}")
    del model
    print(f"{label} [{card}] strict decode, {cfg.name} full width at depth {layers}: "
          f"{len(prompts)} requests x {GUARD_ROUNDS} rounds, tokens equal; sentinel "
          f"{json.dumps(sizes)}")
    return dict(sentinel=sizes, depth=layers)


def profile_kernels(path_to_trace):
    """The CUDA kernels of a Chrome trace: the repository's by name (count
    and summed device ms), every kernel's count, their busy ms (the union of
    their intervals, so kernels that overlap count once) over the span from
    the first kernel's start to the last one's end, the idle share of that
    span, and its GUARD_GAPS longest idle gaps (the device waiting on the
    host), each named by the host operator that fills it the longest.  The
    arithmetic is the benchmark's (``bench/harness/trace.py``)."""
    import re

    from bench.harness import trace as bench_trace

    with open(path_to_trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    ours = {}
    for name in GUARD_KERNELS:
        pattern = re.compile(GUARD_KERNEL_RE.format(name=name))
        mine = [e for e in kernels if pattern.search(e["name"])]
        ours[name] = dict(count=len(mine), device_ms=sum(e["dur"] for e in mine) / 1e3)
    intervals = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in kernels]
    lo = min((s for s, _ in intervals), default=0.0)
    hi = max((e for _, e in intervals), default=0.0)
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    idle = sorted(bench_trace.gaps(intervals, lo, hi), key=lambda g: g[0] - g[1])
    top = [dict(gap_us=g1 - g0, host_op=next(iter(bench_trace.name_gaps([(g0, g1)], host))))
           for g0, g1 in idle[:GUARD_GAPS]]
    busy = bench_trace.busy(intervals, lo, hi)
    span = hi - lo
    return dict(ours=ours, kernels=len(kernels), busy_ms=busy / 1e3, span_ms=span / 1e3,
                idle_share=(1 - busy / span) if span else None, top_gaps_us=top)


def profiled_fit(torch, ops, core, net, split, cfg, fit_kw, outdir, dev):
    """compile, then fit under ExecutionConfig(profile_dir=), the launch
    counters reset between the two; returns (launch counts, accuracy,
    the parsed profile)."""
    x, y, xt, yt = split
    compiled = net.compile(core.ExecutionConfig(device=str(dev), profile_dir=outdir, **cfg))
    torch.cuda.synchronize()
    ops.reset_launches()
    compiled.fit((x, y), **fit_kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    acc = compiled.evaluate((xt, yt), batch_size=B)
    check(compiled.last_profile is not None and Path(compiled.last_profile).exists(),
          "8d: profile_dir wrote no trace")
    return counts, acc, profile_kernels(compiled.last_profile)


def profiles_and_plain(torch, ops, core, net, split, fit_kw, paths, plain_nets, card, dev):
    """8d: an unfused and a fused fit under profile_dir, each kernel of the
    repository in the trace as often as its launch counter says; 8e: the
    unfused fit with use_kernels=False on the card, no launch of ours in
    the counters or the trace, accuracy within 0.03 of the kernel path."""
    outdir = str(ROOT / "chiprun_out" / "profiles")
    report, launched = {}, {}
    for path in ("unfused_f32", "fused_bf16"):
        counts, acc, prof = profiled_fit(torch, ops, core, net, split, paths[path][0], fit_kw,
                                         outdir, dev)
        if not any(prof["ours"][k]["count"] for k in GUARD_KERNELS) and prof["kernels"] == 0:
            raise SmokeFailure(f"8d {path}: the profile recorded no device activity")
        for name in GUARD_KERNELS:
            check(prof["ours"][name]["count"] == counts[name],
                  f"8d {path}: {name} {prof['ours'][name]['count']} times in the profile, "
                  f"{counts[name]} by the counter")
        launched[f"guard_profile/{path}"] = counts
        report[path] = dict(prof, launches=counts, acc=acc)
        print(f"8d [{card}] profile_dir fit {path}: "
              + " ".join(f"{k}={v['count']}x {v['device_ms']:.3f}ms" for k, v in prof["ours"].items())
              + f"; all kernels {prof['kernels']} busy {prof['busy_ms']:.3f} ms of a "
              f"{prof['span_ms']:.3f} ms span (idle share {prof['idle_share']}); top gaps "
              f"{json.dumps(prof['top_gaps_us'])}")
    counts, acc, prof = profiled_fit(torch, ops, core, net, split,
                                     dict(use_kernels=False), fit_kw, outdir, dev)
    check(not any(counts.values()), f"8e use_kernels=False: launches {counts}")
    check(not any(v["count"] for v in prof["ours"].values()),
          f"8e use_kernels=False: kernels of ours in the profile {prof['ours']}")
    kernel_acc = plain_nets["unfused_f32"].evaluate((split[2], split[3]), batch_size=B)
    check(abs(acc - kernel_acc) <= 0.03,
          f"8e use_kernels=False: accuracy {acc} vs the kernel path's {kernel_acc}")
    report["use_kernels_false"] = dict(acc=acc, kernel_path_acc=kernel_acc, kernels=prof["kernels"],
                                       busy_ms=prof["busy_ms"])
    launched["guard_plain"] = counts
    print(f"8e [{card}] use_kernels=False on the card: accuracy {acc:.4f} (kernel path "
          f"{kernel_acc:.4f}), no launch of ours; {prof['kernels']} device kernels, "
          f"busy {prof['busy_ms']:.3f} ms")
    return launched, report


def hot_path_guard(torch, ops, ref, core, data, policy, card, dev, dec_cfg=None):
    """Phase 8: the hot-path guard on the card at MNIST width (8a strict
    fits, 8b seeded faults, 8c strict serving and decoding with a caller
    thread reading back, 8d profile_dir, 8e use_kernels=False).  ``dev``
    and ``dec_cfg`` (the decoder's config) let a rehearsal on the CPU run
    it at a small width."""
    print(f"phase 8 (the hot-path guard) on {card}")
    net, split, fit_kw, paths = listing1(core, data, policy)
    plain_nets, strict_nets, fits = strict_fits(torch, core, net, split, fit_kw, paths, card, dev)
    seeded = seeded_violations(torch, ops, ref, core, net, split, fit_kw, dev)
    serving = strict_serving(torch, plain_nets, strict_nets, split, card)
    serving["decode"] = strict_decoder(torch, dev, card, dec_cfg)
    launched, profiles = profiles_and_plain(torch, ops, core, net, split, fit_kw, paths,
                                            plain_nets, card, dev)
    return launched, dict(strict_fits=fits, seeded=seeded, serving=serving, profiles=profiles)


# ------------------------------------------------------------------ phase 9
# Distribution, the paper's MPI backend: Listing 1 at phase 4's width and
# schedule through ExecutionConfig(trainer=DataParallelTrainer(mesh, mode)).
# (a) one rank on the card over NCCL, in this process: shard_map on the scan
# and the batch engine, pjit on the scan engine with the fused bf16-state
# config; (b) two ranks on the one card over gloo with CUDA tensors (NCCL
# refuses two ranks on one device), one process each, shard_map on the scan
# engine, meshes (2, 1) and (1, 2) (the 30 hidden HCUs split 15 + 15).  The
# one-batch rule is the reference's data-parallel tolerance
# (tests/test_distributed.py:52-59): w rtol 2e-4 / atol 2e-5, C_ij rtol
# 2e-4 / atol 1e-7.
DP_RUNS = {
    "shard_map_scan": ("shard_map", "scan", "unfused_f32"),
    "shard_map_batch": ("shard_map", "batch", "unfused_f32"),
    "pjit_scan_fused_bf16": ("pjit", "scan", "fused_bf16"),
}
DP_MESHES = ((2, 1), (1, 2))
DP_TOL = dict(w=(2e-4, 2e-5), cij=(2e-4, 1e-7))
DP_TIMEOUT_S = 300


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def event_ms(torch, fn, reps: int = REPS) -> float:
    """Median ms of one call of ``fn`` between CUDA events, over ``reps``
    calls after two warm-up calls (a collective inside cannot be captured
    in a CUDA graph, so this counts any host wait inside the call too)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dp_batch_check(torch, layers, states, x, y, tr, dev, label):
    """One hidden and one readout batch of B rows from the same states
    through the trainer's steps (this rank's rows and units, then the
    gather) against the single-device steps on the whole batch; fails
    beyond DP_TOL.  Returns the largest |difference| of w and C_ij, and the
    events ms of the trainer's hidden step."""
    (hidden, readout), (hs, rs) = layers, states
    xb = torch.as_tensor(x[:B], device=dev)
    yb = torch.as_tensor(y[:B], device=dev)
    rows = tr.rows(B)
    hb = hidden.forward(hs, xb)
    step_h, step_r = tr.hidden_step(hidden), tr.readout_step(readout)
    local_h, local_r = tr.place_state(hidden, hs), tr.place_state(readout, rs)
    pairs = {
        "hidden": (tr.gather_state(hidden, step_h(local_h, xb[rows])),
                   hidden.train_batch(hs, xb)[0]),
        "readout": (tr.gather_state(readout, step_r(local_r, hb[rows], yb[rows])),
                    readout.train_batch(rs, hb, yb)[0]),
    }
    torch.cuda.synchronize()
    errs = {}
    for name, (got, want) in pairs.items():
        for leaf, (rtol, atol) in DP_TOL.items():
            g = (got.w if leaf == "w" else got.marginals.cij).float()
            w = (want.w if leaf == "w" else want.marginals.cij).float()
            diff = (g - w).abs()
            check(bool((diff <= rtol * w.abs() + atol).all()),
                  f"9 {label}: one {name} batch, {leaf} {float(diff.max()):.3e} beyond rtol {rtol} "
                  f"atol {atol} of the single-device step")
            errs[f"{name}/{leaf}"] = float(diff.max())
    step_ms = event_ms(torch, lambda: step_h(local_h, xb[rows]))
    return errs, step_ms


def dp_rank(argv) -> int:
    """One rank of phase 9b, started by :func:`two_ranks` as ``chip_smoke.py
    --dp-rank RANK WORLD PORT MODEL OUTDIR DEVICE``: gloo with the tensors
    on DEVICE ("cuda": the card), Listing 1 fitted in shard_map mode on the
    scan engine with its launches and collectives counted from the compile,
    the one-batch check, then the rank's global state (npz) and report
    (json) into OUTDIR."""
    import numpy as np
    import torch
    import torch.distributed as dist

    rank, world, port, model, out = int(argv[0]), int(argv[1]), argv[2], int(argv[3]), Path(argv[4])
    dev = torch.device(argv[5], 0) if argv[5] == "cuda" else torch.device(argv[5])
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import core, data
    from repro_torch.checkpoint import flat_from_network_state
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.precision import policy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        tr = D.DataParallelTrainer(make_host_mesh(model=model, device_type=dev.type), "shard_map")
        net, split, fit_kw, _ = listing1(core, data, policy)
        ops.reset_launches()
        D.reset_collectives()
        compiled, run = fit_once(torch, core, net, split, str(dev), dict(trainer=tr), fit_kw, True)
        counts, coll, coll_s = ops.launch_counts(), D.collective_counts(), D.collective_seconds()
        errs, step_ms = dp_batch_check(torch, compiled.layers, compiled.state.layers, split[0],
                                       split[1], tr, dev, f"rank {rank} of {world}x{model}")
        out.mkdir(parents=True, exist_ok=True)
        np.savez(out / f"rank{rank}.npz", **flat_from_network_state(compiled.state))
        (out / f"rank{rank}.json").write_text(json.dumps(dict(
            acc=run["acc"], fit_s=run["fit_s"], launches=counts, collectives=coll,
            all_reduce_s=coll_s["all_reduce"], step_errors=errs, step_ms=step_ms,
            epochs=[{k: h[k] for k in ("phase", "seconds")} for h in run["history"]])))
    finally:
        dist.destroy_process_group()
    return 0


def two_ranks(torch, ops, trained, runs, card, dev):
    """Phase 9b: each mesh of DP_MESHES as two processes on the one card.
    Both ranks must end with the same global state bit for bit, each at
    phase 4's accuracy rule against the single-device card fit, with the
    one-batch check passed and its launches exactly those of the path:
    the forward pair once a hidden batch (on its rows), once a projection
    chunk of its share and three times a test chunk; one reduced-means
    bcpnn_update a learning cycle and no other kernel."""
    import numpy as np

    x, _, xt, _ = trained["split"]
    fit_kw = trained["fit_kw"]
    batches, test_chunks = len(x) // B, -(-len(xt) // P)
    cycles = (fit_kw["epochs_hidden"] + fit_kw["epochs_readout"]) * batches
    launched, report = {}, {}
    for shape in DP_MESHES:
        name = f"{shape[0]}x{shape[1]}"
        out = ROOT / "build" / "phase9" / name  # the ranks' states, ~38 MB a rank
        port, world = free_port(), shape[0] * shape[1]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank", str(r),
                                   str(world), str(port), str(shape[1]), str(out), dev.type])
                 for r in range(world)]
        try:
            codes = [p.wait(timeout=DP_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        check(codes == [0] * world, f"9b {name}: rank exit codes {codes}")
        ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]
        states = [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]
        shutil.rmtree(out)
        for r in range(1, world):
            check(states[r].keys() == states[0].keys()
                  and all(states[r][k].dtype == states[0][k].dtype
                          and states[r][k].shape == states[0][k].shape
                          and states[r][k].tobytes() == states[0][k].tobytes() for k in states[0]),
                  f"9b {name}: rank {r}'s global state differs from rank 0's")
        forwards = fit_kw["epochs_hidden"] * batches + -(-batches // shape[0]) + 3 * test_chunks
        want = {"masked_matmul": forwards, "hcu_softmax": forwards, "bcpnn_update": cycles,
                "bcpnn_update.means": cycles}
        card_acc = runs["unfused_f32/card"]["acc"]
        for r, rep in enumerate(ranks):
            check(launches_equal(rep["launches"], want),
                  f"9b {name} rank {r}: launches {json.dumps(rep['launches'])}, want {json.dumps(want)}")
            check(rep["collectives"]["all_reduce"] == cycles + 3,
                  f"9b {name} rank {r}: {rep['collectives']} all-reduces, want {cycles + 3}")
            check(rep["acc"] >= 0.5 and abs(rep["acc"] - card_acc) <= 0.03,
                  f"9b {name} rank {r}: accuracy {rep['acc']} vs the single-device card fit's {card_acc}")
            launched[f"dp2/{name}/rank{r}"] = rep["launches"]
        report[name] = dict(ranks=ranks, wall_s=wall)
        print(f"9b [{card}] mesh {name}, gloo, two ranks on one card: wall {wall:.2f} s; "
              + "; ".join(f"rank {r}: accuracy {rep['acc']:.4f} fit_wall_s={rep['fit_s']:.4f} "
                          f"all_reduce {rep['collectives']['all_reduce']}x {rep['all_reduce_s']:.4f} s "
                          f"(host) hidden step {rep['step_ms']:.4f} ms (events) one-batch errors "
                          f"{json.dumps(rep['step_errors'])} launches {json.dumps(rep['launches'])}"
                          for r, rep in enumerate(ranks))
              + "; states equal bit for bit")
    return launched, report


def distribution(torch, ops, core, trained, runs, launches4, card, dev, backend="nccl"):
    """Phase 9: (a) one rank over ``backend`` (NCCL) in this process, the
    three runs of DP_RUNS, each at phase 4's accuracy rule against the same
    path's single-device card fit, its launches exactly phase 4's
    (shard_map: the unfused path's, every bcpnn_update in the reduced-means
    mode; pjit: the fused path's), its all-reduces counted, and one hidden
    and one readout batch against the single-device steps; then (b).  A
    rehearsal on the CPU passes ``dev`` (the CPU) and ``backend="gloo"``."""
    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.launch.mesh import make_host_mesh

    x, y, _, _ = trained["split"]
    fit_kw = trained["fit_kw"]
    batches = len(x) // B
    hidden_batches = fit_kw["epochs_hidden"] * batches
    cycles = hidden_batches + fit_kw["epochs_readout"] * batches
    # Besides one a learning cycle (pjit: and one a readout batch, its
    # labels): the hidden shards' gather, and the readout's projected level
    # (the ranks' hit-or-miss flag, then the projection).
    want_collectives = {"shard_map": cycles + 3, "pjit": cycles + fit_kw["epochs_readout"] * batches + 3}
    launched, report = {}, {}
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        mesh = make_host_mesh(device_type=dev.type)
        for name, (mode, engine, path) in DP_RUNS.items():
            tr = D.DataParallelTrainer(mesh, mode)
            cfg = {**trained["configs"][path], "trainer": tr, "engine": engine}
            ops.reset_launches()
            D.reset_collectives()
            _, run = fit_once(torch, core, trained["net"], trained["split"], str(dev), cfg,
                              fit_kw, True)
            counts, coll, coll_s = ops.launch_counts(), D.collective_counts(), D.collective_seconds()
            want = dict(launches4[path])
            if mode == "shard_map":
                want["bcpnn_update.means"] = want["bcpnn_update"]
            check(launches_equal(counts, want),
                  f"9a {name}: launches {json.dumps(counts)}, want {json.dumps(want)}")
            check(coll["all_reduce"] == want_collectives[mode],
                  f"9a {name}: {coll['all_reduce']} all-reduces, want {want_collectives[mode]}")
            single = runs[f"{path}/card"]["acc"]
            check(run["acc"] >= 0.5 and abs(run["acc"] - single) <= 0.03,
                  f"9a {name}: accuracy {run['acc']} vs the single-device card fit's {single}")
            card_net = trained["nets"][path]
            errs, step_ms = dp_batch_check(torch, card_net.layers, card_net.state.layers, x, y, tr,
                                           dev, f"9a {name}")
            launched[f"dp/{name}"] = counts
            report[name] = dict(acc=run["acc"], single_device_acc=single, fit_s=run["fit_s"],
                                all_reduce=coll["all_reduce"], all_reduce_s=coll_s["all_reduce"],
                                step_errors=errs, step_ms=step_ms, launches=counts)
            print(f"9a [{card}] {name} ({backend}, one rank): accuracy {run['acc']:.4f} (single device "
                  f"{single:.4f}) fit_wall_s={run['fit_s']:.4f} all_reduce {coll['all_reduce']}x "
                  f"{coll_s['all_reduce']:.4f} s (host) hidden step {step_ms:.4f} ms (events) "
                  f"one-batch errors {json.dumps(errs)} launches {json.dumps(counts)}")
        # One all-reduce of the hidden layer's packed means alone.
        F, H = 2 * N_FEATURES, HIDDEN[0] * HIDDEN[1]
        buf = torch.zeros(F + H + F * H, device=dev)
        group = D.DataParallelTrainer(mesh).batch_group
        report["all_reduce_ms"] = event_ms(torch, lambda: D.all_reduce(buf, group))
        print(f"9a [{card}] one all_reduce of the packed means ({4 * buf.numel() / 1e6:.1f} MB, "
              f"{backend}, one rank): {report['all_reduce_ms']:.4f} ms (events)")
    finally:
        dist.destroy_process_group()
    two, report["two_ranks"] = two_ranks(torch, ops, trained, runs, card, dev)
    launched.update(two)
    return launched, report


# ------------------------------------------------------------ phase 10
# The MoE family with MLA attention (PR 22), with phase 7's slots, buckets,
# prompts and gates: moonshot-v1-16b-a3b as the repository configures it
# (48 layers, 64 experts top-6 + 2 shared, GQA; 28.39 B parameters, 56.8 GB
# in bf16), deepseek-v2-236b at its published width cut to 4 layers (the
# dense first layer + 3 MoE layers: MLA with 128 heads, 160 experts; 26.6
# GB), random weights from torch.Generator seed 0.
MOE_ARCH, MLA_ARCH, MLA_LAYERS = "moonshot-v1-16b-a3b", "deepseek-v2-236b", 4
# 10a serves moonshot cut to 24 of its 48 layers, to keep the script
# within its time with phase 13: the same blocks, half the depth.
MOE_SERVE_LAYERS = 24
MOE_STRICT_LAYERS = 4  # strict serving of moonshot, cut to depth 4
MOE_HOST_REPS = 10  # eager calls timed a decode step (a step's host time is ~0.1 s)
# 10c: moonshot's width at depth 3 (one dense and two MoE layers), f32, the
# card against the CPU at the configured capacity factor.  A routed expert
# may differ between the devices only where the CPU's probabilities at the
# two places in question are closer than MOE_ROUTE_RTOL relative; the
# logits are compared only on rows no such flip reached.
MOE_F32_LAYERS, MOE_ROUTE_RTOL = 3, 1e-5


def moe_step_bytes(torch, model, cfg):
    """(S, the step) -> the bytes a decode step of S slots reads at least:
    every weight but the routed experts no slot chose (counted from the
    step's own routing, one eager call) and the embedding rows the step
    does not look up (the untied table; a tied one is the unembedding),
    plus each slot's whole cache (the step masks over all ``max_seq``
    positions)."""
    elem = 2  # bf16
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    expert = 3 * cfg.d_model * cfg.moe_d_ff * elem
    n_moe = len(model.layers) if cfg.family == "moe" else 0
    table = 0 if cfg.tie_embeddings else model.embed.table.numel() * elem
    cache_slot = sum(math.prod(shape) for shape in model.cache_shapes(1, DEC_MAX_SEQ).values()) * elem

    def step_bytes(S, step):
        with RouteLog() as log:
            step()
        chosen = sum(len(torch.unique(idx)) for _, _, idx in log.calls)
        return (total - n_moe * cfg.n_experts * expert + chosen * expert
                - table + S * cfg.d_model * elem + S * cache_slot)

    return step_bytes


def prefill_drops(torch, model, cfg, prompts, dev):
    """Each prompt's bucketed prefill, as the plan serves it, at the
    configured capacity factor: its assignments dropped in each MoE layer
    (``_slots``' verdicts, the prompt's own assignments; the pad tokens'
    apart), with the bucket's capacity (``_capacity``)."""
    from repro_torch.models import moe

    out, real = {}, moe._slots
    for p in prompts:
        n = len(p)
        m = next(b for b in DEC_BUCKETS if b >= n)
        fits = []

        def recorded(e_flat, n_experts, capacity):
            slot, fit = real(e_flat, n_experts, capacity)
            fits.append(fit)
            return slot, fit

        t = torch.zeros((1, m), dtype=torch.long, device=dev)
        t[0, :n] = torch.from_numpy(p.astype("int64")).to(dev)
        moe._slots = recorded
        try:
            model.prefill({"tokens": t, "last_pos": n - 1})
        finally:
            moe._slots = real
        a = n * cfg.top_k
        out[n] = dict(bucket=m, capacity=moe._capacity(m, cfg.top_k, cfg.n_experts,
                                                      cfg.capacity_factor),
                      assignments=a, dropped=[int((~f[:a]).sum()) for f in fits],
                      pad_dropped=[int((~f[a:]).sum()) for f in fits])
    return out


def moe_f32_twin(torch, cfg, dev, card):
    """Phase 10c: moonshot's width at depth 3 (one dense and two MoE
    layers), f32, the card against the CPU from the same weights (carried
    through the flat arrays), at the configured capacity factor (prefills
    drop): three requests in one slot batch, every routing call held
    against the CPU's (``route_diffs``: a flip only at a near-tie of the
    CPU's probabilities, MOE_ROUTE_RTOL), each prefill's kept slots equal
    up to its first flip, the logits within 1e-4 relative + 1e-4 x std on
    every row no flip reached, tokens equal up to the first near-tie;
    then, on the card, prefill + decode against ``forward`` in f32."""
    import copy
    import dataclasses

    import numpy as np

    from repro_torch.checkpoint import lm_params_from_flat, flat_from_lm
    from repro_torch.models import build_model, moe
    from repro_torch.runtime import DecodePlan, Request, ServiceConfig

    cfg32 = dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS, dtype="float32")
    card_m = build_model(cfg32, dev).init(torch.Generator(device=dev).manual_seed(0))
    cpu_m = lm_params_from_flat(cfg32, flat_from_lm(card_m), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in DEC_F32_LENGTHS]
    runs, recs, logs, walls = {}, {}, {}, {}
    for name, m in (("card", card_m), ("cpu", cpu_m)):
        rec = LogitRecorder(torch, m)
        plan = DecodePlan(rec, ServiceConfig(plan="decode", max_batch=len(prompts),
                                             max_seq=DEC_MAX_SEQ, buckets=DEC_BUCKETS))
        t0 = time.perf_counter()
        with RouteLog(rec) as log:
            done = sorted(plan.generate(dec_requests(Request, prompts, DEC_F32_NEW)),
                          key=lambda c: c.rid)
        walls[name] = time.perf_counter() - t0
        runs[name], recs[name], logs[name] = rec.logits(done, prompts), rec, log
    check(recs["card"].placed == recs["cpu"].placed,
          "10c: the two plans placed the requests differently")
    n_steps = DEC_F32_NEW - 1
    card_r, cpu_r = (routes(logs[n], recs[n], prompts, n_steps) for n in ("card", "cpu"))
    same = {rid: same_input_rows(runs["card"][rid][0], runs["cpu"][rid][0])
            for rid in range(len(prompts))}
    flips, out = route_diffs(torch, card_r, cpu_r, MOE_ROUTE_RTOL, "10c", own_row=False,
                             same=same)
    # The kept slots of each prefill (the configured capacity, drops and
    # all) agree up to the first flipped token, and each prefill's drops.
    kept, drops = 0, {}
    for rid in range(len(prompts)):
        n = len(prompts[rid])
        cap = moe._capacity(next(b for b in DEC_BUCKETS if b >= n), cfg.top_k, cfg.n_experts,
                            cfg.capacity_factor)
        upto = min([f["token"] for f in flips if f["rid"] == rid and f["row"] == 0] + [n])
        for (ic, _), (ip, _) in zip(card_r[(rid, 0)], cpu_r[(rid, 0)]):
            kc = moe._slots(ic.reshape(-1), cfg.n_experts, cap)[1]
            kp = moe._slots(ip.reshape(-1), cfg.n_experts, cap)[1]
            check(torch.equal(kc[:upto * cfg.top_k], kp[:upto * cfg.top_k]),
                  f"10c: request {rid}: kept slots differ before any flip")
            kept += upto * cfg.top_k
            drops.setdefault(n, []).append(int((~kp).sum()))
    worst, compared = {}, 0
    for rid in range(len(prompts)):
        (ct, cl), (pt, pl) = runs["card"][rid], runs["cpu"][rid]
        k = first_tie(pl)
        check(np.array_equal(ct[:k], pt[:k]),
              f"10c: request {rid}: card tokens {ct[:k]} != CPU tokens {pt[:k]} before step {k}")
        rows = kept_rows(same_input_rows(ct, pt), out.get(rid, ()))
        got, want = cl[rows].cpu(), pl[rows]
        err = (got - want).abs()
        std = float(pl.std())
        check(bool((err <= DEC_F32_TOL * want.abs() + DEC_F32_TOL * std).all()),
              f"10c: request {rid}: card logits {float(err.max()) if rows else 0} from the CPU's "
              f"(std {std})")
        worst[DEC_F32_LENGTHS[rid]] = dict(max_abs=float(err.max()) if rows else None,
                                           logit_std=std, rows=len(rows), first_near_tie=k)
        compared += len(rows)
    # prefill + decode against forward on the card in f32, at full width,
    # under a capacity factor that drops nothing: the gather-based decode
    # step held to the capacity-buffer forward, routing replayed (a choice
    # replayed only at a near-tie below MOE_ROUTE_RTOL).
    twin = copy.copy(card_m)
    twin.cfg = dataclasses.replace(cfg32, capacity_factor=cfg.n_experts / cfg.top_k)
    sc = dict(plan="decode", max_seq=DEC_MAX_SEQ, buckets=DEC_BUCKETS)
    fwd = {}
    for n, lg, want, gaps in forward_check(torch, twin, prompts, sc, dev, DEC_F32_NEW):
        err, std = (lg - want).abs(), float(want.std())
        gap = max((g["rel_gap"] for g in gaps), default=0.0)
        check(gap < MOE_ROUTE_RTOL, f"10c: prompt {n}: a replayed routing {gap} from forward's own")
        check(bool((err <= DEC_F32_TOL * want.abs() + DEC_F32_TOL * std).all()),
              f"10c: prompt {n}: f32 prefill + decode logits {float(err.max())} from forward's "
              f"(std {std})")
        fwd[n] = dict(max_abs=float(err.max()), logit_std=std, replayed_tokens=len(gaps),
                      max_rel_gap=gap)
    print(f"10c [{card}] {cfg.name} full width, depth {MOE_F32_LAYERS}, f32, capacity factor "
          f"{cfg.capacity_factor}: card against CPU, {len(logs['cpu'].calls)} routing calls, "
          f"{kept} prefill assignments' kept slots equal, flips {json.dumps(flips)}; logits over "
          f"{compared} rows {json.dumps(worst)}; CPU prefill drops per MoE layer "
          f"{json.dumps(drops)}; on the card, prefill + decode against forward (routing "
          f"replayed, nothing dropped) {json.dumps(fwd)}; generate wall s {json.dumps(walls)}")
    del card_m, twin
    return dict(per_prompt=worst, rows_compared=compared, flips=flips,
                kept_assignments_compared=kept, prefill_drops=drops, forward_vs_decode=fwd,
                generate_wall_s=walls)


def moe_decoders(torch, ops, card, dev):
    """Phase 10: the MoE family with MLA at full width (10a moonshot,
    10b deepseek-v2 at 4 layers, 10d the async engine and a fleet over
    moonshot, strict serving of moonshot at depth 4, the launcher), then
    10c, the f32 twin; the path launches none of the five kernels."""
    import copy
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    ops.reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    report = dict(memory_at_start=torch.cuda.memory_allocated(dev))
    for label, arch, layers in (("10a", MOE_ARCH, MOE_SERVE_LAYERS), ("10b", MLA_ARCH, MLA_LAYERS)):
        cfg = get_config(arch)
        if layers is not None:
            print(f"{label}: {arch} cut in depth to {layers} of {cfg.n_layers} layers")
            cfg = dataclasses.replace(cfg, n_layers=layers)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        model = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        # The same weights under a capacity factor of E / k: a capacity of
        # at least T, so no prefill or forward drops (the forward and
        # bucketed checks; a bucketed MoE prefill equals an exact one only
        # while nothing drops).
        twin = copy.copy(model)
        twin.cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        rep, prompts, batched, ties = decode_width(
            torch, model, cfg, dev, card, label, twin=twin,
            step_bytes=moe_step_bytes(torch, model, cfg), host_reps=MOE_HOST_REPS)
        rep["init_s"] = init_s
        rep["prefill_drops"] = prefill_drops(torch, model, cfg, prompts, dev)
        print(f"{label} [{card}] dropped assignments per MoE layer of each bucketed prefill at "
              f"capacity factor {cfg.capacity_factor}: {json.dumps(rep['prefill_drops'])}")
        if arch == MOE_ARCH:
            rep.update(decode_async_fleet(torch, model, prompts, batched, ties, dev, card,
                                          label="10d"))
        rep["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        rep["wall_s"] = time.perf_counter() - t0
        print(f"{label} [{card}] {arch}: peak memory {rep['max_memory_allocated']} bytes, "
              f"init {init_s:.2f} s, wall {rep['wall_s']:.2f} s")
        report[arch] = rep
        del model, twin
        gc.collect()
        torch.cuda.empty_cache()
        if arch == MOE_ARCH:  # the launcher needs the card's memory free
            report["strict"] = strict_decoder(torch, dev, card, get_config(MOE_ARCH),
                                              layers=MOE_STRICT_LAYERS, label="10a")
            gc.collect()
            torch.cuda.empty_cache()
            report["launcher"] = launcher_runs((
                ("full", ["--arch", MOE_ARCH, "--full", "--requests", "8", "--max-batch", "4",
                          "--max-seq", "1024"], True),
                ("too_large", ["--arch", MLA_ARCH, "--full"], False),
            ), "10a", card)
    report["f32_twin"] = moe_f32_twin(torch, get_config(MOE_ARCH), dev, card)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(not any(counts.values()), f"10: the MoE decode path launched {counts}")
    return {"moe": counts}, report



# ------------------------------------------------------------ phase 11
# The state-space and front-end families, bf16, random weights from
# torch.Generator seed 0, with phase 7's slots, buckets, prompts and gates:
# mamba2-1.3b (48 Mamba-2 layers, d 2048, 64 heads of 64, state 128; 1.446 B
# parameters, 2.89 GB) and zamba2-2.7b (54 Mamba-2 layers, d 2560, 80 heads
# of 64, state 64, one shared block of 32 heads of 80 and d_ff 10240 after
# every 6 layers; 2.42 B, 4.84 GB), whole, prefilled at exact length (their
# plans ignore the buckets) with a 1- and a 2-token prompt beside phase 7's
# eight, under the conv's K - 1 = 3; internvl2-1b (24 layers, d 896; 0.63 B)
# whole, its text prompts and one batch of patch embeddings.
SSM_ARCH, HYBRID_ARCH, VLM_ARCH = "mamba2-1.3b", "zamba2-2.7b", "internvl2-1b"
# 11a and 11b serve mamba2 and zamba2 cut to 24 layers (zamba2: 4 of its 9
# groups), to keep the script within its time with phase 13;
# the launcher (11e) still serves them whole.
SSM_SERVE_LAYERS = {SSM_ARCH: 24, HYBRID_ARCH: 24}
SSM_LENGTHS = (1, 2) + DEC_LENGTHS
SSM_FORWARD_CHECK = (2, 60, 700)
SSM_LONG, SSM_LONG_SEQ = 8000, 8192  # 31 chunks of 256 and a ragged tail of 64
VLM_TOKENS, VLM_NEW = 32, 8  # the text after the 1024 patch embeddings; tokens decoded after
# 11d: each arch's width cut in depth (zamba2's 12 is two groups), f32,
# the card against the CPU, the 1- and 2-token prompts included.
SSM_F32_LAYERS = {SSM_ARCH: 4, HYBRID_ARCH: 12, VLM_ARCH: 4}
SSM_F32_LENGTHS = (1, 2, 60, 700)
HYBRID_STRICT_LAYERS = 12  # 11e: strict serving of zamba2, two groups
# A Mamba-2 stack in bf16 with random weights is sensitive to the order
# of its roundings: two prefills of one prompt at other chunkings, or its
# bf16 forward and the f32 forward of the same weights, land further
# apart than DEC_FORWARD_TOL x std at mamba2-1.3b's depth (11a prints
# both).  The decode recurrence and the chunked scan round at other
# places, so the stateful families' bf16 forward checks are bounded as the
# MoE one is: the larger of DEC_FORWARD_TOL x std and SSM_DRIFT_FACTOR x
# the model's drift between two prefill shapes.  The algorithm itself is
# held in f32 at full width and depth (``ssm_f32_forward``: prefill +
# decode against forward within DEC_F32_TOL).
SSM_DRIFT_FACTOR = 2.0


def lm_step_bytes(model, cfg):
    """(S, the step) -> the bytes a decode step of S slots moves at least,
    each slot at ``DEC_MAX_SEQ // 2`` tokens (``decode_width``'s timing):
    every weight once (the untied embedding table as the S rows it looks
    up; the hybrid's shared block once at each of its ``n_layers /
    attn_every`` applications), and for each slot a read and a write of
    its recurrent state (the f32 SSM state and the conv history) and a
    read of its k/v up to its length."""
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    table = model.embed.table
    rows = 0 if cfg.tie_embeddings else table.numel() * table.element_size()
    shared = 0
    if cfg.family == "hybrid":
        shared = (cfg.n_layers // cfg.attn_every - 1) * sum(
            p.numel() * p.element_size() for p in model.shared_attn.parameters())
    shapes, dtypes = model.cache_shapes(1, DEC_MAX_SEQ), model.cache_dtypes()
    state = sum(math.prod(s) * dtypes[n].itemsize for n, s in shapes.items() if n not in ("k", "v"))
    kv = sum(math.prod(s) // DEC_MAX_SEQ * dtypes[n].itemsize for n, s in shapes.items()
             if n in ("k", "v")) * (DEC_MAX_SEQ // 2 + 1)
    row = cfg.d_model * table.element_size()
    return lambda S, step: total - rows + shared + S * (row + 2 * state + kv)


def state_bytes(cache) -> int:
    """A cache's recurrent state (every entry but the k/v), in bytes."""
    return sum(t.numel() * t.element_size() for n, t in cache.items() if n not in ("k", "v"))


def long_prompt(torch, model, cfg, dev, card, label, drift):
    """11a-b: one 8000-token prompt (31 chunks of 256 and a ragged tail of
    64): its prefill's device ms, then served to 16 new tokens through a
    single-slot plan with max_seq 8192, prefill + decode held to
    ``forward`` over the whole sequence (the larger of DEC_FORWARD_TOL x
    std and SSM_DRIFT_FACTOR x ``drift``, the model's drift between two
    prefill shapes), and the slot's state bytes against a 2-token
    prompt's."""
    import numpy as np

    rng = np.random.default_rng(13)
    p = rng.integers(0, cfg.vocab_size, SSM_LONG).astype(np.int32)
    t = torch.from_numpy(p.astype(np.int64))[None].to(dev)
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)

    def fn():
        return model.prefill({"tokens": t})

    # One prefill a replay: each takes most of a second on zamba2.
    pre = dict(device_ms=device_ms(torch, fn, flush, reps=1), wall_ms=wall_ms(torch, fn, 1))
    with torch.inference_mode():
        _, c_long = model.prefill({"tokens": t})
        _, c_short = model.prefill({"tokens": t[:, :2]})
    sizes = dict(long=state_bytes(c_long), short=state_bytes(c_short),
                 slot_at_max_seq=[sum(math.prod(s) * model.cache_dtypes()[n].itemsize
                                      for n, s in model.cache_shapes(1, m).items()
                                      if n not in ("k", "v"))
                                  for m in (DEC_MAX_SEQ, SSM_LONG_SEQ)])
    check(sizes["long"] == sizes["short"] == sizes["slot_at_max_seq"][0]
          == sizes["slot_at_max_seq"][1],
          f"{label}: a slot's state bytes grow with its prompt: {sizes}")
    del c_long, c_short
    t0 = time.perf_counter()
    [(n, lg, want, _)] = forward_check(torch, model, [p], dict(plan="decode", max_seq=SSM_LONG_SEQ),
                                       dev, DEC_NEW)
    wall = time.perf_counter() - t0
    err, std = float((lg - want).abs().max()), float(want.std())
    tol = max(DEC_FORWARD_TOL * std, SSM_DRIFT_FACTOR * drift)
    check(err <= tol, f"{label}: the {n}-token prompt's prefill + decode logits {err} from "
                      f"forward's (std {std}, bound {tol})")
    rep = dict(prompt=SSM_LONG, max_seq=SSM_LONG_SEQ, prefill=pre, state_bytes=sizes,
               forward_vs_decode=dict(max_abs=err, logit_std=std, ratio=err / std, tol=tol),
               served_and_forward_wall_s=wall)
    print(f"{label} [{card}] {cfg.name}: a {SSM_LONG}-token prompt, prefill {json.dumps(pre)} ms; "
          f"served to {DEC_NEW} tokens at max_seq {SSM_LONG_SEQ}, prefill + decode {err:.4g} from "
          f"forward (std {std:.4g}); state bytes a slot {json.dumps(sizes)}")
    return rep


def ssm_f32_forward(torch, model, cfg, dev, card, label):
    """11a-b: the bf16 model's weights in f32 at full width and depth, on
    the card: prefill + decode (a single-slot plan, 16 new tokens) against
    ``forward`` over the whole sequence on SSM_FORWARD_CHECK's prompts,
    within DEC_F32_TOL relative + DEC_F32_TOL x std; and the bf16 model's
    ``forward`` against the f32 one on the 700-token prompt (printed: the
    model's own bf16 error)."""
    import dataclasses

    import numpy as np

    from repro_torch.models import build_model

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = build_model(cfg32, dev)
    with torch.no_grad():
        for p32, p in zip(m32.parameters(), model.parameters()):
            p32.copy_(p)
    rng = np.random.default_rng(7)
    lengths = {n: rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in SSM_LENGTHS}
    prompts = [lengths[n] for n in SSM_FORWARD_CHECK]
    sc = dict(plan="decode", max_seq=DEC_MAX_SEQ)
    out = {}
    for n, lg, want, _ in forward_check(torch, m32, prompts, sc, dev, DEC_NEW):
        err, std = (lg - want).abs(), float(want.std())
        check(bool((err <= DEC_F32_TOL * want.abs() + DEC_F32_TOL * std).all()),
              f"{label}: f32 prefill + decode logits {float(err.max())} from forward's (std {std})")
        out[n] = dict(max_abs=float(err.max()), logit_std=std)
    t = torch.from_numpy(prompts[-1].astype(np.int64))[None].to(dev)
    with torch.inference_mode():
        f16 = model({"tokens": t})[0][0].float()
        f32 = m32({"tokens": t})[0][0]
    bf16_err = float((f16 - f32).abs().max())
    del m32, f16, f32
    print(f"{label} [{card}] {cfg.name} in f32 at full width and depth: prefill + decode against "
          f"forward {json.dumps(out)}; the bf16 forward {bf16_err:.4g} from the f32 forward of "
          f"the same weights ({len(prompts[-1])} tokens)")
    return dict(f32_forward_vs_decode=out, bf16_vs_f32_forward_max_abs=bf16_err)


def vlm_embeds(torch, model, cfg, dev, card, label="11c"):
    """11c: one batch of ``n_patches`` random patch embeddings (N(0,
    0.02^2), the token table's scale) and 32 tokens through ``prefill``,
    held against ``forward`` of the same batch, then VLM_NEW greedy decode
    steps from that cache held against ``forward`` over the embeddings,
    the tokens and the decoded ones (DEC_FORWARD_TOL x std); the prefill's
    device ms."""
    from repro_torch.runtime import pad_cache_like

    g = torch.Generator(device=dev).manual_seed(5)
    embeds = torch.randn((1, cfg.n_patches, cfg.d_model), generator=g, device=dev) * 0.02
    toks = torch.randint(0, cfg.vocab_size, (1, VLM_TOKENS), generator=g, device=dev)
    n = cfg.n_patches + VLM_TOKENS
    batch = {"tokens": toks, "embeds": embeds}
    with torch.inference_mode():
        logits, cache = model.prefill(batch)
        check(all(cache[k].shape[2] == n for k in ("k", "v")),
              f"{label}: the prefill's cache covers {cache['k'].shape[2]} positions, want {n}")
        cache = pad_cache_like(cache, model.cache_shapes(1, n + VLM_NEW))
        rows, out = [logits[0].float()], [int(logits[0].argmax())]
        for i in range(VLM_NEW - 1):
            lg, cache = model.decode_step(cache, torch.tensor([[out[-1]]], device=dev), n + i)
            rows.append(lg[0].float())
            out.append(int(lg[0].argmax()))
        seq = torch.cat([toks, torch.tensor([out[:-1]], device=dev)], dim=1)
        full, _ = model({"tokens": seq, "embeds": embeds})
        want = full[0, n - 1:].float()
        got = torch.stack(rows)
        first, _ = model(batch)
    pre_err = float((logits[0].float() - first[0, -1].float()).abs().max())
    err, std = float((got - want).abs().max()), float(want.std())
    check(pre_err <= DEC_FORWARD_TOL * std and err <= DEC_FORWARD_TOL * std,
          f"{label}: with patch embeddings, prefill {pre_err} and prefill + decode {err} from "
          f"forward's (std {std})")
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    pre_ms = device_ms(torch, lambda: model.prefill(batch), flush, reps=DEC_REPS)
    rep = dict(patches=cfg.n_patches, tokens=VLM_TOKENS, prefill_vs_forward_max_abs=pre_err,
               decode_vs_forward_max_abs=err, logit_std=std, decoded=VLM_NEW,
               prefill_device_ms=pre_ms)
    print(f"{label} [{card}] {cfg.name}: {cfg.n_patches} patch embeddings + {VLM_TOKENS} tokens, "
          f"prefill {pre_err:.4g} and {VLM_NEW} decoded tokens {err:.4g} from forward (std "
          f"{std:.4g}); prefill device {pre_ms:.3f} ms")
    return rep


def ssm_decoders(torch, ops, card, dev):
    """Phase 11: the state-space and front-end families at full width and
    depth (11a mamba2-1.3b, 11b zamba2-2.7b, 11c internvl2-1b), 11e strict
    serving of zamba2 at depth 12 and the launcher, then 11d, the f32
    twins; the paths launch none of the five kernels."""
    import dataclasses
    import gc

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    ops.reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    report = dict(memory_at_start=torch.cuda.memory_allocated(dev))
    for label, arch in (("11a", SSM_ARCH), ("11b", HYBRID_ARCH), ("11c", VLM_ARCH)):
        cfg = get_config(arch)
        if arch in SSM_SERVE_LAYERS:
            print(f"{label}: {arch} cut in depth to {SSM_SERVE_LAYERS[arch]} of {cfg.n_layers} layers")
            cfg = dataclasses.replace(cfg, n_layers=SSM_SERVE_LAYERS[arch])
        stateful = cfg.family in ("ssm", "hybrid")
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        model = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        kw = dict(lengths=SSM_LENGTHS, forward_lengths=SSM_FORWARD_CHECK,
                  drift_factor=SSM_DRIFT_FACTOR) if stateful else {}
        rep, _, _, _ = decode_width(torch, model, cfg, dev, card, label,
                                    step_bytes=lm_step_bytes(model, cfg), **kw)
        if stateful:
            st = rep["stats"]
            check(st["prefill_cells"] == len(set(SSM_LENGTHS)) and st["prefill_cell_evictions"] == 0,
                  f"{label}: {st['prefill_cells']} prefill cells ({st['prefill_cell_evictions']} "
                  f"evicted) for {len(set(SSM_LENGTHS))} prompt lengths")
            rep["long_prompt"] = long_prompt(torch, model, cfg, dev, card, label,
                                             rep["bucketed_vs_exact_max_abs"])
            rep["f32"] = ssm_f32_forward(torch, model, cfg, dev, card, label)
        else:
            rep["embeds"] = vlm_embeds(torch, model, cfg, dev, card, label)
        rep["init_s"] = init_s
        rep["state_bytes_a_slot"] = state_bytes(model.init_cache(1, 1))
        rep["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        rep["wall_s"] = time.perf_counter() - t0
        print(f"{label} [{card}] {arch}: {rep['weight_bytes']} weight bytes, state "
              f"{rep['state_bytes_a_slot']} bytes a slot, peak memory "
              f"{rep['max_memory_allocated']} bytes, init {init_s:.2f} s, wall {rep['wall_s']:.2f} s")
        report[arch] = rep
        del model
        gc.collect()
        torch.cuda.empty_cache()
    report["strict"] = strict_decoder(torch, dev, card, get_config(HYBRID_ARCH),
                                      layers=HYBRID_STRICT_LAYERS, label="11e")
    gc.collect()
    torch.cuda.empty_cache()
    report["launcher"] = launcher_runs(tuple(
        (arch, ["--arch", arch, "--full", "--requests", "8", "--max-batch", "4",
                "--max-seq", "1024"], True) for arch in (SSM_ARCH, HYBRID_ARCH, VLM_ARCH)),
        "11e", card)
    report["f32_twin"] = {
        arch: decode_f32_twin(torch, get_config(arch), dev, card, layers=SSM_F32_LAYERS[arch],
                              lengths=SSM_F32_LENGTHS, label="11d")
        for arch in (SSM_ARCH, HYBRID_ARCH, VLM_ARCH)}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(not any(counts.values()), f"11: the ssm, hybrid and vlm decode paths launched {counts}")
    return {"ssm": counts}, report


# Phase 12: the enc-dec family served, and the LM zoo's training path.
# 12a: seamless-m4t-large-v2 as published (24 + 24 layers, d 1024, 16
# heads, gelu 8192, vocab 256206), bf16, random weights from seed 0; each
# request a source of ENC_FRAMES random frame embeddings and a decoder
# prompt, served through the model's functions at 1 and ENC_SLOTS slots.
ENC_ARCH = "seamless-m4t-large-v2"
ENC_FRAMES, ENC_PROMPTS, ENC_NEW, ENC_SLOTS, ENC_MAX_SEQ = 1024, (1, 5, 17, 64), 16, 4, 128
ENC_F32_LAYERS, ENC_F32_PROMPT, ENC_F32_STEPS = 4, 17, 4
# 12b: gemma3-1b trained as published (bf16 compute, f32 masters, remat),
# AdamW under warmup_cosine, TRAIN_BATCH x TRAIN_SEQ tokens a step in
# TRAIN_MICRO microbatches, TRAIN_STEPS steps of token_stream.
TRAIN_ARCH = "gemma3-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 1024, 2, 10
TRAIN_LR, TRAIN_WARMUP, TRAIN_WD = 6e-4, 2, 0.1
# The accumulated step (TRAIN_MICRO microbatches) against the full batch in
# one, bf16: the loss within TRAIN_LOSS_RTOL, each gradient leaf within
# TRAIN_MICRO_GRAD_RTOL of the full batch's, normwise (the CPU tests
# measured two bf16 orders of gemma3's smoke gradients 1.2% apart).
TRAIN_LOSS_RTOL, TRAIN_MICRO_GRAD_RTOL = 2e-3, 5e-2
H100_BF16_PEAK = 989e12  # dense bf16 FLOP/s, H100 SXM data sheet, at 700 W
# 12c: the card against the CPU, one train step at full width and depth 2
# (2 + 2 for the enc-dec); f32: the loss within TWIN_LOSS_RTOL, each
# gradient within TWIN_GRAD_RTOL x |g| + TWIN_GRAD_RTOL x max |g| of its
# leaf, the updated params within rtol 1e-5 / atol 1e-6 wherever the
# CPU's gradient is at least TWIN_STEP_GRAD_FLOOR of its leaf's largest,
# and everywhere within 2 x lr (AdamW's first move is lr x g / (|g| +
# eps): where g is within the gradient rule's noise of zero, the two
# moves may differ by up to 2 x lr); bf16 (matmul_f32's autograd function on the card):
# the loss within TRAIN_LOSS_RTOL and each gradient leaf, normwise, within
# TWIN_BF16_FACTOR x the CPU's own bf16 gradient's distance from its f32
# one.
TWIN_BATCH, TWIN_SEQ, TWIN_FRAMES, TWIN_LR = 1, 64, 64, 1e-3
TWIN_LOSS_RTOL, TWIN_GRAD_RTOL, TWIN_STEP_GRAD_FLOOR, TWIN_BF16_FACTOR = 1e-5, 1e-4, 1e-3, 2.0
# 12c also holds _MatmulF32's backward on the card directly, at 12b's
# shapes (gemma3-1b's logits, one 1,024-token sequence against the
# d x 262,144 tied table; a microbatch's attention score and PV tiles),
# against the f32 autograd of the widened operands on the CPU: each f32
# product before its rounding within BWD_F32_RTOL of the CPU's, normwise
# (f32 sums in another order: ~1e-7; a cotangent rounded to bf16 first
# moves it by ~1e-3, TF32 by ~5e-4), and each bf16 gradient within one
# bf16 ulp of the CPU's f32 product plus BWD_F32_RTOL x (|g| @ |b|^T)
# where the product cancels.  A planted backward that rounds the
# cotangent to bf16 must fail the same rules.
BWD_F32_RTOL = 1e-5
# 12d: the train loop on the card, gemma3-1b's smoke width in bf16 with f32
# masters: LOOP_STEPS steps, a checkpoint every LOOP_CKPT_EVERY.
LOOP_STEPS, LOOP_CKPT_EVERY = 6, 2


def encdec_serve(torch, model, sources, prompts, slots, new, max_seq):
    """Requests served through an enc-dec model's own functions, ``slots``
    at a time: each prefilled alone (its self-attention k/v and its cross
    k/v copied into its slot of one cache), then every slot stepped
    together, a position a row.  Returns rid -> (tokens (new,) numpy,
    logits (new, V) f32 on the host)."""
    import numpy as np

    dev, frames = model.device, sources[0].shape[0]
    out = {}
    for first in range(0, len(prompts), slots):
        group = list(range(first, min(first + slots, len(prompts))))
        cache = model.init_cache(slots, max_seq, frames)
        toks, rows = {}, {}
        for r, rid in enumerate(group):
            lg, made = model.prefill({"enc_embeds": sources[rid][None],
                                      "tokens": torch.from_numpy(prompts[rid]).long()[None].to(dev)})
            for name, t in made.items():
                cache[name][:, r, :t.shape[2]] = t[:, 0]
            lg = lg[0].float().cpu()
            toks[rid], rows[rid] = [int(lg.argmax())], [lg]
        cur = torch.tensor([len(prompts[rid]) for rid in group] + [0] * (slots - len(group)),
                           device=dev)
        for _ in range(new - 1):
            tok = torch.tensor([[toks[rid][-1]] for rid in group] + [[0]] * (slots - len(group)),
                               device=dev)
            lg, cache = model.decode_step(cache, tok, cur)
            lg = lg.float().cpu()  # one read a step
            for r, rid in enumerate(group):
                toks[rid].append(int(lg[r].argmax()))
                rows[rid].append(lg[r])
            cur = cur + 1
        for rid in group:
            out[rid] = (np.array(toks[rid]), torch.stack(rows[rid]))
        del cache
    return out


def encdec_step_bytes(model, cfg, slots, max_seq, frames):
    """The bytes a decode step of ``slots`` slots reads at least: the
    decoder's weights but the cross attention's ``wk``/``wv`` (the step
    reads the cached cross k/v in their place), the unembedding, and each
    slot's self-attention k/v (the step masks over all ``max_seq``
    positions) and cross k/v."""
    unread = (".xattn.wk", ".xattn.wv")
    dec = sum(p.numel() * p.element_size() for name, p in model.dec_layers.named_parameters()
              if not name.endswith(unread))
    dec += sum(p.numel() * p.element_size() for p in model.final_norm.parameters())
    unemb = model.unembed.numel() * model.unembed.element_size()
    kv = 2 * cfg.n_dec_layers * cfg.n_kv_heads * cfg.d_head * 2  # k and v, bf16, a position
    return dec + unemb + slots * kv * (max_seq + frames)


def encdec_f32_twin(torch, cfg, dev, card, sources):
    """12a's f32 check: the card against the CPU at full width and depth
    ENC_F32_LAYERS + ENC_F32_LAYERS, the card's weights carried to the CPU
    through the flat arrays; one request, the CPU's greedy tokens fed to
    both, every step's logits within DEC_F32_TOL relative + DEC_F32_TOL x
    std."""
    import dataclasses

    import numpy as np

    from repro_torch.checkpoint import flat_from_lm, lm_params_from_flat
    from repro_torch.models import build_model

    cfg32 = dataclasses.replace(cfg, n_layers=ENC_F32_LAYERS, n_dec_layers=ENC_F32_LAYERS,
                                dtype="float32")
    card_m = build_model(cfg32, dev).init(torch.Generator(device=dev).manual_seed(0))
    cpu_m = lm_params_from_flat(cfg32, flat_from_lm(card_m), device="cpu")
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, ENC_F32_PROMPT)
    src = sources[0].float().cpu()
    runs = {}
    for name, m, d in (("cpu", cpu_m, torch.device("cpu")), ("card", card_m, dev)):
        toks = runs["cpu"][0] if name == "card" else None
        lg, cache = m.prefill({"enc_embeds": src[None].to(d),
                               "tokens": torch.from_numpy(prompt)[None].to(d)})
        full = m.init_cache(1, ENC_F32_PROMPT + ENC_F32_STEPS, ENC_FRAMES)
        for k, t in cache.items():
            full[k][:, :, :t.shape[2]] = t
        rows, chosen = [lg[0].cpu()], [int(lg[0].argmax())]
        for i in range(ENC_F32_STEPS):
            tok = int(toks[i]) if toks is not None else chosen[-1]
            lg, full = m.decode_step(full, torch.tensor([[tok]], device=d), ENC_F32_PROMPT + i)
            rows.append(lg[0].cpu())
            chosen.append(int(lg[0].argmax()))
        runs[name] = (chosen, torch.stack(rows))
    want, got = runs["cpu"][1], runs["card"][1]
    std = float(want.std())
    err = (got - want).abs()
    check(bool((err <= DEC_F32_TOL * want.abs() + DEC_F32_TOL * std).all()),
          f"12a: f32 depth {ENC_F32_LAYERS}: card logits {float(err.max())} from the CPU's "
          f"(std {std})")
    del card_m, cpu_m
    return dict(max_abs=float(err.max()), logit_std=std, steps=len(want))


def encdec_serving(torch, card, dev, cfg=None):
    """Phase 12a: seamless-m4t-large-v2 at full width and depth, bf16,
    served through its functions at 1 and ENC_SLOTS slots: prefill +
    decode against ``forward`` on the same tokens (DEC_FORWARD_TOL x std),
    slot-batched against single-slot logits (NEAR_TIE / 2, tokens equal up
    to the first near-tie), f32 at depth ENC_F32_LAYERS against the CPU;
    the decode step's device and host ms against its bytes' bound, the
    prefill's device ms, peak memory."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = cfg or get_config(ENC_ARCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, dev).init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(7)
    sources = [torch.from_numpy(rng.standard_normal((ENC_FRAMES, cfg.d_model))
                                .astype(np.float32)).to(dev) for _ in ENC_PROMPTS]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int64) for n in ENC_PROMPTS]
    runs = {}
    for name, slots in (("single", 1), ("batched", ENC_SLOTS)):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runs[name] = encdec_serve(torch, model, sources, prompts, slots, ENC_NEW, ENC_MAX_SEQ)
        runs[name + "_wall_s"] = time.perf_counter() - t1
    single, batched = runs["single"], runs["batched"]
    slot_err, compared, ties = 0.0, 0, {}
    for rid in range(len(prompts)):
        (st, sl), (bt, bl) = single[rid], batched[rid]
        k = ties[rid] = first_tie(sl)
        check(np.array_equal(bt[:k], st[:k]),
              f"12a: request {rid}: slot-batched tokens {bt[:k]} != single-slot {st[:k]} before "
              f"its first near-tie (step {k})")
        rows = same_input_rows(bt, st)
        slot_err = max(slot_err, float((bl[:rows] - sl[:rows]).abs().max()))
        compared += rows
    check(slot_err <= NEAR_TIE / 2,
          f"12a: slot-batched logits {slot_err} from single-slot ones, over NEAR_TIE / 2")
    fwd = {}
    for rid, p in enumerate(prompts):
        toks, lg = single[rid]
        seq = torch.from_numpy(np.concatenate([p, toks[:-1]]))[None].to(dev)
        want = model({"enc_embeds": sources[rid][None], "tokens": seq})[0][0, len(p) - 1:]
        want = want.float().cpu()
        err, std = float((lg - want).abs().max()), float(want.std())
        fwd[len(p)] = dict(max_abs=err, logit_std=std, ratio=err / std)
        check(err <= DEC_FORWARD_TOL * std,
              f"12a: prompt {len(p)}: prefill + decode logits {err} from forward's (std {std})")
    f32 = encdec_f32_twin(torch, cfg, dev, card, sources)

    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    seq64 = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, max(ENC_PROMPTS)))).to(dev)
    prefill = dict(device_ms=device_ms(
        torch, lambda: model.prefill({"enc_embeds": sources[0][None], "tokens": seq64}), flush,
        reps=DEC_REPS))
    steps = {}
    for S in (1, ENC_SLOTS):
        cache = model.init_cache(S, ENC_MAX_SEQ, ENC_FRAMES)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (S, 1))).to(dev)
        cur = torch.full((S,), ENC_MAX_SEQ // 2, device=dev)

        def fn(cache=cache, toks=toks, cur=cur):
            return model.decode_step(cache, toks, cur)

        n_bytes = encdec_step_bytes(model, cfg, S, ENC_MAX_SEQ, ENC_FRAMES)
        dev_ms, host = device_ms(torch, fn, flush, reps=DEC_REPS), wall_ms(torch, fn, 10)
        steps[S] = dict(device_ms=dev_ms, wall_ms=host, bytes=n_bytes,
                        bound_ms=n_bytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
                        device_share=dev_ms / host)
        del cache
    report = dict(
        card=card, params=sum(p.numel() for p in model.parameters()),
        config_param_count=cfg.param_count(),
        weight_bytes=sum(p.numel() * p.element_size() for p in model.parameters()),
        frames=ENC_FRAMES, prompts=list(ENC_PROMPTS), new_tokens=ENC_NEW,
        serve_wall_s={k: runs[k + "_wall_s"] for k in ("single", "batched")},
        first_near_tie=ties, slot_batched_vs_single_max_abs=slot_err, rows_compared=compared,
        forward_vs_decode=fwd, f32_twin=f32, prefill_ms=prefill, decode_step=steps,
        max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        wall_s=time.perf_counter() - t0)
    print(f"12a [{card}] {cfg.name} full width, {cfg.n_layers} + {cfg.n_dec_layers} layers, "
          f"bf16: {report['params']} params ({cfg.param_count()} by param_count), "
          f"{len(prompts)} requests x {ENC_NEW} tokens over {ENC_FRAMES} frames; slot-batched "
          f"logits {slot_err:.4g} from single-slot over {compared} rows (ties {json.dumps(ties)}); "
          f"forward vs decode {json.dumps(fwd)}; f32 depth {ENC_F32_LAYERS} card vs CPU "
          f"{json.dumps(f32)}; prefill ({ENC_FRAMES} frames, {max(ENC_PROMPTS)} tokens) "
          f"{json.dumps(prefill)}; decode step {json.dumps(steps)}; peak memory "
          f"{report['max_memory_allocated']} bytes")
    del model
    return report


def train_flops(cfg, n_params, batch, seq):
    """Model FLOPs of one training step: 6 x N x tokens, plus the attention
    products (QK^T and PV, 2 x 2 x H x d_head a key a query forward, three
    times that with the backward), each query over the keys its layer lets
    it see (gemma3's local layers at most ``window``)."""
    total = 6 * n_params * batch * seq
    for i in range(cfg.n_layers):
        local = cfg.window is not None and not (cfg.global_every and (i + 1) % cfg.global_every == 0)
        keys = sum(min(q + 1, cfg.window) if local else q + 1 for q in range(seq))
        total += 3 * 4 * cfg.n_heads * cfg.d_head * keys * batch
    return total


def grad_gap(torch, got, want):
    """Per leaf, ||got - want|| / ||want||, over two gradient trees."""
    from repro_torch.optim import tree_flatten

    g, w = tree_flatten(got)[0], tree_flatten(want)[0]
    return [float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))
            for a, b in zip(g, w)]


def profiled_ms(torch, fn, trace_path):
    """One call of ``fn`` under ``torch.profiler`` (the card's activity
    only, so the trace stays small): (its result, ``profile_kernels`` of
    the trace: the kernels' busy ms, their span and the idle share, the
    longest gaps; the call's CUDA-event ms)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    trace = profile_kernels(trace_path)
    trace.pop("ours")
    Path(trace_path).unlink()
    return out, trace, start.elapsed_time(end)


def gemma_training(torch, card, dev, cfg=None):
    """Phase 12b: gemma3-1b trained at full width and depth: f32 masters,
    bf16 compute, remat, AdamW under warmup_cosine, TRAIN_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ tokens from token_stream in TRAIN_MICRO
    microbatches.  Every loss finite, the last below the first; the
    accumulated step's loss and gradients against the full batch's; step
    device (profiled) and host ms, tokens/s, model FLOPs and their share of
    the bf16 peak, peak memory."""
    import functools
    import statistics as st

    from repro_torch.configs import get_config
    from repro_torch.data import lm_batches, token_stream
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, microbatched_value_and_grad, warmup_cosine

    cfg = cfg or get_config(TRAIN_ARCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, dev, param_dtype=torch.float32)
    model.init(torch.Generator(device=dev).manual_seed(0))
    params = model.params()
    n_params = sum(p.numel() for p in model.parameters())
    model.to("meta")  # the step reads the tree; the module's own copy is not needed
    tokens = token_stream(TRAIN_STEPS * TRAIN_BATCH * (TRAIN_SEQ + 1) * 2, cfg.vocab_size, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for b in lm_batches(tokens, TRAIN_BATCH, TRAIN_SEQ, epoch=0)][:TRAIN_STEPS]
    check(len(batches) == TRAIN_STEPS, f"12b: {len(batches)} batches for {TRAIN_STEPS} steps")

    # The accumulated step's gradients against the full batch's.
    full_l, full_g = microbatched_value_and_grad(model.loss, 1)(params, batches[0])
    micro_l, micro_g = microbatched_value_and_grad(model.loss, TRAIN_MICRO)(params, batches[0])
    loss_gap = abs(float(micro_l) - float(full_l)) / abs(float(full_l))
    gaps = grad_gap(torch, micro_g, full_g)
    check(loss_gap <= TRAIN_LOSS_RTOL and max(gaps) <= TRAIN_MICRO_GRAD_RTOL,
          f"12b: {TRAIN_MICRO} microbatches against the full batch: loss {loss_gap}, "
          f"gradients up to {max(gaps)} apart")
    del full_g, micro_g

    opt = AdamW(learning_rate=warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS),
                weight_decay=TRAIN_WD)
    opt_state = opt.init(params)
    step = model.make_train_step(opt, n_micro=TRAIN_MICRO)
    losses, host_ms = [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if i == len(batches) - 1:
            (ROOT / "build").mkdir(exist_ok=True)
            (params, opt_state, met), trace, event_ms = profiled_ms(
                torch, functools.partial(step, params, opt_state, batch),
                ROOT / "build" / "train_step.json")
            busy_ms = trace["busy_ms"]
        else:
            params, opt_state, met = step(params, opt_state, batch)
        losses.append(float(met["loss"]))
        host_ms.append((time.perf_counter() - t1) * 1e3)
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f"12b: losses {losses}")
    tokens_step = TRAIN_BATCH * TRAIN_SEQ
    step_ms = st.median(host_ms[1:-1])
    flops = train_flops(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ)
    report = dict(
        card=card, params=n_params, config_param_count=cfg.param_count(),
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, n_micro=TRAIN_MICRO, lr=TRAIN_LR, losses=losses,
        micro_vs_full=dict(loss_rel=loss_gap, grad_rel_max=max(gaps)),
        host_ms=host_ms, step_host_ms=step_ms, step_device_busy_ms=busy_ms,
        step_event_ms=event_ms, device_share=busy_ms / step_ms, profiled_step=trace,
        tokens_per_s=tokens_step / step_ms * 1e3, model_flops=flops,
        bf16_peak_share=flops / (step_ms / 1e3) / H100_BF16_PEAK,
        max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        wall_s=time.perf_counter() - t0)
    print(f"12b [{card}] {cfg.name} trained at full width, {cfg.n_layers} layers, {n_params} "
          f"params, f32 masters, bf16 compute, remat: {TRAIN_STEPS} steps of {tokens_step} "
          f"tokens ({TRAIN_MICRO} microbatches), losses {[round(v, 4) for v in losses]}; "
          f"accumulated vs full batch {json.dumps(report['micro_vs_full'])}; step host ms "
          f"{step_ms:.1f} (median), device busy {busy_ms:.1f} ms (profiled step: "
          f"{json.dumps({k: trace[k] for k in ('kernels', 'span_ms', 'idle_share')})}, "
          f"{event_ms:.1f} event ms), {report['tokens_per_s']:.0f} tok/s, {flops:.4g} model FLOPs, "
          f"{report['bf16_peak_share']:.3f} of the bf16 peak; peak memory "
          f"{report['max_memory_allocated']} bytes")
    del params, opt_state, batches
    return report


def train_twin_step(torch, cfg, dev, batch, update: bool):
    """One train step of ``cfg`` from the same f32 masters (seed 0, made on
    the card) on the card and on the CPU: name -> (loss, gradients, the
    params after the step, or None without ``update``, the seconds
    taken)."""
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, apply_updates, tree_map
    from repro_torch.optim.accumulation import value_and_grad

    cpu = torch.device("cpu")
    card_m = build_model(cfg, dev, param_dtype=torch.float32)
    card_m.init(torch.Generator(device=dev).manual_seed(0))
    params = {"card": card_m.params()}
    params["cpu"] = tree_map(lambda t: t.to(cpu), params["card"])
    card_m.to("meta")
    cpu_m = build_model(cfg, cpu, param_dtype=torch.float32).to("meta")
    out = {}
    for name, m, d in (("card", card_m, dev), ("cpu", cpu_m, cpu)):
        t0 = time.perf_counter()
        b = {k: v.to(d) for k, v in batch.items()}
        loss, grads = value_and_grad(m.loss)(params[name], b)
        new = None
        if update:
            opt = AdamW(learning_rate=TWIN_LR)
            updates, _ = opt.update(grads, opt.init(params[name]), params[name])
            new = tree_map(lambda t: t.cpu(), apply_updates(params[name], updates))
        out[name] = (float(loss), tree_map(lambda t: t.cpu(), grads), new,
                     time.perf_counter() - t0)
    return out


def twin_holds(torch, label, f32, bf16, cfg_name):
    """12c's rules over one model's f32 and bf16 steps (see TWIN_*)."""
    from repro_torch.optim import tree_flatten

    rep = {f"{dt}_{dev}_s": run[dev][3] for dt, run in (("f32", f32), ("bf16", bf16))
           for dev in ("card", "cpu")}
    (cl, cg, cp, _), (pl, pg, pp, _) = f32["card"], f32["cpu"]
    rep["f32_loss_rel"] = abs(cl - pl) / abs(pl)
    check(rep["f32_loss_rel"] <= TWIN_LOSS_RTOL, f"{label} {cfg_name}: f32 loss {cl} vs {pl}")
    worst = 0.0
    for g, w in zip(tree_flatten(cg)[0], tree_flatten(pg)[0]):
        d = (g - w).abs()
        lim = TWIN_GRAD_RTOL * w.abs() + TWIN_GRAD_RTOL * w.abs().max()
        check(bool((d <= lim).all()), f"{label} {cfg_name}: f32 gradient {float(d.max())} apart")
        worst = max(worst, float(d.max() / w.abs().max().clamp_min(1e-30)))
    rep["f32_grad_max_rel_to_leaf_max"] = worst
    noisy, worst_held = 0, 0.0
    for g, w, grad in zip(tree_flatten(cp)[0], tree_flatten(pp)[0], tree_flatten(pg)[0]):
        d = (g - w).abs()
        held = grad.abs() >= TWIN_STEP_GRAD_FLOOR * grad.abs().max()
        out = held & (d > 1e-6 + 1e-5 * w.abs())
        check(not bool(out.any()) and float(d.max()) <= 2 * TWIN_LR,
              f"{label} {cfg_name}: f32 step params {int(out.sum())} apart where the gradient "
              f"is held, {float(d.max())} at most")
        noisy += int((~held & (d > 1e-6 + 1e-5 * w.abs())).sum())
        worst_held = max(worst_held, float(d[held].max()) if bool(held.any()) else 0.0)
    rep["f32_step_params_held_max_abs"] = worst_held
    rep["f32_step_params_apart_at_small_gradients"] = noisy
    (cl, cg, _, _), (pl, pg, _, _) = bf16["card"], bf16["cpu"]
    rep["bf16_loss_rel"] = abs(cl - pl) / abs(pl)
    check(rep["bf16_loss_rel"] <= TRAIN_LOSS_RTOL, f"{label} {cfg_name}: bf16 loss {cl} vs {pl}")
    ratios = []
    for g, w, e in zip(tree_flatten(cg)[0], tree_flatten(pg)[0], tree_flatten(f32["cpu"][1])[0]):
        own = float((w - e).norm())
        gap = float((g - w).norm())
        check(gap <= TWIN_BF16_FACTOR * own,
              f"{label} {cfg_name}: bf16 gradient {gap} from the CPU's, its own bf16 {own}")
        ratios.append(gap / own if own else 0.0)
    rep["bf16_grad_gap_over_own"] = max(ratios)
    return rep


def matmul_f32_backward_on_card(torch, cfg, dev):
    """12c's direct hold of ``_MatmulF32``'s backward (see BWD_F32_RTOL):
    for each case, the gradients a train step takes (autograd through
    ``matmul_f32``), their f32 products before rounding
    (``_matmul_f32_grads``), and a planted variant that rounds the
    cotangent to bf16, each against the CPU's f32 autograd of the widened
    operands."""
    from repro_torch.models.common import _matmul_f32_grads, matmul_f32

    gen = torch.Generator(device=dev).manual_seed(7)
    kh, grp, d = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.d_head
    mb = TRAIN_BATCH // TRAIN_MICRO
    qc, kc = min(cfg.q_chunk, TRAIN_SEQ), min(cfg.kv_chunk, TRAIN_SEQ)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    cases = {
        "logits": (rand(1, TRAIN_SEQ, cfg.d_model), rand(cfg.vocab_size, cfg.d_model).T),
        "score tile": (rand(mb, kh, grp * qc, d), rand(mb, kh, d, kc)),
        "PV tile": (torch.softmax(torch.randn((mb, kh, grp * qc, kc), generator=gen, device=dev),
                                  -1).bfloat16(), rand(mb, kh, kc, d)),
    }

    def held(f32, bf16, want, scale):
        """(normwise rel of the f32 product, elements of the bf16 result
        more than one ulp + BWD_F32_RTOL x scale from the CPU's), on the
        card."""
        rel = float((f32 - want).norm() / want.norm())
        ulp = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-38))) - 7)
        over = (bf16.float() - want).abs() - ulp - BWD_F32_RTOL * scale
        return rel, int((over > 0).sum())

    out = {}
    for name, (a, b) in cases.items():
        la, lb = a.detach().requires_grad_(True), b.detach().requires_grad_(True)
        res = matmul_f32(la, lb)
        g = torch.randn(res.shape, generator=gen, device=dev)
        got = torch.autograd.grad(res, (la, lb), g)
        f32 = _matmul_f32_grads(a, b, g)
        plant = _matmul_f32_grads(a, b, g.bfloat16().float())
        # the scale of each sum, |g| @ |b|^T and |a|^T @ |g|, on the card
        sa, sb = (a.float().abs().requires_grad_(True), b.float().abs().requires_grad_(True))
        scale = torch.autograd.grad(torch.matmul(sa, sb), (sa, sb), g.abs())
        ca = a.float().cpu().requires_grad_(True)
        cb = b.float().cpu().requires_grad_(True)
        want = [t.to(dev) for t in torch.autograd.grad(torch.matmul(ca, cb), (ca, cb), g.cpu())]
        rep = {"shape": [list(a.shape), list(b.shape)]}
        for i, op in enumerate(("a", "b")):
            check(got[i].dtype == (a, b)[i].dtype == torch.bfloat16,
                  f"12c: matmul_f32 {name} grad {op} is {got[i].dtype}")
            rel, off = held(f32[i], got[i], want[i], scale[i])
            p_rel, p_off = held(plant[i], plant[i].bfloat16(), want[i], scale[i])
            check(rel <= BWD_F32_RTOL and off == 0,
                  f"12c: matmul_f32 {name} grad {op}: f32 product {rel} from the CPU's, "
                  f"{off} bf16 elements beyond one ulp")
            check(p_rel > BWD_F32_RTOL or p_off > 0,
                  f"12c: the planted bf16-cotangent backward passes {name} grad {op} ({p_rel})")
            rep[op] = dict(f32_rel=rel, bf16_beyond_ulp=off, planted_f32_rel=p_rel,
                           planted_beyond_ulp=p_off)
        out[name] = rep
        del la, lb, res, g, got, f32, plant, sa, sb, scale, ca, cb, want
    return out


def training_twins(torch, card, dev, cfgs=None):
    """Phase 12c: one train step of gemma3-1b at full width, depth 2, and of
    seamless-m4t at full width, depth 2 + 2, in f32 and in bf16 (f32
    masters), on the card and on the CPU from the same masters."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    report = {}
    for arch in (TRAIN_ARCH, ENC_ARCH):
        base = (cfgs or {}).get(arch) or get_config(arch)
        cut = dict(n_layers=2, n_dec_layers=2) if base.family == "encdec" else dict(n_layers=2)
        batch = {"tokens": torch.from_numpy(rng.integers(0, base.vocab_size, (TWIN_BATCH, TWIN_SEQ))),
                 "labels": torch.from_numpy(rng.integers(0, base.vocab_size, (TWIN_BATCH, TWIN_SEQ)))}
        if base.family == "encdec":
            batch["enc_embeds"] = torch.from_numpy(
                rng.standard_normal((TWIN_BATCH, TWIN_FRAMES, base.d_model)).astype(np.float32))
        steps = {dt: train_twin_step(torch, dataclasses.replace(base, dtype=dt, **cut), dev, batch,
                                     update=dt == "float32")
                 for dt in ("float32", "bfloat16")}
        report[arch] = twin_holds(torch, "12c", steps["float32"], steps["bfloat16"], arch)
        del steps
    t1 = time.perf_counter()
    report["matmul_f32_backward"] = matmul_f32_backward_on_card(
        torch, (cfgs or {}).get(TRAIN_ARCH) or get_config(TRAIN_ARCH), dev)
    report["matmul_f32_backward"]["wall_s"] = time.perf_counter() - t1
    report["wall_s"] = time.perf_counter() - t0
    print(f"12c [{card}] one train step at full width, depth 2 (2 + 2), card against CPU: "
          f"{json.dumps(report)}")
    return report


def loop_on_card(torch, card, dev, cfg=None):
    """Phase 12d: ``train_loop`` on the card (gemma3-1b's smoke width, bf16,
    f32 masters): an uninterrupted run; a run with a failure before its
    first checkpoint and one after it (restored, replayed, ``restarts``
    counted, the history monotonic); a run stopped at step 3 and resumed by
    a second one; the final params of each equal the first's bit for
    bit."""
    import dataclasses
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import latest_checkpoint, load_flat
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.runtime import TrainLoopConfig, train_loop

    cfg = cfg or dataclasses.replace(get_smoke_config(TRAIN_ARCH), dtype="bfloat16")
    t0 = time.perf_counter()
    model = build_model(cfg, dev, param_dtype=torch.float32)
    model.init(torch.Generator(device=dev).manual_seed(0))
    init = model.params()
    rng = np.random.default_rng(9)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 64))).to(dev)
                for k in ("tokens", "labels")} for _ in range(LOOP_STEPS)]
    opt = AdamW(learning_rate=warmup_cosine(1e-3, 2, LOOP_STEPS), weight_decay=0.1)
    step = model.make_train_step(opt, n_micro=1)

    def run(directory, total, injector=None):
        return train_loop(step, init, opt.init(init), lambda i: batches[i],
                          TrainLoopConfig(total_steps=total, ckpt_dir=directory,
                                          ckpt_every=LOOP_CKPT_EVERY),
                          fail_injector=injector)

    def final(directory):
        s, path = latest_checkpoint(directory)
        return s, {k: v for k, v in load_flat(path).items()}

    failed = set()

    def injector(i):
        if i in (1, 3) and i not in failed:  # before and after the first checkpoint (step 2)
            failed.add(i)
            raise RuntimeError(f"injected failure at step {i}")

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        a, b, c = (str(Path(tmp) / n) for n in "abc")
        plain = run(a, LOOP_STEPS)
        faulty = run(b, LOOP_STEPS, injector)
        first = run(c, 3)
        resumed = run(c, LOOP_STEPS)
        check(plain.restarts == 0 and faulty.restarts == 2 and failed == {1, 3},
              f"12d: restarts {plain.restarts} / {faulty.restarts}, failures {failed}")
        check([m["step"] for m in faulty.metrics] == list(range(LOOP_STEPS)),
              f"12d: history {[m['step'] for m in faulty.metrics]}")
        check(first.steps_done == 3 and resumed.steps_done == LOOP_STEPS - 3
              and resumed.metrics[0]["step"] == 3, "12d: the second run did not resume at 3")
        (sa, fa), (sb, fb), (sc, fc) = final(a), final(b), final(c)
        check(sa == sb == sc == LOOP_STEPS and fa.keys() == fb.keys() == fc.keys(),
              f"12d: final checkpoints {sa} / {sb} / {sc}")
        differ = sorted(k for k in fa if not (torch.equal(fa[k], fb[k]) and torch.equal(fa[k], fc[k])))
        check(not differ, f"12d: final params differ from the uninterrupted run's: {differ[:5]}")
        losses = [m["loss"] for m in plain.metrics]
        check([m["loss"] for m in faulty.metrics] == losses,
              "12d: the replayed run's losses differ from the uninterrupted run's")
    report = dict(steps=LOOP_STEPS, ckpt_every=LOOP_CKPT_EVERY, restarts=faulty.restarts,
                  losses=losses, final_bit_equal=True, keys=len(fa),
                  wall_s=time.perf_counter() - t0)
    print(f"12d [{card}] train_loop on the card ({cfg.name} smoke width, bf16): failures at "
          f"steps 1 and 3 restored and replayed ({faulty.restarts} restarts), a run resumed at "
          f"step 3; final params bit for bit the uninterrupted run's over {len(fa)} arrays")
    return report


def train_launcher(card, extra_env=None, specs=None):
    """Phase 12e: ``python -m repro_torch.launch.train`` on the card as a user
    runs it, the two launches at once: each exits 0 with a falling loss."""
    import os
    import re

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **(extra_env or {}))
    specs = specs or (("gemma3-1b full", ["--arch", TRAIN_ARCH, "--full", "--steps", "20"]),
                      ("seamless smoke", ["--arch", ENC_ARCH, "--smoke", "--steps", "20"]))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train", *args],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                    env=env, cwd=ROOT)
             for name, args in specs}  # both at once: neither needs the card to itself
    runs = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            lines = [ln for ln in stdout.splitlines() if ln.startswith("[train]")]
            m = re.search(r"loss ([0-9.]+) -> ([0-9.]+)", stdout)
            check(proc.returncode == 0 and m is not None
                  and float(m.group(2)) < float(m.group(1)),
                  f"12e {name}: rc {proc.returncode}, {lines}: {stderr[-2000:]}")
            runs[name] = dict(rc=proc.returncode, wall_s=time.perf_counter() - t0, lines=lines)
            for ln in lines:
                print(f"12e [{card}] {name}: {ln}")
    finally:
        for proc in procs.values():  # none outlives the phase
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return runs


def encdec_and_training(torch, ops, card, dev):
    """Phase 12: 12a enc-dec serving, 12b gemma3-1b training, 12c the card
    against the CPU in training, 12d the train loop, 12e the launcher; the
    paths launch none of the five kernels."""
    import gc

    ops.reset_launches()
    report = {}
    for key, fn in (("encdec_serving", lambda: encdec_serving(torch, card, dev)),
                    ("training", lambda: gemma_training(torch, card, dev)),
                    ("card_vs_cpu", lambda: training_twins(torch, card, dev)),
                    ("train_loop", lambda: loop_on_card(torch, card, dev)),
                    ("launcher", lambda: train_launcher(card))):
        t0 = time.perf_counter()
        report[key] = fn()
        gc.collect()
        torch.cuda.empty_cache()
        print(f"phase 12 {key} wall: {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(not any(counts.values()), f"12: the enc-dec and training paths launched {counts}")
    return {"encdec_train": counts}, report


# ------------------------------------------------------------ phase 13
# The tooling slice: the dry run and roofline against real steps,
# one pod-scale BCPNN rank through the kernels, the deprecated surfaces.
# 13b's cells: decode at long_500k for mamba2-1.3b and gemma3-1b, whole
# (batch 1, a 524,288-position cache); train and prefill on internvl2-1b.
# The CPU sweep (``python -m repro_torch.launch.dryrun --all``, PERF.md
# §6) finds no train cell that fits one card at its global batch, and
# internvl2-1b's prefill_32k the only prefill cell that does; internvl2-1b
# is the smallest arch.  Each is cut in batch to one step the phase can
# afford: its counted traffic at 3.35 TB/s is ~0.49 s a training sequence
# and ~7.8 s a prefill sequence (PERF.md §6), so train_4k runs 8
# sequences (one a microbatch) and prefill_32k one.  13a counts exactly
# these cells on ``meta``: the two cut cells' counts (a minute each on one
# host core) run in a background process started before phase 10
# (``tooling_background``), niced, with no card visible to it.
TOOL_DECODE = (("mamba2-1.3b", "long_500k"), ("gemma3-1b", "long_500k"))
TOOL_CUT = (("internvl2-1b", "train_4k", 8), ("internvl2-1b", "prefill_32k", 1))
TOOL_MEM_SLACK = 1.25  # the card's peak at most this x the dry run's (allocator blocks, workspaces)
TOOL_SHARE_MAX = 1.05  # no step may read faster than its bound / this
TOOL_DECODE_REPS = 5
TOOL_DIR = ROOT / "build" / "phase13"
# 13c: one rank of bcpnn_xl (launch/dryrun_bcpnn.py): 55,296 inputs, 32 of
# the 512 hypercolumns of 256 MCUs (8,192 units), the pod rank's 1,024 rows
# and the multipod rank's 512, one shard_map hidden step through a one-rank
# NCCL group; the kernels' times at these shapes from XL_REPS graph replays.
XL_N_F, XL_RANK_HCU, XL_MCU = 55296, 32, 256
XL_RANKS = (("pod", 1024), ("multipod", 512))
XL_REPS = 3
# 13d: ServeSession on gemma3-1b at full width, two requests, 8 new tokens.
SESSION_PROMPTS, SESSION_NEW, SESSION_MAX_SEQ = (5, 17), 8, 64


def tooling_background():
    """Start 13a's two slow dry-run counts (the cut train and prefill cells)
    in one niced process that sees no card; phase 13 waits for it."""
    import os

    shutil.rmtree(TOOL_DIR, ignore_errors=True)  # the dry run's CLI skips a record it finds
    TOOL_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    code = ";".join(
        ["from repro_torch.launch import dryrun"]
        + [f"dryrun.main(['--arch', {a!r}, '--shape', {s!r}, '--batch', '{b}', '--tag', 'b{b}', "
           f"'--out', {str(TOOL_DIR)!r}])" for a, s, b in TOOL_CUT])
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            preexec_fn=lambda: os.nice(19))


def tooling_dryrun(proc):
    """13a: the dry run of 13b's cells (the decode cells here, the cut
    cells from the background process) and of bcpnn_xl on both production
    meshes; returns {(arch, shape): (record, roofline record)} and the
    bcpnn_xl records by mesh."""
    from repro_torch.launch import dryrun, dryrun_bcpnn, roofline

    for arch, shape in TOOL_DECODE:
        for m, rec in dryrun.run_cell(arch, shape).items():
            with open(roofline.record_path(str(TOOL_DIR), arch, shape, m), "w") as f:
                json.dump(rec, f)
    t0 = time.perf_counter()
    out, _ = proc.communicate(timeout=900)
    waited = time.perf_counter() - t0
    print(out.strip())
    check(proc.returncode == 0, f"13a: the background dry run exited {proc.returncode}")
    cells = {}
    for arch, shape, *cut in (*TOOL_DECODE, *TOOL_CUT):
        tag = f"b{cut[0]}" if cut else ""
        with open(roofline.record_path(str(TOOL_DIR), arch, shape, "card", tag)) as f:
            rec = json.load(f)
        roof = roofline.analyze_cell(str(TOOL_DIR), arch, shape, tag=tag, mesh="card")
        check(rec["fits_one_card"],
              f"13a: {arch} {shape} at batch {rec['global_batch']} does not fit one card "
              f"({rec['peak_bytes']} bytes)")
        print(f"13a {arch} {shape} batch {rec['global_batch']}"
              + (f" (cut from {dryrun.SHAPES[shape].global_batch})" if cut else "")
              + f": counted on meta {rec['count_s']} s (depths {rec['counted_depths']}): "
              f"flops {rec['flops']} argument bytes {rec['argument_size_in_bytes']} peak bytes "
              f"{rec['peak_bytes']} fits_one_card {rec['fits_one_card']}; roofline at H100 SXM "
              f"700 W peaks: compute {roof['compute_term_s']:.6f} s memory "
              f"{roof['memory_term_s']:.6f} s collective {roof['collective_term_s']} s, bound "
              f"{roof['bound_step_s']:.6f} s ({roof['dominant']})")
        cells[(arch, shape)] = (rec, roof)
    xl = {}
    for mp in (False, True):
        rec = dryrun_bcpnn.run(mp, write=False)
        xl[rec["mesh"]] = rec
        print("13a bcpnn_xl " + json.dumps({k: rec[k] for k in (
            "mesh", "chips", "rank_rows", "rank_hidden_units", "flops_per_device",
            "bytes_per_device", "allreduce_bytes_per_rank", "model_flops", "compute_term_s",
            "memory_term_s", "collective_term_s", "useful_flop_ratio")}))
    print(f"13a waited {waited:.2f} s for the background counts")
    return cells, xl, waited


def _card_batch(torch, cfg, shape, dev, gen):
    """A random batch of ``shape``'s step on the card (batch_specs' shapes)."""
    from repro_torch.configs import batch_specs

    out = {}
    for k, spec in batch_specs(cfg, shape).items():
        if spec.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, tuple(spec.shape), generator=gen,
                                   device=dev, dtype=torch.int32)
        else:
            out[k] = torch.randn(tuple(spec.shape), generator=gen, device=dev).to(spec.dtype)
    return out


def _card_step(torch, cfg, shape, dev):
    """(step, args, model) of one cell's step on the card, the arguments
    ``dryrun.build_cell`` counts: a train step over f32 masters (the
    module's own weights freed, as the dry run holds none), a prefill, or a
    decode step over ``decode_specs``' cache."""
    from repro_torch.configs import decode_specs
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW

    gen = torch.Generator(device=dev).manual_seed(0)
    if shape.kind == "train":
        model = build_model(cfg, dev, param_dtype=torch.float32).init(gen)
        params = model.params()
        model.to("meta")
        opt = AdamW(learning_rate=1e-4, weight_decay=0.1)
        batch = _card_batch(torch, cfg, shape, dev, gen)
        return model.make_train_step(opt), (params, opt.init(params), batch), model
    model = build_model(cfg, dev).init(gen)
    if shape.kind == "prefill":
        batch = _card_batch(torch, cfg, shape, dev, gen)

        def prefill(b):
            with torch.inference_mode():
                return model.prefill(b)

        return prefill, (batch,), model
    spec = decode_specs(cfg, shape, model)
    cache = {k: torch.zeros(tuple(v.shape), dtype=v.dtype, device=dev) for k, v in spec["cache"].items()}
    token = torch.randint(0, cfg.vocab_size, tuple(spec["token"].shape), generator=gen, device=dev,
                          dtype=torch.int32)
    cur = torch.tensor(shape.seq_len - 1, dtype=torch.int32, device=dev)  # the last position

    def decode(c, t, n):
        with torch.inference_mode():
            return model.decode_step(c, t, n)

    return decode, (cache, token, cur), model


def card_count(torch, cfg, shape, dev, depths):
    """The card's FlopCounterMode count of the cell's step, at full depth
    or at the dry run's depths extrapolated as the dry run extrapolates."""
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun

    def one(c):
        step, args, _ = _card_step(torch, c, shape, dev)
        with FlopCounterMode(display=False) as fc:
            step(*args)
        torch.cuda.synchronize()
        return {"flops": int(fc.get_total_flops())}

    dryrun.register_out_dtype_products()
    if depths is None:
        return one(cfg)["flops"]
    counts = [one(dataclasses.replace(cfg, **d)) for d in depths]
    return dryrun._extrapolate_depth(cfg, depths, counts, "flops")


def roofline_on_card(torch, card, dev, cells):
    """13b: each cell's step on the card against its dry run: (i) the
    card's FlopCounterMode count equals the dry run's, (ii) the card's peak
    (above what was allocated before) is at least the arguments' bytes and
    at most TOOL_MEM_SLACK x the dry run's peak, (iii) the step's device
    time (CUDA events, after a warm-up) is at least bound_step_s /
    TOOL_SHARE_MAX (a decode step the median of TOOL_DECODE_REPS after a
    warm-up; a train or prefill step, seconds long, one call after (i)'s
    counts ran its kernels).  Events measure the device's timeline,
    idle gaps included: an eager step that the host holds back reads as
    long as its enqueue.  Returns the report and gemma3-1b's model (13d)."""
    import dataclasses
    import gc

    from repro_torch.configs import SHAPES, get_config

    report, gemma = {}, None
    for arch, shape_name, *cut in (*TOOL_DECODE, *TOOL_CUT):
        rec, roof = cells[(arch, shape_name)]
        cfg = get_config(arch)
        shape = dataclasses.replace(SHAPES[shape_name], global_batch=rec["global_batch"])
        # (i) first: it runs the step's kernels (a decode step whole, a
        # train or prefill step at the dry run's depths), the warm-up of
        # a train or prefill step, whose one timed call takes seconds.
        flops = card_count(torch, cfg, shape, dev, rec["counted_depths"])
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        step, args, model = _card_step(torch, cfg, shape, dev)
        reps = TOOL_DECODE_REPS if shape.kind == "decode" else 1
        if shape.kind == "decode":
            step(*args)  # warm-up
        times = []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated(dev) - base
        ms = statistics.median(times)
        if arch == "gemma3-1b" and shape.kind == "decode":
            gemma = model  # 13d serves it
        del step, args, model
        gc.collect()
        torch.cuda.empty_cache()
        bound = roof["bound_step_s"]
        share = bound / (ms / 1e3)
        r = dict(batch=shape.global_batch, cut=bool(cut), card_flops=flops, dryrun_flops=rec["flops"],
                 card_peak_bytes=peak, dryrun_peak_bytes=rec["peak_bytes"],
                 argument_bytes=rec["argument_size_in_bytes"], step_ms=ms,
                 bound_step_s=bound, bound_by=roof["dominant"], share=share,
                 compute_term_s=roof["compute_term_s"], memory_term_s=roof["memory_term_s"],
                 model_flops=roof["model_flops"], useful_flop_ratio=roof.get("useful_flop_ratio"))
        print(f"13b [{card}] {arch} {shape_name} batch {shape.global_batch}: step {ms:.4f} ms "
              f"(device, CUDA events, median of {reps}), bound {bound * 1e3:.4f} ms "
              f"({roof['dominant']}), share {share:.4f}; FlopCounterMode card {flops} vs meta "
              f"{rec['flops']}; peak {peak} bytes vs dry run {rec['peak_bytes']} "
              f"(arguments {rec['argument_size_in_bytes']})")
        check(flops == rec["flops"], f"13b (i): {arch} {shape_name}: card counts {flops} FLOPs, "
              f"the dry run {rec['flops']}")
        check(rec["argument_size_in_bytes"] <= peak <= TOOL_MEM_SLACK * rec["peak_bytes"],
              f"13b (ii): {arch} {shape_name}: card peak {peak} outside [{rec['argument_size_in_bytes']}, "
              f"{TOOL_MEM_SLACK} x {rec['peak_bytes']}]")
        check(share <= TOOL_SHARE_MAX, f"13b (iii): {arch} {shape_name}: share {share:.4f} of the bound")
        report[f"{arch}/{shape_name}"] = r
    return report, gemma


def xl_state_rule(torch, ops, ref, layer, st, x, mask, got, want):
    """13c's rule for the state of a kernel step against a plain one from
    the same state and rows.  The two forwards differ by phase 3's GEMM
    tolerance in s; over 55,296 inputs s spans hundreds and the gain is 4,
    so where a hypercolumn's top units lie close, a_j moves by more than
    the update's tolerance (a near-tie).  The step's means carry that
    into the traces through the EWMA (lam x the means' difference) and
    into w and b through the logs (the traces' relative difference).  So
    each trace is held within that carry plus the update's tolerance of
    phase 3 (1e-4, 1e-5), and w and b within the carried log differences
    (x 1.5, the first-order terms) plus the same tolerance.  Returns (max
    abs, max rel, the (row, HCU) groups of a_j moved by more than 1e-3)."""
    from repro_torch.core.learning import full_f32_matmul

    s = layer.spec
    rows = x.shape[0]
    fwd = [
        fn_sm(fn_mm(x, st.w, st.b, mask=mask) * s.gain, s.post.n_hcu, s.post.n_mcu)
        for fn_mm, fn_sm in ((ops.masked_matmul, ops.hcu_softmax),
                             (ref.masked_matmul, ref.hcu_softmax))]
    moved = int(((fwd[0] - fwd[1]).abs().view(rows, s.post.n_hcu, s.post.n_mcu).amax(-1)
                 > 1e-3).sum())
    mj = [a.mean(0) for a in fwd]
    mij = [full_f32_matmul(x.T, a) / rows for a in fwd]
    carry_cj = s.lam * (mj[0] - mj[1]).abs()
    carry_cij = s.lam * (mij[0] - mij[1]).abs()
    tol = (1e-4, 1e-5)
    worst_abs = worst_rel = 0.0
    rel_cj = carry_cj / want.marginals.cj.clamp_min(STREAM_EPS)
    rel_cij = carry_cij / want.marginals.cij.clamp_min(STREAM_EPS)
    for g, w, carry in ((got.marginals.cj, want.marginals.cj, carry_cj),
                        (got.marginals.cij, want.marginals.cij, carry_cij),
                        (got.w, want.w, 1.5 * (rel_cij + rel_cj[None, :]) * mask),
                        (got.b, want.b, 1.5 * s.k_b * rel_cj)):
        diff = (g - w).abs()
        limit = carry + tol[0] * w.abs() + tol[1] * float(w.abs().max())
        check(bool(torch.isfinite(g).all()), "13c: the kernel step's state is not finite")
        check(bool((diff <= limit).all()), f"13c: state error {float(diff.max())} beyond its rule")
        worst_abs = max(worst_abs, float(diff.max()))
        big = w.abs() >= 1e-3 * float(w.abs().max())
        worst_rel = max(worst_rel, float((diff[big] / w.abs()[big]).max()))
    return worst_abs, worst_rel, moved


def xl_rank(torch, ops, ref, card, dev, xl, records, backend="nccl"):
    """13c: one rank of bcpnn_xl on the card, through the kernels, at the
    pod and the multipod rank's rows: one shard_map hidden step through a
    one-rank NCCL group against the same step with use_kernels=False (the
    update's tolerance of phase 3 and what the two forwards' near-ties carry,
    ``xl_state_rule``), timed against the dry run's per-device
    terms, then each kernel of the step at its shape against its plain
    version (phase 3's rules), timed beside its bound and the library call;
    the cases join the kernels' records.  Returns its launch counts by path
    and the report."""
    import gc

    import torch.distributed as dist

    from repro_torch.core.distributed import DataParallelTrainer
    from repro_torch.kernels import bcpnn_update as bk
    from repro_torch.kernels import masked_matmul as mk
    from repro_torch.launch.dryrun_bcpnn import xl_layer
    from repro_torch.launch.mesh import make_host_mesh

    by_name = {r["name"]: r for r in records}
    launches, report = {}, {}
    flush = torch.ones(16 << 20, dtype=torch.float32, device=dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        tr = DataParallelTrainer(make_host_mesh(device_type=dev.type), "shard_map")
        layer = xl_layer(XL_N_F, XL_RANK_HCU, XL_MCU)
        plain_layer = xl_layer(XL_N_F, XL_RANK_HCU, XL_MCU, use_kernels=False)
        f, h = XL_N_F, XL_RANK_HCU * XL_MCU
        gen = torch.Generator(device=dev).manual_seed(0)
        st = layer.init(gen)
        mask = st.plast.unit_mask(layer.spec.pre, layer.spec.post).contiguous()
        for mesh_name, rows in XL_RANKS:
            u = torch.rand(rows, f // 2, generator=gen, device=dev)
            x = torch.stack([u, 1 - u], -1).reshape(rows, f)  # complementary-coded
            step, plain_step = tr.hidden_step(layer), tr.hidden_step(plain_layer)
            ops.reset_launches()
            got = step(st, x)
            torch.cuda.synchronize()
            launches[f"xl_rank_{mesh_name}"] = ops.launch_counts()
            want = plain_step(st, x)
            max_abs, max_rel, moved = xl_state_rule(torch, ops, ref, layer, st, x, mask, got, want)
            ms = event_ms(torch, lambda: step(st, x), reps=XL_REPS)
            plain_ms = event_ms(torch, lambda: plain_step(st, x), reps=XL_REPS)
            d = xl[mesh_name]
            local_bound = max(d["compute_term_s"], d["memory_term_s"])
            share = local_bound / (ms / 1e3)
            print(f"13c [{card}] bcpnn_xl {mesh_name} rank ({rows} rows, {f} x {h}): step "
                  f"{ms:.3f} ms (events) plain {plain_ms:.3f} ms; state vs use_kernels=False "
                  f"max_abs {max_abs:.3e} max_rel {max_rel:.3e} ({moved} (row, HCU) groups of "
                  f"a_j moved by more than 1e-3 between the forwards); launches "
                  f"{json.dumps(launches[f'xl_rank_{mesh_name}'])}; dry run a device: compute "
                  f"{d['compute_term_s'] * 1e3:.3f} ms memory {d['memory_term_s'] * 1e3:.3f} ms "
                  f"collective {d['collective_term_s'] * 1e3:.3f} ms; share of max(compute, memory) "
                  f"{share:.4f}")
            check(share <= TOOL_SHARE_MAX, f"13c: {mesh_name} rank step at {share:.4f} of its bound")
            # Each kernel of the step, at its shape.
            s = layer.spec
            aj = ops.hcu_softmax(ops.masked_matmul(x, st.w, st.b, mask=mask) * s.gain,
                                 s.post.n_hcu, s.post.n_mcu)
            mi, mj, mij = x.mean(0), aj.mean(0), (x.T @ aj) / rows
            sc = 4 * torch.randn(rows, h, generator=gen, device=dev)
            m = st.marginals
            p = mk.plan(rows, f, h, mk.n_sm(dev))
            mp = bk.means_plan(f, h, mk.n_sm(dev))
            cases = (
                ("masked_matmul", f"xl {mesh_name} rank x({rows},{f}) @ w({f},{h})*mask + b "
                 f"[plan {p.config} CL={p.cl} {p.ctas} CTAs]",
                 lambda: ops.masked_matmul(x, st.w, st.b, mask=mask),
                 lambda: ref.masked_matmul(x, st.w, st.b, mask=mask),
                 lambda: torch.matmul(x, st.w * mask) + st.b, GEMM_TOL,
                 4 * (rows * f + 2 * f * h + h + rows * h), 2 * rows * f * h + f * h),
                ("hcu_softmax", f"xl {mesh_name} rank s({rows},{XL_RANK_HCU}x{XL_MCU})",
                 lambda: ops.hcu_softmax(sc, XL_RANK_HCU, XL_MCU),
                 lambda: ref.hcu_softmax(sc, XL_RANK_HCU, XL_MCU),
                 lambda: torch.softmax(sc.view(rows, XL_RANK_HCU, XL_MCU), -1), SOFTMAX_TOL,
                 2 * 4 * rows * h, 5 * rows * h),
                ("bcpnn_update", f"xl {mesh_name} rank means mi({f}) mj({h}) mij({f},{h}) masked "
                 f"[plan TH={mp.th} TR={mp.tr} {mp.ctas} CTAs]",
                 lambda: bk.bcpnn_update_means(mi, mj, mij, m.ci, m.cj, m.cij, s.lam, k_b=s.k_b,
                                               mask=mask),
                 lambda: ref.bcpnn_update_means(mi, mj, mij, m.ci, m.cj, m.cij, s.lam, k_b=s.k_b,
                                                mask=mask),
                 None, (1e-4, 1e-5), 4 * (5 * f * h + 3 * f + 4 * h), 7 * f * h),
            )
            for name, label, kernel, plain, library, tol, n_bytes, n_flops in cases:
                g_, w_ = kernel(), plain()
                g_ = g_ if isinstance(g_, tuple) else (g_,)
                w_ = w_ if isinstance(w_, tuple) else (w_,)
                torch.cuda.synchronize()
                k_abs, k_rel = compare(torch, g_, w_, tol)
                del g_, w_
                k_ms = device_ms(torch, kernel, flush, reps=XL_REPS)
                k_plain = device_ms(torch, plain, flush, reps=XL_REPS)
                k_lib = device_ms(torch, library, flush, reps=XL_REPS) if library else None
                bms, bound_by = bound_ms(n_bytes, n_flops)
                print(f"check {name} {label}: max_abs_err={k_abs:.3e} max_rel_err={k_rel:.3e} "
                      f"(tol {tol}) kernel_ms={k_ms:.5f} versus_ms={k_plain:.5f} library_ms="
                      f"{'null' if k_lib is None else f'{k_lib:.5f}'} bound_ms={bms:.5f} ({bound_by})")
                check(bms / k_ms <= TOOL_SHARE_MAX, f"13c: {name} at {bms / k_ms:.4f} of its bound")
                by_name[name]["cases"].append(dict(
                    ms=k_ms, plain_ms=k_plain, bound_ms=bms, bound_by=bound_by, library_ms=k_lib,
                    at=label, max_abs_err=k_abs, max_rel_err=k_rel))
                by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], k_abs)
                torch.cuda.synchronize()
                gc.collect()
            report[mesh_name] = dict(rows=rows, step_ms=ms, plain_step_ms=plain_ms,
                                     max_abs_err=max_abs, max_rel_err=max_rel, share=share,
                                     moved_groups=moved,
                                     dryrun_terms_ms={k: d[k] * 1e3 for k in (
                                         "compute_term_s", "memory_term_s", "collective_term_s")})
            del got, want, x, u, aj, mij, sc
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    for path, counts in launches.items():
        check(counts["masked_matmul"] == counts["hcu_softmax"] == 1
              and counts["bcpnn_update"] == counts["bcpnn_update.means"] == 1,
              f"13c: {path} launched {counts}")
    return launches, report


def session_check(torch, card, dev, model):
    """13d: the deprecated ServeSession on gemma3-1b at full width (the
    model of 13b's decode cell, bf16), two requests of SESSION_NEW tokens:
    its tokens equal DecodePlan's up to the first near-tie of the session's
    own logits (phase 7's rule), and it warns."""
    import warnings

    import numpy as np

    from repro_torch.runtime import Request, ServeSession, ServiceConfig, serve_model

    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(0, model.cfg.vocab_size, n).astype(np.int32),
                    max_new_tokens=SESSION_NEW) for i, n in enumerate(SESSION_PROMPTS)]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        session = ServeSession(model, max_batch=2, max_seq=SESSION_MAX_SEQ)
    check(any(issubclass(w.category, DeprecationWarning) for w in caught),
          "13d: ServeSession did not warn")
    t0 = time.perf_counter()
    done = {c.rid: c for c in session.generate(reqs)}
    session_s = time.perf_counter() - t0
    plan = {c.rid: c for c in serve_model(model, ServiceConfig(
        max_batch=2, max_seq=SESSION_MAX_SEQ)).generate(reqs)}
    report = {}
    for r in reqs:
        toks = done[r.rid].tokens
        seq = torch.as_tensor(np.concatenate([r.prompt, toks[:-1]])[None], device=dev)
        with torch.inference_mode():
            logits = model.forward({"tokens": seq})[0][0, len(r.prompt) - 1:]
        tie = first_tie(logits)
        equal = bool(np.array_equal(toks[:tie], plan[r.rid].tokens[:tie]))
        differ = np.nonzero(toks != plan[r.rid].tokens)[0]
        same = int(differ[0]) if len(differ) else len(toks)
        report[r.rid] = dict(tokens=toks.tolist(), plan=plan[r.rid].tokens.tolist(),
                             first_tie=tie, equal_to_tie=equal, equal_steps=same)
        print(f"13d [{card}] ServeSession request {r.rid} (prompt {len(r.prompt)}): "
              f"{toks.tolist()} vs DecodePlan {plan[r.rid].tokens.tolist()}, first near-tie "
              f"(NEAR_TIE {NEAR_TIE}) at step {tie}; the first {same} of {len(toks)} tokens equal")
        check(equal, f"13d: request {r.rid}: ServeSession and DecodePlan differ before step {tie}")
    report["session_s"] = session_s
    return report


def legacy_fit_check(torch, ops, core, data, policy, card):
    """13e: the deprecated Network.fit(engine="scan") on phase 4's
    configuration cut to 1 + 1 epochs, on the card: its states, predict and
    evaluate equal compile(ExecutionConfig(engine="scan")).fit's on the
    same seed bit for bit.  Returns its launch counts and the report."""
    import warnings

    legacy, split, fit_kw, _ = listing1(core, data, policy)
    x, y, xt, yt = split
    kw = dict(fit_kw, epochs_hidden=1, epochs_readout=1)
    ops.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy.fit((x, y), engine="scan", **kw)
    check(any(issubclass(w.category, DeprecationWarning) for w in caught),
          "13e: Network.fit did not warn")
    acc = legacy.evaluate((xt, yt))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    net, *_ = listing1(core, data, policy)
    compiled = net.compile(core.ExecutionConfig(engine="scan"))
    compiled.fit((x, y), **kw)
    want = compiled.state.layers
    same = all(states_equal(torch, a, b) for a, b in zip(legacy.states, want))
    same_scores = bool(torch.equal(legacy.predict(xt), compiled.predict(xt)))
    c_acc = compiled.evaluate((xt, yt))
    print(f"13e [{card}] Network.fit(engine='scan') 1 + 1 epochs: accuracy {acc:.4f} "
          f"(compiled {c_acc:.4f}), states equal {same}, scores equal {same_scores}; launches "
          f"{json.dumps(counts)}")
    check(same and same_scores and acc == c_acc, "13e: the legacy fit differs from the compiled fit")
    return {"legacy_fit": counts}, dict(accuracy=acc, compiled_accuracy=c_acc)


def tooling(torch, ops, ref, core, data, policy, card, dev, records, proc):
    """Phase 13: 13a the dry runs, 13b the roofline against real steps, 13c
    one bcpnn_xl rank through the kernels, 13d ServeSession, 13e the legacy
    fit."""
    import gc

    report = {}
    t0 = time.perf_counter()
    cells, xl, waited = tooling_dryrun(proc)
    report["13a"] = dict(wall_s=time.perf_counter() - t0, waited_s=waited, xl=xl,
                         cells={f"{a}/{s}": rec for (a, s), (rec, _) in cells.items()})
    ops.reset_launches()
    t0 = time.perf_counter()
    report["13b"], gemma = roofline_on_card(torch, card, dev, cells)
    report["13d"] = session_check(torch, card, dev, gemma)
    torch.cuda.synchronize()
    lm_counts = ops.launch_counts()
    check(not any(lm_counts.values()), f"13b/13d: the LM paths launched {lm_counts}")
    del gemma
    gc.collect()
    torch.cuda.empty_cache()
    report["13b_13d_wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches, report["13c"] = xl_rank(torch, ops, ref, card, dev, xl, records)
    report["13c_wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    legacy_launches, report["13e"] = legacy_fit_check(torch, ops, core, data, policy, card)
    launches.update(legacy_launches)
    report["13e_wall_s"] = time.perf_counter() - t0
    return launches, report


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--dp-rank"]:
        return dp_rank(sys.argv[2:])
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

    # Phase 7: the LM zoo's dense decoder at full width, and the launcher.
    t0 = time.perf_counter()
    dec_launches, dec_report = decoder(torch, ops, card, dev)
    launches.update(dec_launches)
    dec_report["wall_s"] = time.perf_counter() - t0
    print(f"phase 7 (the dense decoder) wall: {dec_report['wall_s']:.2f} s")

    # Phase 8: the hot-path guard: strict mode, profile_dir, use_kernels=False.
    t0 = time.perf_counter()
    guard_launches, guard_report = hot_path_guard(torch, ops, ref, core, data, policy, card, dev)
    launches.update(guard_launches)
    guard_report["wall_s"] = time.perf_counter() - t0
    print(f"phase 8 (the hot-path guard) wall: {guard_report['wall_s']:.2f} s")

    # Phase 9: distribution, the paper's MPI backend.
    t0 = time.perf_counter()
    dp_launches, dp_report = distribution(torch, ops, core, trained, runs, launches, card, dev)
    launches.update(dp_launches)
    dp_report["wall_s"] = time.perf_counter() - t0
    print(f"phase 9 (distribution) wall: {dp_report['wall_s']:.2f} s")

    # Phase 13a's two slow dry-run counts run in a niced background
    # process from here on (CPU only, no card visible to it).
    dry_proc = tooling_background()
    try:
        return _later_phases(torch, ops, ref, core, data, policy, card, dev, records, launches,
                             runs, stage_s, cliffs, per_batch, stages, served, fabric_report,
                             dec_report, guard_report, dp_report, dry_proc)
    finally:
        if dry_proc.poll() is None:
            dry_proc.kill()
            dry_proc.wait()


def _later_phases(torch, ops, ref, core, data, policy, card, dev, records, launches, runs,
                  stage_s, cliffs, per_batch, stages, served, fabric_report, dec_report,
                  guard_report, dp_report, dry_proc) -> int:
    """Phases 10-14 of ``main``."""
    # Phase 10: the MoE family with MLA attention.
    t0 = time.perf_counter()
    moe_launches, moe_report = moe_decoders(torch, ops, card, dev)
    launches.update(moe_launches)
    moe_report["wall_s"] = time.perf_counter() - t0
    print(f"phase 10 (the MoE decoders) wall: {moe_report['wall_s']:.2f} s")

    # Phase 11: the state-space and front-end families at full width.
    t0 = time.perf_counter()
    ssm_launches, ssm_report = ssm_decoders(torch, ops, card, dev)
    launches.update(ssm_launches)
    ssm_report["wall_s"] = time.perf_counter() - t0
    print(f"phase 11 (the state-space and front-end families) wall: {ssm_report['wall_s']:.2f} s")

    # Phase 12: the enc-dec family served, and the LM zoo's training path.
    t0 = time.perf_counter()
    train_launches, train_report = encdec_and_training(torch, ops, card, dev)
    launches.update(train_launches)
    train_report["wall_s"] = time.perf_counter() - t0
    print(f"phase 12 (the enc-dec family and training) wall: {train_report['wall_s']:.2f} s")

    # Phase 13: the tooling slice: the dry run and the roofline against
    # real steps, a bcpnn_xl rank through the kernels, the deprecated
    # surfaces.
    t0 = time.perf_counter()
    tool_launches, tool_report = tooling(torch, ops, ref, core, data, policy, card, dev, records,
                                         dry_proc)
    launches.update(tool_launches)
    tool_report["wall_s"] = time.perf_counter() - t0
    print(f"phase 13 (the tooling slice) wall: {tool_report['wall_s']:.2f} s")

    # Phase 14: the records.
    for rec in records:
        rec["launches_by_path"] = {path: counts[rec["name"]] for path, counts in launches.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        for mode, m in rec.get("modes", {}).items():  # a subset of the kernel's launches
            key = f"{rec['name']}.{mode}"
            m["launches_by_path"] = {path: counts[key] for path, counts in launches.items()}
            m["launches"] = sum(m["launches_by_path"].values())
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
        "decoder": dec_report,
        "hot_path_guard": guard_report,
        "distribution": dp_report,
        "moe_decoders": moe_report,
        "ssm_decoders": ssm_report,
        "encdec_train": train_report,
        "tooling": tool_report,
    }, default=str))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
