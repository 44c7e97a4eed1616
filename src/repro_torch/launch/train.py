"""Training launcher for the port: the LM zoo's families.

    python -m repro_torch.launch.train --arch gemma3-1b --full --steps 20
    python -m repro_torch.launch.train --arch seamless-m4t-large-v2 --steps 20
    python -m repro_torch.launch.train --arch zamba2-2.7b --steps 20 --device cpu

The port of the JAX package's ``repro/launch/train.py``, with its flags
and output lines: the config (``--smoke``, the default, or ``--full``,
the published one) -> ``build_model`` with f32 master weights (random,
``torch.Generator`` seed 0) -> AdamW with ``warmup_cosine(lr, 10,
steps)`` and weight decay 0.1 -> ``token_stream`` cut by ``lm_batches``
-> ``make_train_step(n_micro=1)`` -> ``train_loop`` (checkpoints in
``--ckpt-dir``, resumed from there).  An enc-dec batch is ``--seq``
random frame embeddings and the tokens cut to ``seq // dec_ratio``; a vlm
batch carries ``min(n_patches, seq // 4)`` random patch embeddings before
its tokens.  ``--profile-dir D`` runs the loop under ``torch.profiler``
and writes a Chrome trace to ``D``.  ``--mesh`` takes ``none`` only: the
port's models take no mesh.  Everything runs on ``--device`` (the card
unless ``--device cpu``).
"""
from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core.compiled import resolve_device
from repro_torch.data import lm_batches, token_stream
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.runtime import TrainLoopConfig, train_loop


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list(ARCH_NAMES), required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--mesh", default="none",
                    help="none: the port's models take no mesh, so no other value is taken")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--profile-dir", default=None,
                    help="run the train loop under torch.profiler, a Chrome trace in DIR")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises with no card) or cpu")
    return ap


def batch_fn_for(cfg, args, device):
    """step -> the step's batch on ``device``: the reference's batches
    (``lm_batches`` of one ``token_stream``, the enc-dec and vlm extras
    drawn from one numpy generator in step order)."""
    tokens = token_stream(1_000_000, vocab_size=cfg.vocab_size, seed=0)
    batches = list(lm_batches(tokens, args.batch, args.seq, epoch=0))
    rng = np.random.default_rng(0)

    def on_device(a):
        return torch.as_tensor(a, device=device)

    def batch_fn(step):
        batch = {k: on_device(v) for k, v in batches[step % len(batches)].items()}
        if cfg.family == "encdec":
            s, sd = args.seq, args.seq // cfg.dec_ratio
            batch = {
                "enc_embeds": on_device(
                    rng.standard_normal((args.batch, s, cfg.d_model)).astype(np.float32)),
                "tokens": batch["tokens"][:, :sd],
                "labels": batch["labels"][:, :sd],
            }
        elif cfg.family == "vlm":
            p = min(cfg.n_patches, args.seq // 4)
            batch["embeds"] = on_device(
                rng.standard_normal((args.batch, p, cfg.d_model)).astype(np.float32))
        return batch

    return batch_fn


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.mesh != "none":
        raise SystemExit(f"--mesh {args.mesh}: the port's models take no mesh (only 'none')")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device, param_dtype=torch.float32)
    model.init(torch.Generator(device=device).manual_seed(0))
    params = model.params()
    n = sum(p.numel() for p in model.parameters())
    print(f"[train] {args.arch} ({cfg.family}): {n/1e6:.1f}M params, mesh={args.mesh}")

    opt = AdamW(learning_rate=warmup_cosine(args.lr, 10, args.steps), weight_decay=0.1)
    opt_state = opt.init(params)
    step_fn = model.make_train_step(opt, n_micro=1)

    profile = contextlib.nullcontext()
    if args.profile_dir is not None:
        os.makedirs(args.profile_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profile = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(args.profile_dir))
    with profile:
        res = train_loop(
            step_fn, params, opt_state, batch_fn_for(cfg, args, device),
            TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir),
        )
    losses = [m["loss"] for m in res.metrics]
    print(
        f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
        f"mean step {res.mean_step_s*1e3:.0f}ms"
    )
    return res


if __name__ == "__main__":
    main()
