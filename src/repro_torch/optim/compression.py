"""Gradient compression for the data-parallel all-reduce.

The port of ``repro/optim/compression.py``'s two schemes, each a function
of a gradient tree:

* **top-k with error feedback** (Lin et al., Deep Gradient Compression):
  keep the k largest-|g| entries of each tensor (after adding back the
  residual of the steps before), send them, and keep the rest as the new
  residual;
* **int8 all-reduce**: a symmetric per-tensor int8 grid whose scale is the
  largest |g| over the group, the codes summed in int32 and dequantised
  to the mean.

``axes=None`` runs them locally (the reference's tests); a
``torch.distributed`` process group in its place (as Slice D's trainer
takes its groups) makes them collective: the reference's
``pmean``/``pmax``/``psum`` over a mesh axis become ``all_reduce`` over
the group.  ``wire_fraction`` is the modelled
collective volume against a dense f32 all-reduce.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adamw import tree_flatten, tree_map


class ErrorFeedbackState(NamedTuple):
    residual: Any  # the grads' structure, f32


def init_error_feedback(grads_like) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_like))


def _topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k largest-|x| entries (flattened) as a 0/1 mask of x's dtype;
    every entry tied with the k-th is kept, as the reference keeps it."""
    flat = x.reshape(-1).abs()
    k = min(k, flat.shape[0])
    thresh = torch.topk(flat, k).values[-1]
    return (x.abs() >= thresh).to(x.dtype)


def topk_compress_allreduce(
    grads, ef: ErrorFeedbackState, k_fraction: float = 0.01, axes=None,
) -> Tuple[Any, ErrorFeedbackState, float]:
    """Top-k + error feedback; returns (the mean sent grads, the new
    state, wire_fraction: (int32 index + f32 value) a kept entry against
    f32 a dense one)."""

    def one(g, r):
        g32 = g.to(torch.float32) + r
        k = max(1, int(k_fraction * g32.numel()))
        sent = g32 * _topk_mask(g32, k)
        new_r = g32 - sent
        if axes is not None:
            sent = sent.clone()
            dist.all_reduce(sent, op=dist.ReduceOp.SUM, group=axes)
            sent = sent / dist.get_world_size(axes)
        return sent.to(g.dtype), new_r

    flat_g, rebuild = tree_flatten(grads)
    out = [one(g, r) for g, r in zip(flat_g, tree_flatten(ef.residual)[0])]
    return (rebuild([o[0] for o in out]),
            ErrorFeedbackState(residual=rebuild([o[1] for o in out])), 2.0 * k_fraction)


def int8_allreduce(grads, axes=None) -> Tuple[Any, float]:
    """Symmetric per-tensor int8 quantise -> sum in int32 -> dequantise to
    the mean; returns (the mean grads, wire_fraction 0.25).  The scale is
    maxed over the group first, so every rank quantises on one grid."""

    def one(g):
        g32 = g.to(torch.float32)
        scale = torch.max(torch.abs(g32)) / 127.0 + 1e-12
        if axes is not None:
            dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=axes)
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        if axes is None:
            return (q.to(torch.float32) * scale).to(g.dtype)
        tot = q.to(torch.int32)
        dist.all_reduce(tot, op=dist.ReduceOp.SUM, group=axes)
        n = torch.tensor(dist.get_world_size(axes), dtype=torch.float32, device=g.device)
        return (tot.to(torch.float32) * scale / n).to(g.dtype)

    return tree_map(one, grads), 0.25
