"""The plain reference of the benchmark's BCPNN network: Listing 1 in plain
PyTorch, written from the paper's Algorithm 1 alone.

One hidden layer of hypercolumns (HCUs) of minicolumns (MCUs) fed by
complementary-coded inputs (two-unit input HCUs), trained without labels:
the support ``s = x @ (w o mask) + b`` times the gain, a softmax within each
HCU, the EWMA of the marginals c_i, c_j and C_ij, the weights
``w = log(C_ij / (c_i c_j))`` (masked) and the bias ``log c_j``; every
``mask_update_every`` batches, before the forward, each hidden HCU swaps its
weakest active input HCU for its strongest silent one by mutual information
when the silent one scores strictly higher.  Then one supervised BCPNN
readout, its post activations clamped to one-hot labels, and class scores
as a softmax of the readout's support.

States are dicts of tensors: ``hidden`` holds ``ci, cj, cij, w, b,
hcu_mask``, ``readout`` holds ``ci, cj, cij, w, b``.  The initial state is
drawn from the seed as ``Network(seed).build()`` documents it (one CPU
``torch.Generator``: the log-normal jitter of C_ij, then one ``randperm``
receptive field per hidden HCU; the readout at its uniform prior), and the
epoch order as ``fit(shuffle=True)`` documents it (one
``np.random.default_rng(seed)`` permutation of the whole split an epoch,
trimmed to whole batches).  It imports nothing of the program under test.

Products run in f32 with TF32 off, unless the caller asks for TF32 (the
control's lower precision) with :func:`matmul_precision`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

EPS = 1e-8  # the probability floor before every logarithm
PRE_MCU = 2  # complementary coding: (x, 1 - x)

State = Dict[str, torch.Tensor]


_TF32 = [False]  # products in TF32 inside matmul_precision(True)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Products in TF32 (``tf32``: the card's TF32 switched on, and every
    operand rounded to TF32's 10 mantissa bits, which is what the card does
    and what the CPU does not) or in full f32 inside the block."""
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision(), _TF32[0])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    _TF32[0] = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before[:2]
        torch.set_float32_matmul_precision(before[2])
        _TF32[0] = before[3]


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to 10 mantissa bits, to nearest, ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _TF32[0]:
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def weights(ci, cj, cij):
    """(w, b) from the marginals, every probability floored at EPS."""
    log_cj = torch.log(torch.clamp_min(cj, EPS))
    w = (torch.log(torch.clamp_min(cij, EPS)) - torch.log(torch.clamp_min(ci, EPS))[:, None]
         - log_cj[None, :])
    return w, log_cj


def unit_mask(hcu_mask: torch.Tensor, post_mcu: int) -> torch.Tensor:
    """The (input HCU, hidden HCU) mask spread over units."""
    return hcu_mask.repeat_interleave(PRE_MCU, 0).repeat_interleave(post_mcu, 1)


def softmax_per_hcu(s: torch.Tensor, n_mcu: int) -> torch.Tensor:
    return torch.softmax(s.reshape(s.shape[0], -1, n_mcu), dim=-1).reshape(s.shape)


def learn(state: State, ai, aj, lam: float, mask=None) -> State:
    """One learning cycle: batch means, EWMA, weights (masked), bias."""
    out = dict(state)
    out["ci"] = (1.0 - lam) * state["ci"] + lam * ai.mean(0)
    out["cj"] = (1.0 - lam) * state["cj"] + lam * aj.mean(0)
    out["cij"] = (1.0 - lam) * state["cij"] + lam * (mm(ai.T, aj) / ai.shape[0])
    w, out["b"] = weights(out["ci"], out["cj"], out["cij"])
    out["w"] = w if mask is None else w * mask
    return out


def mutual_information(state: State, post_mcu: int) -> torch.Tensor:
    """MI of every (input HCU, hidden HCU) pair: the sum over their units of
    C_ij log(C_ij / (c_i c_j))."""
    ci, cj, cij = (torch.clamp_min(state[k], EPS) for k in ("ci", "cj", "cij"))
    point = cij * (torch.log(cij) - torch.log(ci)[:, None] - torch.log(cj)[None, :])
    n_pre, n_post = cij.shape[0] // PRE_MCU, cij.shape[1] // post_mcu
    return point.reshape(n_pre, PRE_MCU, n_post, post_mcu).sum(dim=(1, 3))


def rewire(hcu_mask: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """One swap per hidden HCU (first index among ties), fan-in kept."""
    active = hcu_mask > 0.5
    cols = torch.arange(hcu_mask.shape[1], device=hcu_mask.device)
    worst = torch.where(active, scores, torch.inf).argmin(0)
    best = torch.where(active, -torch.inf, scores).argmax(0)
    swap = (scores[best, cols] > scores[worst, cols]) & active.any(0) & (~active).any(0)
    out = hcu_mask.clone()
    out[worst[swap], cols[swap]] = 0.0
    out[best[swap], cols[swap]] = 1.0
    return out


def init_state(net: Dict, seed: int):
    """(hidden, readout) as drawn from ``seed``, on the CPU."""
    gen = torch.Generator().manual_seed(int(seed))
    features, n_pre = 2 * net["input_features"], net["input_features"]
    post_hcu, post_mcu = net["hidden_hcu"], net["hidden_mcu"]
    units, classes = post_hcu * post_mcu, net["classes"]
    pi, pj = 1.0 / PRE_MCU, 1.0 / post_mcu
    ci = torch.full((features,), pi)
    cj = torch.full((units,), pj)
    cij = torch.full((features, units), pi * pj)
    cij = cij * torch.exp(net["init_jitter"] * torch.randn((features, units), generator=gen))
    fields = torch.stack([torch.randperm(n_pre, generator=gen) < net["fan_in"]
                          for _ in range(post_hcu)])
    hcu_mask = fields.T.to(torch.float32).contiguous()
    w, b = weights(ci, cj, cij)
    hidden = dict(ci=ci, cj=cj, cij=cij, w=w * unit_mask(hcu_mask, post_mcu), b=b,
                  hcu_mask=hcu_mask)
    rci = torch.full((units,), pj)
    rcj = torch.full((classes,), 1.0 / classes)
    rcij = torch.full((units, classes), pj / classes)
    rw, rb = weights(rci, rcj, rcij)
    return hidden, dict(ci=rci, cj=rcj, cij=rcij, w=rw, b=rb)


def epoch_orders(seed: int, n_total: int, batch: int, count: int) -> List[np.ndarray]:
    """The first ``count`` epochs' shuffled rows, trimmed to whole batches."""
    rng = np.random.default_rng(int(seed))
    n = (n_total // batch) * batch
    return [rng.permutation(n_total)[:n] for _ in range(count)]


def hidden_step(net: Dict, state: State, step: int, xb: torch.Tensor) -> State:
    """Algorithm 1 for the ``step``-th hidden batch (0-based): rewire on
    schedule, forward, learn."""
    post_mcu = net["hidden_mcu"]
    every = net.get("mask_update_every") or net["hidden_hcu"]
    if net["fan_in"] < net["input_features"] and step % every == 0:
        state = dict(state, hcu_mask=rewire(state["hcu_mask"], mutual_information(state, post_mcu)))
    mask = unit_mask(state["hcu_mask"], post_mcu)
    s = (mm(xb, state["w"] * mask) + state["b"]) * net["gain"]
    return learn(state, xb, softmax_per_hcu(s, post_mcu), net["lam"], mask)


def hidden_codes(net: Dict, state: State, x: torch.Tensor, chunk: int = 1024) -> torch.Tensor:
    """The hidden layer's codes of ``x``, ``chunk`` rows at a time."""
    w = state["w"] * unit_mask(state["hcu_mask"], net["hidden_mcu"])
    parts = []
    for i in range(0, x.shape[0], chunk):
        s = (mm(x[i:i + chunk], w) + state["b"]) * net["gain"]
        parts.append(softmax_per_hcu(s, net["hidden_mcu"]))
    return torch.cat(parts)


def readout_epoch(net: Dict, state: State, h: torch.Tensor, y: torch.Tensor,
                  order: np.ndarray, batch: int) -> State:
    """One supervised epoch of the readout over ``order`` in batches."""
    rows = torch.as_tensor(order, device=h.device)
    for part in rows.split(batch):
        aj = torch.nn.functional.one_hot(y.index_select(0, part).long(), net["classes"])
        state = learn(state, h.index_select(0, part), aj.to(h.dtype), net["readout_lam"])
    return state


def scores(net: Dict, readout: State, h: torch.Tensor) -> torch.Tensor:
    """Class scores: the readout's support times its gain, softmax."""
    s = (mm(h, readout["w"]) + readout["b"]) * net.get("readout_gain", 1.0)
    return torch.softmax(s, dim=-1)
