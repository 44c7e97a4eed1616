"""Faults planted in the program under test, to show that the check catches
them, and the control: the plain reference computed in the next lower
precision (TF32 products) put in the program's place.

Each fault is a context manager that patches the port's modules for the
duration of a run:

* ``half``: every learning cycle takes the mean over the first half of its
  batch and leaves the rest out;
* ``unchanged``: every hidden training batch returns its state unchanged;
* ``answer``: the readout's class scores come out with the first row's
  order reversed, so its best class becomes its worst.
"""
from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Dict

import torch

from bench.reference import bcpnn as ref


@contextlib.contextmanager
def half():
    from repro_torch.kernels import ops

    inner = ops.bcpnn_update

    def update(marginals, ai, aj, *args, **kw):
        n = max(1, ai.shape[0] // 2)
        return inner(marginals, ai[:n].contiguous(), aj[:n].contiguous(), *args, **kw)

    ops.bcpnn_update = update
    try:
        yield
    finally:
        ops.bcpnn_update = inner


@contextlib.contextmanager
def unchanged():
    from repro_torch.core.layers import StructuralPlasticityLayer

    inner = StructuralPlasticityLayer.train_batch

    def train_batch(self, state, x):
        return state, inner(self, state, x)[1]

    StructuralPlasticityLayer.train_batch = train_batch
    try:
        yield
    finally:
        StructuralPlasticityLayer.train_batch = inner


@contextlib.contextmanager
def answer():
    from repro_torch.kernels import ops

    inner = ops.hcu_softmax

    def softmax(s, n_hcu, n_mcu, *args, **kw):
        out = inner(s, n_hcu, n_mcu, *args, **kw)
        if n_hcu == 1:  # the readout's class scores
            out = out.clone()
            row = out[0].clone()
            out[0] = row.sort().values.flip(0)[torch.argsort(torch.argsort(row))]
        return out

    ops.hcu_softmax = softmax
    try:
        yield
    finally:
        ops.hcu_softmax = inner


FAULTS = {"half": half, "unchanged": unchanged, "answer": answer}


def control(gen) -> SimpleNamespace:
    """What the TF32 reference puts out in the program's place, stage by
    stage from the same inputs as the program's stages (``gen`` after its
    set-up): the stand-in ``observed`` that ``gen.numbers`` judges."""
    dev = gen.device
    if gen.kind == "score":
        hidden, readout = gen.reference_readout(tf32=True)
        served = []
        with ref.matmul_precision(True):
            for xb in gen.pool:
                s = ref.scores(gen.net, readout, ref.hidden_codes(
                    gen.net, hidden, xb, gen.traffic["predict_chunk"]))
                served.append(s.argmax(-1).to(torch.uint8).cpu())
        return SimpleNamespace(readout={k: v.cpu() for k, v in readout.items()}, served=served)
    orders = gen.orders()
    after: Dict[int, Dict] = {}
    checked = []
    chunk = gen.traffic["evaluate_chunk"]

    def classes(snap):  # the test rows' classes from the program's state
        h = {n: v.to(dev) for n, v in snap["hidden"].items()}
        r = {n: v.to(dev) for n, v in snap["readout"].items()}
        sc = ref.scores(gen.net, r, ref.hidden_codes(gen.net, h, gen.xt, chunk))
        return sc.argmax(-1).to(torch.uint8).cpu()

    with ref.matmul_precision(True):
        for it in gen.checked:
            for step in it["steps"]:
                before = {n: v.to(dev) for n, v in gen.state_before(step).items()}
                out = ref.hidden_step(gen.net, before, step, gen.rows_of(orders, step))
                after[step] = {n: v.cpu() for n, v in out.items()}
            h = {n: v.to(dev) for n, v in it["hidden"].items()}
            codes = ref.hidden_codes(gen.net, h, gen.x, gen.batch)
            r = ref.readout_epoch(
                gen.net, {n: v.to(dev) for n, v in it["readout_before"].items()}, codes, gen.y,
                orders[it["t"] * gen.epochs_per_iter + gen.traffic["epochs_hidden"]], gen.batch)
            checked.append(dict(readout={n: v.cpu() for n, v in r.items()},
                                classes=classes(it)))
        end = dict(classes=classes(gen.end)) if gen.end is not None else None
    return SimpleNamespace(after=after, checked=checked, end=end)


__all__ = ["FAULTS", "control"]
