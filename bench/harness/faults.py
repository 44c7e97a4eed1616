"""Faults planted in the program under test, to show that the check catches
them: those of the BCPNN kinds (``bench/kinds/train.py`` and ``score.py``
name them in their ``faults``; a kind's control is its own ``control()``).

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

import torch


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
