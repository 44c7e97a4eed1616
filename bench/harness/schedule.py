"""The launches a cell's traffic asks of the program, listed from its
schedule alone.

A training iteration is ``fit((x, y), epochs_hidden, epochs_readout,
batch_size, shuffle=True)`` then ``evaluate((x_test, y_test))``; a scoring
request is ``predict(x, batch_size=chunk)``.  Every hidden batch is one
forward pair (``masked_matmul``, ``hcu_softmax``) and one learning cycle
(``bcpnn_update``); every readout batch one learning cycle; every forward
pass through a layer one forward pair.  With the activation store on, the
training rows are projected through the hidden layer once at the readout
phase's start and the test rows once per ``evaluate``, each in chunks of
the phase's batch, the ragged tail padded to a full chunk (counted by its
real rows); without it the readout epochs run the hidden forward per batch
and ``predict`` runs the whole stack per chunk.  Rewiring launches none of
these kernels.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from bench.harness.counts import Forward, Softmax, Update

Launch = Tuple[str, object]

# The port's BCPNN kernels, as ``ops.launch_counts()`` keys them: what the
# BCPNN kinds' traces summarise and their launches are held to.
KERNELS = ("masked_matmul", "hcu_softmax", "bcpnn_update", "bcpnn_phase", "bf_round")


class Shapes:
    """The layer shapes of a configuration's ``network`` object."""

    def __init__(self, net: Dict):
        self.features = 2 * net["input_features"]
        self.pre_hcu = net["input_features"]
        self.hcu, self.mcu = net["hidden_hcu"], net["hidden_mcu"]
        self.units = self.hcu * self.mcu
        self.classes = net["classes"]
        self.kept = 2 * net["fan_in"]
        self.mask = self.pre_hcu * self.hcu
        self.every = net.get("mask_update_every") or self.hcu

    def hidden_forward(self, rows: int) -> List[Launch]:
        return [("masked_matmul", Forward(rows, self.features, self.units, self.kept, self.mask)),
                ("hcu_softmax", Softmax(rows, self.units))]

    def head_forward(self, rows: int) -> List[Launch]:
        return [("masked_matmul", Forward(rows, self.units, self.classes, self.units)),
                ("hcu_softmax", Softmax(rows, self.classes))]

    def hidden_batch(self, rows: int) -> List[Launch]:
        return self.hidden_forward(rows) + [
            ("bcpnn_update", Update(rows, self.features, self.units, self.mask))]

    def readout_batch(self, rows: int) -> List[Launch]:
        return [("bcpnn_update", Update(rows, self.units, self.classes))]


def chunks(n: int, chunk: int) -> List[int]:
    """Real rows of each chunk of ``n`` rows."""
    return [min(chunk, n - i) for i in range(0, n, chunk)]


def predict(shapes: Shapes, rows: int, chunk: int, store: bool) -> List[Launch]:
    """``predict`` of ``rows`` fresh rows in chunks of ``chunk``."""
    out: List[Launch] = []
    parts = chunks(rows, min(chunk, rows))
    if store:  # the level-1 projection, then the head per chunk
        for r in parts:
            out += shapes.hidden_forward(r)
    for r in parts:
        if not store:
            out += shapes.hidden_forward(r)
        out += shapes.head_forward(r)
    return out


def iteration(shapes: Shapes, traffic: Dict, n_train: int, n_test: int) -> List[Launch]:
    """One training iteration: fit then evaluate."""
    batch = min(traffic["batch_size"], n_train)
    n_batches = n_train // batch
    store = traffic["cache_activations"]
    out: List[Launch] = []
    for _ in range(traffic["epochs_hidden"] * n_batches):
        out += shapes.hidden_batch(batch)
    if traffic["epochs_readout"]:
        if store:
            for r in chunks(n_train, batch):
                out += shapes.hidden_forward(r)
        for _ in range(traffic["epochs_readout"] * n_batches):
            if not store:
                out += shapes.hidden_forward(batch)
            out += shapes.readout_batch(batch)
    return out + predict(shapes, n_test, traffic["evaluate_chunk"], store)


def samples(traffic: Dict, n_train: int) -> int:
    """Samples one iteration trains on, over every hidden and readout epoch."""
    batch = min(traffic["batch_size"], n_train)
    return (traffic["epochs_hidden"] + traffic["epochs_readout"]) * (n_train // batch) * batch


def training_batches(traffic: Dict, n_train: int) -> int:
    batch = min(traffic["batch_size"], n_train)
    return (traffic["epochs_hidden"] + traffic["epochs_readout"]) * (n_train // batch)


def counted(launches: List[Launch]) -> Dict[str, int]:
    """Launches by kernel, as ``ops.launch_counts()`` keys them."""
    out: Dict[str, int] = {}
    for kernel, _ in launches:
        out[kernel] = out.get(kernel, 0) + 1
    return out
