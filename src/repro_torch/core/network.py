"""Keras-like DSL for BCPNN networks (the paper's Listing 1).

::

    model = Network(seed=0)
    model.add(StructuralPlasticityLayer(...))   # input -> hidden, unsupervised
    model.add(DenseLayer(...))                  # hidden -> output, supervised
    compiled = model.compile(ExecutionConfig(engine="scan"))   # device="cuda"
    compiled.fit((x, y), epochs_hidden=2, epochs_readout=2)
    compiled.evaluate((x_test, y_test))

``Network`` is declarative: layers plus a seed.  Everything about execution
binds in the compile step (:mod:`repro_torch.core.compiled`).  Initial
states are drawn on the CPU from one ``torch.Generator`` seeded with
``seed``, so a network compiled for the card and one compiled for the CPU
start from identical states.

A *hybrid* readout (``fit(readout="sgd")``) replaces the BCPNN readout
phase with AdamW cross-entropy training of a linear softmax head on the
frozen hidden codes (:func:`sgd_readout_setup`), the configuration the
paper reports at 97.5%+.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.layers import DenseLayer, LayerState, StructuralPlasticityLayer
from repro_torch.core.learning import full_f32_matmul
from repro_torch.optim import AdamW


@dataclasses.dataclass
class FitResult:
    """Bookkeeping returned by ``fit``/``partial_fit``: one ``history``
    entry per epoch (``phase``, ``epoch``, ``seconds``, ``host_s``,
    ``device_wait_s``) plus one per phase-boundary projection."""

    epochs_hidden: Any
    epochs_readout: int
    batch_size: int
    wall_time_s: float
    history: List[dict]


def sgd_readout_setup(
    seed: int,
    n_hidden: int,
    y,
    lr: float,
    n_classes: Optional[int] = None,
    init_params: bool = True,
    device="cpu",
):
    """The hybrid readout's (params, opt, opt_state, loss_fn), shared by
    both execution plans: AdamW (``lr``, weight decay 1e-4) on a linear
    head ``{"w": (n_hidden, n_classes), "b": (n_classes,)}`` with the mean
    cross-entropy loss.

    The head's weights are ``N(0, 1) / sqrt(n_hidden)``, drawn on the CPU
    from a ``torch.Generator`` seeded with ``seed + 1`` and placed on
    ``device`` (the bits differ from the reference's ``jax.random`` draw;
    parity tests carry its head across).  ``n_classes`` defaults to the
    labels' range.  ``init_params=False`` skips the head and the moments
    (both come back None) for paths that resume a stored head.
    """
    if n_classes is None:
        n_classes = int(np.max(y)) + 1
    opt = AdamW(learning_rate=lr, weight_decay=1e-4)
    params = None
    if init_params:
        g = torch.Generator().manual_seed(seed + 1)
        w = torch.randn((n_hidden, n_classes), generator=g, dtype=torch.float32)
        params = {
            "w": (w * (1.0 / np.sqrt(n_hidden))).to(device),
            "b": torch.zeros((n_classes,), dtype=torch.float32, device=device),
        }

    def loss_fn(p, hb, yb):
        # Every batch holds B real rows: epochs are trimmed to a multiple
        # of B, never padded, so the mean counts no padding.
        logits = full_f32_matmul(hb, p["w"]) + p["b"]
        logz = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, yb.long()[:, None])[:, 0]
        return torch.mean(logz - ll)

    opt_state = opt.init(params) if params is not None else None
    return params, opt, opt_state, loss_fn


class Network:
    """A sequential BCPNN network (hidden plasticity layers + one readout)."""

    def __init__(self, seed: int = 0):
        self.layers: List[Any] = []
        self.states: List[LayerState] = []
        self.seed = seed
        self._built = False

    def add(self, layer) -> "Network":
        if self._built:
            raise RuntimeError("Cannot add layers after the network is built")
        if self.layers and not isinstance(self.layers[-1], StructuralPlasticityLayer):
            raise ValueError(
                "Only the final layer may be a DenseLayer readout; hidden "
                "layers must be StructuralPlasticityLayer"
            )
        self.layers.append(layer)
        return self

    def build(self) -> "Network":
        """Initialize all layer states on the CPU (idempotent)."""
        if self._built:
            return self
        if not self.layers:
            raise ValueError("Network has no layers")
        generator = torch.Generator().manual_seed(self.seed)
        self.states = [layer.init(generator) for layer in self.layers]
        self._built = True
        return self

    def compile(self, config=None):
        """Bind this model to an :class:`ExecutionConfig` (default: the scan
        engine on the CUDA device) and return a CompiledNetwork."""
        from repro_torch.core.compiled import CompiledNetwork

        return CompiledNetwork(self, config)

    @property
    def hidden_layers(self) -> List[StructuralPlasticityLayer]:
        return [la for la in self.layers if isinstance(la, StructuralPlasticityLayer)]

    @property
    def readout_layer(self) -> Optional[DenseLayer]:
        return self.layers[-1] if isinstance(self.layers[-1], DenseLayer) else None
