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
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch

from repro_torch.core.layers import DenseLayer, LayerState, StructuralPlasticityLayer


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
