"""The system under test, as the benchmark drives it: Listing 1 on the
PyTorch/CUDA port (``repro_torch``), built from a configuration file.

The port is imported inside these functions only, so the harness's other
modules (and the reference) load without it.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

HIDDEN_KEYS = ("ci", "cj", "cij", "w", "b", "hcu_mask")
READOUT_KEYS = ("ci", "cj", "cij", "w", "b")


def build(cfg: Dict, seed: int, device, cache_activations: bool):
    """``Network(seed)`` + one ``StructuralPlasticityLayer`` + one
    ``DenseLayer``, compiled with the default ``ExecutionConfig`` on
    ``device`` (the activation store as the traffic says)."""
    from repro_torch.core import (
        DenseLayer, ExecutionConfig, Network, StructuralPlasticityLayer, UnitLayout,
        complementary_layout, onehot_layout,
    )

    n = cfg["network"]
    hidden = UnitLayout(n["hidden_hcu"], n["hidden_mcu"])
    net = Network(seed=int(seed))
    net.add(StructuralPlasticityLayer(
        complementary_layout(n["input_features"]), hidden, fan_in=n["fan_in"], lam=n["lam"],
        k_b=n["k_b"], mask_update_every=n["mask_update_every"], gain=n["gain"],
        init_jitter=n["init_jitter"],
    ))
    net.add(DenseLayer(hidden, onehot_layout(n["classes"]), lam=n["readout_lam"], k_b=n["k_b"],
                       gain=n["readout_gain"]))
    return net.compile(ExecutionConfig(device=str(device), cache_activations=cache_activations))


def leaves(layer_state, keys: Iterable[str], device: Optional[str] = "cpu") -> Dict[str, torch.Tensor]:
    """Copies of a layer state's tensors by the reference's names (on the
    host unless ``device`` says otherwise)."""
    table = {"ci": layer_state.marginals.ci, "cj": layer_state.marginals.cj,
             "cij": layer_state.marginals.cij, "w": layer_state.w, "b": layer_state.b}
    if layer_state.plast is not None:
        table["hcu_mask"] = layer_state.plast.hcu_mask
    return {k: table[k].detach().to(device, copy=True) for k in keys}


class StepTap:
    """Copies the hidden layer's state before and after chosen training
    batches (counted from the compile; ``start`` batches were trained before
    the tap) while the program trains, by wrapping the bound hidden layer's
    ``train_batch`` (looked up per batch by the epoch loop).  It reads and
    never changes what the program computes; :meth:`close` unwraps."""

    def __init__(self, compiled, steps: Iterable[int], start: int = 0):
        self.layer = compiled.hidden_layers[0]
        self.steps = set(steps)
        self.before: Dict[int, Dict[str, torch.Tensor]] = {}
        self.after: Dict[int, Dict[str, torch.Tensor]] = {}
        inner = type(self.layer).train_batch.__get__(self.layer)
        self.calls = start  # hidden batches trained since the network was compiled

        def train_batch(state, xb):
            k = self.calls
            self.calls += 1
            if k in self.steps and k - 1 not in self.after:
                self.before[k] = leaves(state, HIDDEN_KEYS)
            new_state, aj = inner(state, xb)
            if k in self.steps:
                self.after[k] = leaves(new_state, HIDDEN_KEYS)
            return new_state, aj

        self.layer.train_batch = train_batch

    def state_before(self, k: int) -> Dict[str, torch.Tensor]:
        return self.before[k] if k in self.before else self.after[k - 1]

    def close(self) -> None:
        self.layer.__dict__.pop("train_batch", None)
