"""SGD with (Nesterov) momentum over trees of tensors, in the reference's
order of operations (``repro/optim/sgd.py``): the weight decay is added to
the f32 gradient before the momentum."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.optim.adamw import learning_rate_at, tree_flatten, tree_map


class SGDState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    momentum: Any


@dataclasses.dataclass(frozen=True)
class SGD:
    learning_rate: Union[float, Callable] = 1e-2
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 0.0

    def init(self, params) -> SGDState:
        leaves, _ = tree_flatten(params)
        return SGDState(
            step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
            momentum=tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params
            ),
        )

    def update(self, grads, state: SGDState, params):
        step = state.step + 1
        lr = learning_rate_at(self.learning_rate, step)

        def upd(g, m, p):
            g32 = g.to(torch.float32)
            if self.weight_decay:
                g32 = g32 + self.weight_decay * p.to(torch.float32)
            m = self.momentum * m + g32
            d = g32 + self.momentum * m if self.nesterov else m
            return (-lr * d).to(p.dtype), m

        flat_g, rebuild = tree_flatten(grads)
        out = [
            upd(*args) for args in zip(
                flat_g, tree_flatten(state.momentum)[0], tree_flatten(params)[0]
            )
        ]
        return (
            rebuild([o[0] for o in out]),
            SGDState(step=step, momentum=rebuild([o[1] for o in out])),
        )
