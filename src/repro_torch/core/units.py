"""Hypercolumn / minicolumn geometry for BCPNN layers.

Every layer is a set of hypercolumn units (HCUs) of a fixed number of
minicolumn units (MCUs); activations within an HCU form a probability
distribution.  Layouts are uniform and reshape-based, as in the paper's
benchmarks (the MNIST hidden layer is 30 HCUs x 100 MCUs = 3000 units).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UnitLayout:
    """Uniform HCU/MCU layout of a BCPNN layer."""

    n_hcu: int
    n_mcu: int

    def __post_init__(self):
        if self.n_hcu <= 0 or self.n_mcu <= 0:
            raise ValueError(
                f"UnitLayout requires positive sizes, got ({self.n_hcu}, {self.n_mcu})"
            )

    @property
    def n_units(self) -> int:
        """Total flat unit count of the layer."""
        return self.n_hcu * self.n_mcu

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_hcu, self.n_mcu)

    def blocked(self, x: torch.Tensor) -> torch.Tensor:
        """Reshape a (..., n_units) tensor to (..., n_hcu, n_mcu)."""
        if x.shape[-1] != self.n_units:
            raise ValueError(
                f"Trailing dim {x.shape[-1]} does not match layout {self.n_units}"
            )
        return x.reshape(*x.shape[:-1], self.n_hcu, self.n_mcu)

    def flat(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`blocked`."""
        if tuple(x.shape[-2:]) != self.shape:
            raise ValueError(f"Trailing dims {tuple(x.shape[-2:])} != layout {self.shape}")
        return x.reshape(*x.shape[:-2], self.n_units)

    def hcu_index(self, device=None) -> torch.Tensor:
        """Map flat unit index -> owning HCU index, shape (n_units,)."""
        return torch.arange(self.n_hcu, device=device).repeat_interleave(self.n_mcu)

    def validate_divisible_by(self, shards: int) -> None:
        """Check the HCU axis splits `shards` ways without splitting an HCU."""
        if self.n_hcu % shards != 0:
            raise ValueError(
                f"n_hcu={self.n_hcu} not divisible by shards={shards}; "
                "HCUs must never be split across model-parallel shards"
            )


def complementary_layout(n_features: int) -> UnitLayout:
    """Each scalar feature x in [0,1] becomes one 2-MCU HCU holding (x, 1-x)."""
    return UnitLayout(n_hcu=n_features, n_mcu=2)


def onehot_layout(n_classes: int) -> UnitLayout:
    """One HCU whose MCUs are the classes (the supervised readout layer)."""
    return UnitLayout(n_hcu=1, n_mcu=n_classes)
