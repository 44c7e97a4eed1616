"""Input unit-coding for BCPNN (Ravichandran et al. conventions).

BCPNN input activations must be probabilities within each input HCU.  For
continuous features x in [0,1], *complementary coding* makes each scalar a
2-MCU hypercolumn (x, 1-x); for categorical data, one-hot HCUs.  The coding
owns the corresponding UnitLayout so networks can be wired without manual
bookkeeping.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.units import UnitLayout, complementary_layout, onehot_layout


def complementary_code(x: np.ndarray) -> Tuple[np.ndarray, UnitLayout]:
    """(n, F) floats in [0,1] -> (n, 2F) with per-feature (x, 1-x) HCUs."""
    x = np.asarray(x, np.float32)
    if x.ndim != 2:
        raise ValueError(f"want (n, features), got {x.shape}")
    n, f = x.shape
    out = np.empty((n, 2 * f), np.float32)
    out[:, 0::2] = x
    out[:, 1::2] = 1.0 - x
    return out, complementary_layout(f)


def onehot_code(y: np.ndarray, n_classes: int) -> Tuple[np.ndarray, UnitLayout]:
    """(n,) int labels -> (n, n_classes) one-hot single-HCU coding."""
    y = np.asarray(y)
    out = np.zeros((y.shape[0], n_classes), np.float32)
    out[np.arange(y.shape[0]), y] = 1.0
    return out, onehot_layout(n_classes)
