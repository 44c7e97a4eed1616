"""What the traffic kinds share.

Each traffic ``kind`` is a generator class of its own in
``bench/kinds/<kind>.py``, driven only by a traffic file's parameters and a
configuration file's sizes, and found by name by
:func:`bench.harness.kinds.load`: ``train`` (Listing 1 training repeated on
one network) and ``score`` (batch scoring, a closed loop with one client).
"""
from __future__ import annotations

from pathlib import Path

import torch

from bench.harness import kinds


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Kinds:
    """The kinds of ``bench/kinds/`` by name, loaded when first asked for:
    for callers outside ``bench/`` that index them (``tools/span_breakdown.py``);
    the harness itself uses :func:`bench.harness.kinds.load`."""

    def __getitem__(self, kind: str) -> type:
        return kinds.load(Path(__file__).resolve().parent.parent / "kinds", kind)


KINDS = _Kinds()
