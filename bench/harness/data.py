"""The benchmark's inputs, made on the device from the seed.

A torch rewrite of the prototype-plus-noise scheme of the image proxies
(``make_image_classes``: each class owns a few prototype vectors in the unit
cube; a row is a prototype plus Gaussian noise on the informative features,
uniform noise on the rest, clipped to [0, 1]), followed by the complementary
coding that Listing 1 feeds its hidden layer: every feature x becomes the
two-unit hypercolumn (x, 1 - x).  Everything is drawn by one
``torch.Generator`` on the device, in a few large calls, so the same seed
gives the same tensors and set-up moves nothing from the host.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


class Draw:
    """The rows of one configuration's data, drawn in sequence from ``seed``."""

    def __init__(self, data: Dict, seed: int, device):
        self.data = data
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))
        features = data["features"]
        self.n_info = max(1, int(features * data["informative_fraction"]))
        self.protos = torch.rand(
            (data["classes"], data["prototypes_per_class"], self.n_info),
            generator=self.gen, device=self.device,
        )

    def rows(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """``n`` complementary-coded rows (n, 2F) in f32 and their labels."""
        d, g, dev = self.data, self.gen, self.device
        features = d["features"]
        y = torch.randint(0, d["classes"], (n,), generator=g, device=dev)
        p = torch.randint(0, d["prototypes_per_class"], (n,), generator=g, device=dev)
        x = torch.empty((n, features), device=dev)
        x[:, :self.n_info] = self.protos[y, p]
        x[:, :self.n_info] += d["noise"] * torch.randn(
            (n, self.n_info), generator=g, device=dev)
        x[:, self.n_info:] = torch.rand((n, features - self.n_info), generator=g, device=dev)
        x.clamp_(0.0, 1.0)
        coded = torch.empty((n, 2 * features), device=dev)
        coded[:, 0::2] = x
        coded[:, 1::2] = 1.0 - x
        return coded, y

