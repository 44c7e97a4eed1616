"""Deterministic synthetic datasets standing in for MNIST / STL-10.

A numpy-only copy of ``repro/data/synthetic.py``'s image generators, so both
packages draw identical datasets from one seed.  The paper's benchmark
datasets are replaced by statistically analogous generators with the same
shapes and a controllable difficulty knob; the claims reproduced (accuracy
far above chance, batch-size scaling) are properties of the algorithm, not
of the specific images.

Generators:

* :func:`make_image_classes` — K class prototypes on the unit cube with
  per-sample noise and distractor dimensions; `mnist_like()` (784 features,
  10 classes) and `stl10_like()` (27648 features, 10 classes) are presets
  with the real datasets' shapes;
* :func:`token_stream` — the LM zoo's training tokens: a Zipf unigram
  stream with planted block bigrams.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageDataset:
    x_train: np.ndarray  # (n_train, n_features) float32 in [0,1]
    y_train: np.ndarray  # (n_train,) int32
    x_test: np.ndarray
    y_test: np.ndarray
    n_classes: int

    @property
    def n_features(self) -> int:
        return self.x_train.shape[1]


def make_image_classes(
    n_train: int,
    n_test: int,
    n_features: int,
    n_classes: int = 10,
    prototypes_per_class: int = 4,
    noise: float = 0.15,
    informative_fraction: float = 0.5,
    seed: int = 0,
) -> ImageDataset:
    """Clustered-prototype classification data in [0,1]^n_features.

    Each class owns `prototypes_per_class` prototype vectors ("one rotated,
    one skewed, ..." — the paper's MCU intuition); a sample is a prototype
    plus Gaussian noise, clipped to [0,1].  A (1-informative_fraction) slice
    of the features is pure noise shared across classes, so structural
    plasticity has something real to prune.
    """
    rng = np.random.default_rng(seed)
    n_info = max(1, int(n_features * informative_fraction))
    protos = rng.random((n_classes, prototypes_per_class, n_info)).astype(np.float32)

    def draw(n: int, rng_):
        y = rng_.integers(0, n_classes, size=n).astype(np.int32)
        p = rng_.integers(0, prototypes_per_class, size=n)
        base = protos[y, p]
        x_info = base + rng_.normal(0.0, noise, size=base.shape).astype(np.float32)
        x_noise = rng_.random((n, n_features - n_info)).astype(np.float32)
        x = np.concatenate([x_info, x_noise], axis=1)
        return np.clip(x, 0.0, 1.0), y

    x_tr, y_tr = draw(n_train, rng)
    x_te, y_te = draw(n_test, rng)
    return ImageDataset(x_tr, y_tr, x_te, y_te, n_classes)


def mnist_like(
    n_train: int = 4096, n_test: int = 1024, seed: int = 0, **kw
) -> ImageDataset:
    """784-feature 10-class proxy with MNIST's shapes (28x28 grayscale)."""
    kw.setdefault("n_features", 28 * 28)
    return make_image_classes(n_train, n_test, seed=seed, **kw)


def stl10_like(
    n_train: int = 1024, n_test: int = 256, seed: int = 0, **kw
) -> ImageDataset:
    """96x96x3-feature 10-class proxy with STL-10's shapes (~30x MNIST)."""
    kw.setdefault("n_features", 96 * 96 * 3)
    kw.setdefault("informative_fraction", 0.25)
    return make_image_classes(n_train, n_test, seed=seed, **kw)


def token_stream(
    n_tokens: int,
    vocab_size: int,
    zipf_a: float = 1.2,
    bigram_classes: int = 64,
    seed: int = 0,
) -> np.ndarray:
    """Zipf unigram + planted block-bigram token stream (int32).

    Tokens are grouped into ``bigram_classes`` blocks; with probability 0.5
    the next token stays within the current block, which gives an LM
    something learnable, so a training loss falls.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    p = ranks ** (-zipf_a)
    p /= p.sum()
    base = rng.choice(vocab_size, size=n_tokens, p=p).astype(np.int32)
    block = vocab_size // bigram_classes
    if block > 0:
        stay = rng.random(n_tokens) < 0.5
        prev_block = np.roll(base, 1) // np.maximum(block, 1)
        within = rng.integers(0, np.maximum(block, 1), size=n_tokens)
        sticky = (prev_block * block + within).astype(np.int32) % vocab_size
        base = np.where(stay, sticky, base).astype(np.int32)
    return base
