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

The legacy imperative surface (``Network.fit(engine=..., trainer=...)``,
``Network.predict/evaluate``) survives as a deprecated shim: ``fit``
compiles on the fly (on the card unless ``device="cpu"``), shares this
Network's shuffle stream, and copies the learned states and the SGD head
back, bit for bit the explicit compile path's.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, List, Optional, Tuple

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

    def __init__(self, seed: int = 0, precision=None):
        self.layers: List[Any] = []
        self.states: List[LayerState] = []
        self.seed = seed
        self.precision = precision  # Optional PrecisionPolicy, carried as the reference carries it
        self._rng = np.random.default_rng(seed)
        self._built = False
        # The deprecated shim's state: the SGD head, the cached forward and
        # the device of the last legacy fit.
        self._sgd_readout: Optional[dict] = None
        self._fwd: Optional[Callable] = None
        self._device = None

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

    # ---------------------------------------------------- legacy (deprecated)
    def predict(self, x, batch_size: int = 1024) -> torch.Tensor:
        """Class scores for a batch of inputs through the whole stack, on
        the last legacy fit's device (the card before any).  The forward
        is built once and takes the states and the SGD head as arguments."""
        from repro_torch.core.compiled import build_forward, resolve_device

        self.build()
        dev = resolve_device(self._device or "cuda")
        if self._fwd is None:
            self._fwd = build_forward(self.layers)
        states = tuple(s.to(dev) for s in self.states)
        head = self._sgd_readout
        if head is not None:
            head = {k: v.to(dev) for k, v in head.items()}
        outs = []
        for i in range(0, x.shape[0], batch_size):
            xb = torch.as_tensor(np.asarray(x[i:i + batch_size]), dtype=torch.float32, device=dev)
            outs.append(self._fwd(states, head, xb))
        return torch.cat(outs)

    def fit(
        self,
        dataset: Tuple[np.ndarray, np.ndarray],
        epochs_hidden: int = 10,
        epochs_readout: int = 10,
        batch_size: int = 128,
        readout: str = "bcpnn",
        readout_lr: float = 1e-3,
        shuffle: bool = True,
        verbose: bool = False,
        trainer=None,
        engine: str = "scan",
        device="cuda",
    ) -> FitResult:
        """DEPRECATED shim over the compile step.

        ``self.compile(ExecutionConfig(engine=engine, trainer=trainer,
        device=device)).fit(...)`` sharing this Network's shuffle stream,
        with the learned states and the SGD head copied back so ``states``
        / ``predict`` / ``evaluate`` keep working."""
        warnings.warn(
            "Network.fit(engine=..., trainer=...) is deprecated; use "
            "network.compile(ExecutionConfig(engine=..., trainer=...)).fit(...)",
            DeprecationWarning,
            stacklevel=2,
        )
        from repro_torch.core.compiled import CompiledNetwork, ExecutionConfig

        config = ExecutionConfig(engine=engine, trainer=trainer, device=device)
        self.build()
        compiled = CompiledNetwork(self, config, rng=self._rng)
        result = compiled.fit(
            dataset, epochs_hidden=epochs_hidden, epochs_readout=epochs_readout,
            batch_size=batch_size, readout=readout, readout_lr=readout_lr,
            shuffle=shuffle, verbose=verbose,
        )
        self.states = list(compiled.state.layers)
        self._sgd_readout = compiled.state.readout
        self._device = compiled.device
        return result

    def evaluate(self, dataset: Tuple[np.ndarray, np.ndarray], batch_size: int = 1024) -> float:
        """Classification accuracy (argmax over output units)."""
        x, y = dataset
        scores = self.predict(x, batch_size=batch_size)
        pred = scores.argmax(dim=-1).cpu().numpy()
        return float(np.mean(pred == np.asarray(y)))
