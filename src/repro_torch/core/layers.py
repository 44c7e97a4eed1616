"""Functional BCPNN layers (the DSL's building blocks).

Each layer is a plain object: ``init(generator) -> LayerState`` plus
``forward(state, x)`` / ``train_batch(state, x, [y])`` transitions that
return new states and never mutate the old ones (the activation store
invalidates cached projections by state identity).  Two layer types, as in
the paper's Listing 1:

* :class:`StructuralPlasticityLayer`: input -> hidden, unsupervised
  Hebbian learning with a dynamic receptive-field mask (Alg. 1).
* :class:`DenseLayer`: hidden -> output, supervised readout with the
  post-activations clamped to one-hot labels.

The hot ops go through ``repro_torch.kernels.ops``, which picks the Hopper
kernels for CUDA tensors and their plain versions for CPU tensors; a spec
with ``use_kernels=False`` runs the plain versions on the card as well, by
the caller's explicit choice (see :class:`BCPNNLayerSpec`).  A spec
with ``fused_phase`` trains each hidden batch in the one-launch
``bcpnn_phase`` kernel; a ``precision`` policy with a ``state_format``
keeps the traces in the quantized state tier; a policy with a reduced
datapath format (``PrecisionPolicy.named("bf20")``) rounds every stage of
the forward and of each learning cycle (``repro_torch.precision.policy``).
A plastic layer's f32 forward hands ``masked_matmul`` its mask per
hypercolumn pair; where the kernel gathers over it (``masked_matmul``'s
plan, from the shapes), no unit mask is expanded for the product, and each
such product counts ``masked_matmul.gathered`` on the active tracer.
Each unit-mask expansion is a ``layer.unit_mask`` span and each rewiring a
``layer.rewire`` span on the active tracer (``repro_torch.runtime.trace``),
if there is one.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import learning, plasticity
from repro_torch.core.learning import MarginalState
from repro_torch.core.plasticity import PlasticityState
from repro_torch.core.units import UnitLayout
from repro_torch.kernels import ops
from repro_torch import trace_context as trace


class LayerState(NamedTuple):
    """Learnable state of a BCPNN layer.

    w/b are derived from the marginals each cycle but cached here because
    inference uses them without touching the marginals.  ``step`` counts
    the train batches seen on the device; ``host_step`` mirrors it on the
    host, so rewiring is decided without reading the device each batch.
    """

    marginals: MarginalState
    w: torch.Tensor
    b: torch.Tensor
    plast: Optional[PlasticityState]
    step: torch.Tensor  # int32 scalar
    host_step: int = 0

    def _map(self, fn) -> "LayerState":
        return LayerState(
            marginals=MarginalState(*(fn(t) for t in self.marginals)),
            w=fn(self.w),
            b=fn(self.b),
            plast=None if self.plast is None else PlasticityState(fn(self.plast.hcu_mask)),
            step=fn(self.step),
            host_step=self.host_step,
        )

    def to(self, device) -> "LayerState":
        """This state with every tensor on ``device`` (a new state object)."""
        return self._map(lambda t: t.to(device))

    def clone(self) -> "LayerState":
        """A copy of this state that shares no tensor with it."""
        return self._map(torch.clone)


@dataclasses.dataclass(frozen=True)
class BCPNNLayerSpec:
    """Hyperparameters shared by both layer types."""

    pre: UnitLayout
    post: UnitLayout
    lam: float = 0.001
    k_b: float = 1.0
    n_cycles: int = 1
    gain: float = 1.0  # softmax inverse temperature (soft-WTA sharpness)
    # A PrecisionPolicy: a reduced datapath format and/or a state tier.
    precision: object = None
    # One-launch training: forward + softmax + EWMA + weights in the
    # bcpnn_phase kernel.  Composes with the quantized state tier.
    fused_phase: bool = False
    # Kernel or plain version on the card.  None (the default) lets the
    # device decide: CUDA tensors launch the Hopper kernels, CPU tensors
    # run the plain versions.  The reference defaults to False because its
    # kernels are Pallas kernels for the TPU, run in interpret mode
    # elsewhere; here the kernels are the card's fast path and the plain
    # versions its slow twin, so the default keeps the kernels on the card.
    # False runs the plain versions on the card too (an explicit choice,
    # never a fallback); True asks for the kernels, which only a card has,
    # so on the CPU every setting runs the plain versions.
    use_kernels: Optional[bool] = None

    def __post_init__(self):
        if self.fused_phase and self.use_kernels is False:
            raise ValueError(
                "fused_phase=True needs the bcpnn_phase kernel; drop use_kernels=False"
            )
        if self.fused_phase and _datapath_policy(self) is not None:
            raise ValueError(
                "fused_phase is incompatible with a reduced-precision datapath "
                f"(precision fmt {self.precision.fmt.name!r}); only the quantized "
                "state tier (state_format=) composes with the fused kernel"
            )

    @property
    def n_pre(self) -> int:
        return self.pre.n_units

    @property
    def n_post(self) -> int:
        return self.post.n_units


def _datapath_policy(spec: BCPNNLayerSpec):
    """The PrecisionPolicy if it reduces the datapath (a fmt other than
    fp32); a policy with only a state tier is not a datapath."""
    p = spec.precision
    if p is None or p.fmt.is_identity:
        return None
    return p


def _state_format(spec: BCPNNLayerSpec):
    """The storage format of the quantized state tier, if any."""
    p = spec.precision
    if p is not None and p.has_state_tier:
        return p.state_format
    return None


def _unit_mask(spec: BCPNNLayerSpec, state: LayerState) -> Optional[torch.Tensor]:
    """The HCU mask expanded to an (F, H) unit mask, or None for a layer
    without one; counted in bytes on the active tracer."""
    if state.plast is None:
        return None
    tracer = trace.active()
    if tracer is None:
        return state.plast.unit_mask(spec.pre, spec.post)
    nbytes = spec.n_pre * spec.n_post * state.plast.hcu_mask.element_size()
    with tracer.span("layer.unit_mask", bytes=nbytes):
        tracer.count("layer.unit_mask_bytes", nbytes)
        return state.plast.unit_mask(spec.pre, spec.post)


def _forward(
    spec: BCPNNLayerSpec, state: LayerState, x: torch.Tensor,
    mask: Optional[torch.Tensor], fan_in: Optional[int] = None,
) -> torch.Tensor:
    """s = x @ (w o mask) + b, times the gain, then softmax per HCU.  The
    gain multiply between the two kernels stays a plain elementwise op.  A
    reduced datapath rounds every stage (``quantized_forward``: the same two
    kernels in their rounding modes, the gain inside ``masked_matmul``).

    ``fan_in`` is given by a plastic layer's own forward (its kept input
    HCUs a hidden HCU): the f32 product may then gather over the layer's HCU
    mask (:func:`_support`), and ``mask`` is the unit mask the caller has
    already expanded, or None.  Without it ``mask`` is the product's mask."""
    if _datapath_policy(spec) is not None:
        from repro_torch.precision.policy import quantized_forward

        if mask is None and fan_in is not None:  # the rounding mode takes the unit mask
            mask = _unit_mask(spec, state)
        return quantized_forward(
            x, state.w, state.b, spec.post, spec.precision, mask, gain=spec.gain,
            use_kernels=spec.use_kernels,
        )
    if fan_in is not None and state.plast is not None:
        s = _support(spec, state, x, mask, fan_in)
    else:
        s = ops.masked_matmul(x, state.w, state.b, mask=mask, use_kernels=spec.use_kernels)
    if spec.gain != 1.0:
        s = s * spec.gain
    return ops.hcu_softmax(
        s, n_hcu=spec.post.n_hcu, n_mcu=spec.post.n_mcu, use_kernels=spec.use_kernels
    )


def _support(
    spec: BCPNNLayerSpec, state: LayerState, x: torch.Tensor,
    mask: Optional[torch.Tensor], fan_in: int,
) -> torch.Tensor:
    """A plastic layer's f32 support: the gathered ``masked_matmul`` over
    its HCU mask where the kernel gathers for these inputs (counted as
    ``masked_matmul.gathered`` on the active tracer), else the dense product
    over the unit mask, ``mask`` or expanded here."""
    hcu = dict(hcu_mask=state.plast.hcu_mask, pre_mcu=spec.pre.n_mcu,
               post_mcu=spec.post.n_mcu, fan_in=fan_in)
    if ops.masked_matmul_gathers(x, state.w, state.b, use_kernels=spec.use_kernels, **hcu):
        tracer = trace.active()
        if tracer is not None:
            tracer.count("masked_matmul.gathered")
        return ops.masked_matmul(x, state.w, state.b, use_kernels=spec.use_kernels, **hcu)
    if mask is None:
        mask = _unit_mask(spec, state)
    return ops.masked_matmul(x, state.w, state.b, mask=mask, use_kernels=spec.use_kernels)


def _learn(
    spec: BCPNNLayerSpec, state: LayerState, ai: torch.Tensor, aj: torch.Tensor,
    mask: Optional[torch.Tensor],
) -> LayerState:
    """n_cycles of the EWMA marginal -> weight update (Alg.1 L10-16): the
    ``bcpnn_update`` kernel, or on a reduced datapath the rounded stages of
    ``quantized_learning_cycle``, one ``bcpnn_update`` launch in its
    datapath mode a cycle."""
    marg, w, b = state.marginals, state.w, state.b
    datapath, sfmt = _datapath_policy(spec), _state_format(spec)
    for _ in range(spec.n_cycles):
        if datapath is not None:
            from repro_torch.precision.policy import quantized_learning_cycle

            marg, w, b = quantized_learning_cycle(
                marg, ai, aj, spec.lam, datapath, spec.k_b, mask=mask,
                use_kernels=spec.use_kernels,
            )
        else:
            marg, w, b = ops.bcpnn_update(
                marg, ai, aj, lam=spec.lam, k_b=spec.k_b, mask=mask, state_format=sfmt,
                use_kernels=spec.use_kernels,
            )
    return LayerState(
        marginals=marg, w=w, b=b, plast=state.plast, step=state.step + 1,
        host_step=state.host_step + 1,
    )


def _fused_train_batch(
    spec: BCPNNLayerSpec, state: LayerState, x: torch.Tensor,
    mask: Optional[torch.Tensor],
) -> Tuple[LayerState, torch.Tensor]:
    """The one-launch training path: the whole Alg.1 batch iteration
    (forward, gain, HCU softmax, EWMA marginals, weight/bias epilogue) in
    one ``bcpnn_phase`` kernel."""
    marg, w, b, aj = ops.bcpnn_phase(
        state.marginals, x, state.w, state.b, spec.post,
        lam=spec.lam, k_b=spec.k_b, gain=spec.gain, mask=mask,
        n_cycles=spec.n_cycles, state_format=_state_format(spec),
    )
    new_state = LayerState(
        marginals=marg, w=w, b=b, plast=state.plast, step=state.step + 1,
        host_step=state.host_step + 1,
    )
    return new_state, aj


def _device(generator: Optional[torch.Generator]) -> torch.device:
    return generator.device if generator is not None else torch.device("cpu")


class StructuralPlasticityLayer:
    """Unsupervised BCPNN layer with dynamic receptive fields (Alg. 1)."""

    def __init__(
        self,
        pre: UnitLayout,
        post: UnitLayout,
        fan_in: Optional[int] = None,
        lam: float = 0.001,
        k_b: float = 1.0,
        n_cycles: int = 1,
        mask_update_every: Optional[int] = None,
        precision=None,
        init_jitter: float = 1.0,
        gain: float = 1.0,
        fused_phase: bool = False,
        use_kernels: Optional[bool] = None,
    ):
        self.spec = BCPNNLayerSpec(
            pre=pre, post=post, lam=lam, k_b=k_b, n_cycles=n_cycles, gain=gain,
            precision=precision, fused_phase=fused_phase, use_kernels=use_kernels,
        )
        self.init_jitter = init_jitter
        self.fan_in = fan_in if fan_in is not None else pre.n_hcu
        # Alg.1 L4: "if i_B % N_HCU == 0: update plasticity mask"
        self.mask_update_every = (
            mask_update_every if mask_update_every is not None else post.n_hcu
        )

    def init(self, generator: torch.Generator) -> LayerState:
        """Jittered marginals, then random receptive fields, both drawn from
        ``generator`` and placed on its device."""
        spec, device = self.spec, _device(generator)
        marg = learning.init_marginals(
            spec.n_pre, spec.n_post, spec.pre, spec.post,
            generator=generator, jitter=self.init_jitter, device=device,
        )
        if self.fan_in < spec.pre.n_hcu:
            plast = plasticity.init_random_mask(generator, spec.pre, spec.post, self.fan_in)
        else:
            plast = plasticity.full_mask(spec.pre, spec.post, device=device)
        w, b = learning.weights_from_marginals(marg, spec.k_b)
        w = w * plast.unit_mask(spec.pre, spec.post)
        return LayerState(
            marginals=marg, w=w, b=b, plast=plast,
            step=torch.zeros((), dtype=torch.int32, device=device),
        )

    @property
    def kept(self) -> int:
        """Input HCUs each hidden HCU keeps (the fan-in, at most all)."""
        return min(self.fan_in, self.spec.pre.n_hcu)

    def forward(self, state: LayerState, x: torch.Tensor) -> torch.Tensor:
        """The forward pass; the unit mask is expanded only if the product
        does not gather over the HCU mask."""
        return _forward(self.spec, state, x, None, self.kept)

    def train_batch(
        self, state: LayerState, x: torch.Tensor
    ) -> Tuple[LayerState, torch.Tensor]:
        """One Alg.1 batch iteration: (maybe) rewire, forward, learn.  The
        unit mask is expanded once, for the update (or the one fused kernel
        with ``spec.fused_phase``), and the forward shares it unless its
        product gathers over the HCU mask."""
        state = self.maybe_update_mask(state)
        mask = _unit_mask(self.spec, state)
        if self.spec.fused_phase:
            return _fused_train_batch(self.spec, state, x, mask)
        aj = _forward(self.spec, state, x, mask, self.kept)
        return _learn(self.spec, state, x, aj, mask), aj

    def maybe_update_mask(self, state: LayerState) -> LayerState:
        """Rewire every ``mask_update_every`` batches (Alg.1 L4-6), decided
        on the host mirror of the step counter: no device sync."""
        if self.fan_in >= self.spec.pre.n_hcu:
            return state  # dense: nothing to rewire
        if state.host_step % self.mask_update_every != 0:
            return state
        tracer = trace.active()
        if tracer is None:
            return self._rewire(state)
        with tracer.span("layer.rewire", host_step=state.host_step):
            tracer.count("layer.rewires")
            return self._rewire(state)

    def _rewire(self, state: LayerState) -> LayerState:
        new_plast = plasticity.update_mask(
            state.plast, state.marginals, self.spec.pre, self.spec.post
        )
        # Re-apply the (possibly changed) mask to the cached weights.
        w = state.w * new_plast.unit_mask(self.spec.pre, self.spec.post)
        return state._replace(w=w, plast=new_plast)


class DenseLayer:
    """Supervised BCPNN readout layer: marginal learning against one-hot
    targets (a_k := onehot(y))."""

    def __init__(
        self,
        pre: UnitLayout,
        post: UnitLayout,
        lam: float = 0.001,
        k_b: float = 1.0,
        n_cycles: int = 1,
        precision=None,
        gain: float = 1.0,
        use_kernels: Optional[bool] = None,
    ):
        self.spec = BCPNNLayerSpec(
            pre=pre, post=post, lam=lam, k_b=k_b, n_cycles=n_cycles, gain=gain,
            precision=precision, use_kernels=use_kernels,
        )

    def init(self, generator: Optional[torch.Generator] = None) -> LayerState:
        """Marginals at the prior; ``generator`` only names the device."""
        spec, device = self.spec, _device(generator)
        marg = learning.init_marginals(
            spec.n_pre, spec.n_post, spec.pre, spec.post, device=device
        )
        w, b = learning.weights_from_marginals(marg, spec.k_b)
        return LayerState(
            marginals=marg, w=w, b=b, plast=None,
            step=torch.zeros((), dtype=torch.int32, device=device),
        )

    def forward(self, state: LayerState, x: torch.Tensor) -> torch.Tensor:
        return _forward(self.spec, state, x, None)

    def train_batch(
        self, state: LayerState, x: torch.Tensor, y: torch.Tensor
    ) -> Tuple[LayerState, torch.Tensor]:
        """Supervised batch: targets (int labels or already one-hot) become
        the post-activations for the marginal update."""
        if y.ndim == x.ndim - 1:  # integer labels -> one-hot over output units
            aj = F.one_hot(y.long(), self.spec.n_post).to(x.dtype)
        else:
            aj = y
        return _learn(self.spec, state, x, aj, None), aj
