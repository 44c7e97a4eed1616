"""The compile step: bind a declarative Network to a device and a plan.

::

    compiled = model.compile(ExecutionConfig(engine="scan"))  # device="cuda"
    compiled.fit((x, y), epochs_hidden=5, epochs_readout=5)
    compiled.evaluate((x_test, y_test))
    sess = compiled.streaming()              # online updates, state adopted on close
    svc = compiled.serve(ServiceConfig(...)) # serving front door (batched / streaming)

:class:`ExecutionConfig` holds everything about *how* the network runs.
On a CUDA device every hot op is a hand-written Hopper kernel; on the CPU
the same code runs the kernels' plain versions (the tests use this).
``fused_phase=True`` trains each hidden batch in one ``bcpnn_phase``
launch; ``precision=PrecisionPolicy.named("fp32", state_format="bf16")``
keeps the traces in bf16; ``precision="bf20"`` (any of bf14 ... bf28)
rounds every algebraic stage of the datapath, the paper's FPGA study.
``fit(readout="sgd")`` trains the hybrid AdamW readout head on the frozen
hidden codes; ``trace=TraceConfig()`` gives the network a tracer,
``compiled.tracing()`` attaches one for a window, and either records the
Listing 1 path's spans and counters (:mod:`repro_torch.runtime.trace`) on
``compiled.tracer``.  ``use_kernels=False`` runs the kernels' plain
versions on the card (an explicit choice; None, the default, lets the
device decide, and on the CPU every setting runs the plain versions: no
kernel runs there).  ``strict=True`` turns on the hot-path guard
(:mod:`repro_torch.analysis.strict`): every epoch, projection chunk and
predict chunk dispatches under a guard that refuses a host sync or an
off-device input, a recompile sentinel watches every callable the network
builds, and the BCPNN state is checked finite after every epoch.
``profile_dir=`` runs each ``fit`` under ``torch.profiler`` and writes a
Chrome trace there.  ``trainer=DataParallelTrainer(make_host_mesh(), mode)``
(``repro_torch.core.distributed``, the paper's MPI backend) trains each
global batch over the ranks of an initialised process group: each rank
stacks its rows, hidden layers are split over a ``model`` axis, and at the
end of each phase the shards are gathered, so ``state``, ``predict``,
``evaluate``, ``save``, ``streaming()`` and ``serve()`` see the global
state on every rank, as on one device.

``predict``, the batched serving plan and the streaming sessions share one
forward (:meth:`CompiledNetwork._forward_fn`) and one readout head
(:meth:`CompiledNetwork._head_fn`), so service and library calls cannot
diverge; ``serve`` binds the ``"batched"`` (default) or ``"streaming"``
plan of :mod:`repro_torch.runtime.service`, or the ``"continual"`` plan
of :mod:`repro_torch.runtime.continual`.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import os
import time
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import trace_context
from repro_torch.analysis.strict import counted, dispatch_guard
from repro_torch.core.layers import DenseLayer, LayerState, StructuralPlasticityLayer
from repro_torch.core.learning import full_f32_matmul
from repro_torch.runtime.activations import store_for
from repro_torch.runtime.epoch_engine import rows_to
from repro_torch.runtime.plans import PLANS, ExecutionPlan, make_plan

MIN_CAPABILITY = (9, 0)  # the kernels are built for sm_90a


def build_head(layers) -> Callable:
    """The readout head ``(states, readout_params, hb) -> scores`` over
    level-H hidden codes: the SGD head ``hb @ w + b`` when
    ``readout_params`` is given (it was trained on the whole hidden stack's
    output, so only a trailing DenseLayer is skipped), else the DenseLayer's
    forward, else the codes themselves.  Shared by :func:`build_forward` and
    the project-once predict, so the two cannot diverge."""
    n_hidden = len(layers) - 1 if isinstance(layers[-1], DenseLayer) else len(layers)

    def head(states, readout_params, hb):
        if readout_params is not None:
            return full_f32_matmul(hb, readout_params["w"]) + readout_params["b"]
        if n_hidden < len(layers):
            return layers[-1].forward(states[-1], hb)
        return hb

    return head


def build_forward(layers) -> Callable:
    """The full-network forward ``(states, readout_params, xb) -> scores``."""
    n_hidden = len(layers) - 1 if isinstance(layers[-1], DenseLayer) else len(layers)
    head = build_head(layers)

    def fwd(states, readout_params, xb):
        h = xb
        for layer, state in zip(layers[:n_hidden], states[:n_hidden]):
            h = layer.forward(state, h)
        return head(states, readout_params, h)

    return fwd


class NetworkState(NamedTuple):
    """The whole network's learnable state: one LayerState per layer, and
    the hybrid readout's head ``{"w", "b"}`` (None while the BCPNN
    DenseLayer is the readout)."""

    layers: Tuple[LayerState, ...]
    readout: Optional[dict] = None


@dataclasses.dataclass(frozen=True)
class ExecutionConfig:
    """Everything about *how* a network executes, none of *what* it is.

    engine:      "scan" (device-resident epoch stacks, default) or "batch"
                 (per-batch reference loop).
    device:      "cuda" (default) runs the Hopper kernels and needs a device
                 of compute capability 9.0 or above; "cpu" runs their plain
                 versions.  ``compile()`` raises rather than fall back.
    donate:      reuse one epoch's device stack buffer for the next epoch.
    cache_activations:    project-once training (default): each phase
                 boundary projects the dataset once through the frozen
                 prefix; False recomputes the frozen stack per batch (the
                 parity reference).
    activation_budget_mb: device-memory budget for cached levels; beyond it
                 levels spill to pinned host memory.
    precision:   a PrecisionPolicy (or a format name) bound into every
                 layer, the readout included: a reduced datapath ("bf14"
                 ... "bf28", every algebraic stage rounded) and/or the
                 quantized state tier (``PrecisionPolicy.named("fp32",
                 state_format="bf16")``).
    use_kernels: None (default) leaves every layer's own setting, whose
                 default lets the device decide (kernels on the card, plain
                 versions on the CPU); False runs the plain versions on the
                 card too, an explicit choice that the port never makes for
                 the caller; True asks for the kernels.  On the CPU every
                 setting runs the plain versions: no kernel runs there.
    fused_phase: train each hidden batch in one ``bcpnn_phase`` launch
                 (forward, softmax and update); composes with the state
                 tier, not with ``use_kernels=False``.
    strict:      the hot-path guard (``repro_torch.analysis.strict``):
                 every epoch, projection chunk and predict chunk runs under
                 ``dispatch_guard`` (no host sync in the dispatching thread,
                 every leaf a tensor on the device), a RecompileSentinel
                 asserts that every callable the network builds meets one
                 input signature (and, on the card, one launch plan per
                 kernel) across repeated fit/partial_fit/predict calls, and
                 the BCPNN state is checked finite after every epoch.  The
                 guards observe only: results are bit for bit those of the
                 same run without them.
    trace:       a ``repro_torch.runtime.trace.TraceConfig``: the compiled
                 network owns a Tracer (``compiled.tracer``), active
                 (``repro_torch.runtime.trace.active()``) for the length of
                 each ``fit``, ``partial_fit``, ``predict`` and
                 ``evaluate``.  It records the spans ``fit``,
                 ``train.<phase>`` (host vs device-wait split),
                 ``layer.step``, ``layer.rewire``, ``layer.unit_mask``,
                 ``store.project``, ``predict``, ``predict.chunk``,
                 ``evaluate`` and ``evaluate.readback``, nested by parent,
                 and the counters ``layer.rewires`` and
                 ``layer.unit_mask_bytes``; under ``torch.profiler`` each
                 span is also a ``record_function`` of its name.  None
                 (default) builds no tracer; ``compiled.tracing()``
                 attaches one for a window.
    profile_dir: when set, ``fit()`` runs its whole phase program under
                 ``torch.profiler.profile`` (CPU activity, and CUDA
                 activity on a CUDA device) and writes a Chrome trace into
                 this directory (``compiled.last_profile`` names it): the
                 device-level view beside the host-side phase spans.
    trainer:     a ``repro_torch.core.distributed.DataParallelTrainer``:
                 every rank of its mesh compiles and fits the same network
                 on the same data, and each global batch is trained over
                 the ranks (mode "shard_map": local means and one
                 all-reduce a learning cycle, the paper's MPI backend;
                 "pjit": the global batch rebuilt on every rank).  The
                 batch size must split evenly over the batch ranks.  The
                 SGD readout averages its gradients over them.
    """

    engine: str = "scan"
    device: str = "cuda"
    donate: bool = True
    cache_activations: bool = True
    activation_budget_mb: float = 512.0
    precision: Any = None
    use_kernels: Optional[bool] = None
    fused_phase: bool = False
    strict: bool = False
    trace: Any = None
    profile_dir: Optional[str] = None
    trainer: Any = None

    def __post_init__(self):
        if self.trace is not None:
            from repro_torch.runtime.trace import TraceConfig

            if not isinstance(self.trace, TraceConfig):
                raise TypeError(f"trace must be a TraceConfig, got {type(self.trace).__name__}")
        if self.engine not in PLANS:
            raise ValueError(f"Unknown engine {self.engine!r} (want one of {sorted(PLANS)})")
        if self.trainer is not None:
            from repro_torch.core.distributed import DataParallelTrainer

            if not isinstance(self.trainer, DataParallelTrainer):
                raise ValueError(
                    f"trainer must be a DataParallelTrainer, got {type(self.trainer).__name__}"
                )
        if self.activation_budget_mb <= 0:
            raise ValueError("activation_budget_mb must be positive")
        if isinstance(self.precision, str):
            from repro_torch.precision.policy import PrecisionPolicy

            object.__setattr__(self, "precision", PrecisionPolicy.named(self.precision))
        if self.fused_phase and self.use_kernels is False:
            raise ValueError(
                "fused_phase=True needs the bcpnn_phase kernel; drop use_kernels=False "
                "(or leave it None)"
            )
        if self.fused_phase and self.precision is not None and not self.precision.fmt.is_identity:
            raise ValueError(
                "fused_phase is incompatible with a reduced-precision datapath "
                f"(precision fmt {self.precision.fmt.name!r}); use PrecisionPolicy.named("
                "'fp32', state_format=...) for the quantized state tier, which does compose"
            )

    def bind_layer(self, layer):
        """A copy of ``layer`` with this config's precision, kernel and
        fused-phase choices bound into its spec (the declarative layer is
        never mutated).  Only hidden layers get ``fused_phase``: the
        readout's post-activations are clamped to labels, so it has no
        forward and softmax to fuse into its update."""
        overrides = {}
        if self.precision is not None:
            overrides["precision"] = self.precision
        if self.use_kernels is not None:
            overrides["use_kernels"] = self.use_kernels
        if self.fused_phase and isinstance(layer, StructuralPlasticityLayer):
            overrides["fused_phase"] = True
        if not overrides:
            return layer
        bound = copy.copy(layer)
        bound.spec = dataclasses.replace(layer.spec, **overrides)
        return bound


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device with an explicit index; raises unless it
    is the CPU or a CUDA device of capability 9.0 or above."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device {str(dev)!r}: want 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU (the kernels' plain versions)"
        )
    dev = torch.device("cuda", dev.index if dev.index is not None else torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability {cap}; "
            f"the kernels need {MIN_CAPABILITY} or above (sm_90a)"
        )
    return dev


class CompiledNetwork:
    """A Network bound to one device and one ExecutionPlan, owning its state."""

    def __init__(self, network, config: Optional[ExecutionConfig] = None,
                 rng: Optional[np.random.Generator] = None):
        self.network = network
        self.config = config if config is not None else ExecutionConfig()
        self.device = resolve_device(self.config.device)
        network.build()
        self.layers = [self.config.bind_layer(layer) for layer in network.layers]
        # The state tier rounds and casts the initial traces here, so every
        # epoch starts in the storage dtype (one bf_round launch per trace
        # on the card).
        from repro_torch.precision.policy import quantize_marginals

        states = [s.to(self.device) for s in network.states]
        self.state = NetworkState(layers=tuple(
            s._replace(marginals=quantize_marginals(
                s.marginals, layer.spec.precision, layer.spec.use_kernels))
            for layer, s in zip(self.layers, states)
        ))
        self.plan: ExecutionPlan = make_plan(
            self.config.engine, self.layers, self.device, donate=self.config.donate,
            strict=self.config.strict,
        )
        if self.config.trainer is not None:
            self.plan = self.config.trainer.decorate(self.plan)
        self.activations = store_for(self.layers, self.config, self.device)
        # The epoch shuffles' stream; the deprecated Network.fit shares the
        # Network's own, so consecutive legacy fits draw as one stream.
        self._rng = rng if rng is not None else np.random.default_rng(network.seed)
        # The hybrid readout's optimizer and epoch runner per (n_hidden,
        # n_classes, lr), and the moments a partial_fit resumes.
        self._sgd_cache: dict = {}
        self._sgd_opt_state = None
        # The forward and the head, built once and shared by predict and
        # the serving plans.
        self._fwd: Optional[Callable] = None
        self._head: Optional[Callable] = None
        # Per-layer LRU of per-size streaming cells, shared by every session
        # this compiled network opens (see streaming()).
        self._stream_train_cells: dict = {}
        self._stream_infer_cells: dict = {}
        # Strict mode (repro_torch.analysis.strict): a recompile sentinel
        # over every callable this network builds and a finite guard the
        # phase programs call after each epoch; None unless strict.
        self._sentinel = None
        self._finite_check = None
        if self.config.strict:
            from repro_torch.analysis.strict import RecompileSentinel, finite_checker

            self._sentinel = RecompileSentinel()
            self._finite_check = finite_checker()
        self.last_profile: Optional[str] = None  # the newest profile_dir trace
        from repro_torch.runtime.trace import build_tracer

        self.tracer = build_tracer(self.config.trace)

    @property
    def hidden_layers(self) -> List[StructuralPlasticityLayer]:
        return self.plan.hidden_layers

    @property
    def readout_layer(self) -> Optional[DenseLayer]:
        return self.plan.readout_layer

    # -------------------------------------------------------------- tracing
    @contextlib.contextmanager
    def tracing(self, config=None):
        """A fresh :class:`~repro_torch.runtime.trace.Tracer` (of ``config``,
        by default ``TraceConfig()``) on ``compiled.tracer`` for the block,
        which yields it; the tracer the network had before (None unless
        ``ExecutionConfig(trace=)``) is back on exit."""
        from repro_torch.runtime.trace import TraceConfig, Tracer

        previous = self.tracer
        self.tracer = Tracer(config if config is not None else TraceConfig())
        try:
            yield self.tracer
        finally:
            self.tracer = previous

    def _span(self, name: str, trace_id: Optional[int] = None, **attrs):
        """A span of ``name`` on the network's tracer, or no span."""
        if self.tracer is None:
            return contextlib.nullcontext({})
        return self.tracer.span(name, trace_id, **attrs)

    # -------------------------------------------------------------- forward
    def _strict_check(self, where: str) -> None:
        """Strict-mode recompile audit: (re)watch every callable this
        network owns (the plan's registry grows as phases run), then assert
        none met a new signature.  No-op unless ``config.strict``."""
        if self._sentinel is None:
            return
        self._sentinel.watch_all(self.plan.callables, prefix="plan.")
        self._sentinel.watch("forward", self._fwd)
        self._sentinel.watch("head", self._head)
        if self.activations is not None:
            for (j, k), fn in self.activations.projections().items():
                self._sentinel.watch(f"proj[{j}->{k}]", fn)
        self._sentinel.check(where)

    def _forward_fn(self) -> Callable:
        """The full-network forward, built once per compile (see
        :func:`build_forward`)."""
        if self._fwd is None:
            self._fwd = counted(build_forward(self.layers), self.config.strict)
        return self._fwd

    def _head_fn(self) -> Callable:
        """The readout head over level-H hidden codes, built once per
        compile: the project-once mirror of :meth:`_forward_fn`, sharing
        the one :func:`build_head` definition."""
        if self._head is None:
            self._head = counted(build_head(self.layers), self.config.strict)
        return self._head

    def predict(self, x, batch_size: int = 1024) -> torch.Tensor:
        """Class scores on the compiled device.  With the activation store
        the hidden stack runs through the same level-H projection training
        used, so only the readout head runs per call.  Each chunk is staged
        on the device before its guarded dispatch.  Traced, the call is a
        ``predict`` span of a new trace id, each chunk a ``predict.chunk``."""
        tracer = self.tracer
        store = self.activations is not None and bool(self.hidden_layers)
        rows = x.shape[0]
        with trace_context.activate(tracer), self._span(
                "predict", tracer.new_trace() if tracer is not None else None, rows=rows,
                chunks=-(-rows // batch_size), store=store):
            states, readout = self.state.layers, self.state.readout
            strict, dev = self.config.strict, self.device
            outs = []
            if store:
                src = self.activations.level(len(self.hidden_layers), list(states), x,
                                             chunk=batch_size)
                fn = self._head_fn()
            else:
                src, fn = x, self._forward_fn()
            for i in range(0, src.shape[0], batch_size):
                if tracer is None:
                    outs.append(self._predict_chunk(fn, src, i, batch_size, states, readout))
                    continue
                with tracer.span("predict.chunk", rows=min(batch_size, src.shape[0] - i)):
                    outs.append(self._predict_chunk(fn, src, i, batch_size, states, readout))
            self._strict_check("predict")
            return torch.cat(outs)

    def _predict_chunk(self, fn, src, i: int, batch_size: int, states, readout) -> torch.Tensor:
        """Rows ``i:i+batch_size`` of ``src`` staged on the device, then
        ``fn`` under strict mode's dispatch guard."""
        xb = rows_to(src, i, i + batch_size, self.device)
        with dispatch_guard(self.config.strict, self.device,
                            {"states": states, "readout": readout, "xb": xb}):
            return fn(states, readout, xb)

    def evaluate(self, dataset, batch_size: int = 1024) -> float:
        """Classification accuracy (argmax over output units)."""
        x, y = dataset
        tracer = self.tracer
        with trace_context.activate(tracer), self._span(
                "evaluate", tracer.new_trace() if tracer is not None else None,
                rows=x.shape[0], batch_size=batch_size):
            scores = self.predict(x, batch_size=batch_size)
            with self._span("evaluate.readback"):
                # torchlint: allow[TL001] reason=accuracy is a host-side API result; one read back per evaluate
                pred = scores.argmax(dim=-1).cpu().numpy()
        return float(np.mean(pred == np.asarray(y)))

    # ------------------------------------------------------------- training
    def fit(
        self,
        dataset,
        epochs_hidden=10,
        epochs_readout: int = 10,
        batch_size: int = 128,
        readout: str = "bcpnn",
        readout_lr: float = 1e-3,
        shuffle: bool = True,
        verbose: bool = False,
    ):
        """Phase-program BCPNN training (Alg. 1 + supervised readout).
        ``readout="sgd"`` trains a fresh hybrid AdamW head (``readout_lr``)
        in place of the BCPNN readout."""
        from repro_torch.core.network import FitResult

        t0 = time.perf_counter()
        history: List[dict] = []
        with self._profiled(), trace_context.activate(self.tracer), self._span(
                "fit", rows=dataset[0].shape[0], batch_size=batch_size):
            self._run(
                dataset, epochs_hidden, epochs_readout, batch_size, readout, readout_lr,
                shuffle, verbose, history, reset_readout=True,
            )
        self._strict_check("fit")
        return FitResult(
            epochs_hidden=epochs_hidden,
            epochs_readout=epochs_readout,
            batch_size=min(batch_size, dataset[0].shape[0]),
            wall_time_s=time.perf_counter() - t0,
            history=history,
        )

    def partial_fit(
        self,
        dataset,
        batch_size: int = 128,
        readout: Optional[str] = None,
        readout_lr: float = 1e-3,
        shuffle: bool = False,
        verbose: bool = False,
    ):
        """One incremental pass over a chunk: one Hebbian epoch per hidden
        layer, plus one readout epoch when ``readout`` is given.  The SGD
        head and its optimizer moments carry over between calls.  A ragged
        tail is dropped and reported as a ``ragged_tail_dropped`` entry."""
        from repro_torch.core.network import FitResult

        t0 = time.perf_counter()
        history: List[dict] = []
        with trace_context.activate(self.tracer):
            self._run(
                dataset, 1, 1 if readout is not None else 0, batch_size,
                readout or "bcpnn", readout_lr, shuffle, verbose, history, reset_readout=False,
            )
        self._strict_check("partial_fit")
        return FitResult(
            epochs_hidden=1,
            epochs_readout=1 if readout is not None else 0,
            batch_size=min(batch_size, dataset[0].shape[0]),
            wall_time_s=time.perf_counter() - t0,
            history=history,
        )

    @contextlib.contextmanager
    def _profiled(self):
        """``torch.profiler`` around a fit when ``config.profile_dir`` is
        set: CPU activity, and CUDA activity on a CUDA device (the
        repository's kernels appear under their C++ symbols), exported as
        a Chrome trace into ``profile_dir`` on exit.  The profiler's stop
        synchronises, outside every guard."""
        if self.config.profile_dir is None:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.config.profile_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        path = os.path.join(
            self.config.profile_dir, f"fit-{os.getpid()}-{time.time_ns()}.pt.trace.json"
        )
        prof.export_chrome_trace(path)
        self.last_profile = path

    def _run(
        self, dataset, epochs_hidden, epochs_readout, batch_size, readout,
        readout_lr, shuffle, verbose, history, reset_readout,
    ) -> None:
        from repro_torch.runtime.program import HiddenPhase, compile_program, run_program

        x, y = dataset
        n_total = x.shape[0]
        if n_total == 0:
            raise ValueError("fit() called with an empty dataset")
        # Clamp B to the dataset; each epoch trains n samples (a multiple of
        # B) from a full-dataset permutation, so the ragged tail rotates.
        batch_size = min(batch_size, n_total)
        n = (n_total // batch_size) * batch_size
        if not reset_readout and n < n_total:
            history.append({"phase": "ragged_tail_dropped", "samples": n_total - n})
        program = compile_program(
            len(self.hidden_layers), epochs_hidden, epochs_readout, readout,
            readout_lr=readout_lr, reset_readout=reset_readout,
        )
        if y is None and any(not isinstance(p, HiddenPhase) for p in program.phases):
            raise ValueError(
                "readout training requires labels: pass (x, y), or run "
                "hidden-only with epochs_readout=0 (fit) / readout=None (partial_fit)"
            )
        if verbose:
            print(f"[fit/{self.plan.name}] program: {program.describe()}")
        result = run_program(self, program, x, y, n, n_total, batch_size, shuffle, verbose, history)
        # A stale SGD head is dropped only once a BCPNN readout has trained
        # a replacement, so a network never ends up without a classifier.
        readout_params = self.state.readout
        if result.bcpnn_trained and self.readout_layer is not None:
            readout_params = None
        if result.sgd_ran:
            readout_params = result.sgd_params
        self.state = self.state._replace(readout=readout_params)

    def _sgd_setup(self, y, lr: float, reset: bool):
        """(params, opt_state, epoch runner) for one SgdReadoutPhase: AdamW
        and cross-entropy on the frozen hidden codes.  The runner matches
        the execution mode (cached level-H codes with the activation store,
        the frozen stack per batch without) and is cached across fit and
        partial_fit calls."""
        from repro_torch.core.network import sgd_readout_setup

        if not self.hidden_layers:
            raise ValueError("readout='sgd' needs at least one hidden layer")
        n_hidden = self.hidden_layers[-1].spec.n_post
        # The head's width comes from the declared output layout, not from
        # this batch's labels (a partial_fit chunk may miss classes).
        if self.readout_layer is not None:
            n_classes = self.readout_layer.spec.n_post
        elif not reset and self.state.readout is not None:
            n_classes = int(self.state.readout["w"].shape[1])
            y_max = int(np.max(y))
            if y_max >= n_classes:
                raise ValueError(
                    f"label {y_max} exceeds the SGD head's {n_classes} classes (a "
                    "headless network's head is sized by its first fit); declare a "
                    "DenseLayer readout or run a full fit() covering the label range"
                )
        else:
            n_classes = int(np.max(y)) + 1
        key = (n_hidden, n_classes, lr)
        resume = not reset and self.state.readout is not None
        cached = self._sgd_cache.get(key)
        if cached is None:
            params, opt, opt_state, loss_fn = sgd_readout_setup(
                self.network.seed, n_hidden, y, lr, n_classes=n_classes,
                init_params=not resume, device=self.device,
            )
            run_epoch = (
                self.plan.sgd_epoch_cached(opt, loss_fn)
                if self.activations is not None
                else self.plan.sgd_epoch(opt, loss_fn)
            )
            self._sgd_cache[key] = (opt, loss_fn, run_epoch)
        else:
            opt, loss_fn, run_epoch = cached
            params = opt_state = None
        if resume:
            # The stored head, with fresh moments if none survive (e.g.
            # right after a checkpoint load).  Updates make new tensors, so
            # the stored head is never written.
            params = self.state.readout
            opt_state = self._sgd_opt_state if self._sgd_opt_state is not None else opt.init(params)
        elif params is None:
            params, _, opt_state, _ = sgd_readout_setup(
                self.network.seed, n_hidden, y, lr, n_classes=n_classes, device=self.device,
            )
        return params, opt_state, run_epoch

    # ------------------------------------------------------------ streaming
    def streaming(
        self,
        layer: int = 0,
        max_batch: int = 16,
        max_wait_s: float = 0.0,
        cache_size: int = 8,
    ):
        """A StreamingSession over hidden layer ``layer``.  Its per-size
        cells live in this compiled network's own LRUs (shared by every
        session over the layer, their bound the latest ``cache_size``), and
        its learned state is written back into ``self.state`` on close()."""
        from repro_torch.core.streaming import StreamingSession, _LRUCells

        bound = self.hidden_layers[layer]
        li = self.layers.index(bound)
        # The session trains its own copy, so nothing it does touches the
        # tensors self.state (or a fit running meanwhile) holds.
        session_state = self.state.layers[li].clone()
        train_lru = self._stream_train_cells.setdefault(li, _LRUCells(cache_size))
        infer_lru = self._stream_infer_cells.setdefault(li, _LRUCells(cache_size))
        train_lru.set_capacity(cache_size)
        infer_lru.set_capacity(cache_size)
        # The host mirror of the step counter: no device read to detect a
        # conflict.
        base_step = self.state.layers[li].host_step

        def adopt(state):
            if self.state.layers[li].host_step != base_step:
                import warnings

                warnings.warn(
                    "StreamingSession.close(): this layer trained elsewhere "
                    "(another session or a fit) since the session opened; "
                    "overwriting those updates with this session's result",
                    RuntimeWarning,
                    stacklevel=3,
                )
            layers = list(self.state.layers)
            layers[li] = state
            self.state = self.state._replace(layers=tuple(layers))
            # Identity purging would drop the stale levels above this layer
            # at the next level() call; drop them now, so the adoption frees
            # their bytes.
            if self.activations is not None:
                self.activations.invalidate_above(li)

        return StreamingSession(
            bound,
            session_state,
            max_batch=max_batch,
            max_wait_s=max_wait_s,
            cache_size=cache_size,
            train_cells=train_lru,
            infer_cells=infer_lru,
            on_close=adopt,
            strict=self.config.strict,
        )

    # -------------------------------------------------------------- serving
    def serve(self, config=None):
        """Bind this compiled network to an :class:`InferenceService`.
        ``ServiceConfig(plan=...)`` picks the strategy: "batched" (default:
        bucket-padded classification through the same projection and head
        ``predict`` uses), "streaming" (the latency path, over
        :meth:`streaming`) or "continual" (batched classification that
        keeps learning from labeled ``Feedback``; the default when
        ``ServiceConfig(continual=...)`` is set).
        ``ServiceConfig(async_mode=True)`` starts the executor thread at
        bind time, and ``submit()`` then returns
        ``concurrent.futures.Future``s (:mod:`repro_torch.runtime.engine`)."""
        from repro_torch.runtime.service import SERVE_PLANS, InferenceService, ServiceConfig

        config = config if config is not None else ServiceConfig()
        plan_name = config.plan or ("continual" if config.continual is not None else "batched")
        if plan_name == "decode":
            raise ValueError(
                "CompiledNetwork.serve supports plans 'batched'/'streaming'/'continual'; "
                "'decode' serves token decoding (use serve_model)"
            )
        plan = SERVE_PLANS[plan_name](self, config)
        service = InferenceService(plan, config)
        if config.async_mode:
            service.start()
        return service

    # ----------------------------------------------------------- checkpoint
    def save(self, directory: str, step: int = 0, retain: int = 3) -> str:
        """Whole-network checkpoint, written atomically: every layer's state,
        the SGD head if any, and the host shuffle RNG, in the reference's layout
        (``repro_torch.checkpoint``).  Returns the checkpoint's path."""
        from repro_torch.checkpoint.network import save_network

        return save_network(
            directory, step, self.state, self._rng.bit_generator.state, retain=retain
        )

    def load(self, path: str) -> "CompiledNetwork":
        """Restore a whole-network checkpoint (this package's or the
        reference's) into this compiled network; the architectures must
        match.  The saved shuffle RNG state resumes, so a resumed fit draws
        the same shuffles."""
        from repro_torch.checkpoint.network import load_network

        layer_states, readout, rng_state = load_network(
            path, list(self.state.layers), self.device,
            readout_in_features=(
                self.hidden_layers[-1].spec.n_post if self.hidden_layers else None
            ),
        )
        self.state = NetworkState(layers=tuple(layer_states), readout=readout)
        # The optimizer moments belong to the trajectory before the load.
        self._sgd_opt_state = None
        if rng_state is not None:
            self._rng.bit_generator.state = rng_state
        return self

    def _epoch_indices(self, n: int, n_total: int, shuffle: bool) -> np.ndarray:
        """First ``n`` indices of a full-dataset permutation drawn from
        ``np.random.default_rng(network.seed)``, as the reference draws them."""
        if not shuffle:
            return np.arange(n)
        return self._rng.permutation(n_total)[:n]
