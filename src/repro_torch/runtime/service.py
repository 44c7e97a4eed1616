"""Serving: ``ServiceConfig -> InferenceService -> ServePlan``.

The inference-side mirror of the compile step.  Training binds a Network to
one ExecutionPlan through ``network.compile(ExecutionConfig(...))``;
serving binds a compiled network to one :class:`ServePlan`::

    service = compiled.serve(ServiceConfig(max_batch=64, buckets=(16, 64)))
    scores  = service.predict(x)             # class scores, on the compiled device

    service = serve_model(model, ServiceConfig(max_batch=8, max_seq=256))
    done    = service.generate(requests)     # LM decode (DecodePlan)

Four strategies of the JAX package's ``repro/runtime/service.py`` are
ported:

* :class:`BatchedPlan`: BCPNN classification through the compiled
  network's shared level-H projection and readout head (the
  ``build_head`` that ``compiled.predict`` uses), with padding-bucket
  selection on the batch axis, so a service facing arbitrary request sizes
  runs a bounded set of shapes.  With the activation store on, repeated
  request batches hit the cached projection (content canonicalization) and
  pay only the head.  Zero-padding rows never change real outputs: the
  forward is row-independent, and the kernels zero-fill the rows of a tile
  past the batch.
* :class:`DecodePlan`: prefill + continuous slot-batched decode for the LM
  zoo's decoder-only families.  The per-slot caches live stacked in one
  ``(max_batch, ...)`` cache, and every active slot advances through ONE
  ``decode_step`` call with per-slot positions (the reference ``vmap``s a
  scalar-position step; the port's step takes a position per row).  The
  admit/evict/step machinery lives in :class:`DecodeSession`, which both
  the synchronous ``generate()`` and the async engine drive, so the two
  are token-identical under deterministic arrivals.  Prompt-length
  padding buckets bound the prefill shapes; prefill gathers the logits at
  the *true* prompt end (``last_pos``), so bucketing is token-exact for
  attention.  An MoE layer's capacity comes from the padded length, so
  once the exact-length prefill drops assignments a bucketed one differs
  from it, as the reference's does (the moe family takes the buckets all
  the same).  The stateful families (ssm, hybrid) prefill at exact length:
  a recurrent state would fold the pad tokens in.  The per-length prefill
  callables are LRU-bounded by ``cache_size``, as the reference's cells
  are.  Enc-dec models are refused: serving them needs a cross-attention
  prefill.
* :class:`StreamingPlan`: the latency path, over the compiled network's
  :class:`~repro_torch.core.streaming.StreamingSession` (host-side
  coalescing, LRU-bounded per-size cells, state adoption on close).
* :class:`~repro_torch.runtime.continual.ContinualPlan` (``plan=
  "continual"`` or ``continual=ContinualConfig(...)``): batched
  classification that keeps learning from labeled ``Feedback``.

``serve_fleet`` binds a model to a :class:`~repro_torch.runtime.router.Router`
fronting N decode engines over the one shared model (``ServiceConfig(
router=RouterConfig(...))``).  ``ServiceConfig(strict=True)`` turns on the
hot-path guard (:mod:`repro_torch.analysis.strict`) for the plan's
dispatches: each runs under the dispatch guard, its inputs staged on the
device first, and a recompile sentinel asserts the plan's callables meet
one input signature each across repeated rounds.

:class:`InferenceService` owns the request queue (admission control via
``max_queue``; ordering via ``policy``: "fcfs" arrival order, or "sjf"
shortest-prompt-first for decode plans, which other plans refuse at bind
time) and delegates execution to its plan.
``service.start()`` (or ``ServiceConfig(async_mode=True)``) hands the queue
to the executor thread of :class:`repro_torch.runtime.engine.AsyncEngine`:
``submit()`` then returns a ``concurrent.futures.Future``, and new decode
requests are admitted into freed slots mid-flight, between steps.  Every plan
records latency telemetry (:mod:`repro_torch.runtime.metrics`), surfaced
through ``service.stats["telemetry"]``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.strict import RecompileSentinel, counted, dispatch_guard
from repro_torch.core.streaming import _LRUCells
from repro_torch.runtime.epoch_engine import rows_to
from repro_torch.runtime.metrics import ServiceMetrics

POLICIES = ("fcfs", "sjf")

# Families whose decode cache is a position-dependent recurrent state: a
# right-padded prefill would fold pad tokens into the state, so prompt
# bucketing is off and prefill runs at exact length.
_STATEFUL_FAMILIES = ("ssm", "hybrid")


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        # torchlint: allow[TL001] reason=a served batch's latency ends on the device; outside every guard
        torch.cuda.synchronize(device)


# --------------------------------------------------------------- requests
@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # Trace correlation: minted by the fabric front door (Router/engine)
    # when tracing is on, so plan-level spans (prefill, per-token decode)
    # join the same trace as the scheduling hops.  None when tracing is off.
    trace_id: Optional[int] = None


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray  # generated tokens
    prefill_len: int
    steps: int


# ---------------------------------------------------------- cache padding
def pad_cache_like(cache: Dict[str, torch.Tensor], template) -> Dict[str, torch.Tensor]:
    """Grow every tensor of ``cache`` to its ``template`` shape (trailing
    zero-pad per axis).  ``template`` maps each name to a shape, or to
    anything with a ``.shape`` (``model.cache_shapes(1, max_seq)``, or
    tensors on the ``meta`` device): purely structural, so a cache pads
    without a registry of its names."""

    def pad(a: torch.Tensor, t) -> torch.Tensor:
        ts = tuple(getattr(t, "shape", t))
        if tuple(a.shape) == ts:
            return a
        if a.dim() != len(ts) or any(s > x for s, x in zip(a.shape, ts)):
            raise ValueError(
                f"cache leaf of shape {tuple(a.shape)} cannot grow to template shape {ts}"
            )
        widths = []
        for s, x in reversed(list(zip(a.shape, ts))):
            widths += [0, x - s]
        return torch.nn.functional.pad(a, widths)

    if set(cache) != set(template):
        raise ValueError(f"cache {sorted(cache)} and template {sorted(template)} differ")
    return {name: pad(a, template[name]) for name, a in cache.items()}


# ------------------------------------------------------------------ config
@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Everything about *how* a model serves, none of *what* it serves.

    max_batch:  concurrent capacity: decode slots (DecodePlan), the padding
                chunk cap (BatchedPlan, without buckets), the coalescing
                micro-batch (StreamingPlan), and the async engine's
                micro-batch.
    max_seq:    decode cache length (prompt + generated), DecodePlan only.
    buckets:    ascending padding buckets: prompt lengths for DecodePlan
                prefill, batch sizes for BatchedPlan (the largest is its
                chunk cap).  None = exact sizes.
    policy:     queue admission order: "fcfs" (arrival) or "sjf"
                (shortest-prompt-first; decode plans only, the others
                refuse it at bind time).
    cache_size: LRU bound on the streaming plan's per-size cells and on
                the decode plan's per-length prefill callables.
    plan:       "batched" | "decode" | "streaming" | "continual"; None lets
                the entry point pick its default (``compiled.serve()`` ->
                "continual" when ``continual`` is set, else "batched";
                ``serve_model()`` -> "decode").
    max_wait_s: micro-batch aggregation deadline: the async engine (and the
                streaming plan's coalescing buffer) waits at most this long
                to fill ``max_batch`` before dispatching a partial batch.
    max_queue:  admission control: submit() beyond this depth is rejected
                (None = unbounded); it also bounds the async engine's inbox.
    layer:      the streaming plan's target hidden layer.
    async_mode: start the executor thread at bind time: ``submit()`` returns
                a ``Future`` and decode slots admit new requests mid-flight.
                For streaming plans the async surface serves per-item
                INFERENCE (sync submit+drain feeds training samples).
    strict:     the hot-path guard (``repro_torch.analysis.strict``): the
                batched head, the streaming cells, the prefill and the
                fused decode step (and the continual tier's update, view
                and merge) run under the dispatch guard, which refuses a
                host sync in the dispatching thread (only there: a caller
                thread reading results back is untouched) and any input
                off the device; a recompile sentinel asserts the plan's
                callables meet one input signature each across repeated
                submit/predict/generate rounds (a new prefill bucket gets
                its own baseline).  Observation only: results are those of
                the same run without it.
    router:     a ``repro_torch.runtime.router.RouterConfig`` for the fleet
                front door: ``serve_fleet()`` builds N decode engines over
                the one shared model behind one Router (per-tenant queues,
                deadlines, hot restart).  None = single-engine serving.
    continual:  a ``repro_torch.runtime.continual.ContinualConfig``
                enabling the online-learning tier: the bound plan becomes
                :class:`~repro_torch.runtime.continual.ContinualPlan`
                (inference unchanged; labeled ``Feedback`` items drive
                Hebbian adapter updates, merges, drift detection and
                rollback).  None = frozen serving.
    trace:      a ``repro_torch.runtime.trace.TraceConfig`` enabling
                per-request spans (engine inbox, batch aggregation, batch,
                learn, end to end), exportable as Chrome trace JSON.  None
                (the default) constructs no tracer at all.
    """

    max_batch: int = 4
    max_seq: int = 256
    buckets: Optional[Tuple[int, ...]] = None
    policy: str = "fcfs"
    cache_size: int = 8
    plan: Optional[str] = None
    max_wait_s: float = 0.0
    max_queue: Optional[int] = None
    layer: int = 0
    async_mode: bool = False
    strict: bool = False
    router: Optional[Any] = None
    continual: Optional[Any] = None
    trace: Optional[Any] = None

    def __post_init__(self):
        if self.continual is not None or self.plan == "continual":
            # Importing the continual module registers ContinualPlan in
            # SERVE_PLANS before the plan-name validation below runs (it
            # imports this module for the plan base, so not at the top).
            from repro_torch.runtime.continual import ContinualConfig

            if self.continual is not None and not isinstance(self.continual, ContinualConfig):
                raise ValueError(
                    f"continual must be a ContinualConfig, got {type(self.continual).__name__}"
                )
            if self.plan not in (None, "continual"):
                raise ValueError(
                    f"continual learning serves through plan='continual', got plan={self.plan!r}"
                )
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.layer < 0:
            raise ValueError(f"layer must be >= 0, got {self.layer}")
        if self.max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {self.max_seq}")
        if self.policy not in POLICIES:
            raise ValueError(f"Unknown policy {self.policy!r} (want one of {POLICIES})")
        if self.plan is not None and self.plan not in SERVE_PLANS:
            raise ValueError(f"Unknown plan {self.plan!r} (want one of {sorted(SERVE_PLANS)})")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {self.max_wait_s}")
        if self.buckets is not None:
            b = tuple(int(x) for x in self.buckets)
            if not b or any(x <= 0 for x in b) or list(b) != sorted(set(b)):
                raise ValueError(
                    f"buckets must be strictly ascending positive ints, got {self.buckets!r}"
                )
            object.__setattr__(self, "buckets", b)
        if self.router is not None:
            # Imported here: the router imports this module for Request.
            from repro_torch.runtime.router import RouterConfig

            if not isinstance(self.router, RouterConfig):
                raise ValueError(f"router must be a RouterConfig, got {type(self.router).__name__}")
        if self.trace is not None:
            from repro_torch.runtime.trace import TraceConfig

            if not isinstance(self.trace, TraceConfig):
                raise ValueError(f"trace must be a TraceConfig, got {type(self.trace).__name__}")

    def bucket_for(self, n: int) -> int:
        """Smallest configured bucket >= n, or n itself when none fits."""
        if self.buckets is not None:
            for b in self.buckets:
                if b >= n:
                    return b
        return n


# ------------------------------------------------------------------- plans
class ServePlan:
    """Base serving strategy.  Subclasses implement the capability they
    serve; calling an unsupported capability raises with the plan name.
    Every plan owns a :class:`ServiceMetrics` bundle (shared with the
    service front door and the async engine) and a ``_lock`` guarding its
    stat counters: the engine's executor thread mutates them while caller
    threads read ``stats``.  ``device`` is where the plan's tensors live
    (None for a plan with none); the engine's thread runs on it."""

    name: str = "?"
    device: Optional[torch.device] = None

    def __init__(self, config: ServiceConfig, metrics: Optional[ServiceMetrics] = None):
        self.config = config
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        self._lock = threading.Lock()
        # Strict-mode recompile sentinel over this plan's callables; None
        # unless ``config.strict``.
        self._sentinel = RecompileSentinel() if config.strict else None
        # Per-request tracer, attached by the service via bind_tracer();
        # None keeps every span site a dead check.
        self.tracer = None

    def bind_tracer(self, tracer) -> None:
        """Attach the service's Tracer; also hooks the strict-mode
        sentinel's rebaseline into the event journal."""
        with self._lock:
            self.tracer = tracer
        if self._sentinel is not None and tracer is not None:
            def _journal_rebaseline(sizes, _t=tracer):
                from repro_torch.runtime.trace import RecompileRebaseline

                _t.emit(RecompileRebaseline(sizes=dict(sizes)))

            self._sentinel.on_rebaseline = _journal_rebaseline

    def _strict_registry(self) -> Dict[str, Any]:
        """name -> watched callable, collected anew at every check (the
        registries grow: new prefill buckets, new cells)."""
        return {}

    def _strict_check(self, where: str) -> None:
        if self._sentinel is None:
            return
        for name, fn in self._strict_registry().items():
            self._sentinel.watch(name, fn)
        self._sentinel.check(where)

    def _unsupported(self, what: str):
        raise NotImplementedError(f"{type(self).__name__} ({self.name!r}) does not serve {what}")

    # capability surface -------------------------------------------------
    def predict(self, x):
        self._unsupported("predict()")

    def generate(self, requests: List[Request]) -> List[Completion]:
        self._unsupported("generate()")

    def feed(self, sample) -> None:
        self._unsupported("feed()")

    def infer(self, sample):
        self._unsupported("infer()")

    def flush(self) -> None:  # batch plans have no buffer
        pass

    def close(self) -> None:
        pass

    @property
    def stats(self) -> Dict[str, Any]:
        return {}


class BatchedPlan(ServePlan):
    """BCPNN classification through the compiled network's shared head.

    ``predict`` chunks the input along the batch axis (chunk cap: the
    largest bucket, else ``max_batch``), pads each chunk up to its bucket
    with zero rows and, with the compiled network's activation store on,
    projects it through the store, as ``compiled.predict``/``evaluate`` do,
    then applies the one shared head (``compiled._head_fn()``).  The store
    keys its projections by the identity of the array, so padded chunks are
    content-canonicalized (a small LRU maps chunk bytes to one anchor
    array): a repeated request batch hits the cached level-H projection and
    pays only the head.  Without the store (``cache_activations=False``)
    the full-network forward (``compiled._forward_fn()``) runs instead."""

    name = "batched"

    _CANON_CAPACITY = 32  # distinct padded chunks remembered for reuse

    def __init__(self, compiled, config: ServiceConfig,
                 metrics: Optional[ServiceMetrics] = None):
        super().__init__(config, metrics)
        self.compiled = compiled
        self.device = compiled.device
        # The plan's own handles on the network's shared forward and head:
        # with strict they count this plan's signatures, whatever else
        # calls the network's.
        self._fwd = counted(compiled._forward_fn(), config.strict)
        self._head = counted(compiled._head_fn(), config.strict)
        self._requests = 0
        self._rows = 0
        self._padded_rows = 0
        # digest -> the first array seen with those bytes.
        self._canon: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._reuse_hits = 0

    def _chunk_cap(self) -> int:
        if self.config.buckets is not None:
            return self.config.buckets[-1]
        return self.config.max_batch

    def _canonical(self, xb: np.ndarray) -> np.ndarray:
        key = (
            xb.shape,
            str(xb.dtype),
            hashlib.blake2b(np.ascontiguousarray(xb).tobytes(), digest_size=16).digest(),
        )
        with self._lock:
            hit = self._canon.get(key)
            if hit is not None:
                self._canon.move_to_end(key)
                self._reuse_hits += 1
                return hit
            # Anchor a private copy, never a view of the caller's array: the
            # mapping (and the store's identity-keyed projection) must
            # survive the caller writing into their buffer.
            anchor = np.array(xb, copy=True)
            self._canon[key] = anchor
            while len(self._canon) > self._CANON_CAPACITY:
                self._canon.popitem(last=False)
            return anchor

    def _strict_registry(self) -> Dict[str, Any]:
        """The plan's forward and head, and the network's counted
        projections: a strict plan projects through those (each chunk
        guarded) whether or not the network was compiled strict."""
        compiled = self.compiled
        reg: Dict[str, Any] = {"forward": self._fwd, "head": self._head}
        if compiled.activations is not None:
            for (j, k), fn in compiled.activations.projections().items():
                reg[f"proj[{j}->{k}]"] = fn
        return reg

    def _scores(self, xb: np.ndarray) -> torch.Tensor:
        """One padded chunk -> class scores, through the shared head; the
        chunk (or its cached projection) is staged on the device before
        the guarded dispatch."""
        compiled = self.compiled
        state = compiled.state
        if compiled.activations is not None and compiled.hidden_layers:
            xb = self._canonical(xb)
            h = compiled.activations.level(
                len(compiled.hidden_layers), list(state.layers), xb, chunk=xb.shape[0],
                strict=self.config.strict,
            )
            xd = rows_to(h, 0, h.shape[0], self.device)  # a spilled level comes back
            fn = self._head
        else:
            xd = rows_to(xb, 0, xb.shape[0], self.device)
            fn = self._fwd
        leaves = {"states": state.layers, "readout": state.readout, "x": xd}
        with dispatch_guard(self.config.strict, self.device, leaves):
            return fn(state.layers, state.readout, xd)

    def predict(self, x) -> torch.Tensor:
        """Class scores of host rows ``x`` (n, F) or one row (F,), on the
        compiled device."""
        x = np.asarray(x, dtype=np.float32)
        if x.ndim == 1:
            x = x[None, :]
        cap = self._chunk_cap()
        outs = []
        for i in range(0, x.shape[0], cap):
            xb = x[i : i + cap]
            n = xb.shape[0]
            m = self.config.bucket_for(n)
            if m > n:
                xb = np.concatenate([xb, np.zeros((m - n,) + xb.shape[1:], xb.dtype)], axis=0)
                with self._lock:
                    self._padded_rows += m - n
            t0 = time.perf_counter()
            scores = self._scores(xb)
            _sync(self.device)  # the chunk's latency ends on the device
            self.metrics.batch_s.observe(time.perf_counter() - t0)
            outs.append(scores[:n])
            with self._lock:
                self._rows += n
        with self._lock:
            self._requests += 1
        self._strict_check("predict")
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    @property
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "requests": self._requests,
                "rows": self._rows,
                "padded_rows": self._padded_rows,
                "projection_reuse_hits": self._reuse_hits,
            }


class DecodeSession:
    """Mutable slot state for one continuously-batched decode run.

    The admit / evict / fused-step cycle lives HERE, so the synchronous
    whole-queue ``DecodePlan.generate`` and the async engine's mid-flight
    admission loop drive the same schedule: admission fills the lowest free
    slot, eviction retires finished slots, and one ``decode_step`` call
    advances every active slot.  ``tag`` is an opaque caller handle (the
    engine keys futures on it); completions come back as ``(tag,
    Completion)`` pairs.  Every method runs under ``torch.inference_mode``
    (thread-local, so whichever thread drives the session enters it)."""

    @torch.inference_mode()
    def __init__(self, plan: "DecodePlan"):
        self.plan = plan
        S = plan.config.max_batch
        self.S = S
        self.active: List[Optional[Dict]] = [None] * S
        self.caches = plan.model.init_cache(S, plan.config.max_seq)

    def free_slots(self) -> int:
        return sum(a is None for a in self.active)

    def has_active(self) -> bool:
        return any(a is not None for a in self.active)

    @torch.inference_mode()
    def admit(self, req: Request, tag: Any = None) -> bool:
        """Prefill ``req`` into the lowest free slot; False when full."""
        slot = next((s for s in range(self.S) if self.active[s] is None), None)
        if slot is None:
            return False
        plan = self.plan
        t0 = time.perf_counter()
        first, cache_one = plan._prefill_one(req.prompt)
        plan._write(self.caches, cache_one, slot)
        if plan.tracer is not None:
            tid = getattr(req, "trace_id", None)
            if tid is not None:
                plan.tracer.record(tid, "plan.prefill", t0, time.perf_counter(),
                                   slot=slot, prompt_len=len(req.prompt))
        self.active[slot] = {
            "req": req,
            "cur_len": len(req.prompt),
            "tokens": [first],
            "steps": 1,
            "tag": tag,
        }
        plan._count_admit()
        plan._strict_check("prefill/admit")
        return True

    @torch.inference_mode()
    def step(self) -> List[Tuple[Any, Completion]]:
        """One engine cycle minus admission: retire finished slots, then
        advance every remaining active slot through ONE fused step.
        Returns the ``(tag, Completion)`` pairs retired this call."""
        plan = self.plan
        cfg = plan.config
        done: List[Tuple[Any, Completion]] = []

        # Eviction: retire finished slots (freed slots refill on the next
        # admission pass: continuous batching at step granularity).
        advancing = []
        for slot in range(self.S):
            st = self.active[slot]
            if st is None:
                continue
            req = st["req"]
            if (
                len(st["tokens"]) >= req.max_new_tokens
                or (req.eos_id is not None and st["tokens"][-1] == req.eos_id)
                or st["cur_len"] + 1 >= cfg.max_seq
            ):
                done.append((st["tag"], Completion(
                    rid=req.rid,
                    tokens=np.asarray(st["tokens"], np.int32),
                    prefill_len=len(req.prompt),
                    steps=st["steps"],
                )))
                plan._count_retired(len(st["tokens"]))
                self.active[slot] = None
                continue
            advancing.append(slot)

        if not advancing:
            return done

        # The fused hot path: ONE decode_step advances every slot.  Idle
        # slots ride along at position 0 with a dead cache: their outputs
        # are discarded and their cache is overwritten at the next
        # admission, so the step keeps the shape (S, ...).
        tokens = np.zeros(self.S, np.int64)
        cur_lens = np.zeros(self.S, np.int64)
        for slot in advancing:
            tokens[slot] = self.active[slot]["tokens"][-1]
            cur_lens[slot] = self.active[slot]["cur_len"]
        t0 = time.perf_counter()
        toks = torch.from_numpy(tokens).to(plan.device)
        lens = torch.from_numpy(cur_lens).to(plan.device)
        leaves = {"caches": self.caches, "tokens": toks, "cur_lens": lens}
        with dispatch_guard(cfg.strict, plan.device, leaves):
            nxt = plan._fused(self.caches, toks, lens)
        # torchlint: allow[TL001] reason=greedy tokens steer EOS and admission host-side; one read back a step, outside the guard
        nxt = nxt.cpu().numpy()
        t1 = time.perf_counter()
        plan.metrics.decode_step_s.observe(t1 - t0)
        if plan.tracer is not None:
            # One span per advancing request per token; the fused step is
            # shared, so concurrent slots show the same span bounds.
            for slot in advancing:
                tid = getattr(self.active[slot]["req"], "trace_id", None)
                if tid is not None:
                    plan.tracer.record(tid, "plan.decode_step", t0, t1, slot=slot,
                                       token=self.active[slot]["steps"])
        for slot in advancing:
            st = self.active[slot]
            st["tokens"].append(int(nxt[slot]))
            st["cur_len"] += 1
            st["steps"] += 1
        plan._count_step(len(advancing))
        plan._strict_check("decode step")
        return done


class DecodePlan(ServePlan):
    """Continuous slot-batched LM serving with a fused decode step.

    Slots are admission units (one request each); their caches live
    stacked on the slot axis of ONE ``(L, max_batch, max_seq, ...)`` cache.
    Every step, all slots advance together through one ``decode_step``
    with per-slot positions: token-exact against the reference's ``vmap``
    of its per-slot step (parity-tested), one call per token instead of
    ``max_batch``.  :meth:`session` exposes the admit/step machinery for
    continuous callers (the async engine).  The plan reads its model and
    never writes it, so many plans (a fleet's engines) share one."""

    name = "decode"

    def __init__(self, model, config: ServiceConfig,
                 metrics: Optional[ServiceMetrics] = None):
        super().__init__(config, metrics)
        self._family = model.cfg.family
        if self._family == "encdec":
            raise ValueError(
                "DecodePlan serves decoder-only models; an enc-dec model is served "
                "through its own functions (prefill, then decode_step)"
            )
        if config.buckets is not None and config.buckets[-1] > config.max_seq:
            raise ValueError(
                f"prompt buckets {config.buckets} exceed max_seq={config.max_seq}: a "
                "bucketed prefill cache could not fit the decode cache"
            )
        self.model = model
        self.device = model.device
        self._cache_template = model.cache_shapes(1, config.max_seq)
        # One prefill callable per padded length seen, LRU-bounded by
        # cache_size, as the reference compiles and keeps one for each: the
        # eager port only counts them, and in strict mode each counts its
        # signatures for the sentinel.
        self._prefill_cells = _LRUCells(config.cache_size)
        self._fused = counted(self._fused_step, config.strict)
        self._write = counted(self._write_slot, config.strict)
        self._fused_steps = 0
        self._slot_steps = 0
        self._requests = 0
        self._tokens = 0

    # ------------------------------------------------------- stat counters
    # DecodeSession (driven by the engine's executor thread) counts through
    # these, so every mutation shares one lock with the ``stats`` reader.
    def _count_admit(self) -> None:
        with self._lock:
            self._requests += 1

    def _count_retired(self, n_tokens: int) -> None:
        with self._lock:
            self._tokens += n_tokens

    def _count_step(self, n_slots: int) -> None:
        with self._lock:
            self._fused_steps += 1
            self._slot_steps += n_slots

    def _strict_registry(self) -> Dict[str, Any]:
        reg: Dict[str, Any] = {"fused_step": self._fused, "write_slot": self._write}
        # Per-bucket prefill callables: a NEW bucket gets its own baseline,
        # the SAME bucket meeting a new signature is a violation.
        with self._lock:
            cells = self._prefill_cells.items()
        for m, cell in cells:
            reg[f"prefill[{m}]"] = cell
        return reg

    # ----------------------------------------------------------- the step
    def _fused_step(self, caches, tokens: torch.Tensor, cur_lens: torch.Tensor) -> torch.Tensor:
        """One decode step for ALL slots: (S,) tokens and per-slot
        positions -> (S,) next greedy tokens; the caches are written in
        place."""
        dev = self.device
        logits, _ = self.model.decode_step(caches, tokens.to(dev)[:, None], cur_lens.to(dev))
        return torch.argmax(logits, dim=-1)

    @staticmethod
    def _write_slot(caches, cache_one, slot: int) -> None:
        """Install one admitted request's (L, 1, max_seq, ...) cache at
        ``slot``."""
        for name, c in cache_one.items():
            caches[name][:, slot] = c[:, 0]

    # ------------------------------------------------------------- prefill
    def _prompt_bucket(self, n: int) -> int:
        if self._family in _STATEFUL_FAMILIES:
            return n  # a recurrent state would absorb pad tokens
        return self.config.bucket_for(n)

    def _prefill_one(self, prompt: np.ndarray):
        """(first greedy token, structurally padded (L, 1, max_seq, ...) cache)."""
        n = len(prompt)
        if n < 1:
            raise ValueError("empty prompt")
        if n > self.config.max_seq:
            raise ValueError(f"prompt length {n} exceeds max_seq={self.config.max_seq}")
        t0 = time.perf_counter()
        m = self._prompt_bucket(n)
        with self._lock:
            cell = self._prefill_cells.get(m)
            if cell is None:
                cell = counted(self.model.prefill, self.config.strict)
                self._prefill_cells.put(m, cell)
        tokens = np.zeros((1, m), np.int64)
        tokens[0, :n] = prompt
        # last_pos gathers the logits at the true prompt end: causal
        # attention makes positions <= last_pos independent of the
        # right-padding.  MoE capacity is not: it grows with the padded
        # length, so a bucketed MoE prefill equals an exact-length one only
        # while the exact one drops no assignment (the reference's too).
        batch = {"tokens": torch.from_numpy(tokens).to(self.device), "last_pos": n - 1}
        with dispatch_guard(self.config.strict, self.device, {"tokens": batch["tokens"]}):
            logits, cache = cell(batch)
        cache = pad_cache_like(cache, self._cache_template)
        # torchlint: allow[TL001] reason=the first token steers admission host-side; one read back a prefill, outside the guard
        first = int(torch.argmax(logits[0]))
        self.metrics.prefill_s.observe(time.perf_counter() - t0)
        return first, cache

    # ------------------------------------------------------------ generate
    def session(self) -> DecodeSession:
        """A fresh slot state for continuous admission (the async engine's
        substrate; ``generate`` opens one per call)."""
        return DecodeSession(self)

    def generate(self, requests: List[Request]) -> List[Completion]:
        """Whole-queue continuous batching: admit into free slots, advance
        all active slots through the fused step, evict on EOS or limits,
        refill: the same DecodeSession schedule the async engine drives."""
        sess = self.session()
        pending: Deque[Request] = deque(requests)
        done: List[Completion] = []
        while pending or sess.has_active():
            while pending and sess.admit(pending[0]):
                pending.popleft()
            done.extend(c for _, c in sess.step())
        return done

    @property
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "requests": self._requests,
                "tokens_generated": self._tokens,
                "fused_steps": self._fused_steps,
                "slot_steps": self._slot_steps,
                "mean_occupancy": (
                    self._slot_steps / self._fused_steps if self._fused_steps else 0.0
                ),
                "prefill_cells": len(self._prefill_cells),
                "prefill_cell_evictions": self._prefill_cells.evictions,
            }


class StreamingPlan(ServePlan):
    """The latency path: online BCPNN updates and inference through the
    compiled network's StreamingSession (coalescing buffer, shared
    LRU-bounded cells, state adoption on close) behind the front door."""

    name = "streaming"

    def __init__(self, compiled, config: ServiceConfig,
                 metrics: Optional[ServiceMetrics] = None):
        super().__init__(config, metrics)
        self.device = compiled.device
        self.session = compiled.streaming(
            layer=config.layer,
            max_batch=config.max_batch,
            max_wait_s=config.max_wait_s,
            cache_size=config.cache_size,
        )

    def _strict_registry(self) -> Dict[str, Any]:
        """The session's cells (shared per layer by the compiled network):
        one per micro-batch size, so a new size gets its own baseline."""
        reg: Dict[str, Any] = {}
        for b, cell in self.session._train_cells.items():
            reg[f"stream_train[{b}]"] = cell
        for b, cell in self.session._infer_cells.items():
            reg[f"stream_infer[{b}]"] = cell
        return reg

    def feed(self, sample) -> None:
        self.session.feed(sample)
        self._strict_check("feed")

    def infer(self, sample) -> np.ndarray:
        t0 = time.perf_counter()
        out = self.session.infer(sample)  # a host array: the device is done
        self.metrics.batch_s.observe(time.perf_counter() - t0)
        self._strict_check("infer")
        return out

    def flush(self) -> None:
        self.session.flush()
        self._strict_check("flush")

    def close(self) -> None:
        self.session.close()

    @property
    def stats(self) -> Dict[str, Any]:
        return self.session.stats


SERVE_PLANS = {
    BatchedPlan.name: BatchedPlan,
    DecodePlan.name: DecodePlan,
    StreamingPlan.name: StreamingPlan,
}


# ----------------------------------------------------------------- service
class InferenceService:
    """The serving front door: a request queue with admission control,
    delegating execution to one bound ServePlan.

    Two execution surfaces share the queue semantics:

    * the synchronous path: ``submit()`` returns bool, ``drain()`` runs
      everything queued through the plan in one call;
    * the async path: ``start()`` hands the plan to a dedicated executor
      thread (:class:`repro_torch.runtime.engine.AsyncEngine`) and
      ``submit()`` returns a ``concurrent.futures.Future``; decode
      requests are admitted into freed slots mid-flight, between steps.
    """

    def __init__(self, plan: ServePlan, config: ServiceConfig):
        if config.policy == "sjf" and plan.name != "decode":
            raise ValueError(
                f"policy='sjf' orders decode Requests by prompt length; the {plan.name!r} "
                "plan has no request length to order by (use policy='fcfs')"
            )
        self.plan = plan
        self.config = config
        self.metrics = plan.metrics
        from repro_torch.runtime.trace import build_tracer

        self.tracer = build_tracer(config.trace)
        if self.tracer is not None:
            plan.bind_tracer(self.tracer)
        self.engine = None  # set by start()
        self._queue: Deque = deque()
        self._queue_t: Deque[float] = deque()

    # --------------------------------------------------------------- async
    def start(self, run: bool = True):
        """Bind (and by default start) the async engine; ``submit()``
        afterwards returns Futures.  Idempotent while the engine is live.

        ``run=False`` binds the engine without launching its thread:
        submits queue into the bounded inbox and execute when ``start()``
        (or ``drain_and_stop()``) runs it.  Items already in the sync queue
        have no Future to resolve into, so ``start()`` refuses while it is
        non-empty (``drain()`` it first)."""
        from repro_torch.runtime.engine import AsyncEngine

        if self._queue:
            raise RuntimeError(
                f"{len(self._queue)} item(s) in the sync queue have no Future to "
                "resolve into; drain() before start()"
            )
        if self.engine is not None and not self.engine.stopped:
            if run:
                self.engine.start()
            return self.engine
        self.engine = AsyncEngine(self.plan, self.config, tracer=self.tracer)
        if run:
            self.engine.start()
        return self.engine

    def drain_and_stop(self):
        """Finish all in-flight and queued async work, then stop the
        engine.  No-op when the engine was never started."""
        if self.engine is not None:
            self.engine.drain_and_stop()

    # --------------------------------------------------------------- queue
    def submit(self, item):
        """Queue one sample.

        Synchronous mode: returns True, or False when ``max_queue`` rejects
        the item.  Once ``start()`` has bound the async engine, delegates to
        it and returns a ``concurrent.futures.Future`` (backpressure raises
        ``QueueFull``; a stopped engine raises ``EngineStopped``).

        The streaming plan's surfaces differ: sync ``submit`` + ``drain``
        FEEDS samples (online training), async submits run INFERENCE per
        item (futures resolve to activations)."""
        if self.engine is not None:
            return self.engine.submit(item)
        if self.config.max_queue is not None and len(self._queue) >= self.config.max_queue:
            self.metrics.rejected.inc()
            return False
        self._queue.append(item)
        self._queue_t.append(time.perf_counter())
        self.metrics.submitted.inc()
        self.metrics.queue_depth.set(len(self._queue))
        return True

    def _ordered(self, requests: List[Request]) -> List[Request]:
        if self.config.policy == "sjf":
            return sorted(requests, key=lambda r: len(r.prompt))  # stable
        return list(requests)

    def drain(self):
        """Run everything queued through the plan: completions (decode),
        stacked scores (batched), a flush (streaming), or one result per
        item in arrival order (continual: an ack dict per ``Feedback``, a
        score row per other item)."""
        if self.engine is not None and not self.engine.stopped:
            raise RuntimeError(
                "the async engine owns this service's queue; submit() returns "
                "Futures — use them, or drain_and_stop() first"
            )
        items = list(self._queue)
        stamps = list(self._queue_t)
        self._queue.clear()
        self._queue_t.clear()
        self.metrics.queue_depth.set(0)
        now = time.perf_counter()
        for t in stamps:
            self.metrics.queue_wait_s.observe(now - t)
        if not items:
            self.plan.flush()
            # Decode plans always answer with completions, even for an
            # empty queue (callers iterate the result).
            return [] if self.plan.name == "decode" else None
        if isinstance(items[0], Request):
            out = self.plan.generate(self._ordered(items))
        elif self.plan.name == "streaming":
            for s in items:
                self.plan.feed(s)
            self.plan.flush()
            out = None
        elif self.plan.name == "continual":
            # Mixed traffic in arrival order: Feedback learns, anything
            # else infers, one result per item, as on the async path.
            from repro_torch.runtime.continual import Feedback

            out = [
                self.plan.learn(s) if isinstance(s, Feedback) else self.plan.infer(s)
                for s in items
            ]
        else:
            out = self.plan.predict(np.stack([np.asarray(s) for s in items]))
        _sync(self.plan.device)
        end = time.perf_counter()
        for t in stamps:
            self.metrics.e2e_s.observe(end - t)
        self.metrics.completed.inc(len(items))
        return out

    # -------------------------------------------------- direct conveniences
    def predict(self, x):
        return self.plan.predict(x)

    def generate(self, requests: List[Request]) -> List[Completion]:
        return self.plan.generate(self._ordered(requests))

    def feed(self, sample) -> None:
        self.plan.feed(sample)

    def infer(self, sample):
        return self.plan.infer(sample)

    def flush(self) -> None:
        self.plan.flush()

    def close(self) -> None:
        if self.engine is not None:
            self.engine.drain_and_stop()
        self.plan.close()

    @property
    def stats(self) -> Dict[str, Any]:
        engine_live = self.engine is not None and not self.engine.stopped
        out = {
            "plan": self.plan.name,
            # The sync queue plus the engine inbox: every waiting item.
            "queued": len(self._queue) + (self.engine.inbox_depth if engine_live else 0),
            "rejected": self.metrics.rejected.value,
            **self.plan.stats,
            "telemetry": self.metrics.snapshot(),
        }
        if self.engine is not None:
            out["engine"] = self.engine.stats
        return out


def serve_model(model, config: Optional[ServiceConfig] = None) -> InferenceService:
    """Bind an LM (a ``CausalLM`` holding its weights) to an
    InferenceService: the LM zoo's twin of ``CompiledNetwork.serve``.  Only
    the decode plan applies.  ``ServiceConfig(async_mode=True)`` starts the
    executor thread at bind time (``submit()`` then returns Futures).  The
    reference's ``serve_model(model, params, config)`` passes the weights
    apart; here the model holds them."""
    config = config if config is not None else ServiceConfig()
    plan_name = config.plan or "decode"
    if plan_name != "decode":
        raise ValueError(
            f"serve_model() serves token decoding; plan {plan_name!r} needs a "
            "CompiledNetwork (use compiled.serve)"
        )
    service = InferenceService(DecodePlan(model, config), config)
    if config.async_mode:
        service.start()
    return service


def serve_fleet(model, config: Optional[ServiceConfig] = None, *, fleet: int = 2):
    """Bind an LM to a started :class:`~repro_torch.runtime.router.Router`
    fronting ``fleet`` decode engines over the ONE shared model: one copy of
    the weights, N independent decode loops;
    ``router.submit(request, tenant=..., deadline_s=...)`` returns a Future
    as the single-engine async path does.

    ``config.router`` (a RouterConfig) carries the scheduling knobs
    (tenants, routing policy, restart budgets); the rest of the
    ServiceConfig applies per engine.  Engine inboxes are kept shallow
    (``max_queue`` defaults to ``max_batch`` here), so queueing, and with
    it tenant and deadline policy, lives in the Router."""
    from repro_torch.runtime.router import Router, RouterConfig

    config = config if config is not None else ServiceConfig()
    if fleet < 1:
        raise ValueError(f"fleet must be >= 1, got {fleet}")
    plan_name = config.plan or "decode"
    if plan_name != "decode":
        raise ValueError(
            f"serve_fleet() serves token decoding; plan {plan_name!r} needs a "
            "CompiledNetwork front door"
        )
    router_config = config.router if config.router is not None else RouterConfig()
    if router_config.trace is None and config.trace is not None:
        # The fleet shares ONE tracer, owned by the Router, so engine and
        # plan spans correlate with the router's sched-wait spans.
        router_config = dataclasses.replace(router_config, trace=config.trace)
    engine_config = dataclasses.replace(
        config, router=None,
        max_queue=config.max_batch if config.max_queue is None else config.max_queue,
    )

    def factory(cfg, metrics):
        # Closes over the model only: called again on hot restart, and the
        # rebuilt plan reads the same weights (nothing is copied or moved).
        return DecodePlan(model, cfg, metrics=metrics)

    router = Router(router_config)
    for i in range(fleet):
        router.add_engine(f"decode{i}", factory, engine_config)
    router.start()
    return router


__all__ = [
    "POLICIES",
    "Request",
    "Completion",
    "pad_cache_like",
    "ServiceConfig",
    "ServePlan",
    "BatchedPlan",
    "DecodeSession",
    "DecodePlan",
    "StreamingPlan",
    "SERVE_PLANS",
    "InferenceService",
    "serve_model",
    "serve_fleet",
]
