"""Project-once activation store for phase-program training.

Training is staged: greedy layer-by-layer Hebbian epochs, then a supervised
readout on frozen representations.  At each phase boundary the dataset is
projected once through the newly frozen prefix and the level-k result is
cached, so the epochs of the phase gather rows from it instead of re-running
the frozen stack per batch.

* Residency: cached levels live on the device under a byte budget
  (``ExecutionConfig(activation_budget_mb=...)``); beyond it the least
  recently used level spills to (pinned) host memory, and host bytes are
  bounded in turn by dropping LRU host entries, which are recomputable.
* Invalidation is by object identity: an entry records the exact
  ``LayerState`` objects (and the dataset array) it was projected from and
  is valid only while ``states[:k]`` still are those objects.  Layers never
  mutate a state, so every update publishes a new object.
* Projection runs in chunks of the training batch size, the ragged tail
  zero-padded to a full chunk, so every row sees the GEMM shape of a
  training batch.  Each chunk is staged on the device first and then
  projected under strict mode's dispatch guard; the projection callable of
  each ``(j, k)`` span is built once, with a signature-counting twin
  (:meth:`ActivationStore.projections`, which a recompile sentinel
  watches) that a strict store, or a strict caller of :meth:`level` (a
  strict serving plan over a network compiled without strict), projects
  through; a caller that is not strict runs the bare callable.
* Under a data-parallel trainer (``ExecutionConfig(trainer=)``) a
  ``collective`` call of :meth:`ActivationStore.level` (the phase
  program's, on every rank together) splits the chunks over the batch
  ranks and gathers the level with one all-reduce into zero-filled rows:
  each chunk has the shape it has on one device, so the level is the
  one-device level.  Every other call (predict, serving) projects on the
  rank that asks, and may cache the level on that rank alone, so a
  collective call first all-reduces a flag: the cache serves it only
  where every batch rank holds the level, and otherwise every rank
  projects (a rank that returned early would leave the others waiting
  in the projection's all-reduce).
* Tracing: each projection of a level (and the spill its insert may make)
  is a ``store.project`` span on the active tracer
  (:mod:`repro_torch.runtime.trace`), if there is one; ``stats`` counts
  projections, hits, spills and evictions either way.
* Threads: :meth:`ActivationStore.level` and
  :meth:`ActivationStore.invalidate_above` hold one lock, so several
  serving engines may share a compiled network (without it, one thread's
  insert could evict the entry another was about to return).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.strict import counted, dispatch_guard
from repro_torch.runtime import trace
from repro_torch.runtime.epoch_engine import forward_stack, rows_to


@dataclasses.dataclass
class _Entry:
    """One cached level-k representation."""

    value: torch.Tensor  # on the store's device, or on the host once spilled
    states: Tuple[Any, ...]  # the frozen states[:k] it was projected from
    x: Any  # the dataset array it was projected from (identity anchor)
    nbytes: int
    on_host: bool
    tick: int  # LRU clock

    def valid_for(self, states: Sequence[Any]) -> bool:
        return len(self.states) <= len(states) and all(
            a is b for a, b in zip(self.states, states)
        )


def _to_host(t: torch.Tensor) -> torch.Tensor:
    if t.device.type == "cpu":
        return t
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


class ActivationStore:
    """Cached frozen-prefix projections, keyed by ``(dataset, level)``.

    ``level(k, states, x, chunk)`` returns ``x`` after the first ``k``
    layers (level 0 is ``x`` itself).  The projection starts from the
    deepest still-valid cached level of ``x`` below ``k``.
    """

    def __init__(
        self,
        layers: Sequence[Any],
        device: torch.device,
        budget_bytes: int = 512 << 20,
        host_budget_bytes: Optional[int] = None,
        strict: bool = False,
        trainer=None,
    ):
        self.layers = list(layers)
        self.device = torch.device(device)
        self.strict = strict
        self.trainer = trainer
        self._proj: Dict[Tuple[int, int], Callable] = {}  # (j, k) -> layers[j:k] forward
        self._counted: Dict[Tuple[int, int], Callable] = {}  # (j, k) -> its Counted twin
        self.budget_bytes = int(budget_bytes)
        self.host_budget_bytes = (
            int(host_budget_bytes) if host_budget_bytes is not None else 4 * self.budget_bytes
        )
        self._entries: Dict[Tuple[int, int], _Entry] = {}  # (id(x), level)
        self._tick = 0
        self.stats = {"projections": 0, "hits": 0, "spills": 0, "evictions": 0}
        self._lock = threading.RLock()

    # ------------------------------------------------------------- interface
    def level(self, k: int, states: Sequence[Any], x, chunk: int, strict: bool = False,
              collective: bool = False):
        """Representation of ``x`` at level ``k`` under frozen ``states[:k]``.
        ``strict`` (or a strict store) projects through the counted
        callables, each chunk under the dispatch guard; ``collective``
        (every rank calls together) shares a projection over a trainer's
        batch ranks."""
        if k == 0:
            return x
        if not 0 < k <= len(self.layers):
            raise ValueError(f"level {k} out of range for {len(self.layers)} layers")
        with self._lock:
            return self._level_locked(k, states, x, chunk, strict or self.strict, collective)

    def _level_locked(self, k: int, states: Sequence[Any], x, chunk: int, strict: bool,
                      collective: bool):
        self._purge(states)
        # Each entry holds a strong reference to its dataset array, so the
        # id() in its key stays reserved for the entry's lifetime.
        key = (id(x), k)
        entry = self._entries.get(key)
        trainer = self.trainer if collective else None
        if trainer is not None and not self._every_rank_holds(entry is not None, trainer):
            entry = None
        if entry is not None:
            self.stats["hits"] += 1
            entry.tick = self._next_tick_locked()
            return entry.value
        base, j = x, 0
        for (aid, lvl), e in self._entries.items():
            if aid == id(x) and j < lvl < k:
                base, j = e.value, lvl
        tracer = trace.active()
        if tracer is None:
            self._insert(key, self._project(base, j, k, states, chunk, strict, trainer), states, x)
            return self._entries[key].value
        n = base.shape[0]
        with tracer.span("store.project", j=j, k=k, rows=n,
                         chunks=-(-n // min(chunk, n))) as attrs:
            self._insert(key, self._project(base, j, k, states, chunk, strict, trainer), states, x)
            entry = self._entries[key]
            attrs.update(bytes=entry.nbytes, spilled=entry.on_host)
        return entry.value

    def invalidate_above(self, level: int) -> int:
        """Drop every cached level strictly above ``level``, for every
        dataset, and return how many entries went.  Identity purging would
        drop them lazily at the next :meth:`level` call; a state adoption
        (a streaming session's close) calls this so the dead projections
        release their device and host bytes at the adoption itself."""
        with self._lock:
            stale = [k for k in self._entries if k[1] > level]
            for k in stale:
                del self._entries[k]
                self.stats["evictions"] += 1
            return len(stale)

    @property
    def device_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values() if not e.on_host)

    @property
    def host_bytes(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values() if e.on_host)

    def projections(self) -> Dict[Tuple[int, int], Callable]:
        """The counted projection callable of every ``(j, k)`` span built
        so far: what a recompile sentinel watches."""
        with self._lock:
            return dict(self._counted)

    def resident(self, k: int, x) -> Optional[str]:
        """'device' / 'host' for the cached level ``k`` of ``x``, else None."""
        with self._lock:
            e = self._entries.get((id(x), k))
        if e is None:
            return None
        return "host" if e.on_host else "device"

    # -------------------------------------------------------------- plumbing
    def _next_tick_locked(self) -> int:
        self._tick += 1
        return self._tick

    def _every_rank_holds(self, held: bool, trainer) -> bool:
        """Whether every batch rank of ``trainer`` holds the level asked
        for (one all-reduce of a flag, on every rank together)."""
        from repro_torch.core.distributed import all_reduce

        flag = torch.tensor([int(held)], dtype=torch.int32, device=self.device)
        return int(all_reduce(flag, trainer.batch_group).item()) == trainer.n_batch

    def _purge(self, states: Sequence[Any]) -> None:
        stale = [k for k, e in self._entries.items() if not e.valid_for(states)]
        for k in stale:
            del self._entries[k]
            self.stats["evictions"] += 1

    def _project(self, base, j: int, k: int, states: Sequence[Any], chunk: int,
                 strict: bool, trainer=None) -> torch.Tensor:
        """One pass of ``base`` (level j) through layers[j:k], chunk by chunk;
        the ragged tail is zero-padded to a full chunk and sliced.  With a
        ``trainer``, this rank projects its contiguous share of the chunks
        into zero-filled rows of the level and one all-reduce over the
        batch ranks fills in the others'."""
        self.stats["projections"] += 1
        if (j, k) not in self._proj:
            self._proj[(j, k)] = forward_stack(self.layers[j:k])
            self._counted[(j, k)] = counted(self._proj[(j, k)])
        fwd = (self._counted if strict else self._proj)[(j, k)]
        frozen = tuple(states[j:k])
        n = base.shape[0]
        chunk = min(chunk, n)
        starts = range(0, n, chunk)
        if trainer is not None:
            share = -(-len(starts) // trainer.n_batch)
            starts = starts[trainer.batch_rank * share:(trainer.batch_rank + 1) * share]
        parts = []
        for start in starts:
            xb = rows_to(base, start, start + chunk, self.device)
            rows = xb.shape[0]
            if rows < chunk:
                pad = torch.zeros((chunk - rows, *xb.shape[1:]), dtype=xb.dtype, device=xb.device)
                xb = torch.cat([xb, pad])
            with dispatch_guard(strict, self.device, {"states": frozen, "xb": xb}):
                parts.append(fwd(frozen, xb)[:rows])
        if trainer is None:
            return torch.cat(parts) if len(parts) > 1 else parts[0]
        width = frozen[-1].b.shape[0]  # the last frozen layer's units
        out = torch.zeros((n, width), dtype=torch.float32, device=self.device)
        if parts:
            out[starts[0]:starts[0] + sum(p.shape[0] for p in parts)] = torch.cat(parts)
        from repro_torch.core.distributed import all_reduce

        return all_reduce(out, trainer.batch_group)

    def _insert(self, key: Tuple[int, int], value: torch.Tensor, states, x) -> None:
        nbytes = value.numel() * value.element_size()
        on_host = nbytes > self.budget_bytes
        if not on_host:
            # Spill least-recently-used device levels until this one fits.
            while self.device_bytes + nbytes > self.budget_bytes:
                victims = [(e.tick, vk) for vk, e in self._entries.items() if not e.on_host]
                if not victims:
                    break
                entry = self._entries[min(victims)[1]]
                entry.value = _to_host(entry.value)
                entry.on_host = True
                self.stats["spills"] += 1
        else:
            value = _to_host(value)
            self.stats["spills"] += 1
        self._entries[key] = _Entry(
            value=value, states=tuple(states[: key[1]]), x=x, nbytes=nbytes,
            on_host=on_host, tick=self._next_tick_locked(),
        )
        # Host-spilled bytes are bounded too: drop LRU host entries.
        while self.host_bytes > self.host_budget_bytes:
            victims = [
                (e.tick, vk) for vk, e in self._entries.items() if e.on_host and vk != key
            ]
            if not victims:
                break  # only the just-inserted entry remains; keep it
            del self._entries[min(victims)[1]]
            self.stats["evictions"] += 1


def store_for(layers: Sequence[Any], config, device) -> Optional[ActivationStore]:
    """The store an ``ExecutionConfig`` asks for (None on the fused path).
    Under its ``trainer`` the phase program's projections of the training
    set are shared over the trainer's batch ranks."""
    if not config.cache_activations:
        return None
    budget = int(float(config.activation_budget_mb) * (1 << 20))
    return ActivationStore(layers, device, budget_bytes=budget, strict=config.strict,
                           trainer=config.trainer)


__all__ = ["ActivationStore", "store_for"]
