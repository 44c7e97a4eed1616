"""Streaming mode: latency-oriented single/few-sample BCPNN updates.

The paper defines two operation modes (Sec. 3); "Streaming" lets a third
party (camera, NIC) deliver samples at unpredictable latency.  The batched
mode turns BLAS2 into BLAS3 by aggregating samples; streaming keeps the same
EWMA semantics at B_S=1 but must avoid per-sample dispatch overhead.

A small host-side coalescing buffer (``max_batch``, ``max_wait_s``) turns
bursts into micro-batches without changing semantics: the EWMA with the
batch mean over b samples at rate λ is applied once per micro-batch, exactly
as Alg. 1 does for any B_S.  The buffered host samples are stacked and
staged onto the layer state's device once per flush; on the card each flush
is one ``train_batch`` (the forward pair and ``bcpnn_update``, or one
``bcpnn_phase`` launch with ``fused_phase``), and inference one forward
pair.

A "cell" is the callable that runs one micro-batch size: a plain closure
over the layer's ``train_batch`` (or ``forward``).  The per-size cells live
in LRU maps bounded by ``cache_size`` (the reference keeps one jitted
callable per size there); the bound, the eviction count and ``stats`` keep
the reference's meaning.  Sessions opened by ``CompiledNetwork.streaming()``
share ONE such LRU per layer across all of that network's sessions, and
write their learned state back into the compiled NetworkState on close().
Adoption publishes a NEW LayerState object, which is exactly what the
project-once ActivationStore keys its cache validity on.

``compiled.serve(ServiceConfig(plan="streaming", ...))`` opens one of these
sessions behind the InferenceService front door
(:class:`repro_torch.runtime.service.StreamingPlan`).  A ``strict`` session
(a network compiled with ``strict=True``) makes each cell a
signature-counting :class:`~repro_torch.analysis.strict.Counted`, which
the serving plan's recompile sentinel watches through
:meth:`_LRUCells.items`, and dispatches each cell under the dispatch guard,
its rows staged on the device first.
"""
from __future__ import annotations

import time
from collections import OrderedDict, deque
from typing import Callable, Deque, Optional

import numpy as np
import torch

from repro_torch.analysis.strict import counted, dispatch_guard
from repro_torch.core.layers import LayerState, StructuralPlasticityLayer


class _LRUCells:
    """A tiny LRU map: micro-batch size -> cell."""

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._d: "OrderedDict[int, Callable]" = OrderedDict()
        self.evictions = 0

    def set_capacity(self, capacity: int) -> None:
        self.capacity = max(1, int(capacity))
        self._evict()

    def get(self, key: int) -> Optional[Callable]:
        cell = self._d.get(key)
        if cell is not None:
            self._d.move_to_end(key)
        return cell

    def put(self, key: int, cell: Callable) -> None:
        self._d[key] = cell
        self._d.move_to_end(key)
        self._evict()

    def _evict(self) -> None:
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def items(self):
        """(key, cell) pairs, LRU-first (for the strict-mode sentinel)."""
        return list(self._d.items())

    def __len__(self) -> int:
        return len(self._d)


def _train_cell(layer, strict: bool = False) -> Callable:
    return counted(lambda state, xb: layer.train_batch(state, xb)[0], strict)


def _infer_cell(layer, strict: bool = False) -> Callable:
    return counted(layer.forward, strict)


class StreamingSession:
    """Online unsupervised training/inference over an unbounded sample feed."""

    def __init__(
        self,
        layer: StructuralPlasticityLayer,
        state: LayerState,
        max_batch: int = 16,
        max_wait_s: float = 0.0,
        cache_size: int = 8,
        train_cells: Optional[_LRUCells] = None,
        infer_cells: Optional[_LRUCells] = None,
        on_close: Optional[Callable] = None,
        strict: bool = False,
    ):
        self.layer = layer
        self.strict = strict
        self.state = state
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._buf: Deque[np.ndarray] = deque()
        self._last_flush = time.perf_counter()
        # A caller (CompiledNetwork.streaming) may pass shared LRUs so several
        # sessions use ONE bounded cache; their capacity then governs and
        # ``cache_size`` is ignored.  Cells close over the LAYER only, never
        # the session, so a cell kept in a shared LRU pins no session state.
        self._train_cells = train_cells if train_cells is not None else _LRUCells(cache_size)
        self._infer_cells = infer_cells if infer_cells is not None else _LRUCells(cache_size)
        self._on_close = on_close
        self._closed = False
        self.samples_seen = 0
        self.flushes = 0

    @property
    def device(self) -> torch.device:
        return self.state.w.device

    def _stage(self, rows) -> torch.Tensor:
        """Host rows -> one f32 tensor on the state's device."""
        xb = np.asarray(rows, dtype=np.float32)
        return torch.from_numpy(np.ascontiguousarray(xb)).to(self.device)

    # ------------------------------------------------------------- training
    def feed(self, sample) -> None:
        """Queue one sample (n_features,); flush when the buffer fills or the
        wait budget expires."""
        if self._closed:
            raise RuntimeError(
                "StreamingSession is closed; its state was already published "
                "— open a new session to keep training"
            )
        self._buf.append(np.asarray(sample))
        now = time.perf_counter()
        if (
            len(self._buf) >= self.max_batch
            or (self.max_wait_s > 0 and now - self._last_flush >= self.max_wait_s)
        ):
            self.flush()

    def flush(self) -> None:
        """Apply one EWMA update over the buffered micro-batch."""
        if self._closed:
            raise RuntimeError("StreamingSession is closed")
        if not self._buf:
            return
        xb = self._stage(np.stack(list(self._buf), axis=0))
        self._buf.clear()
        b = xb.shape[0]
        cell = self._train_cells.get(b)
        if cell is None:
            cell = _train_cell(self.layer, self.strict)
            self._train_cells.put(b, cell)
        with dispatch_guard(self.strict, xb.device, {"state": self.state, "xb": xb}):
            self.state = cell(self.state, xb)
        self.samples_seen += b
        self.flushes += 1
        self._last_flush = time.perf_counter()

    # ------------------------------------------------------------ inference
    def infer(self, sample) -> np.ndarray:
        """Single-sample inference: the layer's activations as a host array."""
        xb = self._stage(np.asarray(sample)[None, :])
        cell = self._infer_cells.get(1)
        if cell is None:
            cell = _infer_cell(self.layer, self.strict)
            self._infer_cells.put(1, cell)
        with dispatch_guard(self.strict, xb.device, {"state": self.state, "xb": xb}):
            out = cell(self.state, xb)
        return out[0].cpu().numpy()

    # ------------------------------------------------------------- plumbing
    @property
    def stats(self) -> dict:
        """Session statistics, including the bounded cell-cache occupancy."""
        return {
            "samples_seen": self.samples_seen,
            "flushes": self.flushes,
            "buffered": len(self._buf),
            "train_cache_size": len(self._train_cells),
            "infer_cache_size": len(self._infer_cells),
            "cache_capacity": self._train_cells.capacity,
            "infer_cache_capacity": self._infer_cells.capacity,
            "cache_evictions": self._train_cells.evictions + self._infer_cells.evictions,
        }

    def close(self) -> LayerState:
        """Flush and hand the learned state to on_close (idempotent: a
        second close returns the state without re-publishing)."""
        if self._closed:
            return self.state
        self.flush()
        if self._on_close is not None:
            self._on_close(self.state)
        self._closed = True
        return self.state


__all__ = ["StreamingSession"]
