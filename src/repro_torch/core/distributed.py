"""Distributed BCPNN training: the paper's MPI backend on ``torch.distributed``.

The paper's scheme (Sec. 3, "MPI Backend"): each rank takes a sub-batch,
computes the *local batch means* of the activation statistics, one
``MPI_Allreduce`` derives the global means, and every rank then applies the
same EWMA update.  Here:

* MPI rank      -> a process of the default group, placed on a mesh of
                   dims ``("data", "model")`` or ``("pod", "data", "model")``
                   (``repro_torch.launch.mesh.make_host_mesh``);
* sub-batch     -> this rank's contiguous rows of every global batch
                   (``runtime.epoch_engine.epoch_sharding``);
* MPI_Allreduce -> one ``all_reduce`` of the packed means (m_i, m_j, m_ij)
                   over the batch axes' group, then the update's
                   reduced-means kernel (``ops.bcpnn_update_means``).

``DataParallelTrainer(mesh, mode)`` has the reference's two modes.
``"shard_map"`` is the scheme above, written out: each rank runs the
forward pair on its rows, averages its means with the others and updates.
``"pjit"`` writes the global math: each rank rebuilds the global batch from
the shards and runs the layer's own ``train_batch``, the same kernels as on
one device (the fused phase, the state tier and the reduced datapath
included).  Beyond the paper, a ``model`` axis shards a hidden layer's
units: each rank holds whole hypercolumns (never a split one), runs and
rewires only those, and the shards are gathered at the end of each phase.

The one collective is ``all_reduce`` of a tensor (an all-gather is an
all-reduce into zero-filled slots), so one code path runs under NCCL and
under gloo with CUDA tensors.  Every collective runs at every world size,
one rank included, and a failed one raises: nothing falls back.  :func:`collective_counts` counts them beside the kernels'
``ops.launch_counts()``.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core import layers as _layers
from repro_torch.core.layers import DenseLayer, LayerState, StructuralPlasticityLayer
from repro_torch.core.learning import MarginalState, full_f32_matmul
from repro_torch.core.plasticity import PlasticityState
from repro_torch.core.units import UnitLayout
from repro_torch.kernels import ops

MODES = ("shard_map", "pjit")

# Collectives since the last reset_collectives(): calls per kind, and the
# host seconds spent inside them.
_counts: Dict[str, int] = {"all_reduce": 0}
_seconds: Dict[str, float] = {"all_reduce": 0.0}


def collective_counts() -> Dict[str, int]:
    """Collectives per kind since the last :func:`reset_collectives`."""
    return dict(_counts)


def collective_seconds() -> Dict[str, float]:
    """Host seconds inside each kind of collective since the last reset
    (under NCCL the call only enqueues; under gloo it waits for the data)."""
    return dict(_seconds)


def reset_collectives() -> None:
    for k in _counts:
        _counts[k] = 0
        _seconds[k] = 0.0


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of ``t`` over ``group``, counted."""
    t0 = time.perf_counter()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _seconds["all_reduce"] += time.perf_counter() - t0
    _counts["all_reduce"] += 1
    return t


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes the batch is split over (pod and data, where present)."""
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(a for a in ("pod", "data") if a in names)


def model_axis(mesh) -> Optional[str]:
    return "model" if "model" in tuple(mesh.mesh_dim_names or ()) else None


def _axis_groups(mesh, axes: Sequence[str]):
    """The process group of this rank's neighbours along ``axes`` (those
    that share every other coordinate) and its size.  Every rank creates
    every such group, in one order, as ``new_group`` requires."""
    names = list(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axes]
    ranks = mesh.mesh
    other = [d for d in range(ranks.ndim) if d not in dims]
    size = math.prod(ranks.shape[d] for d in dims)
    me, mine = dist.get_rank(), None
    for row in ranks.permute(*other, *dims).reshape(-1, size).tolist():
        group = dist.new_group(row)
        if me in row:
            mine = group
    return mine, size


def mesh_position(mesh, axes: Sequence[str]) -> Tuple[int, int]:
    """This rank's row-major index along ``axes`` and their rank count."""
    names, coord = list(mesh.mesh_dim_names), mesh.get_coordinate()
    index, count = 0, 1
    for a in axes:
        d = names.index(a)
        index, count = index * mesh.mesh.shape[d] + coord[d], count * mesh.mesh.shape[d]
    return index, count


def batch_rows(n: int, index: int, count: int, axes: Sequence[str]) -> slice:
    """The rows of a global batch of ``n`` that batch rank ``index`` of
    ``count`` (along ``axes``) holds: equal contiguous blocks in rank
    order; ``n`` must divide evenly."""
    if n % count:
        raise ValueError(
            f"batch_size={n} does not split over {count} batch ranks (mesh axes {tuple(axes)})"
        )
    per = n // count
    return slice(index * per, (index + 1) * per)


def local_layout(post: UnitLayout, n_local: int) -> UnitLayout:
    """The layout of ``n_local`` of ``post``'s units, whole hypercolumns."""
    if n_local == post.n_units:
        return post
    if n_local % post.n_mcu:
        raise ValueError(f"a shard of {n_local} units splits a hypercolumn of {post.n_mcu}")
    return UnitLayout(n_hcu=n_local // post.n_mcu, n_mcu=post.n_mcu)


def dp_learning_cycle(
    state: MarginalState,
    ai: torch.Tensor,
    aj: torch.Tensor,
    lam: float,
    k_b: float,
    group,
    group_size: int,
    mask: Optional[torch.Tensor] = None,
    use_kernels: Optional[bool] = None,
):
    """One learning cycle on a local sub-batch: the local means (m_i, m_j,
    m_ij = a_i^T a_j / B_local) packed in one buffer, one all-reduce over
    ``group`` divided by its size (the paper's allreduce; equal shard sizes
    make the mean of the means the global mean), then the reduced-means
    update.  Returns (new MarginalState, w, b)."""
    f, h = ai.shape[1], aj.shape[1]
    buf = torch.empty(f + h + f * h, dtype=torch.float32, device=ai.device)
    mi, mj, mij = buf[:f], buf[f:f + h], buf[f + h:].view(f, h)
    torch.mean(ai, dim=0, out=mi)
    torch.mean(aj, dim=0, out=mj)
    full_f32_matmul(ai.T, aj, out=mij).div_(ai.shape[0])
    all_reduce(buf, group).div_(group_size)
    return ops.bcpnn_update_means(state, mi, mj, mij, lam, k_b=k_b, mask=mask,
                                  use_kernels=use_kernels)


class DataParallelTrainer:
    """Per-batch steps that train one global batch spread over the ranks.

    mode="shard_map": the paper's scheme, explicit means and all-reduce.
    mode="pjit":      the global batch rebuilt on every rank, then the
                      layer's own ``train_batch``.
    A hidden layer's units are sharded over the mesh's ``model`` axis,
    which must divide its hypercolumns; the readout is replicated.  Bind
    it with ``ExecutionConfig(trainer=...)``.
    """

    def __init__(self, mesh, mode: str = "shard_map"):
        if mode not in MODES:
            raise ValueError(f"mode must be shard_map|pjit, got {mode}")
        self.mesh = mesh
        self.mode = mode
        self.baxes = batch_axes(mesh)
        if not self.baxes:
            raise ValueError(f"mesh {tuple(mesh.mesh_dim_names or ())} has no pod/data axis")
        self.batch_group, self.n_batch = _axis_groups(mesh, self.baxes)
        self.batch_rank = mesh_position(mesh, self.baxes)[0]
        m = model_axis(mesh)
        self.model_group, self.n_model = _axis_groups(mesh, (m,)) if m else (None, 1)
        self.model_rank = mesh_position(mesh, (m,))[0] if m else 0
        self._local: Dict[int, Any] = {}  # id(layer) -> its local copy

    # ------------------------------------------------------- plan decoration
    def decorate(self, plan):
        """Bind this trainer into an ExecutionPlan (``runtime.plans``): its
        epoch runners take this trainer's steps, rows and placement.
        Invoked by ``compile(ExecutionConfig(trainer=...))``."""
        for layer in plan.layers:
            self.check_layer(layer)
        return plan.bind_trainer(self)

    def check_layer(self, layer) -> None:
        """Refuse what this trainer cannot run: in shard_map mode a reduced
        datapath, a state tier or the fused phase (the explicit step is the
        f32 forward pair and the f32 reduced-means update); a model axis
        that would split a hidden layer's hypercolumns."""
        spec = layer.spec
        if self.mode == "shard_map":
            if _layers._datapath_policy(spec) is not None:
                raise ValueError(
                    f"DataParallelTrainer(mode='shard_map') runs the f32 datapath; the layer's "
                    f"precision={spec.precision.fmt.name!r} datapath needs mode='pjit'"
                )
            if _layers._state_format(spec) is not None:
                raise ValueError(
                    "DataParallelTrainer(mode='shard_map') keeps f32 traces; the layer's state "
                    f"tier (precision state_format={spec.precision.state_format!r}) needs mode='pjit'"
                )
            if spec.fused_phase:
                raise ValueError(
                    "DataParallelTrainer(mode='shard_map') runs the forward pair and the "
                    "reduced-means update; fused_phase=True needs mode='pjit'"
                )
        if self.shards(layer):
            spec.post.validate_divisible_by(self.n_model)

    def shards(self, layer) -> bool:
        """A hidden layer's units are split over the model axis (of any
        size); the readout stays replicated."""
        return isinstance(layer, StructuralPlasticityLayer) and self.model_group is not None

    def local_layer(self, layer):
        """``layer`` with its post layout cut to this rank's hypercolumns
        (the layer itself when it is not sharded)."""
        if not self.shards(layer):
            return layer
        bound = self._local.get(id(layer))
        if bound is None or bound[0] is not layer:
            spec = layer.spec
            spec.post.validate_divisible_by(self.n_model)
            local = copy.copy(layer)
            local.spec = dataclasses.replace(
                spec, post=local_layout(spec.post, spec.post.n_units // self.n_model))
            bound = self._local[id(layer)] = (layer, local)
        return bound[1]

    # ------------------------------------------------------------- placement
    def _columns(self, layer) -> Tuple[int, int, int, int]:
        """This rank's unit columns [u0, u1) and hypercolumns [h0, h1)."""
        post = layer.spec.post
        n_hcu = post.n_hcu // self.n_model
        h0 = self.model_rank * n_hcu
        return h0 * post.n_mcu, (h0 + n_hcu) * post.n_mcu, h0, h0 + n_hcu

    def place_state(self, layer, state: LayerState) -> LayerState:
        """This rank's part of a global layer state: its units' columns of
        w, b, c_j, C_ij and its hypercolumns of the mask (c_i whole)."""
        if not self.shards(layer):
            return state
        u0, u1, h0, h1 = self._columns(layer)
        marg = state.marginals
        return LayerState(
            marginals=MarginalState(marg.ci, marg.cj[u0:u1].contiguous(),
                                    marg.cij[:, u0:u1].contiguous()),
            w=state.w[:, u0:u1].contiguous(),
            b=state.b[u0:u1].contiguous(),
            plast=PlasticityState(state.plast.hcu_mask[:, h0:h1].contiguous()),
            step=state.step,
            host_step=state.host_step,
        )

    def gather_state(self, layer, state: LayerState) -> LayerState:
        """The global layer state from every rank's part: one all-reduce
        over the model axis into zero-filled slots (f32; bf16 traces are
        widened and narrowed exactly)."""
        if not self.shards(layer):
            return state
        u0, u1, h0, h1 = self._columns(layer)
        spec = layer.spec
        f, h = spec.n_pre, spec.n_post
        hp, hh = spec.pre.n_hcu, spec.post.n_hcu
        sizes = (f * h, f * h, h, h, hp * hh)
        buf = torch.zeros(sum(sizes), dtype=torch.float32, device=state.w.device)
        w, cij, b, cj, hm = torch.split(buf, sizes)
        w, cij, hm = w.view(f, h), cij.view(f, h), hm.view(hp, hh)
        w[:, u0:u1] = state.w
        cij[:, u0:u1] = state.marginals.cij
        b[u0:u1] = state.b
        cj[u0:u1] = state.marginals.cj
        hm[:, h0:h1] = state.plast.hcu_mask
        all_reduce(buf, self.model_group)
        tdt = state.marginals.cij.dtype
        return LayerState(
            marginals=MarginalState(state.marginals.ci, cj.to(tdt), cij.to(tdt)),
            w=w, b=b, plast=PlasticityState(hm), step=state.step, host_step=state.host_step,
        )

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        return batch_rows(n, self.batch_rank, self.n_batch, self.baxes)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch from every rank's rows: one all-reduce over the
        batch axes into zero-filled slots."""
        per = t.shape[0]
        out = torch.zeros((per * self.n_batch, *t.shape[1:]), dtype=t.dtype, device=t.device)
        out[self.batch_rank * per:(self.batch_rank + 1) * per] = t
        return all_reduce(out, self.batch_group)

    def average_grads(self, grads: Sequence[torch.Tensor]) -> list:
        """The mean of every rank's gradients over the batch axes (one
        all-reduce of the packed leaves): each rank's loss is the mean over
        its rows, so this is the global batch's gradient."""
        flat = torch.cat([g.reshape(-1) for g in grads])
        all_reduce(flat, self.batch_group).div_(self.n_batch)
        return [p.view_as(g) for p, g in zip(torch.split(flat, [g.numel() for g in grads]), grads)]

    # ---------------------------------------------------------- step builders
    def hidden_step(self, layer: StructuralPlasticityLayer) -> Callable:
        """``(local state, local rows) -> local state`` for one global batch."""
        self.check_layer(layer)
        local = self.local_layer(layer)
        if self.mode == "pjit":
            return lambda state, xb: local.train_batch(state, self.gather_rows(xb))[0]
        return self._shard_map_step(local, supervised=False)

    def readout_step(self, layer: DenseLayer) -> Callable:
        """``(state, local rows, local labels) -> state`` for one global batch."""
        self.check_layer(layer)
        if self.mode == "pjit":
            return lambda state, hb, yb: layer.train_batch(
                state, self.gather_rows(hb), self.gather_rows(yb))[0]
        return self._shard_map_step(layer, supervised=True)

    def _shard_map_step(self, layer, supervised: bool) -> Callable:
        """The explicit step on this rank's rows and units: (rewire), the
        forward pair with the gain before the softmax (as the reference's
        step scales it: without it shard_map training diverges from the
        single-device path for any gain other than 1), one-hot targets for
        the readout, then
        ``n_cycles`` of :func:`dp_learning_cycle`.  The rewire scores and
        swaps each of this rank's hypercolumns from its own columns, which
        is the global rewire restricted to them."""
        spec = layer.spec

        def learn(state: LayerState, ai, aj, mask) -> LayerState:
            marg, w, b = state.marginals, state.w, state.b
            for _ in range(spec.n_cycles):
                marg, w, b = dp_learning_cycle(
                    marg, ai, aj, spec.lam, spec.k_b, self.batch_group, self.n_batch,
                    mask=mask, use_kernels=spec.use_kernels,
                )
            return LayerState(marginals=marg, w=w, b=b, plast=state.plast,
                              step=state.step + 1, host_step=state.host_step + 1)

        if supervised:
            def readout(state, hb, yb):
                aj = F.one_hot(yb.long(), spec.n_post).to(hb.dtype) if yb.ndim == 1 else yb
                return learn(state, hb, aj, None)

            return readout

        def hidden(state, xb):
            state = layer.maybe_update_mask(state)
            mask = _layers._unit_mask(spec, state)
            return learn(state, xb, _layers._forward(spec, state, xb, mask), mask)

        return hidden


__all__ = [
    "DataParallelTrainer", "MODES", "all_reduce", "batch_axes", "batch_rows",
    "collective_counts", "collective_seconds", "dp_learning_cycle", "local_layout",
    "mesh_position", "model_axis", "reset_collectives",
]
