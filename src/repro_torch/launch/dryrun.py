"""Dry run: count every (arch x shape x mesh) cell's step on the ``meta`` device.

The port of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 512 placeholder TPU devices and reads XLA's cost
and memory analyses.  The port has no compiler to ask: it runs the step
itself on ``meta`` tensors (shapes and dtypes, no values, nothing
allocated) and counts what it does:

* ``flops`` from ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products, attention and convolutions; elementwise work is not counted);
* ``bytes_accessed``: every operation's tensor inputs read and outputs
  written, views excluded: an upper bound on device-memory traffic, the
  counterpart of XLA's ``bytes accessed`` (eager PyTorch fuses nothing);
* the step's peak of new tensors from
  ``torch.distributed._tools.mem_tracker.MemTracker``, beside the
  arguments (parameters, optimizer state, cache and batch);
* the collectives the step issues, by op, from the process group's
  ``c10d`` operations as they dispatch (``collective_bytes``).

``run_cell`` builds the model on ``meta``, the batch from
``batch_specs``, the cache from ``decode_specs`` and, to train, AdamW's
state over f32 masters, runs ``make_train_step`` / ``prefill`` /
``decode_step`` as the shape's kind says, and writes one record per mesh:

* ``card``: one device, the default;
* ``pod`` (16 x 16) and ``multipod`` (2 x 16 x 16), the reference's
  meshes: FLOPs, bytes and temporaries a device are the step's over the
  device count (the reference's uniform-sharding form); argument bytes a
  device go through ``ShardCtx`` on the mesh's shape.  The port's models
  issue no collective and take no mesh, so ``collectives`` is None there,
  with the reason: nothing is counted, nothing is claimed.

The record keeps the reference's keys (``flops_per_device``,
``bytes_per_device``, ``argument_size_in_bytes``, ``temp_size_in_bytes``,
``collectives``, ...), so ``roofline.analyze_cell`` reads it, and adds
``peak_bytes`` (arguments + temporaries a device) and ``fits_one_card``
(``peak_bytes`` at most 0.9 x the card's 80 GB).  Every figure is a count
from ``meta``, not a measurement on a device.

    python -m repro_torch.launch.dryrun --arch gemma3-1b --shape long_500k
    python -m repro_torch.launch.dryrun --all --mesh all --out experiments/dryrun_torch
    python -m repro_torch.launch.dryrun --all --probes   # the probe grid

Flags: ``--mesh card|pod|multipod|all``; ``--no-remat``; ``--micro N``
(microbatches); ``--batch N`` (the global batch cut); ``--tag`` (a suffix
of the file names); ``--probes``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, batch_specs, decode_specs, get_config, shape_applicable
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCH_NAMES
from repro_torch.launch.mesh import HBM_BYTES, production_shape
from repro_torch.launch.roofline import DEFAULT_DIR, WIRE_WEIGHT
from repro_torch.models import build_model
from repro_torch.optim import AdamW
from repro_torch.sharding.rules import L, ShardCtx, cache_logical, local_bytes, logical

COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
# The c10d operations a ProcessGroup call dispatches, by the reference's
# collective names; each one's RESULT tensors are counted.
_C10D_OPS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}
MESHES = ("card", "pod", "multipod")
FIT_SHARE = 0.9  # a cell fits one card when its peak is at most this share of HBM_BYTES
_NO_COLLECTIVES = ("the port's LM models take no mesh and issue no collective; their "
                   "sharded traffic on this mesh is not counted")


def mesh_shape(mesh: str) -> Dict[str, int]:
    """{axis: size} of a named mesh."""
    if mesh == "card":
        return {"data": 1, "model": 1}
    if mesh not in ("pod", "multipod"):
        raise ValueError(f"mesh {mesh!r}: want one of {MESHES}")
    return production_shape(multi_pod=mesh == "multipod")


# ------------------------------------------------------------- counting
def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _Traffic(TorchDispatchMode):
    """Bytes every operation reads and writes (views and allocations
    without a write excluded), and the collectives' result bytes by op."""

    _SKIP = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collectives: Dict[str, float] = {}
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns == "c10d":
            op = _C10D_OPS.get(name)
            if op is not None:  # every one of these takes its result tensors first
                self.collectives[op] = self.collectives.get(op, 0.0) + float(_nbytes(args[0]))
                self.count += 1
            return out
        if not (func.is_view or name in self._SKIP):
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out


def collective_bytes(mode: _Traffic) -> Dict[str, float]:
    """The collectives a counted step issued: result bytes per op
    (``COLLECTIVE_OPS`` names), ``count``, and ``total``, the wire bytes a
    device moves under ring algorithms (``WIRE_WEIGHT``); ``{}`` when it
    issued none."""
    if not mode.count:
        return {}
    rec = {op: mode.collectives.get(op, 0.0) for op in COLLECTIVE_OPS}
    rec["count"] = mode.count
    rec["total"] = sum(rec[op] * WIRE_WEIGHT[op] for op in COLLECTIVE_OPS)
    return rec


def count_step(fn: Callable, *args) -> Dict:
    """Run ``fn(*args)`` (meta tensors) once under the counters: its
    ``flops``, ``bytes_accessed``, ``temp_bytes`` (the peak of tensors it
    made, its outputs included), ``output_bytes``, ``collectives`` and
    ``count_s`` (host seconds)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    t0 = time.perf_counter()
    traffic = _Traffic()
    mem = MemTracker()
    with FlopCounterMode(display=False) as flops, mem, traffic:
        out = fn(*args)
    peak = mem.get_tracker_snapshot("peak")
    temp = max((dev_peak.get("Total", 0) for dev_peak in peak.values()), default=0)
    return {
        "flops": int(flops.get_total_flops()),
        "bytes_accessed": int(traffic.bytes),
        "temp_bytes": int(temp),
        "output_bytes": _nbytes(out),
        "collectives": collective_bytes(traffic),
        "count_s": time.perf_counter() - t0,
    }


def register_out_dtype_products() -> None:
    """Count ``aten.mm.dtype`` / ``aten.bmm.dtype`` (``torch.mm(...,
    out_dtype=)``, the f32 accumulator of a bf16 product on the card and on
    ``meta``) as ``mm`` / ``bmm``.  FlopCounterMode looks a formula up by
    the op's packet and passes the ``out_dtype`` on as a positional
    argument, which its ``bmm`` formula refuses; the formulas installed
    here take the two shapes and ignore the rest.  Idempotent."""
    from torch.utils import flop_counter as fc

    aten = torch.ops.aten

    def tolerant(formula):
        def count(a_shape, b_shape, *_, out_shape=None, **__):
            return formula(a_shape, b_shape)

        count.out_dtype_tolerant = True
        return fc.shape_wrapper(count)

    for packet, formula in ((aten.mm, fc.mm_flop), (aten.bmm, fc.bmm_flop)):
        if not getattr(fc.flop_registry.get(packet), "out_dtype_tolerant", False):
            wrapped = tolerant(formula)
            wrapped.out_dtype_tolerant = True
            fc.flop_registry[packet] = wrapped


# ------------------------------------------------------------- one cell
def _batch_logical(t: torch.Tensor) -> L:
    """A batch tensor's names: its first dim ``batch`` (when wider than 1)."""
    if t.dim() and t.shape[0] > 1:
        return L("batch", *([None] * (t.dim() - 1)))
    return L(*([None] * t.dim()))


def _opt_logical(names, opt_state):
    return type(opt_state)(step=L(), mu=names, nu=names)


def build_cell(cfg, shape: ShapeConfig):
    """(step, args, {argument name: (tree, logical tree)}) of one cell's
    step on ``meta``: train -> (params, opt_state, batch); prefill ->
    (batch,); decode -> (cache, token, cur_len)."""
    names = logical(cfg)
    if shape.kind == "train":
        model = build_model(cfg, "meta", param_dtype=torch.float32)
        params = model.params()
        opt = AdamW(learning_rate=1e-4, weight_decay=0.1)
        opt_state = opt.init(params)
        batch = batch_specs(cfg, shape)
        step = model.make_train_step(opt)
        parts = {"params": (params, names),
                 "opt_state": (opt_state._asdict(), _opt_logical(names, opt_state)._asdict()),
                 "batch": (batch, {k: _batch_logical(v) for k, v in batch.items()})}
        return step, (params, opt_state, batch), parts, model
    model = build_model(cfg, "meta")  # serving: the compute dtype (bf16)
    params = model.params()
    if shape.kind == "prefill":
        batch = batch_specs(cfg, shape)

        def step(b):
            with torch.no_grad():
                return model.prefill(b)

        parts = {"params": (params, names),
                 "batch": (batch, {k: _batch_logical(v) for k, v in batch.items()})}
        return step, (batch,), parts, model
    dspec = decode_specs(cfg, shape, model)

    def step(cache, token, cur_len):
        with torch.no_grad():
            return model.decode_step(cache, token, cur_len)

    parts = {"params": (params, names),
             "cache": (dspec["cache"], cache_logical(cfg)),
             "token": (dspec["token"], _batch_logical(dspec["token"])),
             "cur_len": (dspec["cur_len"], L())}
    return step, (dspec["cache"], dspec["token"], dspec["cur_len"]), parts, model


def _cell_config(arch, cfg, remat, micro, probe):
    cfg = cfg if cfg is not None else get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if micro is not None:
        cfg = dataclasses.replace(cfg, n_micro=micro)
    if probe is not None:
        reps = {"n_micro": probe.get("micro", 1)}
        if "n_layers" in probe:
            reps["n_layers"] = probe["n_layers"]
        if "n_dec_layers" in probe and cfg.family == "encdec":
            reps["n_dec_layers"] = probe["n_dec_layers"]
        if cfg.family == "hybrid":  # probe depth counts groups
            reps["n_layers"] = probe["n_layers"] * cfg.attn_every
        cfg = dataclasses.replace(cfg, **reps)
    return cfg


def count_depths(cfg, kind: str):
    """The depths a cell's step is counted at: None (full depth) for a
    decode step; else the probe depths of ``probe_suite`` (two, or the
    enc-dec family's three (encoder, decoder) pairs), each as
    ``dataclasses.replace`` keywords, from which ``run_cell`` extrapolates
    linearly to full depth.  A meta count of a train or prefill step at
    full depth takes minutes (its attention and SSD chunk loops run op by
    op), and every layer of a stack counts alike."""
    if kind == "decode":
        return None
    if cfg.family == "encdec":
        return [{"n_layers": e, "n_dec_layers": dd} for e, dd in ((1, 1), (2, 1), (1, 2))]
    unit = cfg.attn_every if cfg.family == "hybrid" else 1
    base = cfg.first_dense_layers if cfg.family == "moe" else 0
    return [{"n_layers": (base + k) * unit} for k in (1, 2)]


def _extrapolate_depth(cfg, depths, counts: list, key: str) -> int:
    """``key`` of ``counts`` (one per entry of ``depths``) at ``cfg``'s
    full depth: linear in each stack's layer count (exact for FLOPs and
    bytes, whose every layer counts alike; the peak of new tensors grows
    the same way wherever it is set by what each layer keeps)."""
    if cfg.family == "encdec":
        c11, c21, c12 = (c[key] for c in counts)
        return c11 + (cfg.n_layers - 1) * (c21 - c11) + (cfg.n_dec_layers - 1) * (c12 - c11)
    (la, ca), (lb, cb) = ((d["n_layers"], c[key]) for d, c in zip(depths, counts))
    unit = lb - la
    return ca + (cfg.n_layers - la) // unit * (cb - ca)


def run_cell(
    arch: str,
    shape_name: str,
    meshes=("card",),
    remat: Optional[bool] = None,
    micro: Optional[int] = None,
    probe: Optional[Dict] = None,
    cfg=None,
    global_batch: Optional[int] = None,
    seq_len: Optional[int] = None,
    full_depth: Optional[bool] = None,
) -> Dict[str, Dict]:
    """Count one cell's step on ``meta``; returns {mesh: record}.

    ``probe``: {"n_layers", "n_dec_layers", "seq", "batch"} overrides for
    the roofline's fit (``probe_suite``), counted as they are.  ``cfg``: a
    config in place of ``get_config(arch)`` (the tests' smoke configs).
    ``global_batch``, ``seq_len``: the shape cut (a card run that must
    fit; the tests' small shapes).
    ``full_depth``: count the step at full depth even where
    ``count_depths`` would extrapolate (slow; the tests' check of the
    extrapolation)."""
    cfg = _cell_config(arch, cfg, remat, micro, probe)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {m: {"arch": arch, "shape": shape_name, "mesh": m, "skipped": why} for m in meshes}
    if probe is not None:
        shape = ShapeConfig(name=f"probe_{shape.name}", seq_len=probe.get("seq", shape.seq_len),
                            global_batch=probe.get("batch", shape.global_batch), kind=shape.kind)
    if global_batch is not None:
        shape = dataclasses.replace(shape, global_batch=global_batch)
    if seq_len is not None:
        shape = dataclasses.replace(shape, seq_len=seq_len)

    register_out_dtype_products()
    step, args, parts, model = build_cell(cfg, shape)
    depths = None if (probe is not None or full_depth) else count_depths(cfg, shape.kind)
    if depths is None:
        counted = count_step(step, *args)
    else:
        del step, args
        counts = []
        for d in depths:
            sub = build_cell(dataclasses.replace(cfg, **d), shape)
            counts.append(count_step(sub[0], *sub[1]))
        counted = {k: _extrapolate_depth(cfg, depths, counts, k)
                   for k in ("flops", "bytes_accessed", "temp_bytes", "output_bytes")}
        counted["count_s"] = sum(c["count_s"] for c in counts)
        counted["collectives"] = counts[-1]["collectives"]
    n_numel = sum(p.numel() for p in model.parameters())
    records = {}
    for m in meshes:
        ms = mesh_shape(m)
        ctx = ShardCtx(mesh=ms)
        chips = 1
        for v in ms.values():
            chips *= v
        arg_bytes = {k: local_bytes(ctx, tree, names) for k, (tree, names) in parts.items()}
        arg_total = sum(arg_bytes.values())
        temp = counted["temp_bytes"] // chips
        rec = {
            "arch": arch,
            "shape": shape_name,
            "probe": probe,
            "kind": shape.kind,
            "mesh": m,
            "mesh_shape": ms,
            "chips": chips,
            "device": "meta",
            "count_s": round(counted["count_s"], 3),
            "counted_depths": depths,
            "flops": counted["flops"],
            "flops_per_device": counted["flops"] / chips,
            "bytes_accessed": counted["bytes_accessed"],
            "bytes_per_device": counted["bytes_accessed"] / chips,
            "argument_size_in_bytes": arg_total,
            "argument_bytes_by_part": arg_bytes,
            "temp_size_in_bytes": temp,
            "output_size_in_bytes": counted["output_bytes"] // chips,
            "peak_bytes": arg_total + temp,
            "fits_one_card": arg_total + temp <= FIT_SHARE * HBM_BYTES,
            "collectives": counted["collectives"] if m == "card" else None,
            "params": int(cfg.param_count()),
            "active_params": int(cfg.active_param_count()),
            "n_params_numel": int(n_numel),
            "global_batch": shape.global_batch,
            "seq_len": shape.seq_len,
            "tokens_per_step": shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1),
            "remat": cfg.remat,
            "n_micro": cfg.n_micro if shape.kind == "train" else None,
            "probe_layers": cfg.n_layers if probe is not None else None,
            "probe_seq": shape.seq_len if probe is not None else None,
            "probe_batch": shape.global_batch if probe is not None else None,
        }
        if m != "card":
            rec["collectives_note"] = _NO_COLLECTIVES
        records[m] = rec
    return records


def probe_suite(arch: str, shape_name: str):
    """The (depth, seq) probe grid for the roofline's fit (``roofline.py``).

    Train probes run the full global batch with n_micro=1 (microbatching
    only re-reads weights, added analytically in roofline.py)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, _ = shape_applicable(cfg, shape)
    if not ok:
        return []
    seqs = (4096, 8192, 16384) if shape.kind == "decode" else (1024, 2048, 4096)
    if cfg.family == "moe":
        la, lb = cfg.first_dense_layers + 1, cfg.first_dense_layers + 2
    else:
        la, lb = 1, 2  # hybrid: groups
    if cfg.family == "encdec":
        grid = []
        for s in seqs:
            grid += [
                {"n_layers": 1, "n_dec_layers": 1, "seq": s},
                {"n_layers": 2, "n_dec_layers": 1, "seq": s},
                {"n_layers": 1, "n_dec_layers": 2, "seq": s},
            ]
        return grid
    # Three sequence points so the per-layer fit can carry a constant term.
    return [{"n_layers": nl, "seq": s} for s in seqs for nl in (la, lb)]


def _error_record(arch, shape, mesh, e) -> Dict:
    return {"arch": arch, "shape": shape, "mesh": mesh, "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:]}


def _write(path: str, rec: Dict) -> None:
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=(*MESHES, "all"), default="card")
    ap.add_argument("--out", default=DEFAULT_DIR)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--micro", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the shape's global batch (a cell run on one card)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--probes", action="store_true",
                    help="count the probe grid instead of the production cells")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in SHAPES]
    else:
        archs = [args.arch] if args.arch else list(ARCH_NAMES)
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]
    meshes = MESHES if args.mesh == "all" else (args.mesh,)
    suffix = f"__{args.tag}" if args.tag else ""
    remat = False if args.no_remat else None
    os.makedirs(args.out, exist_ok=True)
    failures = 0

    if args.probes:
        for arch, shape in cells:
            for i, probe in enumerate(probe_suite(arch, shape)):
                tag = f"{arch}__{shape}__probe{i}{suffix}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    continue  # incremental
                try:
                    rec = run_cell(arch, shape, meshes=("card",), remat=remat, probe=probe)["card"]
                    print(f"[probe] ok {tag} L={probe.get('n_layers')} S={probe.get('seq')} "
                          f"count={rec['count_s']}s flops={rec['flops_per_device']:.4e}", flush=True)
                except Exception as e:  # noqa: BLE001 - record the failure and go on
                    failures += 1
                    rec = _error_record(arch, shape, "card", e)
                    rec["probe"] = probe
                    print(f"[probe] FAIL {tag}: {rec['error']}", flush=True)
                _write(path, rec)
        return 1 if failures else 0

    for arch, shape in cells:
        paths = {m: os.path.join(args.out, f"{arch}__{shape}__{m}{suffix}.json") for m in meshes}
        todo = tuple(m for m in meshes if not os.path.exists(paths[m]))
        if not todo:
            continue  # incremental sweep
        try:
            recs = run_cell(arch, shape, meshes=todo, remat=remat, micro=args.micro,
                            global_batch=args.batch)
        except Exception as e:  # noqa: BLE001 - record the failure and go on
            failures += 1
            recs = {m: _error_record(arch, shape, m, e) for m in todo}
            print(f"[dryrun] FAIL {arch}__{shape}: {recs[todo[0]]['error']}", flush=True)
        for m, rec in recs.items():
            if "error" not in rec:
                status = "SKIP" if rec.get("skipped") else "ok"
                print(f"[dryrun] {status:4s} {arch}__{shape}__{m}{suffix} "
                      f"count={rec.get('count_s', '-')}s "
                      f"flops/dev={rec.get('flops_per_device', '-')} "
                      f"peak/dev={rec.get('peak_bytes', '-')} fits={rec.get('fits_one_card', '-')}",
                      flush=True)
            _write(paths[m], rec)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
