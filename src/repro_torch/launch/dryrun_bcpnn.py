"""Pod-scale dry run of the paper's technique: one rank of ``bcpnn_xl``.

The port of ``repro/launch/dryrun_bcpnn.py``.  A BCPNN layer two orders of
magnitude beyond the paper's largest run (STL-10: 3000 hidden units):

  bcpnn_xl: N_F = 55,296 input units (complementary-coded 96x96x3),
            hidden = 512 HCUs x 256 MCUs = 131,072 units (dense receptive
            fields: fan_in = every input HCU), gain 4, init jitter 1,
            C_ij = 7.25e9 marginals (29 GB f32), global batch 16,384.

It runs on the production mesh of a ``fake`` process group in one process
(``launch.mesh.fake_world``) through the port's ``DataParallelTrainer(mesh,
"shard_map")``, the paper's MPI backend with hidden-axis model
parallelism: rank 0's hidden step runs on ``meta`` tensors of its shard
with ``use_kernels=False`` (the kernels' plain versions, which run on
``meta``; the kernels themselves refuse it), and ``dryrun.count_step``
counts it.  A pod rank holds 1,024 rows and 32 x 256 = 8,192 hidden units
(a 55,296 x 8,192 shard of C_ij and w); a multipod rank 512 rows.  Its
one collective all-reduces the packed means, F x H + F + H floats a rank.

The rewire (every N_HCU batches, a small program of its own) is outside
the step counted, as the paper treats it.  The terms are per device at one
H100 SXM's peaks (``launch/mesh.py``): compute at ``PEAK_FLOPS_F32`` (the
products are f32; the port keeps TF32 off), memory at ``HBM_BW`` over the
bytes the step's operations read and write, collective at ``NVLINK_BW``
over the all-reduce's ring wire bytes.  An axis of 16 or 32 cards spans
more than one host, whose links are slower than NVLink: the collective
term is the NVLink floor, not a prediction for such a mesh.  Counts from
``meta``, not measurements.

    python -m repro_torch.launch.dryrun_bcpnn [--mesh pod|multipod|both] [--out D]

Writes ``D/bcpnn_xl__train__{pod,multipod}.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from repro_torch.core import StructuralPlasticityLayer, UnitLayout
from repro_torch.core.distributed import DataParallelTrainer
from repro_torch.core.layers import LayerState
from repro_torch.core.learning import MarginalState
from repro_torch.core.plasticity import PlasticityState
from repro_torch.launch.dryrun import count_step
from repro_torch.launch.mesh import (
    PEAK_FLOPS_F32,
    fake_world,
    make_production_mesh,
    production_shape,
)
from repro_torch.launch.roofline import DEFAULT_DIR, WIRE_WEIGHT, terms

XL = dict(n_f=55296, n_hcu=512, n_mcu=256, batch=16384, lam=0.01)


def xl_layer(n_f: int, n_hcu: int, n_mcu: int, lam: float = 0.01, fan_in=None,
             use_kernels=None) -> StructuralPlasticityLayer:
    """The ``bcpnn_xl`` layer (or one of its shards' shape, with the
    rank's ``n_hcu``): complementary-coded inputs, dense receptive fields
    unless ``fan_in`` says otherwise."""
    pre = UnitLayout(n_f // 2, 2)
    return StructuralPlasticityLayer(
        pre, UnitLayout(n_hcu, n_mcu), fan_in=fan_in or pre.n_hcu, lam=lam, init_jitter=1.0,
        gain=4.0, use_kernels=use_kernels)


def meta_state(spec) -> LayerState:
    """A layer state of ``spec``'s shapes on ``meta``, nothing drawn."""
    f, h = spec.n_pre, spec.n_post

    def t(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    return LayerState(
        marginals=MarginalState(t(f), t(h), t(f, h)), w=t(f, h), b=t(h),
        plast=PlasticityState(t(spec.pre.n_hcu, spec.post.n_hcu)),
        step=torch.empty((), dtype=torch.int32, device="meta"), host_step=1)


def run(multi_pod: bool, out_dir: str = DEFAULT_DIR, n_f=XL["n_f"], n_hcu=XL["n_hcu"],
        n_mcu=XL["n_mcu"], batch=XL["batch"], lam=XL["lam"], fan_in=None, write: bool = True):
    """Count rank 0's hidden step on the production mesh; returns the
    record (and writes it when ``write``)."""
    shape = production_shape(multi_pod)
    chips = 1
    for v in shape.values():
        chips *= v
    layer = xl_layer(n_f, n_hcu, n_mcu, lam, fan_in, use_kernels=False)
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        tr = DataParallelTrainer(mesh, mode="shard_map")
        step = tr.hidden_step(layer)
        local = tr.local_layer(layer)
        rows = tr.rows(batch)
        state = meta_state(local.spec)
        x = torch.empty((rows.stop - rows.start, n_f), dtype=torch.float32, device="meta")
        counted = count_step(step, state, x)
    n_h = n_hcu * n_mcu
    model_flops = 2.0 * batch * n_f * n_h * 2  # forward GEMM + the means' GEMM, global
    coll = counted["collectives"]
    wire = sum(coll.get(op, 0.0) * w for op, w in WIRE_WEIGHT.items())
    arg_bytes = sum(t.numel() * t.element_size()
                    for t in (*state.marginals, state.w, state.b, state.plast.hcu_mask, x))
    rec = {
        "arch": "bcpnn_xl",
        "shape": f"train_b{batch}",
        "kind": "train",
        "mesh": "multipod" if multi_pod else "pod",
        "mesh_shape": shape,
        "chips": chips,
        "device": "meta",
        "count_s": round(counted["count_s"], 3),
        "rank_rows": rows.stop - rows.start,
        "rank_hidden_units": local.spec.n_post,
        "flops_per_device": float(counted["flops"]),
        "bytes_per_device": float(counted["bytes_accessed"]),
        "argument_size_in_bytes": arg_bytes,
        "temp_size_in_bytes": counted["temp_bytes"],
        "peak_bytes": arg_bytes + counted["temp_bytes"],
        "collectives": coll,
        "allreduce_bytes_per_rank": coll.get("all-reduce", 0.0),
        "model_flops": model_flops,
        "n_f": n_f,
        "n_hidden": n_h,
        "cij_gb": n_f * n_h * 4 / 1e9,
        "peaks": {"compute": "PEAK_FLOPS_F32", "memory": "HBM_BW", "collective": "NVLINK_BW"},
    }
    # No layer loop: the memory term takes the counted bytes themselves.
    rec.update(analytic_hbm_bytes=rec["bytes_per_device"], coll_bytes_per_device=wire)
    rec.update(terms(rec, PEAK_FLOPS_F32))
    rec["useful_flop_ratio"] = model_flops / (rec["flops_per_device"] * chips)
    if write:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"bcpnn_xl__train__{rec['mesh']}.json"), "w") as f:
            json.dump(rec, f, indent=2)
    print(
        f"[bcpnn-dryrun] {rec['mesh']} rows={rec['rank_rows']} units={rec['rank_hidden_units']} "
        f"flops/dev={rec['flops_per_device']:.4e} allreduce={rec['allreduce_bytes_per_rank']:.4e} B "
        f"compute={rec['compute_term_s']:.5f}s mem={rec['memory_term_s']:.5f}s "
        f"coll={rec['collective_term_s']:.5f}s useful={rec['useful_flop_ratio']:.3f}",
        flush=True,
    )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"), default="both")
    ap.add_argument("--out", default=DEFAULT_DIR)
    ap.add_argument("--batch", type=int, default=XL["batch"])
    args = ap.parse_args(argv)
    for mp in {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]:
        run(mp, args.out, batch=args.batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
