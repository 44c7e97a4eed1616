"""Roofline analysis from the port's dry-run records, at one H100's peaks.

The port of ``repro/launch/roofline.py``.  Per (arch x shape) cell on one
mesh (``card``, ``pod`` or ``multipod``), it reads

* the PRODUCTION record (``launch/dryrun.py``): the step counted on the
  ``meta`` device at full depth: FLOPs, the bytes its ops read and write,
  argument and peak bytes per device;
* the PROBE records, where they exist: the same step at two depths x three
  sequence lengths (enc-dec: three depth combinations), from which

      f(L, S) = base(S) + L * layer(S)
      base(S)  = delta + gamma * S          (embed/unembed/loss/optimizer)
      layer(S) = w + alpha * S + beta * S**2

  is fitted and evaluated at the production (L, S), as the reference does
  (XLA costs a while body once, so the reference needs them; the port's
  count is exact at full depth, and the probes stand in for a full-depth
  count that would take too long).  Train probes run the full global batch
  with n_micro=1; the microbatch loop's extra weight re-reads are added to
  the bytes term analytically.

Terms, per device, each over the peak it names (``launch/mesh.py``: one
H100 SXM at 700 W): compute = FLOPs / ``PEAK_FLOPS_BF16`` (the LM zoo
computes in bf16; ``dryrun_bcpnn`` divides its f32 products by
``PEAK_FLOPS_F32``), memory = analytic HBM bytes / ``HBM_BW``,
collective = collective wire bytes / ``NVLINK_BW``.  A record whose
collectives are None (the LM meshes: the port's models issue none, so
there is nothing to count) gets no collective term.  Every number here is
a count from ``meta`` divided by a published peak: a bound, never a
measurement.

    python -m repro_torch.launch.roofline [--dir D] [--mesh card|pod|multipod] [--out F]
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import itertools
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

METRICS = ("flops_per_device", "bytes_per_device", "coll_total")
DEFAULT_DIR = "experiments/dryrun_torch"

# Per-device wire bytes per RESULT byte (ring algorithms; 16-way axes):
# all-reduce moves 2x the tensor; reduce-scatter receives (n-1)x its (1/n)
# result; gather/all-to-all/permute receive ~1x their result.
WIRE_WEIGHT = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 15.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

PEAK_NAMES = {"compute": "PEAK_FLOPS_BF16", "memory": "HBM_BW", "collective": "NVLINK_BW"}


def _metric(rec: Dict, name: str) -> Optional[float]:
    """One record's metric; ``coll_total`` is its wire bytes (None when
    the record has no collective count)."""
    if name == "coll_total":
        coll = rec.get("collectives", {})
        if coll is None:
            return None
        return float(sum(coll.get(op, 0.0) * w for op, w in WIRE_WEIGHT.items()))
    return float(rec.get(name) or 0.0)


def _nonneg_basis_fit(ss, vs, basis) -> List[float]:
    """Least-squares fit of vs(ss) over the basis functions with every
    coefficient nonnegative: tries every basis subset, keeps the feasible
    solution with the smallest residual."""
    ss = np.asarray(ss, np.float64)
    vs = np.maximum(np.asarray(vs, np.float64), 0.0)
    best, best_res = None, None
    nb = len(basis)
    for r in range(nb, 0, -1):
        for subset in itertools.combinations(range(nb), r):
            a = np.stack([basis[i](ss) for i in subset], axis=1)
            coef, *_ = np.linalg.lstsq(a, vs, rcond=None)
            if (coef < -1e-12).any():
                continue
            res = float(np.sum((a @ coef - vs) ** 2))
            if best_res is None or res < best_res - 1e-9:
                full = [0.0] * nb
                for i, c in zip(subset, coef):
                    full[i] = max(float(c), 0.0)
                best, best_res = full, res
        if best is not None and best_res <= 1e-12 * float(np.sum(vs**2) + 1.0):
            break
    return best if best is not None else [0.0] * nb


def _fit_linear(ss, vs) -> Tuple[float, float]:
    """base(S) = delta + gamma*S (nonneg least squares over >=2 points)."""
    c = _nonneg_basis_fit(ss, vs, [lambda s: s * 0 + 1.0, lambda s: s])
    return c[0], c[1]


def _fit_layer(ss, ls) -> Tuple[float, float, float]:
    """layer(S) = w + alpha*S + beta*S^2 (nonneg LS; w is the per-layer
    cost that does not grow with S)."""
    c = _nonneg_basis_fit(ss, ls, [lambda s: s * 0 + 1.0, lambda s: s, lambda s: s * s])
    return c[0], c[1], c[2]


def extrapolate(probes: List[Dict], cfg, shape, metric: str) -> Optional[float]:
    """Fit f(L, S) from probes and evaluate at the production (L, S)."""
    if not probes or any("error" in p for p in probes):
        return None
    if any(_metric(p, metric) is None for p in probes):
        return None
    if cfg.family == "encdec":
        return _extrapolate_encdec(probes, cfg, shape, metric)
    by = {}
    for p in probes:
        by[(p["probe"]["n_layers"], p["probe"]["seq"])] = _metric(p, metric)
    depths = sorted({k[0] for k in by})
    seqs = sorted({k[1] for k in by if (depths[0], k[1]) in by and (depths[-1], k[1]) in by})
    if len(depths) < 2 or len(seqs) < 2:
        return None
    la, lb = depths[0], depths[1]
    lays = [max((by[(lb, s)] - by[(la, s)]) / (lb - la), 0.0) for s in seqs]
    bases = [max(by[(la, s)] - la * lay, 0.0) for s, lay in zip(seqs, lays)]
    delta, gamma = _fit_linear(seqs, bases)
    w, alpha, beta = _fit_layer(seqs, lays)

    s_real = shape.seq_len
    l_real = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers
    return delta + gamma * s_real + l_real * (w + alpha * s_real + beta * s_real**2)


def _extrapolate_encdec(probes, cfg, shape, metric):
    by = {}
    for p in probes:
        key = (p["probe"]["n_layers"], p["probe"]["n_dec_layers"], p["probe"]["seq"])
        by[key] = _metric(p, metric)
    seqs = sorted({k[2] for k in by})
    if len(seqs) < 2:
        return None
    encs, decs, bases = [], [], []
    for s in seqs:
        f11, f21, f12 = by[(1, 1, s)], by[(2, 1, s)], by[(1, 2, s)]
        enc = max(f21 - f11, 0.0)
        dec = max(f12 - f11, 0.0)
        encs.append(enc)
        decs.append(dec)
        bases.append(max(f11 - enc - dec, 0.0))
    delta, gamma = _fit_linear(seqs, bases)
    we, ae, be = _fit_layer(seqs, encs)
    wd, ad, bd = _fit_layer(seqs, decs)
    s_real = shape.seq_len
    return (
        delta + gamma * s_real
        + cfg.n_layers * (we + ae * s_real + be * s_real**2)
        + cfg.n_dec_layers * (wd + ad * s_real + bd * s_real**2)
    )


def analytic_hbm_bytes(cfg, shape, chips: int, n_micro: int, arg_bytes, tp: int) -> float:
    """First-order per-device HBM traffic model, on a mesh of ``chips``
    devices whose model (tensor-parallel) axis is ``tp`` wide.

      train:   n_micro x bf16 weight reads (TP-sharded) + f32 optimizer
               states/params r/w + remat-era activation traffic
               (~64 B/token/layer/d_model: ~16 bf16 tensors written+read,
               x2 for the recompute pass)
      prefill: one weight read + fwd activation traffic (~32 B/token/layer/d)
      decode:  every argument byte (params shard + cache shard) read once,
               the canonical decode bound.

    At ``chips=256, tp=16`` it is the reference's model."""
    n = cfg.param_count()
    d = cfg.d_model
    layers = cfg.n_layers + (cfg.n_dec_layers if cfg.family == "encdec" else 0)
    if shape.kind == "decode":
        return float(arg_bytes or 2.0 * n / chips)
    tokens_local = shape.global_batch * shape.seq_len / chips
    if shape.kind == "train":
        w = n_micro * 2.0 * n / tp
        opt = 16.0 * n / chips
        act = tokens_local * d * layers * 64.0
        return w + opt + act
    return 2.0 * n / tp + tokens_local * d * layers * 32.0


def record_path(dryrun_dir: str, arch: str, shape_name: str, mesh: str, tag: str = "") -> str:
    suffix = f"__{tag}" if tag else ""
    return os.path.join(dryrun_dir, f"{arch}__{shape_name}__{mesh}{suffix}.json")


def _probes(dryrun_dir: str, arch: str, shape_name: str, tag: str) -> List[Dict]:
    suffix = f"__{tag}" if tag else ""
    pat = re.compile(re.escape(f"{arch}__{shape_name}__probe") + r"\d+" + re.escape(suffix)
                     + r"\.json$")
    out = []
    for p in sorted(glob.glob(os.path.join(dryrun_dir, f"{arch}__{shape_name}__probe*.json"))):
        if pat.search(os.path.basename(p)):  # not another tag's probe set
            with open(p) as f:
                out.append(json.load(f))
    return out


def _model_width(prod: Dict) -> int:
    """The model (tensor-parallel) axis' width of a record's mesh: the
    port's ``mesh_shape``, or the reference's ``mesh`` list (its last axis
    is ``model``)."""
    if prod.get("mesh_shape"):
        return int(prod["mesh_shape"].get("model", 1))
    if isinstance(prod.get("mesh"), list) and prod["mesh"]:
        return int(prod["mesh"][-1])
    return 1


def terms(rec: Dict, peak_flops: float = PEAK_FLOPS_BF16) -> Dict:
    """The three terms of a record holding ``flops_per_device``,
    ``analytic_hbm_bytes`` and ``coll_bytes_per_device`` (None: no term),
    the dominant one and ``bound_step_s``, the no-overlap lower bound."""
    out = {}
    if rec.get("flops_per_device") is not None:
        out["compute_term_s"] = rec["flops_per_device"] / peak_flops
    out["memory_term_s"] = rec["analytic_hbm_bytes"] / HBM_BW
    coll = rec.get("coll_bytes_per_device")
    out["collective_term_s"] = None if coll is None else coll / NVLINK_BW
    present = {k: v for k, v in out.items() if v is not None}
    dom = max(present, key=present.get)
    out["dominant"] = dom.replace("_term_s", "")
    out["bound_step_s"] = present[dom]
    return out


def analyze_cell(dryrun_dir: str, arch: str, shape_name: str, tag: str = "",
                 mesh: str = "card") -> Optional[Dict]:
    """The roofline record of one cell on ``mesh`` (None when the dry run
    wrote none).  FLOPs and bytes come from the probes' fit where the
    probes exist, else from the full-depth count."""
    prod_path = record_path(dryrun_dir, arch, shape_name, mesh, tag)
    if not os.path.exists(prod_path):
        return None
    with open(prod_path) as f:
        prod = json.load(f)
    if prod.get("skipped"):
        return {"arch": arch, "shape": shape_name, "skipped": prod["skipped"]}
    if "error" in prod:
        return {"arch": arch, "shape": shape_name, "error": prod["error"]}

    probes = _probes(dryrun_dir, arch, shape_name, tag)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if prod.get("global_batch") and not probes:  # a cell cut in batch (dryrun --batch)
        shape = dataclasses.replace(shape, global_batch=prod["global_batch"])
    chips = prod.get("chips", 1)
    tp = _model_width(prod)

    if probes:
        # Probes count per device on their own mesh: rescale to this one.
        scale = [p.get("chips", chips) / chips for p in probes]
        scaled = [{**p, "flops_per_device": (p.get("flops_per_device") or 0.0) * s,
                   "bytes_per_device": (p.get("bytes_per_device") or 0.0) * s}
                  for p, s in zip(probes, scale)]
        flops = extrapolate(scaled, cfg, shape, "flops_per_device")
        bytes_ = extrapolate(scaled, cfg, shape, "bytes_per_device")
        coll = extrapolate(probes, cfg, shape, "coll_total")
    else:
        flops = prod.get("flops_per_device")
        bytes_ = prod.get("bytes_per_device")
        coll = _metric(prod, "coll_total")
    if prod.get("collectives", {}) is None:
        coll = None

    # Microbatch weight re-reads (train): the probes ran n_micro=1.
    n_micro = prod.get("n_micro") or 1
    if probes and shape.kind == "train" and bytes_ is not None and n_micro > 1:
        bytes_ += (n_micro - 1) * 2.0 * cfg.param_count() / chips

    rec = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": mesh,
        "chips": chips,
        "count_s": prod.get("count_s"),
        "flops_per_device": flops,
        "bytes_per_device": bytes_,
        "coll_bytes_per_device": coll,
        "collectives_note": prod.get("collectives_note"),
        "raw_prod_flops_per_device": prod.get("flops_per_device"),
        "temp_bytes": prod.get("temp_size_in_bytes"),
        "arg_bytes": prod.get("argument_size_in_bytes"),
        "peak_bytes": prod.get("peak_bytes"),
        "fits_one_card": prod.get("fits_one_card"),
        "n_params_numel": prod.get("n_params_numel"),
        "n_probes": len(probes),
        "probe_errors": sum(1 for p in probes if "error" in p),
        "peaks": dict(PEAK_NAMES),
    }
    rec["analytic_hbm_bytes"] = analytic_hbm_bytes(cfg, shape, chips, n_micro,
                                                   rec.get("arg_bytes"), tp)
    if bytes_ is not None:
        rec["memory_hlo_upper_s"] = bytes_ / HBM_BW
    rec.update(terms(rec))
    step_time = rec["bound_step_s"]
    # MODEL_FLOPS = 6 * N(_active) * tokens (train), 2 * N * tokens (inference);
    # N is cfg.param_count(), the reference's (it leaves out the enc-dec
    # family's unembed: n_params_numel stands beside it).
    n = cfg.active_param_count() if cfg.n_experts else cfg.param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    factor = 6.0 if shape.kind == "train" else 2.0
    rec["model_flops"] = factor * n * tokens
    if flops:
        rec["useful_flop_ratio"] = rec["model_flops"] / (flops * chips)
    if shape.kind == "decode":
        # Decode is bandwidth-bound by construction: how close the step is
        # to the read-everything-once bound.
        rec["roofline_fraction"] = rec["memory_term_s"] / step_time if step_time else None
    else:
        model_compute_s = rec["model_flops"] / (chips * PEAK_FLOPS_BF16)
        rec["roofline_fraction"] = model_compute_s / step_time if step_time else None
    return rec


def _s(v) -> str:
    return "—" if v is None else f"{v:.4f}"


def markdown_table(records: List[Dict]) -> str:
    hdr = (
        "| arch | shape | compute s | memory s | collective s | dominant | "
        "MODEL_FLOPS | useful ratio | roofline frac |\n"
        "|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for r in records:
        if r.get("skipped"):
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | skipped | — | — | — |")
            continue
        if r.get("error") or r.get("compute_term_s") is None:
            rows.append(f"| {r['arch']} | {r['shape']} | ? | ? | ? | error | ? | ? | ? |")
            continue
        rows.append(
            "| {arch} | {shape} | {c:.4f} | {m:.4f} | {k} | {dom} | "
            "{mf:.3e} | {ur:.3f} | {rf:.3f} |".format(
                arch=r["arch"], shape=r["shape"],
                c=r["compute_term_s"], m=r["memory_term_s"],
                k=_s(r["collective_term_s"]), dom=r["dominant"],
                mf=r["model_flops"], ur=r.get("useful_flop_ratio") or -1,
                rf=r.get("roofline_fraction") or -1,
            )
        )
    return hdr + "\n".join(rows) + "\n"


def main(argv=None) -> int:
    from repro_torch.configs.registry import ARCH_NAMES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--out", default=None, help="JSON of the records (default: DIR/roofline_MESH.json)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", choices=("card", "pod", "multipod"), default="card")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    args = ap.parse_args(argv)

    records = []
    archs = [args.arch] if args.arch else list(ARCH_NAMES)
    shapes = [args.shape] if args.shape else list(SHAPES)
    for arch in archs:
        for shape in shapes:
            rec = analyze_cell(args.dir, arch, shape, tag=args.tag, mesh=args.mesh)
            if rec is not None:
                records.append(rec)
    out = args.out or os.path.join(args.dir, f"roofline_{args.mesh}.json")
    with open(out, "w") as f:
        json.dump(records, f, indent=2)
    print(markdown_table(records))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
