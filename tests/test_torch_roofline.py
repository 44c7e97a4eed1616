"""The port's roofline against the reference's: the probe fit and its
extrapolation on synthetic probes, the analytic HBM model at the
reference's mesh (256 chips, tensor parallel 16) for every applicable
cell, ``analyze_cell`` on the same record files, the markdown table and
the probe grid.  The port divides by one H100 SXM's peaks where the
reference divides by a TPU v5e's, so the terms are compared through the
ratio of the constants."""
import json
import os

import jax  # noqa: F401  (initialise the backend before the reference's dry-run module loads)
import numpy as np
import pytest

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import mesh as j_mesh
from repro.launch import roofline as jroof
from repro_torch.configs import SHAPES, all_cells, get_config
from repro_torch.launch import mesh as mesh
from repro_torch.launch import roofline as roof

CELLS = [(a, s) for a, s, ok, _ in all_cells() if ok]
SYNTH_ARCHS = ("yi-9b", "deepseek-v2-236b", "zamba2-2.7b", "seamless-m4t-large-v2")


@pytest.fixture(scope="module")
def j_dryrun():
    """The reference's dry-run module, imported without letting its
    ``XLA_FLAGS`` line reach later tests of this process."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return dryrun


def _f(nl, s):
    return 7e9 + 3e6 * s + nl * (5e8 + 1e6 * s + 40.0 * s * s)


def _synthetic(arch, shape_name, f=_f, coll=True):
    cfg = get_config(arch)
    grid = []
    for s in ((4096, 8192, 16384) if SHAPES[shape_name].kind == "decode" else (1024, 2048, 4096)):
        if cfg.family == "encdec":
            for e, d in ((1, 1), (2, 1), (1, 2)):
                grid.append({"probe": {"n_layers": e, "n_dec_layers": d, "seq": s},
                             "flops_per_device": f(e, s) + 2e8 * d * s,
                             "bytes_per_device": 3 * f(e, s),
                             "collectives": {"all-reduce": 1e6 * s * (e + d)} if coll else {}})
        else:
            for nl in (1, 2):
                grid.append({"probe": {"n_layers": nl, "seq": s},
                             "flops_per_device": f(nl, s), "bytes_per_device": 3 * f(nl, s),
                             "collectives": {"all-reduce": 1e6 * s * nl,
                                             "all-gather": 5e5 * nl} if coll else {}})
    return grid


def test_constants_are_the_h100s():
    assert roof.WIRE_WEIGHT == jroof.WIRE_WEIGHT
    assert mesh.PEAK_FLOPS_BF16 == 989e12 and mesh.PEAK_FLOPS_F32 == 67e12
    assert mesh.HBM_BW == 3.35e12 and mesh.HBM_BYTES == 80e9 and mesh.NVLINK_BW == 450e9


@pytest.mark.parametrize("basis_n", [2, 3])
def test_nonneg_basis_fit_equals_the_reference(basis_n):
    rng = np.random.default_rng(0)
    basis = [lambda s: s * 0 + 1.0, lambda s: s, lambda s: s * s][:basis_n]
    for _ in range(20):
        ss = np.array([1024.0, 2048.0, 4096.0])
        vs = rng.normal(size=3) * 1e9 + rng.uniform(0, 1e10)
        np.testing.assert_array_equal(roof._nonneg_basis_fit(ss, vs, basis),
                                      jroof._nonneg_basis_fit(ss, vs, basis))


@pytest.mark.parametrize("metric", roof.METRICS)
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", SYNTH_ARCHS)
def test_extrapolate_equals_the_reference(arch, shape, metric):
    probes = _synthetic(arch, shape)
    got = roof.extrapolate(probes, get_config(arch), SHAPES[shape], metric)
    want = jroof.extrapolate(probes, j_get_config(arch), J_SHAPES[shape], metric)
    assert got == pytest.approx(want, rel=1e-12)


def test_the_fit_recovers_synthetic_costs():
    """Exact recovery of f(L,S) = 7e9 + 3e6*S + L*(5e8 + 1e6*S + 40*S^2)."""
    cfg = get_config("yi-9b")
    got = roof.extrapolate(_synthetic("yi-9b", "train_4k"), cfg, SHAPES["train_4k"],
                           "flops_per_device")
    np.testing.assert_allclose(got, _f(cfg.n_layers, 4096), rtol=1e-6)


def test_no_collective_count_gives_no_term():
    probes = _synthetic("yi-9b", "train_4k")
    for p in probes:
        p["collectives"] = None
    assert roof.extrapolate(probes, get_config("yi-9b"), SHAPES["train_4k"], "coll_total") is None


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_hbm_bytes_at_the_reference_mesh(arch, shape):
    arg = 1.234e10 if SHAPES[shape].kind == "decode" else None
    for n_micro in (1, 8):
        got = roof.analytic_hbm_bytes(get_config(arch), SHAPES[shape], 256, n_micro, arg, tp=16)
        want = jroof.analytic_hbm_bytes(j_get_config(arch), J_SHAPES[shape], 256, n_micro, arg)
        assert got == want


def _write(d, name, rec):
    with open(os.path.join(d, name), "w") as f:
        json.dump(rec, f)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", SYNTH_ARCHS)
def test_analyze_cell_reads_the_reference_records(tmp_path, arch, shape):
    """The same pod record and probes through both: every count equal, the
    terms apart by the ratio of the two cards' peaks."""
    d = str(tmp_path)
    _write(d, f"{arch}__{shape}__pod.json", {
        "arch": arch, "shape": shape, "mesh": [16, 16], "chips": 256, "compile_s": 1.0,
        "flops_per_device": 1.0, "temp_size_in_bytes": 7, "argument_size_in_bytes": 3.3e9,
        "n_micro": 8 if SHAPES[shape].kind == "train" else None})
    for i, p in enumerate(_synthetic(arch, shape)):
        _write(d, f"{arch}__{shape}__probe{i}.json", p)
    got = roof.analyze_cell(d, arch, shape, mesh="pod")
    want = jroof.analyze_cell(d, arch, shape)
    for k in ("flops_per_device", "bytes_per_device", "coll_bytes_per_device",
              "analytic_hbm_bytes", "model_flops", "useful_flop_ratio", "n_probes"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert got["compute_term_s"] == pytest.approx(
        want["compute_term_s"] * j_mesh.PEAK_FLOPS_BF16 / mesh.PEAK_FLOPS_BF16, rel=1e-12)
    assert got["memory_term_s"] == pytest.approx(
        want["memory_term_s"] * j_mesh.HBM_BW / mesh.HBM_BW, rel=1e-12)
    assert got["collective_term_s"] == pytest.approx(
        want["collective_term_s"] * j_mesh.ICI_BW / mesh.NVLINK_BW, rel=1e-12)
    terms = {k: got[k] for k in ("compute_term_s", "memory_term_s", "collective_term_s")}
    assert got["bound_step_s"] == max(terms.values())
    assert got["dominant"] == max(terms, key=terms.get).replace("_term_s", "")


def test_analyze_cell_without_probes_takes_the_count(tmp_path):
    d = str(tmp_path)
    rec = {"arch": "gemma3-1b", "shape": "long_500k", "mesh": "card",
           "mesh_shape": {"data": 1, "model": 1}, "chips": 1, "flops_per_device": 5.0e10,
           "bytes_per_device": 9.0e10, "argument_size_in_bytes": 1.6e10, "collectives": {},
           "peak_bytes": 3.2e10, "fits_one_card": True}
    _write(d, "gemma3-1b__long_500k__card.json", rec)
    got = roof.analyze_cell(d, "gemma3-1b", "long_500k")
    assert got["flops_per_device"] == 5.0e10
    assert got["compute_term_s"] == 5.0e10 / mesh.PEAK_FLOPS_BF16
    assert got["memory_term_s"] == 1.6e10 / mesh.HBM_BW  # decode: every argument byte once
    assert got["collective_term_s"] == 0.0
    assert got["dominant"] == "memory" and got["bound_step_s"] == got["memory_term_s"]
    assert got["roofline_fraction"] == 1.0
    rec.update(mesh="pod", mesh_shape={"data": 16, "model": 16}, chips=256, collectives=None)
    _write(d, "gemma3-1b__long_500k__pod.json", rec)
    pod = roof.analyze_cell(d, "gemma3-1b", "long_500k", mesh="pod")
    assert pod["collective_term_s"] is None and pod["dominant"] == "memory"
    assert "—" in roof.markdown_table([pod])


def test_markdown_table_equals_the_reference():
    recs = [
        {"arch": "a", "shape": "s", "skipped": "why"},
        {"arch": "b", "shape": "s", "error": "boom"},
        {"arch": "c", "shape": "s", "compute_term_s": 0.5, "memory_term_s": 0.25,
         "collective_term_s": 0.125, "dominant": "compute", "model_flops": 1.5e15,
         "useful_flop_ratio": 0.75, "roofline_fraction": 0.6},
        {"arch": "d", "shape": "s", "compute_term_s": 0.01, "memory_term_s": 0.02,
         "collective_term_s": 0.0, "dominant": "memory", "model_flops": 3e9,
         "useful_flop_ratio": None, "roofline_fraction": 1.0},
    ]
    assert roof.markdown_table(recs) == jroof.markdown_table(recs)


@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _, _ in all_cells()])
def test_probe_suite_equals_the_reference(j_dryrun, arch, shape):
    from repro_torch.launch.dryrun import probe_suite

    assert probe_suite(arch, shape) == j_dryrun.probe_suite(arch, shape)
