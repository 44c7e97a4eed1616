"""The port's dry-run input specs against the reference's: ``all_cells``
(applicability and reasons), and ``batch_specs`` / ``decode_specs`` (meta
tensors) shape for shape and dtype for dtype against the reference's
``jax.ShapeDtypeStruct``s, for every applicable (arch x shape) cell."""
import numpy as np
import pytest
import torch

from repro.configs import all_cells as j_all_cells
from repro.configs import batch_specs as j_batch_specs
from repro.configs import decode_specs as j_decode_specs
from repro.configs import get_config as j_get_config
from repro.configs import SHAPES as J_SHAPES
from repro.models import build_model as j_build_model
from repro_torch.configs import SHAPES, all_cells, batch_specs, decode_specs, get_config
from repro_torch.models import build_model

CELLS = [(a, s) for a, s, ok, _ in all_cells() if ok]


def _dtype(d) -> str:
    return str(np.dtype(d)) if not isinstance(d, torch.dtype) else str(d).replace("torch.", "")


def _flat(tree, prefix=""):
    """{name: leaf}, nested names joined with a dot (the hybrid's ssm.h)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_all_cells_equal_the_reference():
    assert list(all_cells()) == list(j_all_cells())
    assert len(list(all_cells())) == 40
    assert len(CELLS) == 33
    long = sorted(a for a, s in CELLS if s == "long_500k")
    assert long == ["gemma3-1b", "mamba2-1.3b", "zamba2-2.7b"]


@pytest.mark.parametrize("arch,shape", [c for c in CELLS if SHAPES[c[1]].kind != "decode"])
def test_batch_specs_equal_the_reference(arch, shape):
    got = batch_specs(get_config(arch), SHAPES[shape])
    want = j_batch_specs(j_get_config(arch), J_SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert _dtype(got[k].dtype) == _dtype(w.dtype), k


@pytest.mark.parametrize("arch,shape", [c for c in CELLS if SHAPES[c[1]].kind == "decode"])
def test_decode_specs_equal_the_reference(arch, shape):
    cfg = get_config(arch)
    got = decode_specs(cfg, SHAPES[shape], build_model(cfg, "meta"))
    jcfg = j_get_config(arch)
    want = j_decode_specs(jcfg, J_SHAPES[shape], j_build_model(jcfg))
    assert tuple(got["token"].shape) == want["token"].shape
    assert _dtype(got["token"].dtype) == _dtype(want["token"].dtype) == "int32"
    assert tuple(got["cur_len"].shape) == want["cur_len"].shape == ()
    gc, wc = got["cache"], _flat(want["cache"])
    assert sorted(gc) == sorted(wc)
    for k, w in wc.items():
        assert gc[k].device.type == "meta"
        assert tuple(gc[k].shape) == tuple(w.shape), k
        assert _dtype(gc[k].dtype) == _dtype(w.dtype), k
