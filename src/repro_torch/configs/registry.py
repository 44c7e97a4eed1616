"""Architecture registry + per-(arch, shape) input specs.

The port of ``repro/configs/registry.py``.  ``batch_specs`` and
``decode_specs`` return tensors on the ``meta`` device, the port's
stand-ins for the reference's ``jax.ShapeDtypeStruct``: shapes and dtypes
of every input of the step the shape's kind runs, nothing allocated.

  train    -> step(params, opt_state, batch{tokens, labels, ...})
  prefill  -> prefill(batch{tokens, ...})
  decode   -> decode_step(cache, token, cur_len)
"""
from __future__ import annotations

import importlib
from typing import Dict, Iterator, Tuple

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable

_ARCH_MODULES: Dict[str, str] = {
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1p3b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "yi-9b": "repro_torch.configs.yi_9b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(_ARCH_MODULES[name])
    return mod.CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    mod = importlib.import_module(_ARCH_MODULES[name])
    return mod.smoke()


def all_cells() -> Iterator[Tuple[str, str, bool, str]]:
    """Every assigned (arch, shape) cell with its applicability flag and
    reason."""
    for arch in ARCH_NAMES:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            yield arch, shape.name, ok, why


# ------------------------------------------------------------- input specs
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta tensors for the data batch of a train/prefill step: int32
    tokens (and labels to train); the enc-dec family's bf16 ``enc_embeds``
    over the source and ``seq // dec_ratio`` target tokens; the vlm's bf16
    patch ``embeds`` (``min(n_patches, seq // 4)`` of them) before the
    text tokens."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        sd = s // cfg.dec_ratio
        specs = {"enc_embeds": _meta((b, s, cfg.d_model), torch.bfloat16),
                 "tokens": _meta((b, sd), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _meta((b, sd), torch.int32)
        return specs
    if cfg.family == "vlm":
        p = min(cfg.n_patches, s // 4)
        st = s - p
        specs = {"embeds": _meta((b, p, cfg.d_model), torch.bfloat16),
                 "tokens": _meta((b, st), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _meta((b, st), torch.int32)
        return specs
    specs = {"tokens": _meta((b, s), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = _meta((b, s), torch.int32)
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, model) -> Dict:
    """Meta tensors for ``decode_step(cache, token, cur_len)``: the cache
    ``model.init_cache`` would make for ``global_batch`` slots of
    ``seq_len`` positions (the enc-dec family's cross k/v over
    ``max(seq // dec_ratio, 1024)`` source frames), an int32 token a slot
    and a scalar int32 length."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        shapes = model.cache_shapes(b, s, max(s // cfg.dec_ratio, 1024))
    else:
        shapes = model.cache_shapes(b, s)
    dtypes = model.cache_dtypes()
    return {
        "cache": {name: _meta(sh, dtypes[name]) for name, sh in shapes.items()},
        "token": _meta((b, 1), torch.int32),
        "cur_len": _meta((), torch.int32),
    }
