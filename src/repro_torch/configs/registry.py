"""Architecture registry: ``--arch`` names -> configs.

The port of ``repro/configs/registry.py``'s ``ARCH_NAMES``,
``get_config`` and ``get_smoke_config``.  The reference's dry-run helpers
(``all_cells``, ``batch_specs``, ``decode_specs``) build
``jax.ShapeDtypeStruct`` stand-ins for the TPU dry-run and wait for the
port's tooling slice.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

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
