"""Carry network weights across between the two packages as flat arrays.

The keys are those of the reference's whole-network checkpoint
(``arrays.npz`` as ``repro/checkpoint/store.py:path_key`` writes it):

    layers/<i>/marginals/{ci,cj,cij}   layers/<i>/{w,b,step}
    layers/<i>/plast/hcu_mask          (hidden layers only)
    readout/{w,b}                      (the SGD readout head, when present)

so a state trained by either package, or read from such a checkpoint,
loads into the other.  Arrays keep their dtype: bf16 traces of the
quantized state tier (``ml_dtypes.bfloat16`` arrays on the reference's
side, viewed through their bits here) stay bf16.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.network import readout_head
from repro_torch.checkpoint.store import decode_array
from repro_torch.core.compiled import NetworkState
from repro_torch.core.layers import LayerState, StructuralPlasticityLayer
from repro_torch.core.learning import MarginalState
from repro_torch.core.plasticity import PlasticityState


def network_state_from_flat(
    flat: Dict[str, np.ndarray], layers: Sequence, device="cpu"
) -> NetworkState:
    """A NetworkState for ``layers`` on ``device`` from flat arrays, the
    SGD readout head included when ``readout/w`` and ``readout/b`` are
    there.  Continual-learning adapters (``adapters/<tenant>/...``) are not
    part of the network's state and are left for ``load_adapters``."""

    def get(key: str, shape) -> torch.Tensor:
        if key not in flat:
            raise KeyError(f"missing array {key!r}")
        t = decode_array(np.asarray(flat[key]))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != expected {tuple(shape)}")
        return t.to(device)

    states = []
    for i, layer in enumerate(layers):
        spec, p = layer.spec, f"layers/{i}/"
        step = int(np.asarray(flat[p + "step"]))
        mask_key = p + "plast/hcu_mask"
        states.append(LayerState(
            marginals=MarginalState(
                ci=get(p + "marginals/ci", (spec.n_pre,)),
                cj=get(p + "marginals/cj", (spec.n_post,)),
                cij=get(p + "marginals/cij", (spec.n_pre, spec.n_post)),
            ),
            w=get(p + "w", (spec.n_pre, spec.n_post)),
            b=get(p + "b", (spec.n_post,)),
            plast=(
                PlasticityState(get(mask_key, (spec.pre.n_hcu, spec.post.n_hcu)))
                if mask_key in flat else None
            ),
            step=torch.tensor(step, dtype=torch.int32, device=device),
            host_step=step,
        ))
    readout = None
    if any(k.startswith("readout/") for k in flat):
        hidden = [la for la in layers if isinstance(la, StructuralPlasticityLayer)]
        readout = readout_head(
            {k.split("/", 1)[1]: decode_array(np.asarray(v))
             for k, v in flat.items() if k.startswith("readout/")},
            hidden[-1].spec.n_post if hidden else None, "flat arrays",
        )
        readout = {k: v.to(device) for k, v in readout.items()}
    return NetworkState(layers=tuple(states), readout=readout)


def flat_from_network_state(state: NetworkState) -> Dict[str, np.ndarray]:
    """The inverse of :func:`network_state_from_flat`, as host numpy arrays
    (numpy has no bf16: bf16 traces come back as float32, exactly)."""
    flat = {}
    for i, s in enumerate(state.layers):
        p = f"layers/{i}/"
        for name, t in (
            ("marginals/ci", s.marginals.ci), ("marginals/cj", s.marginals.cj),
            ("marginals/cij", s.marginals.cij), ("w", s.w), ("b", s.b), ("step", s.step),
        ):
            t = t.detach().cpu()
            flat[p + name] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        if s.plast is not None:
            flat[p + "plast/hcu_mask"] = s.plast.hcu_mask.detach().cpu().numpy()
    if state.readout is not None:
        for name, t in state.readout.items():
            flat["readout/" + name] = t.detach().cpu().numpy()
    return flat
