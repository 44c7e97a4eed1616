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

The LM zoo's weights cross under the keys that the reference's
``save_checkpoint`` writes for ``CausalLM.init``'s pytree:

    embed/table   final_norm/{scale,bias}   unembed (untied only)
    layers/{ln1,ln2}/{scale,bias}
    layers/attn/{wq,wk,wv,wo}                                   (GQA)
    layers/attn/{kv_down,kv_norm/scale,k_up,v_up,wo,
                 q_down,q_norm/scale,q_up | wq}                 (MLA)
    layers/mlp/{gate,up,down}
    layers/moe/{router,gate,up,down,shared/{gate,up,down}}      (MoE)
    dense_layers/...                  (the MoE family's first dense blocks)
    layers/{wz,wx,wB,wC,wdt,conv_w,conv_b,A_log,D,dt_bias,
            norm/scale,norm_in/scale,out}                       (Mamba-2: ssm, hybrid)
    shared_attn/{ln1,ln2}/{scale,bias}, shared_attn/attn/{wq,wk,wv,wo},
    shared_attn/mlp/{gate,up,down}    (the hybrid family's one shared block)

and for ``EncDecLM.init``'s (the enc-dec family):

    embed/table   enc_norm/{scale,bias}   final_norm/{scale,bias}   unembed
    enc_layers/{ln1,ln2}/..., enc_layers/attn/..., enc_layers/mlp/...
    dec_layers/{ln1,ln_x,ln2}/..., dec_layers/{attn,xattn}/{wq,wk,wv,wo},
    dec_layers/mlp/...

where every ``layers/...``, ``dense_layers/...``, ``enc_layers/...`` and
``dec_layers/...`` array is stacked over its stack's layers on the leading
axis; here each is one parameter of one ``nn.ModuleList`` entry.
``shared_attn/...`` is not stacked: one block serves every group.
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
from repro_torch.models.lm import build_model, flat_key


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


def lm_params_from_flat(cfg, flat: Dict, device="cuda", param_dtype=None):
    """The model of ``cfg`` (``build_model``'s: a ``CausalLM`` or an
    ``EncDecLM``) on ``device`` (the card by default) holding the weights
    of flat arrays (numpy or CPU tensors, as ``load_flat`` gives them)
    under the reference's keys.  Each array is cast to the parameter's
    dtype: the compute dtype for matrices, which the reference casts to at
    each use, and f32 for the norms; with ``param_dtype`` (training) that
    dtype for the matrices."""
    model = build_model(cfg, device, param_dtype)
    want = {flat_key(name)[0] for name, _ in model.named_parameters()}
    missing, extra = sorted(want - set(flat)), sorted(set(flat) - want)
    if missing or extra:
        raise KeyError(f"{cfg.name}: flat arrays missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, p in model.named_parameters():
            key, layer = flat_key(name)
            v = flat[key]
            t = v if isinstance(v, torch.Tensor) else decode_array(np.asarray(v))
            if layer is not None:
                t = t[layer]
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} != expected {tuple(p.shape)}")
            p.copy_(t.to(p.dtype))
    return model


def flat_from_lm(model) -> Dict[str, np.ndarray]:
    """The inverse of :func:`lm_params_from_flat`: host f32 arrays under
    the reference's keys, the layers' stacked (bf16 weights widen to f32
    exactly)."""
    flat, stacks = {}, {}
    for name, p in model.named_parameters():
        key, layer = flat_key(name)
        a = p.detach().float().cpu().numpy()
        if layer is None:
            flat[key] = a
        else:
            stacks.setdefault(key, []).append(a)
    flat.update({k: np.stack(v) for k, v in stacks.items()})
    return flat
