"""Whole-network checkpoints on top of :mod:`repro_torch.checkpoint.store`.

A network checkpoint is one atomic store checkpoint holding every layer's
LayerState and the SGD readout head when there is one, with the host
shuffle-RNG state in the manifest's ``extra`` — enough to resume
``CompiledNetwork.fit`` with identical shuffles and to make ``evaluate()``
after a load bit-identical to before the save.  The layout is the
reference's (``repro/checkpoint/network.py``)::

    layers/<i>/marginals/{ci,cj,cij}   layers/<i>/{w,b,step}
    layers/<i>/plast/hcu_mask          (hidden layers)
    readout/{w,b}                      (the SGD readout head, when present)
    adapters/<tenant>/...              per-tenant continual-learning adapter
                                       LayerStates (when the continual tier
                                       snapshots at a merge)

with ``extra = {network_ckpt_version, n_layers, has_readout, rng_state}``,
plus ``adapter_tenants`` and ``adapter_layer`` when adapters are saved.
Loading checks the layer count, every shape, and the head's input width
against the target network.  The optimizer's moments are not saved (a
resumed fit starts them afresh), as in the reference.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint.store import (
    load_flat,
    load_manifest,
    restore_into_template,
    save_checkpoint,
)

_VERSION = 1

# Tenant names become flat array keys (``adapters/<tenant>/...``): restrict
# them so a name can never alias another key's path segments.
_TENANT_RE = re.compile(r"^[A-Za-z0-9._-]+$")


def _unmirrored(state):
    # host_step mirrors ``step`` on the host and is not saved.
    return state._replace(host_step=None)


def _network_tree(layer_states: Sequence[Any], readout: Optional[dict]) -> dict:
    tree = {"layers": {str(i): _unmirrored(s) for i, s in enumerate(layer_states)}}
    if readout is not None:
        tree["readout"] = readout
    return tree


def readout_head(
    arrays: Dict[str, torch.Tensor], in_features: Optional[int], where: str
) -> Dict[str, torch.Tensor]:
    """The SGD head ``{"w", "b"}`` from its arrays, checked: w is 2-D, b
    matches its width, and w takes ``in_features`` hidden units (when
    given), so a mismatched head fails here and not inside predict."""
    if not arrays:
        raise KeyError(f"{where}: has_readout but no readout/* arrays")
    w, b = arrays.get("w"), arrays.get("b")
    if w is None or b is None or w.ndim != 2 or tuple(b.shape) != (w.shape[1],):
        raise ValueError(
            f"malformed readout head in {where}: "
            f"w={None if w is None else tuple(w.shape)} b={None if b is None else tuple(b.shape)}"
        )
    if in_features is not None and w.shape[0] != in_features:
        raise ValueError(
            f"readout head expects {w.shape[0]} hidden features, target network "
            f"produces {in_features}"
        )
    return {"w": w, "b": b}


def save_network(
    directory: str,
    step: int,
    state,
    rng_state: Optional[dict] = None,
    retain: int = 3,
    adapters: Optional[Dict[str, Any]] = None,
    adapter_layer: Optional[int] = None,
) -> str:
    """Atomically write a NetworkState (+ host RNG state) checkpoint.

    adapters: optional ``tenant -> LayerState`` map from the continual tier;
    each adapter is a fork of layer ``adapter_layer`` and is stored under
    ``adapters/<tenant>/...``, so a base+adapters snapshot is ONE atomic
    manifest (the rollback unit).
    """
    extra = {
        "network_ckpt_version": _VERSION,
        "n_layers": len(state.layers),
        "has_readout": state.readout is not None,
        "rng_state": rng_state,
    }
    tree = _network_tree(state.layers, state.readout)
    if adapters:
        for tenant in adapters:
            if not _TENANT_RE.match(tenant):
                raise ValueError(
                    f"tenant name {tenant!r} is not checkpoint-safe (expected [A-Za-z0-9._-]+)"
                )
        tree["adapters"] = {t: _unmirrored(s) for t, s in adapters.items()}
        extra["adapter_tenants"] = sorted(adapters)
        extra["adapter_layer"] = adapter_layer
    return save_checkpoint(directory, step, tree, retain=retain, extra=extra)


def load_adapters(path: str, template: Any, device=None) -> Dict[str, Any]:
    """Restore the per-tenant adapter LayerStates of a network checkpoint
    (this package's or the reference's), on ``device`` (default: the
    template's).  template: the adapted layer's current LayerState (its
    structure and shapes).  Returns ``{}`` for a checkpoint written without
    adapters."""
    extra = load_manifest(path).get("extra", {})
    if extra.get("network_ckpt_version") != _VERSION:
        raise ValueError(f"{path} is not a network checkpoint")
    tenants = extra.get("adapter_tenants") or []
    if not tenants:
        return {}
    flat = load_flat(path)
    out = {}
    for t in tenants:
        s = restore_into_template(flat, template, prefix=f"adapters/{t}/", device=device)
        out[t] = s._replace(host_step=int(s.step))
    return out


def load_network(
    path: str, layer_templates: Sequence[Any], device=None,
    readout_in_features: Optional[int] = None,
) -> Tuple[List[Any], Optional[dict], Optional[dict]]:
    """Restore (layer_states, readout_params, rng_state) from a network
    checkpoint.

    layer_templates: the target network's current LayerStates; their
    structure and shapes define what is restored, on ``device`` (default:
    each template tensor's device).  readout_in_features: the width of the
    hidden codes the SGD head must take, checked when given.
    """
    manifest = load_manifest(path)
    extra = manifest.get("extra", {})
    version = extra.get("network_ckpt_version")
    if version != _VERSION:
        raise ValueError(f"{path} is not a network checkpoint (version={version!r})")
    n_saved = extra.get("n_layers")
    if n_saved != len(layer_templates):
        raise ValueError(
            f"checkpoint has {n_saved} layers, target network has {len(layer_templates)}"
        )
    flat = load_flat(path)
    states = []
    for i, template in enumerate(layer_templates):
        s = restore_into_template(flat, template, prefix=f"layers/{i}/", device=device)
        states.append(s._replace(host_step=int(s.step)))
    readout = None
    if extra.get("has_readout"):
        head = readout_head(
            {k.split("/", 1)[1]: t for k, t in flat.items() if k.startswith("readout/")},
            readout_in_features, path,
        )
        target = device if device is not None else layer_templates[0].w.device
        readout = {k: t.to(target) for k, t in head.items()}
    return states, readout, extra.get("rng_state")
