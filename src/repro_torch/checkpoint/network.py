"""Whole-network checkpoints on top of :mod:`repro_torch.checkpoint.store`.

A network checkpoint is one atomic store checkpoint holding every layer's
LayerState, with the host shuffle-RNG state in the manifest's ``extra`` —
enough to resume ``CompiledNetwork.fit`` with identical shuffles and to
make ``evaluate()`` after a load bit-identical to before the save.  The
layout is the reference's (``repro/checkpoint/network.py``)::

    layers/<i>/marginals/{ci,cj,cij}   layers/<i>/{w,b,step}
    layers/<i>/plast/hcu_mask          (hidden layers)

with ``extra = {network_ckpt_version, n_layers, has_readout, rng_state}``.
Loading checks the layer count and every shape against the target network.
The SGD readout head (``readout/*``) and continual-learning adapters
(``adapters/*``) are not ported yet: a checkpoint with a readout head is
refused.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from repro_torch.checkpoint.store import (
    load_flat,
    load_manifest,
    restore_into_template,
    save_checkpoint,
)

_VERSION = 1


def _network_tree(layer_states: Sequence[Any]) -> dict:
    # host_step mirrors ``step`` on the host and is not saved.
    return {"layers": {str(i): s._replace(host_step=None) for i, s in enumerate(layer_states)}}


def save_network(
    directory: str,
    step: int,
    state,
    rng_state: Optional[dict] = None,
    retain: int = 3,
) -> str:
    """Atomically write a NetworkState (+ host RNG state) checkpoint."""
    extra = {
        "network_ckpt_version": _VERSION,
        "n_layers": len(state.layers),
        "has_readout": False,
        "rng_state": rng_state,
    }
    return save_checkpoint(directory, step, _network_tree(state.layers), retain=retain, extra=extra)


def load_network(
    path: str, layer_templates: Sequence[Any], device=None
) -> Tuple[List[Any], Optional[dict]]:
    """Restore (layer_states, rng_state) from a network checkpoint.

    layer_templates: the target network's current LayerStates; their
    structure and shapes define what is restored, on ``device`` (default:
    each template tensor's device).
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
    if extra.get("has_readout"):
        raise ValueError(f"{path} holds an SGD readout head (readout/*), which is not ported yet")
    flat = load_flat(path)
    states = []
    for i, template in enumerate(layer_templates):
        s = restore_into_template(flat, template, prefix=f"layers/{i}/", device=device)
        states.append(s._replace(host_step=int(s.step)))
    return states, extra.get("rng_state")
