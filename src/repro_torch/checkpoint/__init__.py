# Whole-network checkpoints in the reference's layout, and carrying weights
# (BCPNN states and the LM zoo's parameters) across from its flat arrays.
from repro_torch.checkpoint.convert import (
    flat_from_lm,
    flat_from_network_state,
    lm_params_from_flat,
    network_state_from_flat,
)
from repro_torch.checkpoint.network import load_adapters, load_network, save_network
from repro_torch.checkpoint.store import (
    AsyncCheckpointer,
    latest_checkpoint,
    list_checkpoints,
    load_flat,
    load_manifest,
    restore_checkpoint,
    restore_into_template,
    save_checkpoint,
)

__all__ = [
    "flat_from_lm", "lm_params_from_flat",
    "flat_from_network_state", "network_state_from_flat",
    "load_adapters", "load_network", "save_network",
    "AsyncCheckpointer", "latest_checkpoint", "list_checkpoints", "load_flat", "load_manifest",
    "restore_checkpoint", "restore_into_template", "save_checkpoint",
]
