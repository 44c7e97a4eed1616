# Whole-network checkpoints in the reference's layout, and carrying weights
# across from its flat arrays.
from repro_torch.checkpoint.convert import flat_from_network_state, network_state_from_flat
from repro_torch.checkpoint.network import load_adapters, load_network, save_network
from repro_torch.checkpoint.store import (
    latest_checkpoint,
    list_checkpoints,
    load_flat,
    load_manifest,
    restore_into_template,
    save_checkpoint,
)

__all__ = [
    "flat_from_network_state", "network_state_from_flat",
    "load_adapters", "load_network", "save_network",
    "latest_checkpoint", "list_checkpoints", "load_flat", "load_manifest",
    "restore_into_template", "save_checkpoint",
]
