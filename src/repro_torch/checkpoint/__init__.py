# Carrying weights across from the reference's flat checkpoint arrays.
from repro_torch.checkpoint.convert import flat_from_network_state, network_state_from_flat

__all__ = ["flat_from_network_state", "network_state_from_flat"]
