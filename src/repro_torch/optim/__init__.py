# Optimizers of the hybrid readout: AdamW and SGD over trees of tensors, in
# the reference's order of operations (``repro/optim``).
from repro_torch.optim.adamw import AdamW, AdamWState, apply_updates, tree_flatten, tree_map
from repro_torch.optim.sgd import SGD, SGDState

__all__ = ["AdamW", "AdamWState", "apply_updates", "tree_flatten", "tree_map", "SGD", "SGDState"]
