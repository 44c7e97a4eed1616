# Optimizers over trees of tensors, in the reference's order of operations
# (``repro/optim``): AdamW and SGD, the learning-rate schedules,
# microbatched gradient accumulation, and the gradient compression schemes.
from repro_torch.optim.adamw import AdamW, AdamWState, apply_updates, tree_flatten, tree_map
from repro_torch.optim.sgd import SGD, SGDState
from repro_torch.optim.schedules import constant, warmup_cosine, warmup_linear
from repro_torch.optim.accumulation import microbatched_value_and_grad, value_and_grad
from repro_torch.optim.compression import (
    ErrorFeedbackState,
    init_error_feedback,
    int8_allreduce,
    topk_compress_allreduce,
)

__all__ = [
    "AdamW", "AdamWState", "apply_updates", "tree_flatten", "tree_map", "SGD", "SGDState",
    "constant", "warmup_cosine", "warmup_linear",
    "microbatched_value_and_grad", "value_and_grad",
    "ErrorFeedbackState", "init_error_feedback", "int8_allreduce", "topk_compress_allreduce",
]
