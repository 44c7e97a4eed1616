# The bfloat formats of the paper's precision study: the reduced datapath
# (every algebraic stage rounded) and the quantized state tier.
from repro_torch.precision.formats import FORMATS, BFFormat, get_format, round_to, state_spec
from repro_torch.precision.policy import (
    PrecisionPolicy,
    quantize_marginals,
    quantized_forward,
    quantized_learning_cycle,
    quantized_support,
    state_quantized_cycle,
)

__all__ = [
    "BFFormat", "FORMATS", "get_format", "round_to", "state_spec",
    "PrecisionPolicy", "quantize_marginals", "quantized_forward",
    "quantized_learning_cycle", "quantized_support", "state_quantized_cycle",
]
