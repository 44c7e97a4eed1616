# The quantized state tier of the BF14..BF28 precision study.
from repro_torch.precision.formats import FORMATS, BFFormat, get_format, round_to, state_spec
from repro_torch.precision.policy import PrecisionPolicy, quantize_marginals, state_quantized_cycle

__all__ = [
    "BFFormat", "FORMATS", "get_format", "round_to", "state_spec",
    "PrecisionPolicy", "quantize_marginals", "state_quantized_cycle",
]
