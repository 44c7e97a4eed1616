# The LM zoo's dense family: GQA decoders with sliding-window attention,
# as nn.Modules over plain tensor operations.  The other families (moe,
# ssm, hybrid, vlm, encdec) wait for later slices; build_model names each.
from repro_torch.models.lm import CausalLM, build_model

__all__ = ["CausalLM", "build_model"]
