# The LM zoo's dense and MoE families: GQA (with sliding windows) or MLA
# decoders with MLPs or mixtures of experts, as nn.Modules over plain
# tensor operations.  The other families (ssm, hybrid, vlm, encdec) wait
# for later slices; build_model names each.
from repro_torch.models.lm import CausalLM, build_model

__all__ = ["CausalLM", "build_model"]
