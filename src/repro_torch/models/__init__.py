# The LM zoo's decoder-only families: GQA (with sliding windows) or MLA
# decoders with MLPs or mixtures of experts, Mamba-2 (SSD) stacks, the
# hybrid of Mamba-2 groups around one shared attention block, and the VLM
# backbone with its patch-embedding frontend, as nn.Modules over plain
# tensor operations.  The enc-dec family waits for Slice F6; build_model
# names it.
from repro_torch.models.lm import CausalLM, build_model

__all__ = ["CausalLM", "build_model"]
