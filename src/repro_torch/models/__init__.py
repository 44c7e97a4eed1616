# The LM zoo: GQA (with sliding windows) or MLA decoders with MLPs or
# mixtures of experts, Mamba-2 (SSD) stacks, the hybrid of Mamba-2 groups
# around one shared attention block, the VLM backbone with its
# patch-embedding frontend, and the encoder-decoder with cross attention,
# as nn.Modules over plain tensor operations; build_model picks the class.
from repro_torch.models.lm import CausalLM, EncDecLM, build_model

__all__ = ["CausalLM", "EncDecLM", "build_model"]
