# Hand-written Hopper (sm_90a) CUDA kernels for the BCPNN hot ops, one
# module per kernel with its launch counter; ops.py is the dispatch layer,
# ref.py the plain versions, _build.py builds csrc/ with nvcc at first use.
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
