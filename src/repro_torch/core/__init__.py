# The BCPNN model, learning rule, structural plasticity and the Keras-like
# DSL, as plain PyTorch functions over NamedTuple states.
from repro_torch.core.units import UnitLayout, complementary_layout, onehot_layout
from repro_torch.core.learning import (
    EPS,
    MarginalState,
    batch_means,
    forward,
    hcu_softmax,
    init_marginals,
    learning_cycle,
    update_marginals,
    weights_from_marginals,
)
from repro_torch.core.plasticity import PlasticityState, full_mask, init_random_mask
from repro_torch.core.layers import (
    BCPNNLayerSpec, DenseLayer, LayerState, StructuralPlasticityLayer,
)
from repro_torch.core.network import FitResult, Network
from repro_torch.core.compiled import CompiledNetwork, ExecutionConfig, NetworkState

__all__ = [
    "UnitLayout", "complementary_layout", "onehot_layout",
    "EPS", "MarginalState", "batch_means", "forward", "hcu_softmax",
    "init_marginals", "learning_cycle", "update_marginals",
    "weights_from_marginals",
    "PlasticityState", "full_mask", "init_random_mask",
    "BCPNNLayerSpec", "DenseLayer", "LayerState", "StructuralPlasticityLayer",
    "FitResult", "Network",
    "CompiledNetwork", "ExecutionConfig", "NetworkState",
]
