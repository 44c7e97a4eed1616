# Logical-axis sharding rules: logical dim names -> mesh axes with the
# divisibility fallback, over a DeviceMesh or a mesh shape alone.
from repro_torch.sharding.rules import (
    DEFAULT_RULES,
    L,
    ShardCtx,
    cache_logical,
    local_bytes,
    logical,
    param_shardings,
    param_specs,
)

__all__ = [
    "DEFAULT_RULES", "L", "ShardCtx", "cache_logical", "local_bytes", "logical",
    "param_shardings", "param_specs",
]
