"""The batch pipeline: deterministic epoch shuffles and rank-local batches.

``epoch_batches`` and ``lm_batches`` are numpy copies of the JAX package's
(the same ``SeedSequence([seed, epoch])`` shuffle, so both packages draw
the same batches).  :class:`ShardedBatcher` feeds a data-parallel run:
torch has no global array, so each rank holds its own contiguous rows of
the global batch, on its device (the rows ``DataParallelTrainer``'s steps
take; ``repro_torch.core.distributed``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class ShardedBatcher:
    """This rank's share of each global batch, for a mesh whose batch is
    split over ``batch_axes`` (a ``torch.distributed.device_mesh.DeviceMesh``
    from ``repro_torch.launch.mesh.make_host_mesh``)."""

    mesh: Any
    batch_axes: Tuple[str, ...] = ("data",)

    def rank_rows(self, n: int) -> slice:
        """The rows of a global batch of ``n`` that this rank holds: the
        ranks of the batch axes in row-major order take equal contiguous
        blocks (``DataParallelTrainer.rows``'s); ``n`` must divide evenly."""
        from repro_torch.core.distributed import batch_rows, mesh_position

        return batch_rows(n, *mesh_position(self.mesh, self.batch_axes), self.batch_axes)

    def global_batch(self, host_array: np.ndarray) -> torch.Tensor:
        """This rank's contiguous rows of the global batch ``host_array``,
        on the mesh's device of this rank."""
        rows = np.ascontiguousarray(host_array[self.rank_rows(host_array.shape[0])])
        device = torch.device(self.mesh.device_type)
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        return torch.from_numpy(rows).to(device)


def epoch_batches(
    x: np.ndarray,
    y: Optional[np.ndarray],
    batch_size: int,
    epoch: int,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Deterministically shuffled minibatches for one epoch."""
    n = x.shape[0]
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    idx = rng.permutation(n)
    stop = (n // batch_size) * batch_size if drop_remainder else n
    for b in range(0, stop, batch_size):
        sel = idx[b : b + batch_size]
        yield x[sel], (y[sel] if y is not None else None)


def lm_batches(
    tokens: np.ndarray,
    batch_size: int,
    seq_len: int,
    epoch: int,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Chop a token stream into (batch, seq) blocks with next-token labels."""
    stride = seq_len + 1
    n_seq = (tokens.shape[0] - 1) // seq_len
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    order = rng.permutation(n_seq)
    for b in range(0, n_seq - batch_size + 1, batch_size):
        sel = order[b : b + batch_size]
        rows = np.stack([tokens[i * seq_len : i * seq_len + stride] for i in sel])
        yield {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
        }


__all__ = ["ShardedBatcher", "epoch_batches", "lm_batches"]
