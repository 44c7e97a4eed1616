"""The host mesh of a data-parallel run: ``torch.distributed``'s
``DeviceMesh`` over the initialised default process group.

The caller initialises the group (``torch.distributed.init_process_group``
with its address, world size and rank, or ``torchrun``), then::

    mesh = make_host_mesh()            # (world, 1) over ("data", "model"), on the cards
    mesh = make_host_mesh(model=2)     # (world // 2, 2)
    mesh = make_host_mesh(pod=2)       # (2, world // 2, 1) over ("pod", "data", "model")
    mesh = make_host_mesh(device_type="cpu")   # gloo ranks holding CPU tensors

Ranks fill the mesh in row-major order, so a rank's neighbours on the
``model`` axis are consecutive ranks.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def make_host_mesh(model: int = 1, device_type: str = "cuda", pod: Optional[int] = None):
    """A ``DeviceMesh`` of dims ``("data", "model")``, or ``("pod", "data",
    "model")`` when ``pod`` is given, over every rank of the default group.
    Its ranks hold their tensors on their card (NCCL, or gloo with CUDA
    tensors) unless the caller passes ``device_type="cpu"``."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs torch.distributed.init_process_group first")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type {device_type!r}: want 'cuda' or 'cpu'")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_host_mesh(device_type='cuda') needs a CUDA device and none is available; "
            "pass device_type='cpu' to hold the ranks' tensors on the CPU"
        )
    world = dist.get_world_size()
    outer = model * (pod or 1)
    if model < 1 or (pod is not None and pod < 1) or world % outer:
        raise ValueError(f"a world of {world} ranks does not split into model={model}, pod={pod}")
    ranks = torch.arange(world)
    if pod is None:
        return DeviceMesh(device_type, ranks.view(world // model, model),
                          mesh_dim_names=("data", "model"))
    return DeviceMesh(device_type, ranks.view(pod, world // outer, model),
                      mesh_dim_names=("pod", "data", "model"))


__all__ = ["make_host_mesh"]
