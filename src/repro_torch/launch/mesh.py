"""Meshes: ``torch.distributed``'s ``DeviceMesh`` over the initialised
default process group, and the card's constants the roofline divides by.

The production meshes (the reference's TPU v5e pods, here as H100 ranks):
one pod ``(16, 16)`` = 256 ranks over ``("data", "model")``, two pods
``(2, 16, 16)`` = 512 over ``("pod", "data", "model")``: the pod axis is
pure data parallelism, model parallelism never crosses a pod.  The dry
runs build them over a ``fake`` process group in one process
(``fake_world``): every rank's collectives are no-ops there.

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

import contextlib
from typing import Iterator, Optional

import torch
import torch.distributed as dist

# One H100 SXM (NVIDIA's data sheet, dense rates without sparsity, at the
# card's full 700 W power limit; a card set below it runs slower).
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_F32 = 67e12  # FLOP/s, f32 outside the tensor cores (TF32 is off)
HBM_BW = 3.35e12  # B/s
HBM_BYTES = 80e9  # B of device memory
NVLINK_BW = 450e9  # B/s each way to the other cards of one host (the reference's ICI_BW)

POD_SHAPE = (16, 16)
MULTIPOD_SHAPE = (2, 16, 16)


def production_shape(multi_pod: bool = False) -> dict:
    """{axis: size} of a production mesh: the mesh shape ``ShardCtx``
    counts with, no process group needed."""
    if multi_pod:
        return dict(zip(("pod", "data", "model"), MULTIPOD_SHAPE))
    return dict(zip(("data", "model"), POD_SHAPE))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The reference's production mesh as a ``DeviceMesh`` over the
    initialised default group, which must hold exactly 256 (one pod) or
    512 (two pods) ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    shape = production_shape(multi_pod)
    world = int(torch.tensor(tuple(shape.values())).prod())
    if not dist.is_initialized():
        raise RuntimeError(
            f"make_production_mesh needs an initialised group of {world} ranks "
            "(torch.distributed.init_process_group, or fake_world for a dry run)")
    if dist.get_world_size() != world:
        raise ValueError(
            f"the production mesh {tuple(shape.values())} needs {world} ranks; the group "
            f"has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(world).view(*shape.values()),
                      mesh_dim_names=tuple(shape))


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0) -> Iterator[None]:
    """A default group of ``world_size`` ranks in this one process, as rank
    ``rank``, whose collectives move nothing: the dry runs' stand-in for a
    pod.  Refuses to replace a group that is already initialised, and
    destroys its own on exit."""
    import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers "fake")

    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group is already initialised")
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


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


__all__ = [
    "HBM_BW", "HBM_BYTES", "NVLINK_BW", "PEAK_FLOPS_BF16", "PEAK_FLOPS_F32",
    "fake_world", "make_host_mesh", "make_production_mesh", "production_shape",
]
