"""Device meshes over the ranks of a ``torch.distributed`` world
(``repro.launch.mesh``).

Functions only: importing this module touches no device and no process
group.  Mesh axes are the outermost level of the paper's dimension
lifting: ``"pod"`` (data parallelism across pods), ``"data"`` (data
parallelism / FSDP within a pod), ``"model"`` (tensor / expert
parallelism).  One rank a device: on the card each rank takes device
``rank % device_count()`` (ranks beyond the cards share them, as a
gloo world on one card does); a mesh asked for on CUDA with no card
raises.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def _mesh(shape: tuple, names: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {dict(zip(names, shape))}, the world "
            f"has {world if dist.is_initialized() else 0}: start them with "
            f"torchrun (or torch.distributed.init_process_group) first")
    dev = resolve_device(device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The production mesh: ``("data", "model")`` 16 x 16 = 256 ranks, or
    ``("pod", "data", "model")`` 2 x 16 x 16 = 512; raises when the world
    has fewer ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_host_mesh(dp: int = 1, tp: int = 1, device_type="cuda"):
    """A ``("data", "model")`` mesh of ``dp x tp`` ranks of the world
    (tests, examples, the train launcher)."""
    return _mesh((dp, tp), ("data", "model"), device_type)
