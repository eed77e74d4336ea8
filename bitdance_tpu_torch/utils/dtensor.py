"""DTensor helpers shared by the optimizer, the checkpoints and the mesh:
a sharded tensor's local shard and its region of the global tensor, and
DTensors laid out like another one (parallel/mesh.py puts models under
FSDP2, whose parameters, gradients, moments and EMA are DTensors)."""

from __future__ import annotations

from typing import Sequence

import torch


def is_sharded(t) -> bool:
    """Whether ``t`` is a DTensor (a shard of a tensor laid out on a mesh)."""
    return hasattr(t, "device_mesh")


def local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of a DTensor (a view that shares its storage); any
    other tensor as it is."""
    return t.to_local() if is_sharded(t) else t


def local_region(shape: Sequence[int], mesh, placements) -> tuple[tuple, tuple]:
    """(offset, local shape) of this process's shard of a tensor of global
    ``shape`` under ``placements``: ``torch.chunk``'s split (chunks of
    ceil(n / size), the last ones short or empty), which FSDP2 and DTensor
    use."""
    offset, size = [0] * len(shape), list(shape)
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if pl.is_shard():
            d = pl.dim
            per = -(-size[d] // mesh.size(i))
            start = min(coord[i] * per, size[d])
            offset[d] += start
            size[d] = max(0, min(per, size[d] - start))
    return tuple(offset), tuple(size)


def shard_like(full: torch.Tensor, like) -> torch.Tensor:
    """A DTensor laid out as ``like`` (a DTensor) holding this process's
    shard of ``full`` (copied)."""
    offset, size = local_region(like.shape, like.device_mesh, like.placements)
    part = full
    for d, (o, s) in enumerate(zip(offset, size)):
        part = part.narrow(d, o, s)
    return dtensor_like(part, like)


def dtensor_like(part: torch.Tensor, like) -> torch.Tensor:
    """A DTensor laid out as ``like`` whose local shard is a copy of
    ``part`` (already this process's shard)."""
    from torch.distributed.tensor import DTensor

    part = part.to(device=local(like).device, copy=True).contiguous()
    return DTensor.from_local(part, like.device_mesh, like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())
