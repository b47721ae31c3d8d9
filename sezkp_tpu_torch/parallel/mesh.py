"""A 1-D world of ranks for multi-GPU scale-out, and its two collectives.

Counterpart of sezkp_tpu/parallel/mesh.py. A JAX mesh is a set of devices
that one SPMD program spans, several of them in one process if need be. Here
one rank is one process that owns one device, and a :class:`Mesh` is the
default process group of ``torch.distributed`` seen from one rank (a world of
one when none is initialised): NCCL for ranks with a card each, gloo for ranks
on the CPU and for ranks that share one card.

The port's only collectives are the two below, with the semantics of
``jax.lax.all_to_all(..., tiled=True)`` and ``jax.lax.all_gather(...,
tiled=True)``: the identity in a world of one, ``torch.distributed``
otherwise. gloo takes CUDA tensors for both (it stages them through host
memory itself; checked on an H100), so ranks sharing a card pass their
device tensors as NCCL ranks do. A failed collective raises; nothing falls
back to another backend or device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops._kernels import resolve_device


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the world: its index, the world's size, the device
    it owns and the backend of the default group ("none" for a world of one
    without ``torch.distributed``)."""

    rank: int
    size: int
    device: torch.device
    backend: str


def _own_device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh over every rank of the initialised default group, or a world
    of one. `device`: this rank's device; None is the one
    ``distributed.ensure_initialized`` chose, else the CUDA card (raises
    without one). `n_devices`, when given, must be the world's size."""
    import torch.distributed as dist

    from . import distributed

    if dist.is_available() and dist.is_initialized():
        rank, size, backend = dist.get_rank(), dist.get_world_size(), dist.get_backend()
        if device is None:
            device = distributed.local_device()
    else:
        rank, size, backend = 0, 1, "none"
    if n_devices is not None and n_devices != size:
        raise ValueError(f"requested {n_devices} ranks but the world has {size}")
    return Mesh(rank, size, _own_device(device), backend)


def make_global(mesh: Mesh, dim: Optional[int], arr) -> torch.Tensor:
    """Host array, the same on every rank -> this rank's part on its device:
    the contiguous shard along `dim`, or all of it (`dim=None`, replicated).
    uint64 arrays (field values) arrive as int64 tensors with the same bits."""
    a = np.asarray(arr)
    if dim is not None:
        if a.shape[dim] % mesh.size:
            raise ValueError(f"dim {dim} of {a.shape} does not split over {mesh.size} ranks")
        loc = a.shape[dim] // mesh.size
        a = a[(slice(None),) * dim + (slice(mesh.rank * loc, (mesh.rank + 1) * loc),)]
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint64:
        a = a.view(np.int64)
    elif not a.flags.writeable:  # torch refuses to alias read-only memory
        a = a.copy()
    return torch.from_numpy(a).to(mesh.device)


def replicated_pull(mesh: Mesh, x: torch.Tensor, dim: int) -> np.ndarray:
    """Every rank's part of a tensor sharded along `dim`, gathered in rank
    order, as host numpy on every rank (int64 field tensors as uint64)."""
    out = all_gather_tiled(x, mesh, dim).cpu().numpy()
    return out.view(np.uint64) if out.dtype == np.int64 else out


def all_to_all_tiled(x: torch.Tensor, mesh: Mesh, split_dim: int, concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``: x is cut
    into `size` equal pieces along `split_dim`, piece s goes to rank s, and the
    pieces received are joined along `concat_dim` in source-rank order.

    ``all_to_all_single`` splits dim 0 of a contiguous tensor, so the receive
    buffer is [size, piece...]; one permuting copy (the join) gives the JAX
    layout."""
    if mesh.size == 1:
        return x
    import torch.distributed as dist

    d = mesh.size
    if x.shape[split_dim] % d:
        raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split over {d} ranks")
    xs = x.movedim(split_dim, 0)
    send = xs.reshape((d, xs.shape[0] // d) + tuple(xs.shape[1:])).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    pieces = recv.movedim(1, split_dim + 1)  # [size, x's layout with split_dim cut]
    return torch.cat(tuple(pieces.unbind(0)), dim=concat_dim)


def all_gather_tiled(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """``lax.all_gather(x, axis=dim, tiled=True)``: every rank's x (equal
    shapes) joined along `dim` in rank order, on every rank."""
    if mesh.size == 1:
        return x
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim=dim)
