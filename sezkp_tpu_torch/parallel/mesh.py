"""A 1-D world of ranks for multi-GPU scale-out, and its three collectives.

Counterpart of sezkp_tpu/parallel/mesh.py. A JAX mesh is a set of devices
that one SPMD program spans, several of them in one process if need be. Here
one rank is one process that owns one device, and a :class:`Mesh` is the
default process group of ``torch.distributed`` seen from one rank (a world of
one when none is initialised): NCCL for ranks with a card each, gloo for ranks
on the CPU and for ranks that share one card.

The port's only collectives are the three below, with the semantics of
``jax.lax.all_to_all(..., tiled=True)``, ``jax.lax.all_gather(...,
tiled=True)`` and ``jax.lax.ppermute``: the identity in a world of one,
``torch.distributed`` otherwise. gloo takes CUDA tensors for all of them (it
stages them through host memory itself), so ranks sharing a card pass their
device tensors as NCCL ranks do. A failed collective raises; nothing falls
back to another backend or device.

Every collective of a world of more than one is tallied on the mesh
(:class:`Tally`, read by ``traffic.collective_bytes``): per scope and kind
(``all-to-all``, ``all-gather``, ``collective-permute``) the number of
calls, the bytes of the output on this rank and the bytes this rank sent to
other ranks.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops._kernels import resolve_device


class Tally:
    """Bytes and calls of a rank's collectives, by scope and kind. `scope`
    names the work under way (`scoped` sets it); each record is {"count":
    calls, "bytes": bytes of the output on this rank, "link_bytes": bytes
    this rank sent to other ranks}."""

    def __init__(self):
        self.scope = ""
        self.records: Dict[Tuple[str, str], Dict[str, int]] = {}

    @contextlib.contextmanager
    def scoped(self, name: str):
        outer, self.scope = self.scope, name
        try:
            yield
        finally:
            self.scope = outer

    def add(self, op: str, out_bytes: int, link_bytes: int) -> None:
        rec = self.records.setdefault((self.scope, op), {"count": 0, "bytes": 0, "link_bytes": 0})
        rec["count"] += 1
        rec["bytes"] += int(out_bytes)
        rec["link_bytes"] += int(link_bytes)

    def clear(self) -> None:
        self.records.clear()


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the world: its index, the world's size, the device
    it owns, the backend of the default group ("none" for a world of one
    without ``torch.distributed``) and the tally of its collectives."""

    rank: int
    size: int
    device: torch.device
    backend: str
    tally: Tally = field(default_factory=Tally, compare=False, repr=False)


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
    nbytes = _nbytes(send)
    mesh.tally.add("all-to-all", nbytes, nbytes - nbytes // d)
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
    mesh.tally.add("all-gather", _nbytes(x) * mesh.size, _nbytes(x) * (mesh.size - 1))
    return torch.cat(parts, dim=dim)


def ppermute(x: torch.Tensor, mesh: Mesh, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute(x, perm=pairs)``: for each (source, destination) pair
    the destination receives the source's x; a rank that is no destination
    gets zeros. Each rank is the source of one pair at most and the
    destination of one at most. Every rank passes an x of the same shape.

    One ``all_to_all_single`` with per-rank split sizes (x's elements to the
    destination, none elsewhere), so NCCL and gloo take one code path; a
    pair (r, r) stays on rank r."""
    dst = {s: t for s, t in pairs}
    src = {t: s for s, t in pairs}
    if len(dst) != len(pairs) or len(src) != len(pairs):
        raise ValueError(f"a rank is the source or the destination of two pairs: {list(pairs)}")
    r = mesh.rank
    if mesh.size == 1:
        return x if dst.get(0) == 0 else torch.zeros_like(x)
    import torch.distributed as dist

    flat = x.contiguous().reshape(-1)
    n = flat.shape[0]
    send_sizes = [n if dst.get(r) == j else 0 for j in range(mesh.size)]
    recv_sizes = [n if src.get(r) == j else 0 for j in range(mesh.size)]
    send = flat if r in dst else flat[:0]
    recv = torch.empty(n if r in src else 0, dtype=x.dtype, device=x.device)
    dist.all_to_all_single(recv, send, output_split_sizes=recv_sizes, input_split_sizes=send_sizes)
    sent_away = r in dst and dst[r] != r
    mesh.tally.add("collective-permute", _nbytes(x), _nbytes(x) if sent_away else 0)
    return recv.reshape(x.shape) if r in src else torch.zeros_like(x)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()
