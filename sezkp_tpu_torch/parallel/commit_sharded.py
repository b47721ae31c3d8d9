"""Distributed Merkle commitments: sharded leaf hashing + collective reduce.

Counterpart of sezkp_tpu/parallel/commit_sharded.py: leaves are sharded
across the ranks, each rank hashes and reduces its local perfect subtree
with kernel K1 (ops/blake3_torch: leaf messages, then one parent level a
launch), and the per-rank subtree roots are all-gathered; the D gathered
roots reduce to the global root on the host in the exact left-balanced
order, so the result is bit-identical to the sequential commitment.
"""

from __future__ import annotations

import numpy as np
import torch

from ..crypto import blake3 as b3
from ..ops import blake3_torch as BT
from .mesh import Mesh, all_gather_tiled, make_global


def build_sharded_leaf_commit(mesh: Mesh, n: int, prefix: bytes = b""):
    """u64 field values [n] (sharded) -> per-rank subtree root CVs.

    n must be divisible by the world's size with a power-of-two local count,
    so each local shard is a perfect subtree of the global left-balanced
    tree. Returns f(values) mapping this rank's int64 [n/D] field tensor to
    int32 [D, 8] subtree-root CVs (replicated, rank order)."""
    d = mesh.size
    assert n % d == 0, "n must divide over the ranks"
    loc = n // d
    assert loc & (loc - 1) == 0, "local leaf count must be a power of two"

    def f(values: torch.Tensor) -> torch.Tensor:
        cv = BT.hash_leaves_u64_planes(values.reshape(-1), prefix)  # [8, loc]
        while cv.shape[1] > 1:
            cv = BT.parent_level_planes(cv)
        return all_gather_tiled(cv.T.contiguous(), mesh, 0)  # [D, 8]

    return f


def gathered_roots_to_root(roots_u32: np.ndarray) -> bytes:
    """Reduce [D, 8]-word subtree roots (D a power of two) to the global root
    on host, preserving the left-balanced pairing order."""
    cur = [
        np.ascontiguousarray(roots_u32[i].astype("<u4")).view(np.uint8).tobytes()
        for i in range(roots_u32.shape[0])
    ]
    while len(cur) > 1:
        cur = [b3.hash_bytes(cur[i] + cur[i + 1]) for i in range(0, len(cur), 2)]
    return cur[0]


def sharded_merkle_root_u64(values: np.ndarray, mesh: Mesh, prefix: bytes = b"") -> bytes:
    """End-to-end: hash + commit u64 leaf values (the same on every rank)
    across the ranks; returns the 32-byte root, bit-identical to the
    sequential path."""
    v = np.asarray(values, dtype=np.uint64)
    f = build_sharded_leaf_commit(mesh, v.shape[0], prefix)
    roots = f(make_global(mesh, 0, v)).cpu().numpy().view(np.uint32)
    return gathered_roots_to_root(roots)
