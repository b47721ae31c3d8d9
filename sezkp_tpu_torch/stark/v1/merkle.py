"""Merkle utilities for v1: batch trees, labeled column leaves, chunked commits.

Tree shape matches crates/sezkp-stark/src/v1/merkle.rs exactly (empty -> one
zero leaf; odd node promoted unchanged). Construction is batch-first: every
level is one `parent_many` call over contiguous pairs, and all chunk trees of
a column are reduced simultaneously (vectorized across chunks) instead of the
reference's per-chunk sequential builds. Everything here runs on the host; the
device-resident commitments live in openings.ColumnEngine and fri_device.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from ...crypto import blake3
from . import params


def hash_field_leaves(le_elems: np.ndarray) -> np.ndarray:
    """BLAKE3(value_le8) per element. le_elems: uint8 [n, 8] -> [n, 32]."""
    le = np.ascontiguousarray(le_elems, dtype=np.uint8)
    return blake3.hash_many(le)


def hash_field_leaves_labeled(le_elems: np.ndarray, col_label: str) -> np.ndarray:
    """BLAKE3(DS_COL_LEAF || le32(len(label)) || label || value_le8) batched."""
    le = np.ascontiguousarray(le_elems, dtype=np.uint8)
    n = le.shape[0]
    prefix = (
        params.DS_COL_LEAF.encode()
        + struct.pack("<I", len(col_label))
        + col_label.encode()
    )
    pre = np.frombuffer(prefix, dtype=np.uint8)
    msgs = np.empty((n, len(prefix) + 8), dtype=np.uint8)
    msgs[:, : len(prefix)] = pre[None, :]
    msgs[:, len(prefix) :] = le
    return blake3.hash_many(msgs)


class MerkleTree:
    """Small Merkle tree over 32-byte leaves with odd promotion."""

    __slots__ = ("levels",)

    def __init__(self, levels: List[np.ndarray]):
        self.levels = levels  # levels[0] = leaves ... levels[-1] = [1, 32]

    @staticmethod
    def from_leaves(leaves: np.ndarray) -> "MerkleTree":
        lv = np.ascontiguousarray(leaves, dtype=np.uint8)
        n = lv.shape[0]
        if n == 0:
            lv = np.zeros((1, 32), dtype=np.uint8)
            n = 1
        # Parent levels build on host (C++ batch hashing); bulk device
        # hashing is the ColumnEngine's and DeviceFri's job.
        levels = [lv]
        cur = lv
        while cur.shape[0] > 1:
            m = cur.shape[0]
            half = m // 2
            nxt = blake3.parent_many(cur[: 2 * half].reshape(half, 64))
            if m & 1:
                nxt = np.concatenate([nxt, cur[-1:]], axis=0)
            levels.append(nxt)
            cur = nxt
        return MerkleTree(levels)

    def root(self) -> bytes:
        return self.levels[-1][0].tobytes()

    def open(self, idx: int) -> List[bytes]:
        """Sibling hashes bottom->top (odd node uses itself as sibling)."""
        idx %= self.levels[0].shape[0]
        sibs: List[bytes] = []
        for lvl in self.levels[:-1]:
            m = lvl.shape[0]
            sib = idx ^ 1
            if sib >= m:
                sib = idx
            sibs.append(lvl[sib].tobytes())
            idx >>= 1
        return sibs

    @staticmethod
    def verify(root: bytes, leaf: bytes, idx: int, sibs: Sequence[bytes]) -> bool:
        cur = leaf
        for s in sibs:
            if idx & 1 == 0:
                cur = blake3.hash_bytes(cur + s)
            else:
                cur = blake3.hash_bytes(s + cur)
            idx >>= 1
        return cur == root


def chunk_roots_batch(leaves: np.ndarray, chunk_log2: int) -> np.ndarray:
    """Roots of per-chunk Merkle trees, all chunks reduced simultaneously.

    Full chunks are perfect binary trees -> log2(chunk) batched parent passes
    over [n_full * chunk] nodes at once; a ragged last chunk is reduced alone.
    Returns uint8 [n_chunks, 32].
    """
    n = leaves.shape[0]
    chunk = 1 << chunk_log2
    n_full = n // chunk
    rem = n - n_full * chunk
    out: List[np.ndarray] = []
    if n_full:
        cur = leaves[: n_full * chunk].reshape(n_full * chunk, 32)
        width = chunk
        while width > 1:
            cur = blake3.parent_many(cur.reshape(cur.shape[0] // 2, 64))
            width >>= 1
        out.append(cur.reshape(n_full, 32))
    if rem:
        out.append(
            np.frombuffer(
                MerkleTree.from_leaves(leaves[n_full * chunk :]).root(), dtype=np.uint8
            ).reshape(1, 32)
        )
    if not out:
        return np.zeros((0, 32), dtype=np.uint8)
    return np.concatenate(out, axis=0)


@dataclass
class ColumnCommit:
    """Chunked column commitment: inner per-chunk trees + outer tree over
    chunk roots (reference: merkle.rs:168-239). Inner trees are rebuilt on
    demand from the retained leaf hashes (batch) rather than stored."""

    chunk_log2: int
    n_leaves: int
    leaves: np.ndarray  # [n, 32] leaf hashes
    chunk_roots: np.ndarray  # [n_chunks, 32]
    outer: MerkleTree

    @staticmethod
    def from_hashed_leaves(leaves: np.ndarray, chunk_log2: int) -> "ColumnCommit":
        roots = chunk_roots_batch(leaves, chunk_log2)
        return ColumnCommit(
            chunk_log2=chunk_log2,
            n_leaves=leaves.shape[0],
            leaves=leaves,
            chunk_roots=roots,
            outer=MerkleTree.from_leaves(roots),
        )

    def root(self) -> bytes:
        return self.outer.root()

    def open(self, row_idx: int) -> Tuple[int, int, bytes, List[bytes], List[bytes]]:
        assert row_idx < self.n_leaves, "row index out of range"
        chunk = 1 << self.chunk_log2
        ci = row_idx // chunk
        ii = row_idx - ci * chunk
        inner = MerkleTree.from_leaves(
            self.leaves[ci * chunk : min((ci + 1) * chunk, self.n_leaves)]
        )
        return ci, ii, inner.root(), inner.open(ii), self.outer.open(ci)


def verify_chunked_open(
    outer_root: bytes,
    col_label: str,
    value_le: bytes,
    chunk_root: bytes,
    idx_in_chunk: int,
    path_in_chunk: Sequence[bytes],
    chunk_idx: int,
    path_to_chunk: Sequence[bytes],
) -> bool:
    leaf = hash_field_leaves_labeled(
        np.frombuffer(value_le, dtype=np.uint8).reshape(1, 8), col_label
    )[0].tobytes()
    if not MerkleTree.verify(chunk_root, leaf, idx_in_chunk, path_in_chunk):
        return False
    return MerkleTree.verify(outer_root, chunk_root, chunk_idx, path_to_chunk)
