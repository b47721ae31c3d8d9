"""Streaming Merkle commitments over BlockSummary leaves.

Re-design of the reference crate ``sezkp-merkle`` (crates/sezkp-merkle/src/
lib.rs) with batch-first hashing: leaves for many blocks are assembled into a
contiguous message matrix and hashed with one `hash_many` call (native C++ on
host) instead of per-leaf hashing. The streaming frontier and the manifest
file helpers are not part of this module yet.

Canonical leaf schema v1 (reference: merkle/lib.rs:85-117) — BLAKE3 over raw
little-endian fields, no framing:
  version u16 | block_id u32 | step_lo u64 | step_hi u64 | ctrl_in u16 |
  ctrl_out u16 | in_head_in i64 | in_head_out i64 | windows.len u64 |
  (left i64, right i64)* | head_in_offsets u32* | head_out_offsets u32* |
  movement_log.steps.len u64
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Sequence

import numpy as np

from ..core.types import BlockSummary
from ..crypto import blake3

__all__ = [
    "MANIFEST_VERSION",
    "CommitManifest",
    "leaf_hash",
    "leaf_hashes_batch",
    "node_hash",
    "merkle_root",
    "commit_blocks",
]

MANIFEST_VERSION = 1


@dataclass
class CommitManifest:
    version: int
    root: bytes  # 32 bytes
    n_leaves: int

    def to_obj(self):
        return {
            "version": int(self.version),
            "root": list(self.root),
            "n_leaves": int(self.n_leaves),
        }

    @staticmethod
    def from_obj(o) -> "CommitManifest":
        return CommitManifest(
            version=o["version"], root=bytes(o["root"]), n_leaves=o["n_leaves"]
        )


# ---------------------------------------------------------------------------
# Leaf hashing
# ---------------------------------------------------------------------------


def leaf_bytes(b: BlockSummary) -> bytes:
    """Canonical leaf message for one block (see module docstring)."""
    tau = b.tau
    parts = [
        struct.pack(
            "<HIQQHHqq",
            b.version & 0xFFFF,
            b.block_id & 0xFFFFFFFF,
            b.step_lo,
            b.step_hi,
            b.ctrl_in & 0xFFFF,
            b.ctrl_out & 0xFFFF,
            b.in_head_in,
            b.in_head_out,
        ),
        struct.pack("<Q", tau),
    ]
    wins = np.ascontiguousarray(b.windows, dtype="<i8")
    parts.append(wins.tobytes())  # (left, right) pairs, LE i64
    parts.append(np.ascontiguousarray(b.head_in_offsets, dtype="<u4").tobytes())
    parts.append(np.ascontiguousarray(b.head_out_offsets, dtype="<u4").tobytes())
    parts.append(struct.pack("<Q", b.movement_log.n_steps))
    return b"".join(parts)


def leaf_hash(b: BlockSummary) -> bytes:
    return blake3.hash_bytes(leaf_bytes(b))


def leaf_hashes_batch(blocks: Sequence[BlockSummary]) -> np.ndarray:
    """Hash many leaves at once. Returns uint8 [N, 32].

    Blocks with equal tau produce equal-length messages, so the common case is
    one contiguous `hash_many`. Mixed lengths fall back to grouping.
    """
    if not blocks:
        return np.zeros((0, 32), dtype=np.uint8)
    msgs = [leaf_bytes(b) for b in blocks]
    lens = {len(m) for m in msgs}
    out = np.empty((len(blocks), 32), dtype=np.uint8)
    if len(lens) == 1:
        mat = np.frombuffer(b"".join(msgs), dtype=np.uint8).reshape(len(blocks), -1)
        out[:] = blake3.hash_many(mat)
    else:
        for i, m in enumerate(msgs):
            out[i] = np.frombuffer(blake3.hash_bytes(m), dtype=np.uint8)
    return out


def node_hash(left: bytes, right: bytes) -> bytes:
    """BLAKE3(left || right) (reference: merkle/lib.rs:119-128)."""
    return blake3.hash_bytes(left + right)


def merkle_root(leaves: np.ndarray) -> bytes:
    """Left-balanced root with odd-promotion over uint8 [N, 32] leaf hashes."""
    return blake3.merkle_root_leaves(leaves)


# ---------------------------------------------------------------------------
# In-memory API
# ---------------------------------------------------------------------------


def commit_blocks(blocks: Sequence[BlockSummary]) -> CommitManifest:
    leaves = leaf_hashes_batch(blocks)
    return CommitManifest(
        version=MANIFEST_VERSION, root=merkle_root(leaves), n_leaves=len(blocks)
    )
