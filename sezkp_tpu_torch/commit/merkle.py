"""Streaming Merkle commitments over BlockSummary leaves.

Re-design of the reference crate ``sezkp-merkle`` (crates/sezkp-merkle/src/
lib.rs) with batch-first hashing: leaves for many blocks are assembled into a
contiguous message matrix and hashed with one `hash_many` call (native C++ on
host) instead of per-leaf hashing.

Canonical leaf schema v1 (reference: merkle/lib.rs:85-117) — BLAKE3 over raw
little-endian fields, no framing:
  version u16 | block_id u32 | step_lo u64 | step_hi u64 | ctrl_in u16 |
  ctrl_out u16 | in_head_in i64 | in_head_out i64 | windows.len u64 |
  (left i64, right i64)* | head_in_offsets u32* | head_out_offsets u32* |
  movement_log.steps.len u64
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..core.types import BlockSummary
from ..crypto import blake3
from ..utils import cbor

__all__ = [
    "MANIFEST_VERSION",
    "CommitManifest",
    "leaf_hash",
    "leaf_hashes_batch",
    "node_hash",
    "merkle_root",
    "Frontier",
    "commit_blocks",
    "validate_blocks_against_manifest",
    "commit_block_file",
    "verify_block_file_against_manifest",
    "read_manifest_auto",
    "write_manifest_auto",
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
# Streaming frontier
# ---------------------------------------------------------------------------


class Frontier:
    """O(log n) incremental left-balanced Merkle root builder.

    Matches the batch `merkle_root` exactly (reference: merkle/lib.rs:166-208).
    Slots can be merged across shards (see `merge_from`) which is what the
    multi-host ingest path uses: each host builds a frontier over its
    contiguous shard, then host 0 absorbs them left-to-right.
    """

    def __init__(self) -> None:
        self.slots: List[Optional[bytes]] = []
        self.n = 0

    def push_leaf(self, h: bytes) -> None:
        self.n += 1
        lvl = 0
        while True:
            if len(self.slots) <= lvl:
                self.slots.append(None)
            if self.slots[lvl] is None:
                self.slots[lvl] = h
                return
            left = self.slots[lvl]
            self.slots[lvl] = None
            h = node_hash(left, h)
            lvl += 1

    def push_leaves(self, hashes: np.ndarray) -> None:
        """Bulk push: reduce full aligned subtrees with batched parent hashing.

        Equivalent to repeated `push_leaf` but uses `parent_many` over large
        batches, so ingesting k leaves costs O(k) hashing with wide batches
        instead of k sequential calls.
        """
        m = hashes.shape[0]
        if m == 0:
            return
        # Flush leaf-by-leaf until the frontier is aligned to a big boundary,
        # then reduce big power-of-two chunks as standalone subtrees.
        i = 0
        while i < m and (self.n & 0xFF) != 0:
            self.push_leaf(hashes[i].tobytes())
            i += 1
        while m - i >= 256:
            take = 256
            sub = hashes[i : i + take]
            # Reduce 256-leaf subtree fully (a perfect tree -> single node).
            cur = sub
            while cur.shape[0] > 1:
                cur = blake3.parent_many(cur.reshape(cur.shape[0] // 2, 64))
            # Insert the subtree root at level 8 of the frontier.
            self._push_at_level(cur[0].tobytes(), 8)
            self.n += take
            i += take
        while i < m:
            self.push_leaf(hashes[i].tobytes())
            i += 1

    def _push_at_level(self, h: bytes, lvl: int) -> None:
        while True:
            # an empty (or short) frontier may be pushed at level 8 directly:
            # grow the slots up to that level, not by one
            while len(self.slots) <= lvl:
                self.slots.append(None)
            if self.slots[lvl] is None:
                self.slots[lvl] = h
                return
            left = self.slots[lvl]
            self.slots[lvl] = None
            h = node_hash(left, h)
            lvl += 1

    def finalize_root(self) -> bytes:
        """Fold pending slots lowest -> highest with the accumulator on the
        RIGHT, which reproduces the batch left-balanced odd-promotion root at
        every size.

        NOTE (deliberate fix vs reference): the reference's finalize_root
        (merkle/lib.rs:196-207) folds highest -> lowest with the accumulator
        on the left, which contradicts its own batch `merkle_root` (and its
        own frontier==batch unit test, lib.rs:474-497) for leaf counts with
        three or more set bits (first divergence at n=7). We implement the
        documented intent — frontier == batch everywhere — which is
        bit-identical to the reference for all power-of-two counts and all
        golden artifacts."""
        acc: Optional[bytes] = None
        for node in self.slots:
            if node is None:
                continue
            acc = node if acc is None else node_hash(node, acc)
        return acc if acc is not None else b"\x00" * 32


# ---------------------------------------------------------------------------
# In-memory API
# ---------------------------------------------------------------------------


def commit_blocks(blocks: Sequence[BlockSummary]) -> CommitManifest:
    leaves = leaf_hashes_batch(blocks)
    return CommitManifest(
        version=MANIFEST_VERSION, root=merkle_root(leaves), n_leaves=len(blocks)
    )


def validate_blocks_against_manifest(
    blocks: Sequence[BlockSummary], man: CommitManifest
) -> None:
    got = commit_blocks(blocks)
    if got.root != man.root:
        raise ValueError(
            f"root mismatch: manifest={man.root.hex()}, recomputed={got.root.hex()}"
        )
    if got.n_leaves != man.n_leaves:
        raise ValueError(
            f"leaf count mismatch: manifest={man.n_leaves}, recomputed={got.n_leaves}"
        )


# ---------------------------------------------------------------------------
# File helpers
# ---------------------------------------------------------------------------


def _ext(path: str) -> str:
    return os.path.splitext(path)[1].lower().lstrip(".")


def _is_jsonl(path: str) -> bool:
    return _ext(path) in ("jsonl", "ndjson")


def _streamable(path: str) -> bool:
    return _ext(path) in ("jsonl", "ndjson", "cbor")


def commit_block_file(blocks_path: str, out_manifest_path: str) -> CommitManifest:
    from ..core import io as core_io

    if _streamable(blocks_path):
        # O(log n) frontier over the streaming reader (jsonl lines or the
        # windowed cbor decoder) — frontier == batch root at every size
        fr = Frontier()
        for blk in core_io.stream_block_summaries_auto(blocks_path):
            fr.push_leaf(leaf_hash(blk))
        man = CommitManifest(MANIFEST_VERSION, fr.finalize_root(), fr.n)
    else:
        blocks = core_io.read_block_summaries_auto(blocks_path)
        man = commit_blocks(blocks)
    write_manifest_auto(out_manifest_path, man)
    print(
        f"Committed {man.n_leaves} leaves, root={man.root.hex()}, "
        f"wrote manifest {out_manifest_path}"
    )
    return man


def verify_block_file_against_manifest(blocks_path: str, manifest_path: str) -> None:
    from ..core import io as core_io

    man = read_manifest_auto(manifest_path)
    if _streamable(blocks_path):
        fr = Frontier()
        for blk in core_io.stream_block_summaries_auto(blocks_path):
            fr.push_leaf(leaf_hash(blk))
        root = fr.finalize_root()
        if root != man.root:
            raise ValueError(
                f"root mismatch: manifest={man.root.hex()}, recomputed={root.hex()}"
            )
        if fr.n != man.n_leaves:
            raise ValueError(
                f"leaf count mismatch: manifest={man.n_leaves}, recomputed={fr.n}"
            )
    else:
        blocks = core_io.read_block_summaries_auto(blocks_path)
        validate_blocks_against_manifest(blocks, man)


def read_manifest_auto(path: str) -> CommitManifest:
    e = _ext(path)
    with open(path, "rb") as f:
        data = f.read()
    if e == "json":
        return CommitManifest.from_obj(json.loads(data))
    if e == "cbor":
        return CommitManifest.from_obj(cbor.loads(data))
    raise ValueError(f"unsupported manifest extension: {e}")


def write_manifest_auto(path: str, man: CommitManifest) -> None:
    e = _ext(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if e == "cbor":
        with open(path, "wb") as f:
            f.write(cbor.dumps(man.to_obj()))
    else:
        with open(path, "w") as f:
            json.dump(man.to_obj(), f, indent=2)
