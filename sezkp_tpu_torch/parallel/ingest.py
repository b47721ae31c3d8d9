"""Multi-host streaming ingest: sharded block hashing + host-0 frontier merge.

Counterpart of sezkp_tpu/parallel/ingest.py: each host streams its contiguous
shard of a JSONL blocks file, leaf-hashes it in batches (native C++ BLAKE3),
and ships only the [k, 32] digests to host 0, which folds them through one
streaming Frontier. Traffic is 32 bytes/block instead of the full block
payloads; the resulting root is bit-identical to the sequential commitment.

Workers here are threads (one per simulated host); on a real multi-host
deployment the same structure runs per-host with a gather to host 0. The
fold runs on the port's Frontier, whose `_push_at_level` holds a first shard
of 256 blocks and more.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import List, Tuple

import numpy as np

from ..commit.merkle import CommitManifest, Frontier, MANIFEST_VERSION, leaf_hashes_batch


def _shard_bounds(path: str, n_hosts: int) -> List[Tuple[int, int]]:
    """Byte ranges [start, end) per host, aligned to line boundaries."""
    size = os.path.getsize(path)
    bounds = []
    with open(path, "rb") as f:
        starts = [0]
        for h in range(1, n_hosts):
            pos = size * h // n_hosts
            f.seek(pos)
            f.readline()  # skip to next newline
            starts.append(f.tell())
        starts.append(size)
    for h in range(n_hosts):
        bounds.append((starts[h], starts[h + 1]))
    return bounds


def _hash_shard(path: str, start: int, end: int) -> Tuple[np.ndarray, int]:
    """Leaf hashes for the blocks in byte range [start, end)."""
    import json

    from ..core.types import BlockSummary

    blocks = []
    with open(path, "rb") as f:
        f.seek(start)
        while f.tell() < end:
            line = f.readline()
            if not line.strip():
                continue
            blocks.append(BlockSummary.from_obj(json.loads(line)))
    return leaf_hashes_batch(blocks), len(blocks)


def commit_block_file_sharded(
    blocks_path: str, n_hosts: int = 4, out_manifest_path: str | None = None
) -> CommitManifest:
    """Commit a JSONL blocks file with n_hosts parallel ingest shards.

    Bit-identical to commit.merkle.commit_block_file (cross-tested)."""
    bounds = _shard_bounds(blocks_path, n_hosts)
    with concurrent.futures.ThreadPoolExecutor(max_workers=n_hosts) as ex:
        results = list(
            ex.map(lambda b: _hash_shard(blocks_path, b[0], b[1]), bounds)
        )

    # host 0: fold shard digests left-to-right through one frontier
    fr = Frontier()
    total = 0
    for hashes, k in results:
        fr.push_leaves(hashes)
        total += k
    man = CommitManifest(MANIFEST_VERSION, fr.finalize_root(), total)
    if out_manifest_path:
        from ..commit.merkle import write_manifest_auto

        write_manifest_auto(out_manifest_path, man)
    return man
