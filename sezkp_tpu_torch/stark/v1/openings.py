"""Column commitment engine: chunked roots + openings.

Counterpart of ``ColumnEngine`` in sezkp_tpu/stark/v1/openings.py for host
``TraceColumns``. From ``device_hash_min`` rows up the commitments are
device-resident: the columns are uploaded once, leaf CVs are hashed and kept
on the device (kernel K1), only chunk roots (KBs) and opening paths (KBs)
come back; the outer trees over the chunk roots are small and built on the
host. Below the threshold everything runs on the host. Roots and paths are
bit-identical either way (reference: crates/sezkp-stark/src/v1/openings.rs).

The recompute/ranges openings (columns derived on the device) and the
streaming engine are not ported yet.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np
import torch

from ...ops import blake3_torch as BT
from ...ops import goldilocks as G
from ...ops import goldilocks_torch as FT
from . import params
from .columns import all_labels
from .merkle import ColumnCommit, MerkleTree, hash_field_leaves_labeled
from .proof import ColumnRoot, Opening

# From this many rows up, column hashing and chunk trees run on the device.
DEVICE_HASH_MIN = 1 << 13


def _label_prefix(lb: str) -> bytes:
    return params.DS_COL_LEAF.encode() + struct.pack("<I", len(lb)) + lb.encode()


class ColumnEngine:
    """In-memory engine over host TraceColumns `tc`; `device` is where the
    resident commitments live (a torch device; the CPU only when asked)."""

    def __init__(
        self,
        tc,
        chunk_log2: int = params.COL_CHUNK_LOG2,
        device=None,
        device_hash_min: int = DEVICE_HASH_MIN,
    ):
        self.tc = tc
        self.chunk_log2 = chunk_log2
        self.device = torch.device("cuda" if device is None else device)
        self.device_hash_min = device_hash_min
        self._n = tc.n
        self.labels = all_labels(tc.tau)
        self._commits: Dict[str, ColumnCommit] = {}
        # device mode state
        self._dev = False
        self._dev_cvs = None  # int32 [C, 8, n] leaf CV planes (device-resident)
        self._dev_label_idx: Dict[str, int] = {}
        self._croots: Dict[str, np.ndarray] = {}
        self._outer: Dict[str, MerkleTree] = {}

    @property
    def n_rows(self) -> int:
        return self._n

    def _commit(self, label: str) -> ColumnCommit:
        cc = self._commits.get(label)
        if cc is None:
            vals = self.tc.column_by_label(label)
            leaves = hash_field_leaves_labeled(G.to_le_bytes(vals), label)
            cc = ColumnCommit.from_hashed_leaves(leaves, self.chunk_log2)
            self._commits[label] = cc
        return cc

    def build_roots(self) -> List[ColumnRoot]:
        """Outer roots for every column in canonical label order."""
        if (
            not self._dev
            and not self._commits
            and self._n >= self.device_hash_min
            and self._n % (1 << self.chunk_log2) == 0
        ):
            self._build_device()
        if self._dev:
            return [ColumnRoot(lb, self._outer[lb].root()) for lb in self.labels]
        return [ColumnRoot(lb, self._commit(lb).root()) for lb in self.labels]

    def _build_device(self) -> None:
        vals = np.stack([self.tc.column_by_label(lb) for lb in self.labels])
        cvs, roots = BT.columns_commit_device(
            FT.pack(vals, self.device),
            [_label_prefix(lb) for lb in self.labels],
            self.chunk_log2,
        )
        croots = BT.croots_to_host(roots)
        for i, lb in enumerate(self.labels):
            self._croots[lb] = croots[i]
            self._outer[lb] = MerkleTree.from_leaves(croots[i])
        self._dev_cvs = cvs
        self._dev_label_idx = {lb: i for i, lb in enumerate(self.labels)}
        self._dev = True

    def open(self, label: str, row_idx: int) -> Opening:
        if self._dev:
            return self.open_batch([(label, row_idx)])[0]
        cc = self._commit(label)
        ci, ii, chunk_root, path_in, path_out = cc.open(row_idx)
        value_le = G.to_le_bytes(self.tc.column_by_label(label)[row_idx]).tobytes()
        return Opening(
            value_le=value_le,
            index=row_idx,
            chunk_index=ci,
            index_in_chunk=ii,
            chunk_root=chunk_root,
            path_in_chunk=path_in,
            path_to_chunk=path_out,
        )

    def open_batch(self, requests) -> List[Opening]:
        """Answer many (label, row) openings; in device mode the inner-chunk
        paths for ALL requests are extracted in one batched device pass."""
        if not self._dev:
            return [self.open(lb, r) for lb, r in requests]

        chunk = 1 << self.chunk_log2
        k = len(requests)
        cols = np.empty(k, dtype=np.int64)
        starts = np.empty(k, dtype=np.int64)
        idxs = np.empty(k, dtype=np.int64)
        for i, (lb, row) in enumerate(requests):
            ci = row // chunk
            cols[i] = self._dev_label_idx[lb]
            starts[i] = ci * chunk
            idxs[i] = row - ci * chunk
        paths, _roots = BT.chunk_paths_device(
            self._dev_cvs, cols, starts, idxs, self.chunk_log2
        )

        out: List[Opening] = []
        for i, (lb, row) in enumerate(requests):
            ci = row // chunk
            ii = row - ci * chunk
            out.append(
                Opening(
                    value_le=G.to_le_bytes(self.tc.column_by_label(lb)[row]).tobytes(),
                    index=row,
                    chunk_index=ci,
                    index_in_chunk=ii,
                    chunk_root=self._croots[lb][ci].tobytes(),
                    path_in_chunk=[paths[i, l].tobytes() for l in range(self.chunk_log2)],
                    path_to_chunk=self._outer[lb].open(ci),
                )
            )
        return out
