"""Column commitment engine: chunked roots + openings.

Counterpart of ``ColumnEngine`` in sezkp_tpu/stark/v1/openings.py. Two
sources of column values:

- host ``TraceColumns`` (`tc`): from ``device_hash_min`` rows up the columns
  are uploaded once and committed on the device; below it everything runs on
  the host;
- ``DeviceColumns`` (`dc`): the columns were derived on the device and are
  hashed, committed and opened there; opened values are gathered there too.

On the card kernel K13 hashes the columns and builds their chunk trees in
one launch (blake3_torch.chunk_roots); the leaf CVs stay resident, only
chunk roots (KBs) and opening paths (KBs, rebuilt with kernel K1) come back,
and the outer trees over the chunk roots are built on the host. With `dc`,
when the leaf CVs (C * n * 32 bytes) would exceed ``cv_budget_bytes`` the
commitment keeps the chunk roots only and the openings recompute the queried
chunks' trees: from the column matrix while it is resident, else from ranges
derived anew from the raw inputs. Roots and paths are bit-identical on every route (reference:
crates/sezkp-stark/src/v1/openings.rs).

``StreamingColumnEngine`` (the streaming prove's) is host code, copied from
the JAX package: it hashes one chunk of 2^COL_CHUNK_LOG2 rows at a time from
the blocks (columns_stream.py), below ``DEVICE_HASH_MIN``.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np
import torch

from ...ops import blake3_torch as BT
from ...ops import goldilocks as G
from ...ops import goldilocks_torch as FT
from ...utils import tracing
from ...utils.tracing import LAUNCH, WAIT, span
from . import params
from .columns import all_labels
from .merkle import ColumnCommit, MerkleTree, hash_field_leaves_labeled
from .proof import ColumnRoot, Opening

# From this many rows up, column hashing and chunk trees run on the device.
DEVICE_HASH_MIN = 1 << 13


# Leaf CVs stay resident up to this many bytes (C * n * 32): 16 GiB holds
# the 59 columns of T = 2^22 (7.9 GB) beside the LDE and FRI layers of that
# size on an 80 GB card.
CV_BUDGET_BYTES = 16 << 30


def _label_prefix(lb: str) -> bytes:
    return params.DS_COL_LEAF.encode() + struct.pack("<I", len(lb)) + lb.encode()


class ColumnEngine:
    """In-memory engine over host TraceColumns `tc`, or over DeviceColumns
    `dc` (then `tc` may be None). `device` is where the resident commitments
    live (a torch device; the CPU only when asked); with `dc` it is dc's."""

    def __init__(
        self,
        tc,
        chunk_log2: int = params.COL_CHUNK_LOG2,
        device=None,
        device_hash_min: int = DEVICE_HASH_MIN,
        dc=None,
        cv_budget_bytes: int = CV_BUDGET_BYTES,
    ):
        self.tc = tc
        self._dc = dc
        self.chunk_log2 = chunk_log2
        if dc is not None:
            if dc.n % (1 << chunk_log2):
                raise ValueError("device columns need a whole number of chunks")
            self.device = dc.device
        else:
            self.device = torch.device("cuda" if device is None else device)
        self.device_hash_min = device_hash_min
        self.cv_budget_bytes = cv_budget_bytes
        self._n = dc.n if dc is not None else tc.n
        self.labels = all_labels(dc.tau if dc is not None else tc.tau)
        self._commits: Dict[str, ColumnCommit] = {}
        # device mode state
        self._dev = False
        self._dev_cvs = None  # int32 [C, 8, n] leaf CV planes (device-resident)
        self._label_idx = {lb: i for i, lb in enumerate(self.labels)}
        self._prefixes = [_label_prefix(lb) for lb in self.labels]
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
        if not self._dev and not self._commits and (
            self._dc is not None
            or (self._n >= self.device_hash_min and self._n % (1 << self.chunk_log2) == 0)
        ):
            self._build_device()
        if self._dev:
            return [ColumnRoot(lb, self._outer[lb].root()) for lb in self.labels]
        return [ColumnRoot(lb, self._commit(lb).root()) for lb in self.labels]

    def _build_device(self) -> None:
        prefixes = self._prefixes
        if self._dc is None:
            with span("commit.stack"):
                vals = np.stack([self.tc.column_by_label(lb) for lb in self.labels])
            with span("commit.upload", WAIT):
                vals = FT.pack(vals, self.device)
            with span("commit.hash", LAUNCH):
                cvs, roots = BT.columns_commit_from_planes(vals, prefixes, self.chunk_log2)
        else:
            with span("commit.hash", LAUNCH):
                if len(self.labels) * self._n * 32 <= self.cv_budget_bytes:
                    cvs, roots = BT.columns_commit_from_planes(
                        self._dc.planes, prefixes, self.chunk_log2
                    )
                else:
                    cvs = None
                    with span("commit.scan", LAUNCH):
                        roots = BT.columns_commit_roots_scan(self._dc.planes, prefixes,
                                                             self.chunk_log2,
                                                             counter="commit.scan_segments")
        with span("commit.pull_roots", WAIT):
            croots = BT.croots_to_host(roots)
        with span("commit.outer_trees"):
            for i, lb in enumerate(self.labels):
                self._croots[lb] = croots[i]
                self._outer[lb] = MerkleTree.from_leaves(croots[i])
        self._dev_cvs = cvs
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
        cols = np.array([self._label_idx[lb] for lb, _ in requests], dtype=np.int64)
        rows = np.array([row for _, row in requests], dtype=np.int64)
        starts = (rows // chunk) * chunk
        idxs = rows - starts
        if self._dev_cvs is not None:
            with span("air_openings.upload", WAIT):
                index = [BT._as_index(a, self.device) for a in (cols, starts, idxs)]
                if self._dc is not None:
                    flat = BT._as_index(cols * self._n + rows, self.device)
            with span("air_openings.paths", LAUNCH):
                planes, _roots = BT.chunk_path_planes(self._dev_cvs, *index, self.chunk_log2)
                if self._dc is not None:
                    gathered = self._dc.planes.reshape(-1)[flat]
            with span("air_openings.pull", WAIT):
                paths = BT.path_planes_to_bytes(planes, len(requests), self.chunk_log2)
                if self._dc is not None:
                    values = FT.unpack(gathered)
            if self._dc is None:  # host columns: the values are read on the host
                values = [self.tc.column_by_label(lb)[row] for lb, row in requests]
        else:
            # no resident CVs: rebuild each distinct queried (column, chunk)
            # tree once, from the column matrix while it is resident, else
            # from the queried ranges derived anew from the raw inputs
            with span("air_openings.recompute", WAIT):
                keys, trees = np.unique(cols * self._n + starts, return_inverse=True)
                k_cols, k_starts = keys // self._n, keys % self._n
                tracing.count("openings.rebuilt_chunks", len(keys))
                order, bounds = BT.prefix_groups([self._prefixes[c] for c in k_cols])
                resident = self._dc.planes_resident
                if resident:  # a chunk's row of the planes' [C * n / chunk, chunk] view
                    uniq, src = np.zeros(0, np.int64), keys // chunk
                else:  # a chunk's row of the derived ranges' [S * C, chunk] view
                    uniq, sel = np.unique(k_starts, return_inverse=True)
                    src = sel.reshape(-1) * len(self.labels) + k_cols
                arrays = [uniq, src, order, trees.reshape(-1), idxs]
                uniq_t, src_t, order_t, trees_t, idxs_t = torch.split(  # one upload
                    BT._as_index(np.concatenate(arrays), self.device), [len(a) for a in arrays])
                if resident:
                    table = self._dc.planes.reshape(-1, chunk)
                else:
                    with span("air_openings.derive_ranges", LAUNCH, sync=True):
                        table = self._dc.derive_ranges(uniq_t, chunk).reshape(-1, chunk)
                with span("air_openings.rehash", LAUNCH, sync=True):
                    planes, _roots, opened = BT.chunk_tree_planes(
                        table[src_t], order_t, bounds, trees_t, idxs_t, self.chunk_log2)
                paths = BT.path_planes_to_bytes(planes, len(requests), self.chunk_log2)
                values = FT.unpack(opened)

        with span("air_openings.assemble"):
            out: List[Opening] = []
            for i, (lb, row) in enumerate(requests):
                ci = row // chunk
                out.append(
                    Opening(
                        value_le=int(values[i]).to_bytes(8, "little"),
                        index=row,
                        chunk_index=ci,
                        index_in_chunk=row - ci * chunk,
                        chunk_root=self._croots[lb][ci].tobytes(),
                        path_in_chunk=[paths[i, l].tobytes() for l in range(self.chunk_log2)],
                        path_to_chunk=self._outer[lb].open(ci),
                    )
                )
        return out


class StreamingColumnEngine:
    """Sublinear-memory column commitments: O(chunk) pending state while
    building roots, recompute-the-chunk on open.

    Equivalent of the reference's OnDemandOpenings (openings.rs:278-498) with
    the per-row hashing replaced by per-chunk batched hashing. Roots, paths,
    and openings are bit-identical to :class:`ColumnEngine` (cross-tested).
    """

    def __init__(self, blocks, chunk_log2: int = params.COL_CHUNK_LOG2):
        from .columns_stream import rows_of_range, stream_column_chunks

        self._stream_column_chunks = stream_column_chunks
        self._rows_of_range = rows_of_range
        self.blocks = blocks
        self.chunk_log2 = chunk_log2
        self.chunk_size = 1 << chunk_log2
        self.tau = blocks[0].tau if blocks else 0
        self.labels = all_labels(self.tau)
        self.n_rows = sum(b.n_steps for b in blocks)
        self._chunk_roots: Dict[str, "np.ndarray"] = {}
        self._outer: Dict[str, MerkleTree] = {}

    def build_roots(self) -> List[ColumnRoot]:
        import numpy as np

        per_label_roots: List[List[bytes]] = [[] for _ in self.labels]
        for chunk in self._stream_column_chunks(self.blocks, self.chunk_size):
            for li, label in enumerate(self.labels):
                leaves = hash_field_leaves_labeled(G.to_le_bytes(chunk[li]), label)
                per_label_roots[li].append(MerkleTree.from_leaves(leaves).root())
        out = []
        for li, label in enumerate(self.labels):
            roots = np.frombuffer(
                b"".join(per_label_roots[li]), dtype=np.uint8
            ).reshape(len(per_label_roots[li]), 32)
            self._chunk_roots[label] = roots
            outer = MerkleTree.from_leaves(roots)
            self._outer[label] = outer
            out.append(ColumnRoot(label, outer.root()))
        return out

    def open_batch(self, requests) -> List[Opening]:
        return [self.open(lb, r) for lb, r in requests]

    def open(self, label: str, row_idx: int) -> Opening:
        assert row_idx < self.n_rows, "row index out of range"
        if label not in self._outer:
            self.build_roots()
        ci = row_idx // self.chunk_size
        ii = row_idx - ci * self.chunk_size
        start = ci * self.chunk_size
        end = min(start + self.chunk_size, self.n_rows)
        li = self.labels.index(label)
        vals = self._rows_of_range(self.blocks, start, end)[li]
        leaves = hash_field_leaves_labeled(G.to_le_bytes(vals), label)
        inner = MerkleTree.from_leaves(leaves)
        return Opening(
            value_le=G.to_le_bytes(vals[ii]).tobytes(),
            index=row_idx,
            chunk_index=ci,
            index_in_chunk=ii,
            chunk_root=inner.root(),
            path_in_chunk=inner.open(ii),
            path_to_chunk=self._outer[label].open(ci),
        )
