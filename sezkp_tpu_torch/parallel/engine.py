"""Sharded v1 column-commitment engine: prove_v1 with its commitments
computed across the ranks.

Counterpart of the column-commitment half of sezkp_tpu/parallel/engine.py
(``ShardedColumnEngine``, ``prove_v1_sharded(..., commitments_only=True)``).
The 9*tau+3 trace columns are committed across the ranks (on the card by
kernel K13, ``blake3_torch.columns_commit_roots_scan``), in one of two ways:

- row-wise (when n % D == 0 and whole chunks fall to each rank): every rank
  derives its own [C, n/D] column slab from the raw movement logs of its
  rows (prove_sharded.rank_columns, a ``columns_device.DeviceColumns`` with
  ``rows``) and hashes its chunks of every column;
- column groups (otherwise): the columns, padded to a multiple of D with
  copies of column 0, are dealt out in contiguous groups and every rank
  hashes and chunk-commits its group.

The chunk roots are all-gathered and every rank builds the outer trees on
the host in canonical label order, so every rank's proof bytes equal the
single-card prover's. Openings recompute the target chunk on the host
(O(chunk) work per query), the same schedule as StreamingColumnEngine.

``ShardedProverEngine`` adds the rest of the hot path across the ranks
(composition, DEEP coset LDE and FRI: prove_sharded.ShardedPipeline), which
prove_v1 takes through its ``deep_lde_fri``; ``prove_v1_sharded`` builds it
by default.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from ..ops import blake3_torch as BT
from ..ops import goldilocks as G
from ..stark.v1 import params
from ..stark.v1.columns import all_labels
from ..stark.v1.merkle import MerkleTree, hash_field_leaves_labeled
from ..stark.v1.openings import _label_prefix
from ..stark.v1.proof import ColumnRoot, Opening
from .mesh import Mesh, all_gather_tiled, make_global
from .prove_sharded import TOPS_MIN_LOG2, check_world, rank_columns


class ShardedColumnEngine:
    """Drop-in for :class:`...stark.v1.openings.ColumnEngine` that computes
    every column's chunked commitment across the ranks of `mesh`."""

    def __init__(self, tc, mesh: Mesh, chunk_log2: int = params.COL_CHUNK_LOG2,
                 blocks=None):
        assert tc.n % (1 << chunk_log2) == 0, (
            "trace length must be a multiple of the column chunk"
        )
        self.tc = tc
        self.mesh = mesh
        self.chunk_log2 = chunk_log2
        self.blocks = blocks
        self.labels = all_labels(tc.tau)
        self.n_rows = tc.n
        self.rowwise = None  # which build ran: True row-wise, False column groups
        self._croots: Dict[str, np.ndarray] = {}
        self._outer: Dict[str, MerkleTree] = {}
        self._raw_args = None

    def raw_args(self):
        """This rank's DeviceColumns over its rows, built once a prove (None
        without blocks): the row-wise commitments and the sharded pipeline's
        phase 1 derive their slabs from the same raw inputs."""
        if self._raw_args is None and self.blocks is not None:
            self._raw_args = rank_columns(self.mesh, self.blocks)
        return self._raw_args

    def build_roots(self) -> List[ColumnRoot]:
        if not self._outer:
            self._build()
        return [ColumnRoot(lb, self._outer[lb].root()) for lb in self.labels]

    def _keep(self, croots: np.ndarray) -> None:
        """uint8 [C, n_chunks, 32] chunk roots in label order -> outer trees."""
        for i, lb in enumerate(self.labels):
            self._croots[lb] = croots[i]
            self._outer[lb] = MerkleTree.from_leaves(croots[i])

    def _build(self) -> None:
        d = self.mesh.size
        n = self.tc.n
        # Row-wise needs d | n (equal row counts per rank) AND whole chunks
        # per rank.
        if (
            self.blocks is not None
            and n % d == 0
            and (n // d) % (1 << self.chunk_log2) == 0
        ):
            self._build_rowwise()
            return
        self.rowwise = False
        c = len(self.labels)
        c_pad = -(-c // d) * d
        lo = self.mesh.rank * (c_pad // d)
        mine = [i if i < c else 0 for i in range(lo, lo + c_pad // d)]  # padding: column 0
        vals = np.stack([self.tc.column_by_label(self.labels[i]) for i in mine])
        roots = BT.columns_commit_roots_scan(
            make_global(self.mesh, None, vals),
            [_label_prefix(self.labels[i]) for i in mine], self.chunk_log2,
        )  # [C_pad / D, 8, n_chunks]
        roots = all_gather_tiled(roots, self.mesh, 0)  # [C_pad, 8, n_chunks]
        self._keep(BT.croots_to_host(roots[:c]))

    def _build_rowwise(self) -> None:
        """Row-sharded commit: derive + hash every column's local rows on the
        device from the raw logs; no host [C, n] matrix."""
        self.rowwise = True
        dc = self.raw_args()
        roots = BT.columns_commit_roots_scan(
            dc.planes, [_label_prefix(lb) for lb in self.labels], self.chunk_log2
        )  # [C, 8, n/D >> chunk_log2]
        dc.release_planes()  # phase 1 derives the slab anew
        self._keep(BT.croots_to_host(all_gather_tiled(roots, self.mesh, 2)))

    def open_batch(self, requests) -> List[Opening]:
        return [self.open(lb, r) for lb, r in requests]

    def open(self, label: str, row_idx: int) -> Opening:
        if not self._outer:
            self._build()
        chunk = 1 << self.chunk_log2
        ci = row_idx // chunk
        ii = row_idx - ci * chunk
        vals = self.tc.column_by_label(label)[ci * chunk : (ci + 1) * chunk]
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


class ShardedProverEngine(ShardedColumnEngine):
    """Column engine + the rest of the hot path across the ranks
    (composition, DEEP coset LDE, FRI folds and trees); prove_v1 finds
    `deep_lde_fri` and takes its FRI engine from it. `tops_min_log2`: as
    ShardedPipeline's."""

    def __init__(self, tc, mesh: Mesh, chunk_log2: int = params.COL_CHUNK_LOG2,
                 blocks=None, tops_min_log2: int = TOPS_MIN_LOG2):
        super().__init__(tc, mesh, chunk_log2, blocks)
        self.tops_min_log2 = tops_min_log2

    def deep_lde_fri(self, alphas, mask_coeffs, blow_log2: int, shift: int, z: int):
        from .prove_sharded import ShardedPipeline

        return ShardedPipeline(
            self.mesh, self.tc, blocks=self.blocks,
            raw_args=self.raw_args(),
            tops_min_log2=self.tops_min_log2,
        ).deep_lde_fri(alphas, mask_coeffs, blow_log2, shift, z)


def prove_v1_sharded(blocks, manifest_root: bytes, mesh: Mesh,
                     commitments_only: bool = False, timings=None,
                     tops_min_log2: int = TOPS_MIN_LOG2):
    """v1 proof across the ranks of `mesh`; every rank runs the whole prove
    and gets the same bytes, equal to the single-card `prove_v1`'s.

    By default the fully sharded prover: column commitments, AIR
    composition, the DEEP coset LDE (four-step NTTs with one all-to-all
    each) and every device FRI fold and layer tree run across the ranks
    (ShardedProverEngine). It needs a power-of-two world with D * ln2 | n
    and raises ValueError otherwise, before any collective.
    `commitments_only=True` shards only the column commitments (any world);
    the rest of the prove then runs on each rank's device on the
    host-columns route. `timings`: as prove_v1's (stages `sharded_phase1`,
    `sharded_fri_commit`, `sharded_open` in the full mode).
    `tops_min_log2`: LDE size (log2) from which the sharded subtrees keep
    only their levels from the 2^11-leaf chunk roots up."""
    from ..stark.v1.columns import TraceColumns
    from ..stark.v1.prover import prove_v1

    n = sum(b.n_steps for b in blocks)
    if not commitments_only:
        check_world(mesh.size, n.bit_length() - 1, params.BLOWUP.bit_length() - 1)
    t0 = time.perf_counter()
    tc = TraceColumns.build(blocks)
    if timings is not None:
        timings["host_columns"] = time.perf_counter() - t0
    if commitments_only:
        eng = ShardedColumnEngine(tc, mesh, blocks=blocks)
    else:
        eng = ShardedProverEngine(tc, mesh, blocks=blocks, tops_min_log2=tops_min_log2)
    return prove_v1(blocks, manifest_root, mesh.device, engine=eng, tc=tc, timings=timings)
