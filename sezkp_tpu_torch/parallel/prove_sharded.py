"""The fully sharded STARK v1 hot path: composition, DEEP coset LDE and FRI
across the ranks of a 1-D world.

Counterpart of sezkp_tpu/parallel/prove_sharded.py. One rank is one process
that owns one device; what the JAX package writes as two SPMD programs is
plain code here, run by every rank on its own shard, with the collectives of
parallel/mesh.py in JAX's schedule:

phase 1 (``ShardedPipeline.deep_lde_fri``):
  - this rank's [C, n/D] column slab: derived from the raw movement logs
    of its rows (``columns_device.DeviceColumns`` with ``rows``, when the
    blocks are given) or cut from the host columns;
  - the AIR composition and the ZK masks on those rows
    (``columns_device.compose_slabs``); the next-row values across the
    shard boundary come from one ``ppermute`` halo a slab (mv, head);
  - the distributed INTT (an all-to-all into the four-step's column shards,
    then ``ntt_sharded.build_sharded_ntt``: K2/K3 and one all-to-all), the
    coset scale shift^k, the coefficient relayout into the forward
    four-step's column shards (two all-to-alls, exact because D * ln2
    divides n; O(n/D) a rank), the forward four-step on the blown-up domain,
    the DEEP divide by (x - z), and one all-to-all to natural order;
  - the layer-0 subtree of this rank's LDE shard (K1), its root all-gathered.

phase 2 (``ShardedFri.commit_rest``, after the Fiat-Shamir betas are known):
  - every device-scale fold (``_fold_layer_local``: low + beta * high, the
    halves exchanged by four half-shard ``ppermute``s), each folded layer's
    subtree (K1), the subtree roots all-gathered once and the last device
    layer (2^MIN_DEVICE_LAYER_LOG2 values) all-gathered for the host tail.

The host builds each layer's top tree over the D subtree roots, folds the
tail and answers the queries: every rank plans the same requests, gathers
the values and subtree paths it owns, and two all-gathers (values, paths)
give every rank all of them. Proof bytes are those of the single-card
prover.

Subtrees are kept whole, or from LDE domains of 2^``tops_min_log2`` up
("tops" mode) only from the 2^CHUNK_LOG2-leaf chunk roots up
(``fri_device._chunk_tops``); an opened chunk is then hashed anew on its
owner (K1). The JAX package's environment variable
``SEZKP_SHARDED_TOPS_MIN_LOG2`` is the keyword ``tops_min_log2`` here.

Not carried: ``_split_programs`` / ``SEZKP_SPLIT_PROGRAMS``, the ``_jit_*``
program wrappers and ``sync_execute``: they answer XLA:CPU compile times and
compile skew between processes, and the port compiles no program. Nor are
the n-entry INTT and ln-entry LDE twiddle tables that JAX replicates: the
local phases build the slices a rank needs from two tables of about sqrt(n)
powers (``ntt_torch._pow_table``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import blake3_torch as BT
from ..ops import goldilocks as G
from ..ops import goldilocks_torch as FT
from ..ops import ntt as ntt_host
from ..ops import ntt_torch as NT
from ..stark.v1.columns_device import (
    COMPOSE_SCAN_MIN_LOG2,
    COMPOSE_SEG_LOG2,
    DeviceColumns,
    compose_args,
    compose_slabs,
)
from ..stark.v1.fri_device import SEG_LOG2, _assemble, _chunk_tops, _plan, _tree_levels
from ..stark.v1.proof import FriQuery
from .mesh import Mesh, all_gather_tiled, all_to_all_tiled, make_global, ppermute
from .ntt_sharded import build_sharded_ntt

# Device FRI layers stop when a layer drops below this size; the remaining
# tail folds on the host (as fri_device.MIN_DEVICE_LAYER_LOG2).
MIN_DEVICE_LAYER_LOG2 = 11
# Tops mode: subtree levels below this are not kept; a queried chunk's
# in-chunk path is recomputed from its 2^CHUNK_LOG2 values on its owner.
CHUNK_LOG2 = 11
# LDE size (log2) from which tops mode is the default (the JAX default of
# SEZKP_SHARDED_TOPS_MIN_LOG2).
TOPS_MIN_LOG2 = 20


def rank_columns(mesh: Mesh, blocks) -> DeviceColumns:
    """This rank's DeviceColumns: the raw inputs of its n/D rows on its
    device, whose `.planes` is its [C, n/D] column slab."""
    nloc = sum(b.n_steps for b in blocks) // mesh.size
    return DeviceColumns(blocks, mesh.device, rows=(mesh.rank * nloc, (mesh.rank + 1) * nloc))


# ------------------------------- geometry ----------------------------------


def check_world(d: int, base_log2: int, blow_log2: int) -> None:
    """The fully sharded prover needs a power-of-two world with D * ln2 | n
    (the coefficient relayout; then D also divides every four-step factor
    and the last device FRI layer). Raises ValueError otherwise."""
    ln_log2 = base_log2 + blow_log2
    ln2 = 1 << (ln_log2 - ln_log2 // 2)
    if d < 1 or d & (d - 1) or (1 << base_log2) % (d * ln2):
        raise ValueError(
            f"the fully sharded prover needs a power-of-two world size D with D * ln2 | n "
            f"(n = 2^{base_log2}, ln2 = 2^{ln_log2 - ln_log2 // 2}); the world has D = {d}"
        )


def _tables(base_log2: int, blow_log2: int, d: int, shift: int, device) -> dict:
    """The tables of phase 1 (JAX ``_tables``' sqrt-size and
    n/D-size entries), int64 field tensors on `device`: the coset scale
    shift^k = s1[k1] * s2[k2] (k = k1 + n1*k2), the DEEP points
    x_k = x1[k1'] * x2[k2'] (k = k1' + ln1*k2'), and the base-domain points
    of the rows, w^i = xs_loc[i % (n/D)] * xs_dev[i // (n/D)]. The
    n-entry INTT and ln-entry LDE twiddles are not built: the local phases
    take slices from two tables of about sqrt(n) powers."""
    ln_log2 = base_log2 + blow_log2
    b1, l1 = base_log2 // 2, ln_log2 // 2
    b2, l2 = base_log2 - b1, ln_log2 - l1
    p = int(G.P)
    w_base = int(G.primitive_root_2exp(base_log2))
    w_lde = int(G.primitive_root_2exp(ln_log2))
    nloc = (1 << base_log2) // d
    dev = torch.device(device)

    def cached(name, make):
        return NT._cached(("sharded_" + name, base_log2, blow_log2, d, shift), dev, make)

    return dict(
        b1=b1, b2=b2, l1=l1, l2=l2,
        s1=cached("s1", lambda: ntt_host.powers(np.uint64(shift), 1 << b1)),
        s2=cached("s2", lambda: ntt_host.powers(np.uint64(pow(shift, 1 << b1, p)), 1 << b2)),
        x1=cached("x1", lambda: G.mul(np.uint64(shift), ntt_host.powers(np.uint64(w_lde), 1 << l1))),
        x2=cached("x2", lambda: ntt_host.powers(np.uint64(pow(w_lde, 1 << l1, p)), 1 << l2)),
        xs_loc=cached("xs_loc", lambda: NT._pow_table(
            base_log2, torch.arange(nloc, dtype=torch.int64, device=dev), False)),
        xs_dev=cached("xs_dev", lambda: ntt_host.powers(np.uint64(pow(w_base, nloc, p)), d)),
    )


# ------------------------------- phase 1 -----------------------------------


def _halo_next(mesh: Mesh, slab: torch.Tensor) -> torch.Tensor:
    """The next rank's first column of a [tau, n/D] slab (rank D - 1 gets
    rank 0's: the trace wraps), by one ppermute (i -> i - 1)."""
    d = mesh.size
    return ppermute(slab[:, :1].contiguous(), mesh, [(i, (i - 1) % d) for i in range(d)])


def _phase1(mesh: Mesh, cols: torch.Tensor, tau: int, a, mc, z: int, base_log2: int,
            blow_log2: int, shift: int) -> torch.Tensor:
    """This rank's [C, n/D] column slab -> its shard of the DEEP coset LDE in
    natural order (int64 [ln/D], global indices rank*ln/D onwards)."""
    d, r = mesh.size, mesh.rank
    t = _tables(base_log2, blow_log2, d, shift, mesh.device)
    b1, b2, l1, l2 = t["b1"], t["b2"], t["l1"], t["l2"]
    n, ln = 1 << base_log2, 1 << (base_log2 + blow_log2)
    n1, n2, ln1, ln2 = 1 << b1, 1 << b2, 1 << l1, 1 << l2
    dev = mesh.device

    # the composition: the last row's next-row values are the next rank's
    # first column (the trace wraps at rank D - 1), one ppermute halo a slab
    m0, h0 = 3, 3 + 3 * tau  # mv and head rows in all_labels order
    seg_log2 = COMPOSE_SEG_LOG2 if cols.shape[1] >= (1 << COMPOSE_SCAN_MIN_LOG2) else None
    comp = compose_slabs(cols, tau, a, mc, FT.mul(t["xs_loc"], t["xs_dev"][r]),
                         _halo_next(mesh, cols[m0 : m0 + tau]), _halo_next(mesh, cols[h0 : h0 + tau]),
                         seg_log2)
    del cols

    # ---- distributed INTT: contiguous rows -> the four-step's columns ----
    y = all_to_all_tiled(comp.reshape(n1 // d, n2), mesh, 1, 0)  # [n1, n2/D]
    del comp
    y = build_sharded_ntt(mesh, b1, b2, inverse=True)(y)  # [n1/D, n2], times n^-1
    # coset scale shift^k, coefficient index k = k1 + n1*k2
    k1 = r * (n1 // d) + torch.arange(n1 // d, dtype=torch.int64, device=dev)
    y = FT.mul(y, FT.mul(t["s1"][k1][:, None], t["s2"][None, :]))

    # ---- coefficients into the forward four-step's column shards ----
    # k2-sharded first: each rank then holds the contiguous coefficients
    # [r*n/D, (r+1)*n/D), viewed as rows j1 of ln2 (D * ln2 | n), whose
    # columns j2 go to their owners.
    y = all_to_all_tiled(y, mesh, 1, 0)  # [n1, n2/D]: all k1, this rank's k2
    c = y.t().contiguous().reshape(n // (d * ln2), ln2)
    del y
    c = all_to_all_tiled(c, mesh, 1, 0)  # [n/ln2, ln2/D]
    a2 = torch.zeros((ln1, ln2 // d), dtype=torch.int64, device=dev)
    a2[: n // ln2] = c
    del c

    # ---- forward NTT on the blown-up domain, DEEP divide by (x - z) ----
    y = build_sharded_ntt(mesh, l1, l2, inverse=False)(a2)  # [ln1/D, ln2]
    del a2
    k1 = r * (ln1 // d) + torch.arange(ln1 // d, dtype=torch.int64, device=dev)
    xk = FT.mul(t["x1"][k1][:, None], t["x2"][None, :])
    y = NT.deep_divide(y.contiguous(), z, xk)
    del xk

    # ---- natural order: k2'-major rows are the flat domain ----
    return all_to_all_tiled(y.t().contiguous(), mesh, 0, 1).reshape(ln // d)


# ----------------------------- local subtrees ------------------------------


class _LocalTree:
    """One FRI layer's values on this rank (int64 [m], m = 2^s) and their
    subtree: every level side by side ([8, 2m - 1], leaves first), or in
    tops mode from s >= CHUNK_LOG2 the levels from the chunk roots up
    ([8, 2K - 1], K = m >> CHUNK_LOG2). The last column is the root."""

    def __init__(self, vals: torch.Tensor, tops: bool):
        self.vals = vals
        self.m = int(vals.shape[0])
        self.s = self.m.bit_length() - 1
        self.chunked = tops and self.s >= CHUNK_LOG2
        if self.chunked:
            self.nodes = _chunk_tops(vals, SEG_LOG2)
        else:
            self.nodes = torch.cat(_tree_levels(vals), dim=1)

    def root(self) -> torch.Tensor:
        return self.nodes[:, -1]  # [8]

    def paths(self, idx: torch.Tensor) -> torch.Tensor:
        """The sibling nodes of local leaves idx (int64 [k]) from the leaf
        level up to below the root: int32 [k, s, 8]."""
        lev0 = CHUNK_LOG2 if self.chunked else 0
        parts = []
        if self.chunked:
            mask = (1 << CHUNK_LOG2) - 1
            starts, rows = torch.unique(idx & ~mask, return_inverse=True)
            chunks = self.vals[starts[:, None] + torch.arange(mask + 1, device=idx.device)[None, :]]
            cvs = BT.hash_leaves_u64_planes(chunks.reshape(-1), b"")
            planes, _ = BT._path_planes_from_leaf_cvs(cvs, idx & mask, CHUNK_LOG2, rows=rows)
            parts.append(planes.permute(2, 0, 1))  # [k, CHUNK_LOG2, 8]
        base = self.m >> lev0  # nodes at the first kept level
        levs = torch.arange(self.s - lev0, dtype=torch.int64, device=idx.device)
        if levs.numel():
            # level j of the kept ones starts at column 2*base - 2*(base >> j)
            cols = (2 * base - 2 * (base >> levs))[None, :] + (((idx >> lev0)[:, None] >> levs[None, :]) ^ 1)
            parts.append(self.nodes[:, cols].permute(1, 2, 0))  # [k, s - lev0, 8]
        return torch.cat(parts, dim=1) if parts else torch.zeros(
            (idx.shape[0], 0, 8), dtype=torch.int32, device=idx.device)


def _fold_layer_local(cur: torch.Tensor, beta: int, mesh: Mesh) -> torch.Tensor:
    """One FRI fold of a layer sharded in rank order: y' = low + beta * high
    (the sharded stark/v1/fri.fold). With D > 1 the new layer's shard t
    takes its low half from rank t // 2 and its high half from rank
    D/2 + t // 2 (half t % 2 of each): four half-shard ppermutes, every
    destination of one of them once."""
    h = cur.shape[0] // 2
    d = mesh.size
    if d == 1:
        low, high = cur[:h], cur[h:]
    else:
        h0, h1 = cur[:h].contiguous(), cur[h:].contiguous()
        half = d // 2
        # disjoint destinations: of each pair one is zero, so + is the merge
        low = (ppermute(h0, mesh, [(j, 2 * j) for j in range(half)])
               + ppermute(h1, mesh, [(j, 2 * j + 1) for j in range(half)]))
        high = (ppermute(h0, mesh, [(half + j, 2 * j) for j in range(half)])
                + ppermute(h1, mesh, [(half + j, 2 * j + 1) for j in range(half)]))
    return FT.add(low, FT.mul(FT.scalar(beta, cur), high))


def _cv_rows(planes: np.ndarray) -> np.ndarray:
    """int32 [..., 8] CV words -> uint8 [..., 32] digests."""
    w = np.ascontiguousarray(planes).astype("<u4", copy=False)
    return w.view(np.uint8).reshape(w.shape[:-1] + (32,))


# ------------------------------- the FRI engine ----------------------------


class ShardedFri:
    """FRI engine whose layers, folds and subtrees are sharded over the
    ranks; the same interface as stark/v1/fri_device.DeviceFri
    (commit_layer0 / commit_rest / final_value_le / open_queries) and the
    bytes of the host fri.py. Every rank holds an equal engine and gets the
    same roots and queries."""

    def __init__(self, mesh: Mesh, ln_log2: int, tree0: _LocalTree, roots0: np.ndarray,
                 tops: bool):
        self.mesh = mesh
        self.ln_log2 = ln_log2
        self.n = 1 << ln_log2
        self.tops = tops
        self._trees: Dict[int, _LocalTree] = {0: tree0}  # device layer -> this rank's subtree
        self._roots0 = roots0  # uint8 [D, 32] layer-0 subtree roots
        self._top_trees: Dict[int, object] = {}
        self._dev_layers = 0
        self._host_layers: Dict[int, np.ndarray] = {}
        self._host_trees: Dict[int, object] = {}
        self._final_value: Optional[int] = None

    def commit_layer0(self) -> bytes:
        from ..stark.v1.merkle import MerkleTree

        self._top_trees[0] = MerkleTree.from_leaves(self._roots0)
        return self._top_trees[0].root()

    def commit_rest(self, betas: List[int]) -> List[bytes]:
        from ..stark.v1 import fri as host_fri
        from ..stark.v1.merkle import MerkleTree

        L = self._dev_layers = max(1, self.ln_log2 - MIN_DEVICE_LAYER_LOG2)
        with self.mesh.tally.scoped("phase2"):
            cur = self._trees[0].vals
            for l in range(1, L + 1):
                cur = _fold_layer_local(cur, betas[l - 1], self.mesh)
                self._trees[l] = _LocalTree(cur, self.tops)
            roots = torch.stack([self._trees[l].root() for l in range(1, L + 1)])  # [L, 8]
            roots = all_gather_tiled(roots[:, None], self.mesh, 1).cpu().numpy()  # [L, D, 8]
            tail = FT.unpack(all_gather_tiled(cur, self.mesh, 0)).copy()
        out = []
        for l in range(1, L + 1):
            self._top_trees[l] = MerkleTree.from_leaves(_cv_rows(roots[l - 1]))
            out.append(self._top_trees[l].root())

        # host tail: fold the remaining small layers from the last device layer
        layer = L
        while tail.shape[0] > 1:
            tail = host_fri.fold(tail, betas[layer])
            layer += 1
            tree = host_fri.layer_tree(tail)
            self._host_layers[layer] = tail
            self._host_trees[layer] = tree
            out.append(tree.root())
        self._final_value = int(tail[0])
        return out

    def final_value_le(self) -> bytes:
        return int(self._final_value).to_bytes(8, "little")

    def open_queries(self, fri_rows: List[int]) -> List[FriQuery]:
        """Every rank plans the same requests (a device layer's leaf: its
        value and its path), answers those whose leaf it owns, and two
        all-gathers (values, paths; each rank's part padded to the largest)
        give every rank all answers. Bit-identical to fri.fri_open_query."""
        L = self._dev_layers
        req_seq: Dict[Tuple[int, int], int] = {}  # (layer, index) -> request number

        def plan_value(layer: int, idx: int):
            if layer > L:
                return ("hostlayer", (layer, idx))
            return ("req", req_seq.setdefault((layer, idx), len(req_seq)))

        def plan_path(layer: int, layer_len: int, target: int):
            if layer > L:
                return ("hosttree", layer, target)
            return ("req", req_seq.setdefault((layer, target), len(req_seq)), layer, target)

        plans = _plan(self.ln_log2, fri_rows, plan_value, plan_path)

        # each request's owner and its place in the owner's answers
        d, r = self.mesh.size, self.mesh.rank
        counts = [0] * d
        row: Dict[int, int] = {}  # request number -> row of the gathered answers, before padding
        mine: Dict[int, List[Tuple[int, int]]] = {}  # layer -> [(local index, place)]
        for (layer, idx), q in req_seq.items():
            s = self._trees[0].s - layer  # every layer's shard is the LDE's >> layer
            owner = idx >> s
            row[q] = (owner, counts[owner])
            if owner == r:
                mine.setdefault(layer, []).append((idx & ((1 << s) - 1), counts[owner]))
            counts[owner] += 1
        width = max(counts)
        depth = self._trees[0].s
        dev = self.mesh.device
        vals = torch.zeros(width, dtype=torch.int64, device=dev)
        paths = torch.zeros((width, depth, 8), dtype=torch.int32, device=dev)
        with self.mesh.tally.scoped("open"):
            for layer, items in mine.items():
                tree = self._trees[layer]
                idx = BT._as_index([i for i, _ in items], dev)
                place = BT._as_index([p for _, p in items], dev)
                vals[place] = tree.vals[idx]
                paths[place, : tree.s] = tree.paths(idx)
            vals_all = FT.unpack(all_gather_tiled(vals, self.mesh, 0))
            paths_all = _cv_rows(all_gather_tiled(paths, self.mesh, 0).cpu().numpy())  # [D*width, depth, 32]

        def value_bytes(ref) -> bytes:
            if ref[0] == "hostlayer":
                layer, idx = ref[1]
                return int(self._host_layers[layer][idx]).to_bytes(8, "little")
            owner, place = row[ref[1]]
            return int(vals_all[owner * width + place]).to_bytes(8, "little")

        def path_bytes(ref) -> List[bytes]:
            if ref[0] == "hosttree":
                _, layer, target = ref
                return self._host_trees[layer].open(target)
            _, q, layer, target = ref
            owner, place = row[q]
            s = self._trees[layer].s
            local = paths_all[owner * width + place, :s]
            return [node.tobytes() for node in local] + self._top_trees[layer].open(target >> s)

        return _assemble(plans, value_bytes, path_bytes)


# ------------------------------- the pipeline ------------------------------


class ShardedPipeline:
    """Composition + DEEP coset LDE + FRI of a proof across the ranks of
    `mesh`; prove_v1 reaches it through ShardedProverEngine.deep_lde_fri.

    `blocks`: the raw block summaries, from which each rank derives its own
    column slab (no [C, n] matrix anywhere); without them the host columns of
    `tc` are cut into row shards. `raw_args`: the rank's DeviceColumns
    (rank_columns), shared with the row-wise commitments; made here when
    None. Read only with `blocks`.
    `tops_min_log2`: LDE size (log2) from which the subtrees keep only their
    levels from the 2^CHUNK_LOG2-leaf chunk roots up. `shift` is the JAX
    signature's; the coset shift is deep_lde_fri's, as there."""

    def __init__(self, mesh: Mesh, tc, shift: int = 3, blocks=None,
                 raw_args: Optional[DeviceColumns] = None, tops_min_log2: int = TOPS_MIN_LOG2):
        self.mesh = mesh
        self.d = mesh.size
        self.tc = tc
        self.blocks = blocks
        self.raw_args = raw_args
        self.tops_min_log2 = tops_min_log2

    def _cols(self) -> torch.Tensor:
        """This rank's [C, n/D] column slab on its device."""
        if self.blocks is not None:
            dc = self.raw_args if self.raw_args is not None else rank_columns(self.mesh, self.blocks)
            cols = dc.planes
            dc.release_planes()  # the slab lives only as long as phase 1 holds it
            return cols
        from ..stark.v1.columns import all_labels

        tc = self.tc
        cols = np.empty((len(all_labels(tc.tau)), tc.n), dtype=np.uint64)
        for i, lb in enumerate(all_labels(tc.tau)):
            cols[i] = tc.column_by_label(lb)
        return make_global(self.mesh, 1, cols)

    def deep_lde_fri(self, alphas, mask_coeffs, blow_log2: int, shift: int, z: int) -> ShardedFri:
        n = self.tc.n
        base_log2 = n.bit_length() - 1
        ln_log2 = base_log2 + blow_log2
        check_world(self.d, base_log2, blow_log2)
        mesh = self.mesh
        a, mc = compose_args(alphas, mask_coeffs, mesh.device)
        tops = ln_log2 >= self.tops_min_log2
        with mesh.tally.scoped("phase1"):
            lde = _phase1(mesh, self._cols(), self.tc.tau, a, mc, z, base_log2, blow_log2, shift)
            tree0 = _LocalTree(lde, tops)
            roots0 = all_gather_tiled(tree0.root()[None], mesh, 0).cpu().numpy()  # [D, 8]
        return ShardedFri(mesh, ln_log2, tree0, _cv_rows(roots0), tops)
