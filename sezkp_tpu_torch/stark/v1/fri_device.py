"""Device-resident FRI: folds, layer hashing, and tree building on the card.

Counterpart of sezkp_tpu/stark/v1/fri_device.py, with both of its modes:

- **resident** (domains below `chunked_min_log2`): every FRI layer's values
  and every level of its Merkle tree are computed on the device and stay
  there;
- **chunked, "tops-only"** (from `chunked_min_log2` up, default
  FRI_CHUNKED_MIN_LOG2): a layer's tree keeps only its levels of
  2^CHUNK_LOG2 leaves a node and above (a few MB at 2^27); on the card the
  chunk roots come from one launch of kernel K13 a layer, which keeps no
  message or leaf CV off chip (on the CPU 2^seg_log2 leaves at a time);
  the layer values stay resident, and the openings gather each
  queried 2^CHUNK_LOG2-leaf chunk from them and hash it anew (the
  reference's recompute-on-open schedule, fri_stream.rs:170-312), every
  distinct chunk once and the chunks of all layers in one batch.

Only the layer roots (a few hundred bytes; the chunked mode's top levels, a
few MB) and, later, the queried values and paths (tens of KB) come back to
the host. Both modes give the bytes of the host implementation in fri.py
(cross-tested).

Two phases are forced by the Fiat-Shamir schedule: betas depend on the
layer-0 root (fri.rs:51-68), so ``commit_layer0`` commits layer 0 and
``commit_rest`` takes the derived betas and produces everything else.

Leaf hashing and parent levels go through kernel K1 (ops/blake3_torch), the
chunked mode's chunk trees through K13; the
fold ``y[:half] + beta * y[half:]`` is plain field arithmetic on tensors, as
it is outside any kernel in the JAX package (folded 2^seg_log2 values at a
time, which bounds its temporaries).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ...ops import blake3_torch as BT
from ...ops import goldilocks_torch as FT
from ...utils import tracing
from ...utils.tracing import LAUNCH, WAIT, span
from .proof import FriQuery

# Device handles layers down to this size; smaller tail layers fold on host.
MIN_DEVICE_LAYER_LOG2 = 11
# Chunked mode: the in-chunk path depth, which is also its smallest device
# layer (one chunk), and the leaves hashed (values folded) a step.
CHUNK_LOG2 = MIN_DEVICE_LAYER_LOG2
SEG_LOG2 = 21
# FRI domains (log2) from which the chunked mode is the default: the first
# at which it lowers a prove's peak device memory on the H100 (PERF.md
# section 7). At 2^26 (T = 2^23) the resident trees, 9.7 GB above the LDE
# against the chunked mode's 0.86 GB, set the prove's peak (34.57 GB against
# 30.07); at 2^25 and 2^27 both modes share a peak set outside the FRI. The
# two modes take the same wall time within the spread between runs from
# 2^23 to 2^27.
FRI_CHUNKED_MIN_LOG2 = 26


def _levels_up(base: torch.Tensor) -> List[torch.Tensor]:
    """[8, K] CV planes -> every Merkle level from them to the root:
    [8, K], [8, K/2], ..., [8, 1]."""
    levels = [base]
    while levels[-1].shape[1] > 1:
        levels.append(BT.parent_level_planes(levels[-1]))
    return levels


def _tree_levels(vals: torch.Tensor) -> List[torch.Tensor]:
    """Field values [m] -> all Merkle levels as [8, m], [8, m/2], ..., [8, 1]
    CV planes (FRI leaves hash with an empty prefix, merkle.rs:132-138)."""
    return _levels_up(BT.hash_leaves_u64_planes(vals, b""))


def _chunk_tops(vals: torch.Tensor, seg_log2: int) -> torch.Tensor:
    """Field values [m] -> the tree's levels from the 2^CHUNK_LOG2-leaf chunk
    roots up, side by side ([8, 2K - 1], K = m >> CHUNK_LOG2, the root last).
    The chunk roots are one K13 launch on the card, which counts 1 to the
    recorded prove's `fri.chunk_tops_segments`; on the CPU they are hashed
    2^seg_log2 leaves at a time (one segment's leaf messages and CVs alive
    at most), and the segments count there."""
    roots = BT.columns_commit_roots_scan(vals[None], [b""], CHUNK_LOG2, seg_log2=seg_log2,
                                         counter="fri.chunk_tops_segments")[0]
    return torch.cat(_levels_up(roots), dim=1)


def _split_top_levels(rows: np.ndarray) -> List[np.ndarray]:
    """uint8 [2K - 1, 32] top nodes of one layer -> per-level arrays of
    sizes K, K/2, ..., 1."""
    out = []
    off = 0
    size = (rows.shape[0] + 1) // 2
    while size >= 1:
        out.append(rows[off : off + size])
        off += size
        size //= 2
    return out


def _fold(cur: torch.Tensor, b: torch.Tensor, seg_log2: int) -> torch.Tensor:
    """y[:half] + b * y[half:], 2^seg_log2 values at a time; b is a 0-d
    field tensor on cur's device (no upload here)."""
    half = cur.shape[0] // 2
    out = torch.empty(half, dtype=torch.int64, device=cur.device)
    seg = min(1 << seg_log2, half)
    for s in range(0, half, seg):
        out[s : s + seg] = FT.add(cur[s : s + seg], FT.mul(b, cur[half + s : half + s + seg]))
    return out


def _plan(n_log2: int, fri_rows: List[int], plan_value, plan_path) -> list:
    """Per query of a 2^n_log2 domain: its positions and, per layer, the value
    and path references (idx, then its pair idx ^ half) that plan_* return."""
    plans = []
    for idx0 in fri_rows:
        positions = []
        layer_plan = []
        idx = idx0
        layer_len = 1 << n_log2
        for l in range(n_log2):
            positions.append(idx)
            half = layer_len // 2
            j = idx ^ half
            layer_plan.append(
                (
                    plan_value(l, idx),
                    plan_path(l, layer_len, idx),
                    plan_value(l, j),
                    plan_path(l, layer_len, j),
                )
            )
            idx = idx % half
            layer_len = half
        positions.append(idx)
        plans.append((positions, layer_plan))
    return plans


def _assemble(plans: list, value_bytes, path_bytes) -> List[FriQuery]:
    return [
        FriQuery(
            positions=positions,
            pairs=[
                (value_bytes(vi), path_bytes(pi), value_bytes(vj), path_bytes(pj))
                for vi, pi, vj, pj in layer_plan
            ],
        )
        for positions, layer_plan in plans
    ]


class DeviceFri:
    """FRI engine with device-resident layers.

    Usage (mirrors the transcript schedule):
        fri = DeviceFri(lde)                 # int64 [n] field tensor on the device
        root0 = fri.commit_layer0()          # absorb, then derive betas
        roots = fri.commit_rest(betas)       # absorb each
        q = fri.open_queries(fri_rows)       # after query derivation

    The chunked mode is taken for n >= 2^max(chunked_min_log2, CHUNK_LOG2 + 1)
    (the JAX package's guard: its smallest device layer is one whole chunk,
    so it keeps device layers down to 2^max(min_device_layer_log2,
    CHUNK_LOG2)); `chunked` says which mode an engine took.
    """

    def __init__(self, lde: torch.Tensor, min_device_layer_log2: int = MIN_DEVICE_LAYER_LOG2,
                 chunked_min_log2: int = FRI_CHUNKED_MIN_LOG2, seg_log2: int = SEG_LOG2):
        self.n = int(lde.shape[0])
        self.n_log2 = self.n.bit_length() - 1
        assert 1 << self.n_log2 == self.n
        if seg_log2 < CHUNK_LOG2:
            raise ValueError(f"seg_log2 must be at least CHUNK_LOG2 = {CHUNK_LOG2}")
        self.chunked = self.n_log2 >= max(chunked_min_log2, CHUNK_LOG2 + 1)
        self._min_device_layer_log2 = (
            max(min_device_layer_log2, CHUNK_LOG2) if self.chunked else min_device_layer_log2
        )
        self._seg_log2 = seg_log2
        self._vals: Dict[int, torch.Tensor] = {0: lde}  # layer -> values [n >> layer]
        self._levels: Dict[int, List[torch.Tensor]] = {}  # resident: layer -> tree levels
        self._tops: Dict[int, torch.Tensor] = {}  # chunked: layer -> [8, 2K - 1] top nodes
        self._tops_host: Dict[int, List[np.ndarray]] = {}  # chunked: layer -> per-level rows
        self._roots: List[bytes] = []
        self._final_value: int | None = None
        self._dev_layers = 0
        self._host_layers = {}
        self._host_trees = {}

    def commit_layer0(self) -> bytes:
        with span("fri_commit.layer0", LAUNCH):
            if self.chunked:
                self._tops[0] = _chunk_tops(self._vals[0], self._seg_log2)
                root = self._tops[0][:, -1:]
            else:
                self._levels[0] = _tree_levels(self._vals[0])
                root = self._levels[0][-1]
        with span("fri_commit.pull_root0", WAIT):
            return BT.cv_planes_to_bytes(root)[0].tobytes()

    def commit_rest(self, betas: List[int]) -> List[bytes]:
        from . import fri as host_fri

        self._dev_layers = max(1, self.n_log2 - self._min_device_layer_log2)
        cur = self._vals[0]
        roots = []
        # one upload of the device layers' betas (an upload synchronises)
        with span("fri_commit.betas", WAIT):
            bs = FT.pack(np.array(betas[: self._dev_layers], dtype=np.uint64), cur.device)
        with span("fri_commit.fold", LAUNCH):
            for l in range(1, self._dev_layers + 1):
                cur = _fold(cur, bs[l - 1], self._seg_log2)
                self._vals[l] = cur
                if self.chunked:
                    self._tops[l] = _chunk_tops(cur, self._seg_log2)
                else:
                    self._levels[l] = _tree_levels(cur)
                    roots.append(self._levels[l][-1])
        with span("fri_commit.pull_tops", WAIT):
            if self.chunked:
                curh = self._pull_tops_and_tail(cur)
                self._roots = [
                    self._tops_host[l][-1][0].tobytes() for l in range(1, self._dev_layers + 1)
                ]
            else:
                # one pull for the layer roots, one for the tail values
                self._roots = [
                    r.tobytes() for r in BT.cv_planes_to_bytes(torch.cat(roots, dim=1))
                ]
                curh = FT.unpack(cur).copy()

        # host tail: fold the remaining small layers from the last device layer
        with span("fri_commit.host_tail"):
            self._host_layers = {}
            self._host_trees = {}
            layer_idx = self._dev_layers
            while curh.shape[0] > 1:
                curh = host_fri.fold(curh, betas[layer_idx])
                layer_idx += 1
                tree = host_fri.layer_tree(curh)
                self._host_layers[layer_idx] = curh
                self._host_trees[layer_idx] = tree
                self._roots.append(tree.root())
            self._final_value = int(curh[0])
        return list(self._roots)

    def _pull_tops_and_tail(self, tail: torch.Tensor) -> np.ndarray:
        """One transfer of every layer's top nodes and the last device
        layer's values; keeps the tops as per-level rows, returns the values."""
        order = sorted(self._tops)
        words = [self._tops[l].t().reshape(-1) for l in order]  # [2K - 1, 8] row-major
        flat = torch.cat(words + [tail.contiguous().view(torch.int32)]).cpu().numpy()
        off = 0
        for l, w in zip(order, words):
            rows = flat[off : off + w.shape[0]].astype("<u4", copy=False)
            self._tops_host[l] = _split_top_levels(rows.view(np.uint8).reshape(-1, 32))
            off += w.shape[0]
        return flat[off:].view(np.uint64).copy()

    def final_value_le(self) -> bytes:
        return int(self._final_value).to_bytes(8, "little")

    # ------------------------------ openings --------------------------------

    def _host_value(self, layer: int, idx: int) -> bytes:
        return int(self._host_layers[layer][idx]).to_bytes(8, "little")

    def open_queries(self, fri_rows: List[int]) -> List[FriQuery]:
        """Assemble FriQuery objects for all query indices.

        One planning pass records every node/value gather with its sequence
        number; the gathers run on the device and come back in two pulls;
        assembly substitutes the gathered rows. Bit-identical to
        fri.fri_open_query."""
        if self.chunked:
            return self._open_queries_chunked(fri_rows)
        node_reqs: Dict[tuple, List[int]] = {}  # (layer, level) -> positions
        val_reqs: Dict[int, List[int]] = {}  # layer -> indices
        val_seq: Dict[tuple, int] = {}

        def plan_value(layer: int, idx: int):
            if layer > self._dev_layers:
                return ("hostlayer", (layer, idx))
            key = (layer, idx)
            if key not in val_seq:
                lst = val_reqs.setdefault(layer, [])
                val_seq[key] = len(lst)
                lst.append(idx)
            return ("val", (layer, val_seq[key]))

        def plan_path(layer: int, layer_len: int, target: int):
            if layer > self._dev_layers:
                return ("hosttree", layer, target)
            refs = []
            m = layer_len
            t = target
            lev = 0
            while m > 1:
                sib = t ^ 1 if (t ^ 1) < m else t
                lst = node_reqs.setdefault((layer, lev), [])
                refs.append(((layer, lev), len(lst)))
                lst.append(sib)
                t >>= 1
                m //= 2
                lev += 1
            return refs

        with span("fri_openings.plan"):
            plans = _plan(self.n_log2, fri_rows, plan_value, plan_path)

        # queue every device gather, then one pull per kind; every gather
        # uploads its positions, which synchronises
        dev = self._vals[0].device
        with span("fri_openings.gather", WAIT):
            node_off: Dict[tuple, int] = {}
            parts = []
            off = 0
            for key, pos in node_reqs.items():
                layer, lev = key
                node_off[key] = off
                off += len(pos)
                parts.append(self._levels[layer][lev][:, torch.as_tensor(pos, device=dev)])
            val_off: Dict[int, int] = {}
            vparts = []
            off = 0
            for layer, idxs in val_reqs.items():
                val_off[layer] = off
                off += len(idxs)
                vparts.append(self._vals[layer][torch.as_tensor(idxs, device=dev)])
        with span("fri_openings.pull", WAIT):
            nodes = (
                BT.cv_planes_to_bytes(torch.cat(parts, dim=1))
                if parts else np.zeros((0, 32), np.uint8)
            )
            vals = FT.unpack(torch.cat(vparts)) if vparts else np.zeros(0, np.uint64)

        def value_bytes(ref) -> bytes:
            kind, x = ref
            if kind == "hostlayer":
                return self._host_value(*x)
            layer, i = x
            return int(vals[val_off[layer] + i]).to_bytes(8, "little")

        def path_bytes(refs) -> List[bytes]:
            if isinstance(refs, tuple) and refs and refs[0] == "hosttree":
                _, layer, target = refs
                return self._host_trees[layer].open(target)
            return [nodes[node_off[key] + i].tobytes() for key, i in refs]

        with span("fri_openings.assemble"):
            return _assemble(plans, value_bytes, path_bytes)

    def _open_queries_chunked(self, fri_rows: List[int]) -> List[FriQuery]:
        """Chunked-tree openings: each opened leaf of a device layer is a
        request against its 2^CHUNK_LOG2-leaf chunk, which gives the value
        and the in-chunk sibling path; the path's upper levels come from the
        host copy of the layer's top nodes. Every distinct (layer, chunk) is
        gathered from the resident layer values and hashed once, all layers
        in one batch: one K1 launch for their leaves and one a parent level.
        Bit-identical to fri.fri_open_query."""
        if not fri_rows:
            return []
        mask = (1 << CHUNK_LOG2) - 1
        req_seq: Dict[tuple, int] = {}  # (layer, index) -> request number

        def plan_req(layer: int, idx: int) -> int:
            return req_seq.setdefault((layer, idx), len(req_seq))

        def plan_value(layer: int, idx: int):
            if layer > self._dev_layers:
                return ("hostlayer", (layer, idx))
            return ("req", plan_req(layer, idx))

        def plan_path(layer: int, layer_len: int, target: int):
            if layer > self._dev_layers:
                return ("hosttree", layer, target)
            return ("req", plan_req(layer, target), layer, target)

        with span("fri_openings.plan"):
            plans = _plan(self.n_log2, fri_rows, plan_value, plan_path)
            # distinct chunks in (layer, start) order: one gather a layer
            chunk_row: Dict[tuple, int] = {}  # (layer, chunk start) -> row of `chunks`
            for layer, idx in sorted(req_seq):
                chunk_row.setdefault((layer, idx & ~mask), len(chunk_row))
            arrays = [np.array([s for _, s in chunk_row], dtype=np.int64),
                      np.array([chunk_row[(layer, idx & ~mask)] for layer, idx in req_seq],
                               dtype=np.int64),
                      np.array([idx & mask for _, idx in req_seq], dtype=np.int64)]
            layers = sorted({l for l, _ in chunk_row})
            per_layer = [sum(1 for l, _ in chunk_row if l == layer) for layer in layers]
        dev = self._vals[0].device
        # one upload of the chunk starts and the requests' chunks and leaves,
        # then a gather a layer
        with span("fri_openings.gather", WAIT):
            starts, rows, idxs = torch.split(BT._as_index(np.concatenate(arrays), dev),
                                             [len(a) for a in arrays])
            offs = torch.arange(mask + 1, device=dev)[None, :]
            chunks = torch.cat([
                self._vals[layer][part[:, None] + offs]
                for layer, part in zip(layers, torch.split(starts, per_layer))
            ])  # [K, 2^CHUNK_LOG2]
        # the chunks' trees, rebuilt
        with span("fri_openings.rehash", LAUNCH, sync=True):
            cvs = BT.hash_leaves_u64_planes(chunks.reshape(-1), b"")
            planes, _ = BT._path_planes_from_leaf_cvs(cvs, idxs, CHUNK_LOG2, rows=rows)
            opened = chunks[rows, idxs]
        tracing.count("openings.rebuilt_chunks", len(chunk_row))
        with span("fri_openings.pull", WAIT):
            paths8 = BT.path_planes_to_bytes(planes, len(req_seq), CHUNK_LOG2)
            values = FT.unpack(opened)

        def value_bytes(ref) -> bytes:
            if ref[0] == "hostlayer":
                return self._host_value(*ref[1])
            return int(values[ref[1]]).to_bytes(8, "little")

        def path_bytes(ref) -> List[bytes]:
            if ref[0] == "hosttree":
                _, layer, target = ref
                return self._host_trees[layer].open(target)
            _, i, layer, target = ref
            out = [paths8[i, lev].tobytes() for lev in range(CHUNK_LOG2)]
            t = target >> CHUNK_LOG2
            for level in self._tops_host[layer][:-1]:
                out.append(level[t ^ 1].tobytes())
                t >>= 1
            return out

        with span("fri_openings.assemble"):
            return _assemble(plans, value_bytes, path_bytes)
