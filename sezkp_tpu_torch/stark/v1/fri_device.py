"""Device-resident FRI: folds, layer hashing, and tree building on the card.

Counterpart of the resident mode of sezkp_tpu/stark/v1/fri_device.py. All FRI
layers (values and every Merkle level) are computed on the device and stay
there; only the layer roots (a few hundred bytes) and, later, the queried
values and paths (tens of KB) come back to the host. Outputs are
bit-identical to the host implementation in fri.py (cross-tested).

Two phases are forced by the Fiat-Shamir schedule: betas depend on the
layer-0 root (fri.rs:51-68), so ``commit_layer0`` commits layer 0 and
``commit_rest`` takes the derived betas and produces everything else.

Leaf hashing and parent levels go through kernel K1 (ops/blake3_torch); the
fold ``y[:half] + beta * y[half:]`` is plain field arithmetic on tensors, as
it is outside any kernel in the JAX package. The chunked tops-only mode for
domains from 2^26 up is not ported yet.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ...ops import blake3_torch as BT
from ...ops import goldilocks_torch as FT
from .proof import FriQuery

# Device handles layers down to this size; smaller tail layers fold on host.
MIN_DEVICE_LAYER_LOG2 = 11


def _tree_levels(vals: torch.Tensor) -> List[torch.Tensor]:
    """Field values [m] -> all Merkle levels as [8, m], [8, m/2], ..., [8, 1]
    CV planes (FRI leaves hash with an empty prefix, merkle.rs:132-138)."""
    levels = [BT.hash_leaves_u64_planes(vals, b"")]
    while levels[-1].shape[1] > 1:
        levels.append(BT.parent_level_planes(levels[-1]))
    return levels


class DeviceFri:
    """FRI engine with device-resident layers.

    Usage (mirrors the transcript schedule):
        fri = DeviceFri(lde)                 # int64 [n] field tensor on the device
        root0 = fri.commit_layer0()          # absorb, then derive betas
        roots = fri.commit_rest(betas)       # absorb each
        q = fri.open_queries(fri_rows)       # after query derivation
    """

    def __init__(self, lde: torch.Tensor, min_device_layer_log2: int = MIN_DEVICE_LAYER_LOG2):
        self.n = int(lde.shape[0])
        self.n_log2 = self.n.bit_length() - 1
        assert 1 << self.n_log2 == self.n
        self._min_device_layer_log2 = min_device_layer_log2
        self._vals: Dict[int, torch.Tensor] = {0: lde}  # layer -> values [n >> layer]
        self._levels: Dict[int, List[torch.Tensor]] = {}  # layer -> tree levels
        self._roots: List[bytes] = []
        self._final_value: int | None = None
        self._dev_layers = 0
        self._host_layers = {}
        self._host_trees = {}

    def commit_layer0(self) -> bytes:
        self._levels[0] = _tree_levels(self._vals[0])
        return BT.cv_planes_to_bytes(self._levels[0][-1])[0].tobytes()

    def commit_rest(self, betas: List[int]) -> List[bytes]:
        from . import fri as host_fri

        self._dev_layers = max(1, self.n_log2 - self._min_device_layer_log2)
        cur = self._vals[0]
        roots = []
        for l in range(1, self._dev_layers + 1):
            half = cur.shape[0] // 2
            cur = FT.add(cur[:half], FT.mul(FT.scalar(betas[l - 1], cur), cur[half:]))
            self._vals[l] = cur
            self._levels[l] = _tree_levels(cur)
            roots.append(self._levels[l][-1])
        # one pull for the layer roots, one for the tail values
        self._roots = [
            r.tobytes() for r in BT.cv_planes_to_bytes(torch.cat(roots, dim=1))
        ]

        # host tail: fold the remaining small layers from the last device layer
        curh = FT.unpack(cur).copy()
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

    def final_value_le(self) -> bytes:
        return int(self._final_value).to_bytes(8, "little")

    # ------------------------------ openings --------------------------------

    def open_queries(self, fri_rows: List[int]) -> List[FriQuery]:
        """Assemble FriQuery objects for all query indices.

        One planning pass records every node/value gather with its sequence
        number; the gathers run on the device and come back in two pulls;
        assembly substitutes the gathered rows. Bit-identical to
        fri.fri_open_query."""
        n_layers = self.n_log2 + 1
        node_reqs: Dict[Tuple[int, int], List[int]] = {}  # (layer, level) -> positions
        val_reqs: Dict[int, List[int]] = {}  # layer -> indices
        val_seq: Dict[Tuple[int, int], int] = {}

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

        plans = []
        for idx0 in fri_rows:
            positions = []
            layer_plan = []
            idx = idx0
            layer_len = self.n
            for l in range(n_layers - 1):
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

        # queue every device gather, then one pull per kind
        dev = self._vals[0].device
        node_off: Dict[Tuple[int, int], int] = {}
        parts = []
        off = 0
        for key, pos in node_reqs.items():
            layer, lev = key
            node_off[key] = off
            off += len(pos)
            parts.append(self._levels[layer][lev][:, torch.as_tensor(pos, device=dev)])
        nodes = (
            BT.cv_planes_to_bytes(torch.cat(parts, dim=1))
            if parts else np.zeros((0, 32), np.uint8)
        )
        val_off: Dict[int, int] = {}
        vparts = []
        off = 0
        for layer, idxs in val_reqs.items():
            val_off[layer] = off
            off += len(idxs)
            vparts.append(self._vals[layer][torch.as_tensor(idxs, device=dev)])
        vals = FT.unpack(torch.cat(vparts)) if vparts else np.zeros(0, np.uint64)

        def value_bytes(ref) -> bytes:
            kind, x = ref
            if kind == "hostlayer":
                layer, idx = x
                return int(self._host_layers[layer][idx]).to_bytes(8, "little")
            layer, i = x
            return int(vals[val_off[layer] + i]).to_bytes(8, "little")

        def path_bytes(refs) -> List[bytes]:
            if isinstance(refs, tuple) and refs and refs[0] == "hosttree":
                _, layer, target = refs
                return self._host_trees[layer].open(target)
            return [nodes[node_off[key] + i].tobytes() for key, i in refs]

        queries = []
        for positions, layer_plan in plans:
            pairs = [
                (value_bytes(vi), path_bytes(pi), value_bytes(vj), path_bytes(pj))
                for vi, pi, vj, pj in layer_plan
            ]
            queries.append(FriQuery(positions=positions, pairs=pairs))
        return queries
