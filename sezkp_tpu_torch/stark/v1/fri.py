"""FRI folding + layer commitments, vectorized.

Fold rule y'[i] = y[i] + beta * y[i + half] and transcript schedule match
crates/sezkp-stark/src/v1/fri.rs. Each fold is one vectorized mulmod/addmod;
each layer commitment is one batched leaf-hash pass + log-level parent
passes.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ...crypto import blake3
from ...crypto.transcript import Blake3Transcript
from ...ops import goldilocks as G
from . import params
from .merkle import MerkleTree, hash_field_leaves
from .proof import FriQuery


def layer_tree(vals: np.ndarray) -> MerkleTree:
    return MerkleTree.from_leaves(hash_field_leaves(G.to_le_bytes(vals)))


class StreamingLayerBuilder:
    """Streaming Merkle root over a FRI layer (reference: fri_stream.rs:52-122).

    Absorbs 8-byte LE leaves in chunks keeping only a per-level stack; for
    the power-of-two layer lengths FRI produces, the root is identical to
    `layer_tree(...).root()`. Chunk hashing is batched."""

    def __init__(self, layer_len: int):
        self.expected = layer_len
        self.seen = 0
        self.stack: list = []

    def absorb_leaves_u64(self, vals: np.ndarray) -> None:
        from ...crypto import blake3 as b3

        hashes = hash_field_leaves(G.to_le_bytes(vals))
        self.seen += int(hashes.shape[0])
        for i in range(hashes.shape[0]):
            cur = hashes[i].tobytes()
            lvl = 0
            while True:
                if len(self.stack) <= lvl:
                    self.stack.append(None)
                if self.stack[lvl] is None:
                    self.stack[lvl] = cur
                    break
                left = self.stack[lvl]
                self.stack[lvl] = None
                cur = b3.hash_bytes(left + cur)
                lvl += 1

    def finalize(self) -> bytes:
        from ...crypto import blake3 as b3

        assert self.seen == self.expected, (
            f"StreamingLayerBuilder absorbed {self.seen} leaves, "
            f"expected {self.expected}"
        )
        acc = None
        for node in self.stack:
            if node is None:
                continue
            acc = node if acc is None else b3.hash_bytes(node + acc)
        return acc if acc is not None else b"\x00" * 32


def fold(vals: np.ndarray, beta: int) -> np.ndarray:
    half = vals.shape[0] // 2
    return G.add(vals[:half], G.mul(np.uint64(beta), vals[half:]))


def fri_commit(
    tr: Blake3Transcript, a0: np.ndarray
) -> Tuple[List[bytes], List[np.ndarray], List[int]]:
    """Commit all layers: bind root0, derive betas, fold + bind each root.

    Returns (roots, layers, betas); layers[0] is a0."""
    n = a0.shape[0]
    assert n & (n - 1) == 0, "FRI layer0 len must be pow2"
    layers = [a0]
    root0 = layer_tree(a0).root()
    tr.absorb(params.DS_FRI_LAYER_ROOT, root0)

    n_folds = n.bit_length() - 1
    betas = params.derive_betas_for_fri(tr, n_folds)

    roots = [root0]
    for r in range(n_folds):
        layers.append(fold(layers[-1], betas[r]))
        root = layer_tree(layers[-1]).root()
        tr.absorb(params.DS_FRI_LAYER_ROOT, root)
        roots.append(root)
    return roots, layers, betas


def fri_open_query(layers: List[np.ndarray], trees: List[MerkleTree], idx: int) -> FriQuery:
    positions: List[int] = []
    pairs = []
    for li, layer in enumerate(layers):
        positions.append(idx)
        if layer.shape[0] == 1:
            break
        half = layer.shape[0] // 2
        j = idx ^ half
        vi = G.to_le_bytes(layer[idx]).tobytes()
        vj = G.to_le_bytes(layer[j]).tobytes()
        pairs.append((vi, trees[li].open(idx), vj, trees[li].open(j)))
        idx %= half
    return FriQuery(positions=positions, pairs=pairs)


def fri_verify(
    tr: Blake3Transcript,
    roots: List[bytes],
    queries: List[FriQuery],
    final_value_le: bytes,
    expected_positions: List[int] | None = None,
) -> None:
    if not roots:
        raise ValueError("no FRI roots")
    n_layers = len(roots)
    if expected_positions is not None:
        # Documented deliberate divergence from fri.rs:152-157 (which
        # trusts q.positions[0], letting a prover pick favorable query
        # positions after committing): bind every query's start position
        # to the transcript-derived sample (docs/parity.md). Honest
        # proofs open exactly these positions.
        if len(queries) != len(expected_positions):
            raise ValueError(
                f"FRI query count mismatch (expected "
                f"{len(expected_positions)}, got {len(queries)})"
            )
        for qi, (q, exp) in enumerate(zip(queries, expected_positions)):
            if q.positions and q.positions[0] != exp:
                raise ValueError(
                    f"FRI query {qi} opens position {q.positions[0]}, "
                    f"expected sampled position {exp}"
                )

    tr.absorb(params.DS_FRI_LAYER_ROOT, roots[0])
    betas = params.derive_betas_for_fri(tr, max(n_layers - 1, 0))

    final_hash = hash_field_leaves(
        np.frombuffer(final_value_le, dtype=np.uint8).reshape(1, 8)
    )[0].tobytes()
    if roots[-1] != final_hash:
        raise ValueError("final FRI value mismatch with last root")

    p = int(G.P)
    for q in queries:
        if len(q.positions) != n_layers:
            raise ValueError("positions length mismatch")
        if len(q.pairs) != max(n_layers - 1, 0):
            raise ValueError("pairs length mismatch")

        idx = q.positions[0]
        layer_len = 1 << (n_layers - 1)
        for l in range(n_layers - 1):
            half = layer_len // 2
            j = idx ^ half
            vi_le, path_i, vj_le, path_j = q.pairs[l]
            leaf_i = hash_field_leaves(
                np.frombuffer(vi_le, dtype=np.uint8).reshape(1, 8)
            )[0].tobytes()
            leaf_j = hash_field_leaves(
                np.frombuffer(vj_le, dtype=np.uint8).reshape(1, 8)
            )[0].tobytes()
            if not MerkleTree.verify(roots[l], leaf_i, idx, path_i):
                raise ValueError(f"FRI Merkle path failed at layer {l}")
            if not MerkleTree.verify(roots[l], leaf_j, j, path_j):
                raise ValueError(f"FRI Merkle path failed at layer {l}")

            vi = int.from_bytes(vi_le, "little") % p
            vj = int.from_bytes(vj_le, "little") % p
            lower, upper = (vi, vj) if idx < half else (vj, vi)
            v_fold = (lower + betas[l] * upper) % p

            expected_next = idx % half
            if q.positions[l + 1] != expected_next:
                raise ValueError(f"FRI index propagation failed at layer {l}")

            if l + 1 < n_layers - 1:
                vi1 = int.from_bytes(q.pairs[l + 1][0], "little") % p
                if vi1 != v_fold:
                    raise ValueError(f"FRI fold mismatch at layer {l}")
            else:
                if v_fold.to_bytes(8, "little") != final_value_le:
                    raise ValueError("final FRI value mismatch")

            idx = expected_next
            layer_len = half


def merkle_path_from_chunks(layer_len: int, chunker, idx: int):
    """Compute a layer-0 Merkle path by re-driving a chunked leaf producer,
    never materializing the layer (reference: fri_stream.rs
    merkle_path_from_le_chunker:260-312, which re-drives the stream once per
    tree level; here one drive hashes leaves in batches and a per-level
    frontier walk extracts the path in a single pass).

    `chunker(consume)` must call `consume(vals_u64_chunk)` repeatedly with
    consecutive u64 value chunks totalling `layer_len` (power of two).
    Returns (value_le8, sibling_hashes_bottom_to_top).
    """
    assert layer_len > 0 and layer_len & (layer_len - 1) == 0
    from ...crypto import blake3 as b3

    n_levels = layer_len.bit_length() - 1
    # Frontier with sibling capture: track pending node per level; when the
    # path node at a level is formed, record its sibling.
    pending = [None] * (n_levels + 1)  # (pos, hash)
    path = [None] * n_levels
    value_le = [None]
    pos_counter = [0]

    def push(level: int, pos: int, h: bytes):
        if pending[level] is None:
            pending[level] = (pos, h)
            return
        lpos, lh = pending[level]
        pending[level] = None
        # record sibling if this pair contains the path node at this level
        if level < n_levels:
            wp = idx >> level
            if lpos == wp:
                path[level] = h
            elif pos == wp:
                path[level] = lh
        push(level + 1, pos >> 1, b3.hash_bytes(lh + h))

    def consume(vals):
        import numpy as np

        from ...ops import goldilocks as G

        hashes = hash_field_leaves(G.to_le_bytes(np.asarray(vals, dtype=np.uint64)))
        base = pos_counter[0]
        for i in range(hashes.shape[0]):
            p = base + i
            if p == idx:
                value_le[0] = G.to_le_bytes(np.uint64(vals[i])).tobytes()
            push(0, p, hashes[i].tobytes())
        pos_counter[0] += hashes.shape[0]

    chunker(consume)
    assert pos_counter[0] == layer_len, "chunker produced wrong leaf count"
    return value_le[0], [p for p in path]
