"""The STARK v1 prove of plain/stark_v1.py in bounded device memory, for
traces whose whole Merkle trees do not fit the card: at T = 2^24 the column
leaves alone are [8, 59, 2^24] int64 words, 63 GB.

Written from the same algorithm, with the transcript, the columns, the
composition, the LDE's interpolation and evaluation, off_coset and the
encoding of plain/stark_v1.py, and three changes, each the plain form of
what a memory-bounded prover does:

1. column commitments one column at a time: the column's labelled leaves
   are hashed 2^seg_log2 rows at a time and folded to their 1024-row chunk
   roots, and only those are kept ([8, C, n / 1024] words as int32); the
   outer trees are built over them. An opening rebuilds the tree of each
   distinct queried (column, chunk) from the resident column values;
2. FRI: every layer's values are kept (2 GB at 2^27 points); each layer's
   leaves are hashed 2^seg_log2 at a time and folded to the roots of
   2^FRI_CHUNK_LOG2-leaf chunks, and the tree's levels from those roots up
   are kept. An opening rebuilds the queried chunks' trees;
3. the DEEP divide runs 2^seg_log2 points at a time, so that the Fermat
   inversion's temporaries are a segment's.

Every tree is a power of two wide and its chunks are aligned, so a chunk's
tree is a subtree of the whole one and a path is the chunk's levels, then
the levels above it: the proof equals plain/stark_v1.prove's byte for byte.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import blake3
from . import field as F
from . import stark_v1 as V1

SEG_LOG2 = 21          # leaves hashed (and points divided) a step
FRI_CHUNK_LOG2 = 11    # leaves of a FRI chunk tree


def _words(x: torch.Tensor) -> torch.Tensor:
    """int32-held digest words -> the int64 words plain/blake3 computes on."""
    return x.to(torch.int64) & F.M32


def _chunk_roots(leaves: torch.Tensor, chunk: int) -> torch.Tensor:
    """[8, K * chunk] leaves of K aligned trees side by side -> their roots
    [8, K] (chunk a power of two, so no node is promoted)."""
    level = leaves
    while chunk > 1:
        level = blake3.hash_pairs(level[:, 0::2], level[:, 1::2])
        chunk //= 2
    return level


def _segment(total: int, chunk: int, seg_log2: int) -> int:
    return max(chunk, min(total, 1 << seg_log2))


def _rows_of(chunks: torch.Tensor, chunk: int) -> torch.Tensor:
    """Chunk numbers [K] -> the row numbers of their values [K, chunk]."""
    return chunks[:, None] * chunk + torch.arange(chunk, device=chunks.device)[None, :]


class ColumnCommitments:
    """Each column's 1024-row chunk roots and its outer tree over them; the
    chunk trees are rebuilt when opened."""

    def __init__(self, cols: torch.Tensor, names: Sequence[str], seg_log2: int = SEG_LOG2):
        c, n = cols.shape
        self.cols, self.names = cols, list(names)
        self.chunk = min(1 << V1.CHUNK_LOG2, n)
        self.n_chunks = n // self.chunk
        assert self.n_chunks * self.chunk == n
        seg = _segment(n, self.chunk, seg_log2)
        roots = torch.empty((8, c, self.n_chunks), dtype=torch.int32, device=cols.device)
        for i, name in enumerate(self.names):
            for lo in range(0, n, seg):
                leaves = V1.column_leaves(cols[i:i + 1, lo:lo + seg], [name])[:, 0]
                roots[:, i, lo // self.chunk:(lo + seg) // self.chunk] = \
                    _chunk_roots(leaves, self.chunk).to(torch.int32)
        self.outer = V1.Trees(_words(roots))

    def roots(self):
        r = blake3.words_to_bytes(self.outer.roots())
        return [r[32 * i:32 * i + 32] for i in range(len(r) // 32)]

    def open(self, col: torch.Tensor, row: torch.Tensor):
        """(chunk roots [8, R], inner paths [K, 8, R], outer paths [K', 8, R]),
        each distinct (column, chunk) tree rebuilt once."""
        ci, ii = row // self.chunk, row % self.chunk
        keys, tree = torch.unique(col * self.n_chunks + ci, return_inverse=True)
        leaves = torch.empty((8, keys.shape[0], self.chunk), dtype=torch.int64, device=col.device)
        k_col = (keys // self.n_chunks).tolist()
        for c in sorted(set(k_col)):
            at = torch.tensor([j for j, x in enumerate(k_col) if x == c], device=col.device)
            vals = self.cols[c][_rows_of(keys[at] % self.n_chunks, self.chunk)]
            leaves[:, at] = V1.column_leaves(vals.reshape(1, -1), [self.names[c]])[:, 0] \
                .reshape(8, at.shape[0], self.chunk)
        inner = V1.Trees(leaves)
        return inner.levels[-1][:, tree, 0], inner.paths(tree, ii), self.outer.paths(col, ci)


class LayerTree:
    """One FRI layer's tree: the layer's values and the levels from its
    chunk roots up; the chunk trees are rebuilt when opened."""

    def __init__(self, values: torch.Tensor, seg_log2: int = SEG_LOG2,
                 chunk_log2: int = FRI_CHUNK_LOG2):
        m = values.shape[0]
        self.values = values
        self.chunk = min(1 << chunk_log2, m)
        seg = _segment(m, self.chunk, seg_log2)
        roots = torch.empty((8, m // self.chunk), dtype=torch.int32, device=values.device)
        for lo in range(0, m, seg):
            roots[:, lo // self.chunk:(lo + seg) // self.chunk] = \
                _chunk_roots(V1.field_leaves(values[lo:lo + seg]), self.chunk).to(torch.int32)
        self.tops = V1.Trees(_words(roots)[:, None])

    def root(self) -> torch.Tensor:
        return self.tops.roots()      # [8, 1]

    def paths(self, idx: torch.Tensor) -> torch.Tensor:
        """Sibling digests from leaf idx[q] up: [levels, 8, Q]."""
        ci = idx // self.chunk
        keys, tree = torch.unique(ci, return_inverse=True)
        vals = self.values[_rows_of(keys, self.chunk)].reshape(-1)
        inner = V1.Trees(V1.field_leaves(vals).view(8, keys.shape[0], self.chunk))
        return torch.cat([inner.paths(tree, idx % self.chunk),
                          self.tops.paths(torch.zeros_like(ci), ci)])


def deep_lde(base: torch.Tensor, z: int, seg_log2: int = SEG_LOG2) -> torch.Tensor:
    """plain/stark_v1.deep_lde, the divide by (x - z) 2^seg_log2 points at a
    time."""
    n, dev = base.shape[0], base.device
    coeffs = F.mul(F.intt(base), F.powers(V1.SHIFT, n, dev))
    big = torch.zeros(V1.BLOWUP * n, dtype=torch.int64, device=dev)
    big[:n] = coeffs
    del coeffs
    y = F.ntt(big)
    del big
    m = y.shape[0]
    w = F.root_of_unity(m.bit_length() - 1)
    seg = min(m, 1 << seg_log2)
    steps = F.powers(w, seg, dev)
    for lo in range(0, m, seg):
        xs = F.mul(steps, F.const(V1.SHIFT * F.pow_int(w, lo), dev))
        y[lo:lo + seg] = F.mul(y[lo:lo + seg], F.inv(F.sub(xs, F.const(z, dev))))
    return y


def prove(blocks: Sequence, manifest_root: bytes, device, queries: int = V1.NUM_QUERIES,
          seg_log2: int = SEG_LOG2, fri_chunk_log2: int = FRI_CHUNK_LOG2) -> bytes:
    """The proof's bytes, as plain/stark_v1.prove gives them. `queries`: the
    AIR and FRI queries drawn (the configuration states 30)."""
    device = torch.device(device)
    n = sum(b.n_steps for b in blocks)
    tau = blocks[0].tau
    assert n > 0 and n & (n - 1) == 0, "the trace length is a power of two"
    names = V1.labels(tau)

    tr = V1.Transcript(V1.DOMAIN)
    tr.absorb("manifest_root", manifest_root)
    tr.absorb_u64("n", n)
    tr.absorb_u64("tau", tau)

    cols = V1.columns(blocks, device)
    com = ColumnCommitments(cols, names, seg_log2)
    col_roots = com.roots()
    tr.absorb_u64("n_cols", len(col_roots))
    for r in col_roots:
        tr.absorb("col_root", r)

    alphas = tr.field("alphas", V1.NUM_ALPHAS)
    tr.absorb("masks", b"masks")
    tr.absorb_u64("n_masks", 1)
    tr.absorb_u64("deg", V1.MASK_DEG)
    mask = [tr.field("mask_coeff", 1)[0] for _ in range(V1.MASK_DEG)]
    log_n = n.bit_length() - 1
    lde_log2 = log_n + V1.BLOWUP.bit_length() - 1
    lde_n = 1 << lde_log2
    z = V1.off_coset(tr.field("ood_point", 1)[0], lde_log2)

    xs = F.powers(F.root_of_unity(log_n), n, device)
    masked = torch.zeros_like(xs)
    for coef in reversed(mask):
        masked = F.add(F.mul(masked, xs), F.const(coef, device))
    base = F.add(V1.composition(cols, tau, alphas), masked)
    del xs, masked

    # FRI layers, kept, and their trees from the chunk roots up
    layers = [deep_lde(base, z, seg_log2)]
    del base
    trees = [LayerTree(layers[0], seg_log2, fri_chunk_log2)]
    fri_roots = [blake3.words_to_bytes(trees[0].root())]
    tr.absorb("fri_layer_root", fri_roots[0])
    betas = tr.field("fri_betas", lde_log2)
    for beta in betas:
        y = layers[-1]
        half = y.shape[0] // 2
        layers.append(F.add(y[:half], F.mul(F.const(beta, device), y[half:])))
        trees.append(LayerTree(layers[-1], seg_log2, fri_chunk_log2))
        fri_roots.append(blake3.words_to_bytes(trees[-1].root()))
        tr.absorb("fri_layer_root", fri_roots[-1])

    # AIR openings: per row, per tape (mv, next mv, flag, symbol, head, next
    # head, window, entry, exit), then first, last, input move
    rows = [x % n for x in tr.u64s("row_queries", queries)]
    req = []
    for row in rows:
        nxt = (row + 1) % n
        for r in range(tau):
            for p, at in (("mv", row), ("mv", nxt), ("wflag", row), ("wsym", row),
                          ("head", row), ("head", nxt), ("winlen", row), ("in_off", row),
                          ("out_off", row)):
                req.append((names.index(f"{p}_{r}"), at))
        req += [(names.index("is_first"), row), (names.index("is_last"), row),
                (names.index("input_mv"), row)]
    col_t = torch.tensor([c for c, _ in req], device=device)
    row_t = torch.tensor([r for _, r in req], device=device)
    croots, inner, outer = com.open(col_t, row_t)
    values = cols[col_t, row_t].cpu().tolist()
    croots, inner, outer = V1._digests(croots[None])[0], V1._digests(inner), V1._digests(outer)
    openings = []
    for q, (_, row) in enumerate(req):
        openings.append(F.to_le_bytes(values[q]) + V1._u64(row) + V1._u64(row // com.chunk)
                        + V1._u64(row % com.chunk) + croots[q]
                        + V1._hashes([lvl[q] for lvl in inner])
                        + V1._hashes([lvl[q] for lvl in outer]))

    # FRI openings: at each layer of more than one value, the position and
    # its partner half a layer away, with their paths
    positions = [x % lde_n for x in tr.u64s("row_queries", queries)]
    fri_queries = []
    for idx0 in positions:
        pos, pairs, idx = [], [], idx0
        for li, y in enumerate(layers):
            pos.append(idx)
            if y.shape[0] == 1:
                break
            half = y.shape[0] // 2
            pairs.append((li, idx, idx ^ half))
            idx %= half
        fri_queries.append((pos, pairs))
    opened = {}
    for li in range(len(layers) - 1):
        at = sorted({i for _, pairs in fri_queries for l, a, b in pairs if l == li for i in (a, b)})
        at_t = torch.tensor(at, device=device)
        sibs = V1._digests(trees[li].paths(at_t))
        vals = layers[li][at_t].cpu().tolist()
        for j, i in enumerate(at):
            opened[(li, i)] = (F.to_le_bytes(vals[j]), [lvl[j] for lvl in sibs])

    out = [V1._u64(lde_n), V1._u64(tau), V1._u64(len(names))]
    for name, root in zip(names, col_roots):
        out += [V1._u64(len(name)), name.encode(), root]
    per_row = len(req) // len(rows)
    out.append(V1._u64(len(rows)))
    for k, row in enumerate(rows):
        out += [V1._u64(row), V1._u64(tau)] + openings[k * per_row:(k + 1) * per_row]
    out.append(V1._hashes(fri_roots))
    out.append(V1._u64(len(fri_queries)))
    for pos, pairs in fri_queries:
        out += [V1._u64(len(pos))] + [V1._u64(x) for x in pos] + [V1._u64(len(pairs))]
        for li, a, b in pairs:
            (va, pa), (vb, pb) = opened[(li, a)], opened[(li, b)]
            out += [va, V1._hashes(pa), vb, V1._hashes(pb)]
    out += [F.to_le_bytes(int(layers[-1][0])), manifest_root]
    return b"".join(out)
