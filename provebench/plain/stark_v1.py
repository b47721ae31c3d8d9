"""The STARK v1 prove, written from the algorithm (upstream
`crates/sezkp-stark/src/v1`), in plain tensor code on one device.

One route: every column built whole, every Merkle tree kept whole, one LDE,
one FRI. The proof, in order of the Fiat-Shamir transcript:

1. the transcript (domain "sezkp-stark/v1") absorbs the manifest root, the
   trace length n and the tape count tau;
2. the 3 + 7 tau columns (below) are committed: each value's leaf is
   BLAKE3("col_leaf" || le32(len(label)) || label || le8(value)); each run
   of 1024 rows is a Merkle tree, and the column's root is the Merkle root
   over those chunk roots; n_cols and each root are absorbed;
3. eight alphas, then one mask polynomial of four coefficients, then the
   out-of-domain point z, moved up by ones until it is off the LDE coset;
4. the composition at each row i of the base domain (next row i + 1 mod n)
   plus the mask at w_n^i; its DEEP coset LDE: interpolate, evaluate on
   3 * <w_8n>, divide by (x - z);
5. FRI: the LDE and each fold y'[i] = y[i] + beta_l * y[i + half] down to
   one value, each layer a Merkle tree over BLAKE3(le8(value)); root 0 is
   absorbed, then log2(8n) betas drawn, then every other root absorbed;
6. 30 rows of the base domain and 30 positions of the LDE domain are drawn;
   each row opens its columns (with the next row's move and head), each
   position its pair in every FRI layer, with their Merkle paths;
7. the proof is encoded as bincode 1.3 (fixed-width little-endian integers,
   u64 lengths).

A Merkle tree hashes BLAKE3(left || right) for each pair and promotes an odd
node unchanged; a path lists the siblings from the leaf up.
"""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np
import torch

from . import blake3
from . import field as F

DOMAIN = "sezkp-stark/v1"
BLOWUP = 8
NUM_QUERIES = 30
CHUNK_LOG2 = 10
SHIFT = 3
NUM_ALPHAS = 8
MASK_DEG = 4
HEAD_BITS = 16
SYM_BITS = 4
PREFIXES = ("mv", "wflag", "wsym", "head", "winlen", "in_off", "out_off")


def labels(tau: int) -> List[str]:
    return ["input_mv", "is_first", "is_last"] + [f"{p}_{r}" for p in PREFIXES for r in range(tau)]


# ------------------------------------------------------------ transcript


class Transcript:
    def __init__(self, domain: str):
        self.h = blake3.Hasher()
        d = domain.encode()
        self.h.update(b"sezkp.transcript.v0" + struct.pack("<I", len(d)) + d)

    def absorb(self, label: str, data: bytes) -> None:
        lb = label.encode()
        self.h.update(b"absorb" + struct.pack("<I", len(lb)) + lb
                      + struct.pack("<I", len(data)) + data)

    def absorb_u64(self, label: str, x: int) -> None:
        self.absorb(label, struct.pack("<Q", x))

    def challenge(self, label: str, n: int) -> bytes:
        lb = label.encode()
        h = self.h.copy()
        h.update(b"challenge" + struct.pack("<I", len(lb)) + lb)
        out = h.digest(n)
        self.h.update(b"after_challenge" + struct.pack("<I", len(lb)) + lb)
        return out

    def u64s(self, label: str, k: int) -> List[int]:
        return list(struct.unpack(f"<{k}Q", self.challenge(label, 8 * k)))

    def field(self, label: str, k: int) -> List[int]:
        return [x % F.P for x in self.u64s(label, k)]


# ------------------------------------------------------------ columns


def columns(blocks: Sequence, device) -> torch.Tensor:
    """The committed columns, [3 + 7 tau, n] in label order: the input move;
    block starts and ends; then per tape its move, write flag, written
    symbol, head after the move (from the window's left end), window length,
    entry and exit offsets."""
    blocks = [b for b in blocks if b.n_steps > 0]
    tau = blocks[0].tau
    lens = torch.tensor([b.n_steps for b in blocks], device=device)
    n = int(lens.sum())
    blk = torch.repeat_interleave(torch.arange(len(blocks), device=device), lens)
    ends = torch.cumsum(lens, 0)
    starts = ends - lens

    def cat(name):
        logs = [getattr(b.movement_log, name) for b in blocks]
        return torch.from_numpy(np.concatenate(logs).astype(np.int64)).to(device)

    def per_block(values):
        return torch.tensor(np.stack(values), dtype=torch.int64, device=device).T[:, blk]

    mv = cat("tape_mv").T                                            # [tau, n]
    pos = torch.cumsum(mv, 1)
    before = torch.where(starts > 0, pos[:, (starts - 1).clamp(min=0)], torch.zeros_like(pos[:, :1]))
    off_in = per_block([b.head_in_offsets.astype(np.int64) for b in blocks])
    off_out = per_block([b.head_out_offsets.astype(np.int64) for b in blocks])
    win = per_block([np.abs(b.windows[:, 1] - b.windows[:, 0]) + 1 for b in blocks])
    head = pos - before[:, blk] + off_in
    first = torch.zeros(n, dtype=torch.int64, device=device)
    last = torch.zeros(n, dtype=torch.int64, device=device)
    first[starts] = 1
    last[ends - 1] = 1
    rows = [F.from_i64(cat("input_mv"))[None], first[None], last[None], F.from_i64(mv),
            cat("write_flag").T, cat("write_sym").T, F.from_i64(head), win, off_in, off_out]
    assert sum(r.shape[0] for r in rows) == 3 + 7 * tau
    return torch.cat(rows)


def composition(cols: torch.Tensor, tau: int, a: List[int]) -> torch.Tensor:
    """The AIR's constraints at every row, each times its alpha, summed:
    per tape, the flag is a bit, the move is in {-1, 0, 1}, the head moves
    by the next row's move (but on a block's last row), the head, the
    window's slack and the symbol fit their bits where a write happens, and
    the head meets the entry offset on a block's first row and the exit
    offset on its last."""
    dev = cols.device
    c = lambda x: F.const(x, dev)
    one = c(1)
    first, last = cols[1], cols[2]
    not_last = F.sub(one.expand_as(last), last)
    acc = torch.zeros_like(last)

    def plane(prefix, r):
        return cols[3 + PREFIXES.index(prefix) * tau + r]

    def term(alpha, x):
        nonlocal acc
        acc = F.add(acc, F.mul(c(alpha), x))

    head_mask, sym_mask = (1 << HEAD_BITS) - 1, (1 << SYM_BITS) - 1
    for r in range(tau):
        mv, flg, sym = plane("mv", r), plane("wflag", r), plane("wsym", r)
        head, win = plane("head", r), plane("winlen", r)
        term(a[0], F.mul(flg, F.sub(flg, one)))
        term(a[1], F.mul(mv, F.mul(F.sub(mv, one), F.add(mv, one))))
        step = F.sub(F.sub(head.roll(-1), head), mv.roll(-1))
        term(a[2], F.mul(not_last, step))
        term(a[4], F.mul(flg, F.sub(head, head & head_mask)))
        slack = F.sub(F.sub(win, one), head)
        term(a[6], F.mul(flg, F.sub(slack, slack & head_mask)))
        term(a[0], F.mul(flg, F.sub(sym, sym & sym_mask)))
        term(a[2], F.mul(first, F.sub(F.sub(head, mv), plane("in_off", r))))
        term(a[2], F.mul(last, F.sub(head, plane("out_off", r))))
    return acc


# ------------------------------------------------------------ Merkle trees


class Trees:
    """B Merkle trees of m leaves each, every level kept: level k is
    [8, B, ceil(m / 2^k)] digest words."""

    def __init__(self, leaves: torch.Tensor):
        self.levels = [leaves]
        cur = leaves
        while cur.shape[2] > 1:
            m = cur.shape[2]
            left, right = cur[:, :, 0:m - 1:2], cur[:, :, 1:m:2]
            nxt = blake3.hash_pairs(left.reshape(8, -1), right.reshape(8, -1))
            nxt = nxt.view(8, cur.shape[1], m // 2)
            cur = torch.cat([nxt, cur[:, :, m - 1:]], dim=2) if m & 1 else nxt
            self.levels.append(cur)

    def roots(self) -> torch.Tensor:
        return self.levels[-1][:, :, 0]          # [8, B]

    def paths(self, tree: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Sibling digests from the leaf up for leaf idx[q] of tree tree[q]:
        [levels - 1, 8, Q]."""
        out = []
        for lvl in self.levels[:-1]:
            sib = idx ^ 1
            sib = torch.where(sib < lvl.shape[2], sib, idx)
            out.append(lvl[:, tree, sib])
            idx = idx >> 1
        if not out:
            return torch.empty((0, 8, idx.shape[0]), dtype=torch.int64, device=idx.device)
        return torch.stack(out)


def field_leaves(values: torch.Tensor) -> torch.Tensor:
    """BLAKE3(le8(v)) of each value -> [8, N]."""
    words = torch.zeros((16, values.shape[0]), dtype=torch.int64, device=values.device)
    words[0] = values & F.M32
    words[1] = F.shr(values, 32)
    return blake3.hash_chunks(words, 8)


def column_leaves(cols: torch.Tensor, names: List[str]) -> torch.Tensor:
    """The labelled leaves of every column -> [8, C, n]."""
    c, n = cols.shape
    out = torch.empty((8, c, n), dtype=torch.int64, device=cols.device)
    for i, name in enumerate(names):
        prefix = b"col_leaf" + struct.pack("<I", len(name)) + name.encode()
        msg = torch.empty((n, len(prefix) + 8), dtype=torch.uint8, device=cols.device)
        msg[:, :len(prefix)] = torch.tensor(list(prefix), dtype=torch.uint8, device=cols.device)
        for j in range(8):
            msg[:, len(prefix) + j] = (F.shr(cols[i], 8 * j) & 0xFF).to(torch.uint8)
        out[:, i] = blake3.hash_chunks(blake3.bytes_to_words(msg), msg.shape[1])
    return out


class ColumnCommitments:
    """Each column's 1024-row chunk trees and its outer tree over their roots."""

    def __init__(self, cols: torch.Tensor, names: List[str]):
        c, n = cols.shape
        self.chunk = min(1 << CHUNK_LOG2, n)
        self.n_chunks = n // self.chunk
        assert self.n_chunks * self.chunk == n
        leaves = column_leaves(cols, names)
        self.inner = Trees(leaves.reshape(8, c * self.n_chunks, self.chunk))
        self.outer = Trees(self.inner.roots().reshape(8, c, self.n_chunks))

    def roots(self) -> List[bytes]:
        r = blake3.words_to_bytes(self.outer.roots())
        return [r[32 * i:32 * i + 32] for i in range(len(r) // 32)]

    def open(self, col: torch.Tensor, row: torch.Tensor):
        """(chunk roots [8, R], inner paths [K, 8, R], outer paths [K', 8, R])."""
        ci, ii = row // self.chunk, row % self.chunk
        tree = col * self.n_chunks + ci
        return (self.inner.levels[-1][:, tree, 0], self.inner.paths(tree, ii),
                self.outer.paths(col, ci))


# ------------------------------------------------------------ LDE and FRI


def deep_lde(base: torch.Tensor, z: int) -> torch.Tensor:
    """Interpolate the base values, evaluate on SHIFT * <w_(8n)>, divide by
    (x - z)."""
    n, dev = base.shape[0], base.device
    coeffs = F.mul(F.intt(base), F.powers(SHIFT, n, dev))
    big = torch.zeros(BLOWUP * n, dtype=torch.int64, device=dev)
    big[:n] = coeffs
    y = F.ntt(big)
    k = (BLOWUP * n).bit_length() - 1
    xs = F.mul(F.powers(F.root_of_unity(k), BLOWUP * n, dev), F.const(SHIFT, dev))
    return F.mul(y, F.inv(F.sub(xs, F.const(z, dev))))


def off_coset(z: int, lde_log2: int) -> int:
    """z, moved up by ones while (z / SHIFT)^(2^lde_log2) = 1."""
    s_inv = F.inv_int(SHIFT)
    while F.pow_int(z * s_inv, 1 << lde_log2) == 1:
        z = (z + 1) % F.P
    return z


# ------------------------------------------------------------ encoding


def _u64(x: int) -> bytes:
    return struct.pack("<Q", x)


def _hashes(hs: List[bytes]) -> bytes:
    return _u64(len(hs)) + b"".join(hs)


def _digests(words: torch.Tensor) -> List[List[bytes]]:
    """[L, 8, Q] digest words -> L lists of Q digests."""
    L, _, q = words.shape
    if L * q == 0:
        return [[] for _ in range(L)]
    b = blake3.words_to_bytes(words.permute(1, 0, 2).reshape(8, L * q))
    return [[b[32 * (l * q + j):32 * (l * q + j + 1)] for j in range(q)] for l in range(L)]


# ------------------------------------------------------------ the prove


def prove(blocks: Sequence, manifest_root: bytes, device, queries: int = NUM_QUERIES) -> bytes:
    """The proof's bytes. `queries`: the AIR and FRI queries drawn (the
    configuration states 30)."""
    device = torch.device(device)
    n = sum(b.n_steps for b in blocks)
    tau = blocks[0].tau
    assert n > 0 and n & (n - 1) == 0, "the trace length is a power of two"
    names = labels(tau)

    tr = Transcript(DOMAIN)
    tr.absorb("manifest_root", manifest_root)
    tr.absorb_u64("n", n)
    tr.absorb_u64("tau", tau)

    cols = columns(blocks, device)
    com = ColumnCommitments(cols, names)
    col_roots = com.roots()
    tr.absorb_u64("n_cols", len(col_roots))
    for r in col_roots:
        tr.absorb("col_root", r)

    alphas = tr.field("alphas", NUM_ALPHAS)
    tr.absorb("masks", b"masks")
    tr.absorb_u64("n_masks", 1)
    tr.absorb_u64("deg", MASK_DEG)
    mask = [tr.field("mask_coeff", 1)[0] for _ in range(MASK_DEG)]
    log_n = n.bit_length() - 1
    lde_log2 = log_n + BLOWUP.bit_length() - 1
    lde_n = 1 << lde_log2
    z = off_coset(tr.field("ood_point", 1)[0], lde_log2)

    xs = F.powers(F.root_of_unity(log_n), n, device)
    masked = torch.zeros_like(xs)
    for coef in reversed(mask):
        masked = F.add(F.mul(masked, xs), F.const(coef, device))
    base = F.add(composition(cols, tau, alphas), masked)
    del xs, masked

    # FRI layers and their trees
    layers = [deep_lde(base, z)]
    trees = [Trees(field_leaves(layers[0])[:, None])]
    fri_roots = [blake3.words_to_bytes(trees[0].roots())]
    tr.absorb("fri_layer_root", fri_roots[0])
    betas = tr.field("fri_betas", lde_log2)
    for beta in betas:
        y = layers[-1]
        half = y.shape[0] // 2
        layers.append(F.add(y[:half], F.mul(F.const(beta, device), y[half:])))
        trees.append(Trees(field_leaves(layers[-1])[:, None]))
        fri_roots.append(blake3.words_to_bytes(trees[-1].roots()))
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
    croots, inner, outer = _digests(croots[None])[0], _digests(inner), _digests(outer)
    openings = []
    for q, (_, row) in enumerate(req):
        openings.append(F.to_le_bytes(values[q]) + _u64(row) + _u64(row // com.chunk)
                        + _u64(row % com.chunk) + croots[q]
                        + _hashes([lvl[q] for lvl in inner]) + _hashes([lvl[q] for lvl in outer]))

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
        sibs = _digests(trees[li].paths(torch.zeros_like(at_t), at_t))
        vals = layers[li][at_t].cpu().tolist()
        for j, i in enumerate(at):
            opened[(li, i)] = (F.to_le_bytes(vals[j]), [lvl[j] for lvl in sibs])

    out = [_u64(lde_n), _u64(tau), _u64(len(names))]
    for name, root in zip(names, col_roots):
        out += [_u64(len(name)), name.encode(), root]
    per_row = len(req) // len(rows)
    out.append(_u64(len(rows)))
    for k, row in enumerate(rows):
        out += [_u64(row), _u64(tau)] + openings[k * per_row:(k + 1) * per_row]
    out.append(_hashes(fri_roots))
    out.append(_u64(len(fri_queries)))
    for pos, pairs in fri_queries:
        out += [_u64(len(pos))] + [_u64(x) for x in pos] + [_u64(len(pairs))]
        for li, a, b in pairs:
            (va, pa), (vb, pb) = opened[(li, a)], opened[(li, b)]
            out += [va, _hashes(pa), vb, _hashes(pb)]
    out += [F.to_le_bytes(int(layers[-1][0])), manifest_root]
    return b"".join(out)
