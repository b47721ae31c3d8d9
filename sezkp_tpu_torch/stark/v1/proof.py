"""ProofV1 structures + bincode 1.3 wire codec.

Field order and types mirror crates/sezkp-stark/src/v1/proof.rs exactly;
encoding is bincode 1.3.3 defaults (fixed-width little-endian ints, u64
sequence/string lengths, arrays as raw elements) so proofs interop with the
reference byte-for-byte.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Tuple

__all__ = [
    "Opening",
    "PerTapeOpen",
    "RowOpenings",
    "ColumnRoot",
    "FriQuery",
    "ProofV1",
    "encode_proof",
    "decode_proof",
]


@dataclass
class Opening:
    value_le: bytes  # 8
    index: int
    chunk_index: int
    index_in_chunk: int
    chunk_root: bytes  # 32
    path_in_chunk: List[bytes]
    path_to_chunk: List[bytes]


@dataclass
class PerTapeOpen:
    mv: Opening
    next_mv: Opening
    write_flag: Opening
    write_sym: Opening
    head: Opening
    next_head: Opening
    win_len: Opening
    in_off: Opening
    out_off: Opening

    def all(self) -> List[Opening]:
        return [
            self.mv,
            self.next_mv,
            self.write_flag,
            self.write_sym,
            self.head,
            self.next_head,
            self.win_len,
            self.in_off,
            self.out_off,
        ]


@dataclass
class RowOpenings:
    row: int
    per_tape: List[PerTapeOpen]
    is_first: Opening
    is_last: Opening
    input_mv: Opening


@dataclass
class ColumnRoot:
    label: str
    root: bytes


@dataclass
class FriQuery:
    positions: List[int]
    pairs: List[Tuple[bytes, List[bytes], bytes, List[bytes]]]


@dataclass
class ProofV1:
    domain_n: int
    tau: int
    col_roots: List[ColumnRoot]
    queries: List[RowOpenings]
    fri_roots: List[bytes]
    fri_queries: List[FriQuery]
    fri_final_value_le: bytes
    manifest_root: bytes


# ------------------------------ bincode ------------------------------------


class _W:
    def __init__(self):
        self.buf = bytearray()

    def u64(self, x: int):
        self.buf += struct.pack("<Q", x)

    def raw(self, b: bytes):
        self.buf += b

    def vec_hashes(self, v: List[bytes]):
        self.u64(len(v))
        for h in v:
            self.raw(h)

    def string(self, s: str):
        b = s.encode()
        self.u64(len(b))
        self.raw(b)


def _enc_opening(w: _W, o: Opening):
    w.raw(o.value_le)
    w.u64(o.index)
    w.u64(o.chunk_index)
    w.u64(o.index_in_chunk)
    w.raw(o.chunk_root)
    w.vec_hashes(o.path_in_chunk)
    w.vec_hashes(o.path_to_chunk)


def encode_proof(p: ProofV1) -> bytes:
    w = _W()
    w.u64(p.domain_n)
    w.u64(p.tau)
    w.u64(len(p.col_roots))
    for cr in p.col_roots:
        w.string(cr.label)
        w.raw(cr.root)
    w.u64(len(p.queries))
    for q in p.queries:
        w.u64(q.row)
        w.u64(len(q.per_tape))
        for t in q.per_tape:
            for o in t.all():
                _enc_opening(w, o)
        _enc_opening(w, q.is_first)
        _enc_opening(w, q.is_last)
        _enc_opening(w, q.input_mv)
    w.vec_hashes(p.fri_roots)
    w.u64(len(p.fri_queries))
    for fq in p.fri_queries:
        w.u64(len(fq.positions))
        for pos in fq.positions:
            w.u64(pos)
        w.u64(len(fq.pairs))
        for (vi, pi, vj, pj) in fq.pairs:
            w.raw(vi)
            w.vec_hashes(pi)
            w.raw(vj)
            w.vec_hashes(pj)
    w.raw(p.fri_final_value_le)
    w.raw(p.manifest_root)
    return bytes(w.buf)


class _R:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.data, self.pos)[0]
        self.pos += 8
        return v

    def raw(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("bincode: truncated input")
        self.pos += n
        return b

    def vec_hashes(self) -> List[bytes]:
        n = self.u64()
        return [self.raw(32) for _ in range(n)]

    def string(self) -> str:
        n = self.u64()
        return self.raw(n).decode()


def _dec_opening(r: _R) -> Opening:
    return Opening(
        value_le=r.raw(8),
        index=r.u64(),
        chunk_index=r.u64(),
        index_in_chunk=r.u64(),
        chunk_root=r.raw(32),
        path_in_chunk=r.vec_hashes(),
        path_to_chunk=r.vec_hashes(),
    )


def decode_proof(data: bytes) -> ProofV1:
    r = _R(data)
    domain_n = r.u64()
    tau = r.u64()
    col_roots = [ColumnRoot(r.string(), r.raw(32)) for _ in range(r.u64())]
    queries = []
    for _ in range(r.u64()):
        row = r.u64()
        per_tape = []
        for _ in range(r.u64()):
            ops = [_dec_opening(r) for _ in range(9)]
            per_tape.append(PerTapeOpen(*ops))
        is_first = _dec_opening(r)
        is_last = _dec_opening(r)
        input_mv = _dec_opening(r)
        queries.append(RowOpenings(row, per_tape, is_first, is_last, input_mv))
    fri_roots = r.vec_hashes()
    fri_queries = []
    for _ in range(r.u64()):
        positions = [r.u64() for _ in range(r.u64())]
        pairs = []
        for _ in range(r.u64()):
            vi = r.raw(8)
            pi = r.vec_hashes()
            vj = r.raw(8)
            pj = r.vec_hashes()
            pairs.append((vi, pi, vj, pj))
        fri_queries.append(FriQuery(positions, pairs))
    fri_final = r.raw(8)
    manifest_root = r.raw(32)
    if r.pos != len(data):
        raise ValueError("bincode: trailing bytes")
    return ProofV1(
        domain_n, tau, col_roots, queries, fri_roots, fri_queries, fri_final, manifest_root
    )
