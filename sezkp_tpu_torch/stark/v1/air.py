"""AIR constraints for v1, vectorized over all rows at once.

Semantics are identical to crates/sezkp-stark/src/v1/air.rs. One deliberate
TPU-first difference in *implementation*: the reference materializes
bit-decomposition aux columns and sums booleanity terms b*(b-1); since those
bits are derived from the committed values inside the honest build, the
booleanity terms are identically zero and the reconstruction terms reduce to
`value - (value & mask)` on the canonical u64 residue. We compute exactly
that, which is bit-identical to the reference's compose_row on every input.

Also contains the three MAC-backed micro-proofs used by the fold line
(LeafPi / AreIface / Wrap), bit-compatible with air.rs:263-444.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ...core.types import BlockSummary
from ...crypto import blake3
from ...ops import goldilocks as G
from .columns import (
    HEAD_BITS,
    IFACE_WINDOW_STEPS,
    SYM_BITS,
    TraceColumns,
    boundary_left_tail_digest,
    boundary_right_head_digest,
)

_HEAD_MASK = np.uint64((1 << HEAD_BITS) - 1)
_SYM_MASK = np.uint64((1 << SYM_BITS) - 1)


@dataclass
class Alphas:
    bool_flag: int
    mv_domain: int
    head_update: int
    head_bits_bool: int
    head_reconstruct: int
    slack_bits_bool: int
    slack_reconstruct: int
    sym_bits_bool: int
    sym_reconstruct: int
    boundary_first: int
    boundary_last: int

    @staticmethod
    def from_list(a: Sequence[int]) -> "Alphas":
        """Mapping from derive_alphas output (reference: prover.rs:86-98)."""
        return Alphas(
            bool_flag=a[0],
            mv_domain=a[1],
            head_update=a[2],
            head_bits_bool=a[3],
            head_reconstruct=a[4],
            slack_bits_bool=a[5],
            slack_reconstruct=a[6],
            sym_bits_bool=a[7],
            sym_reconstruct=a[0],
            boundary_first=a[2],
            boundary_last=a[2],
        )


def _c(x: int, n: int) -> np.ndarray:
    return np.full(n, np.uint64(x % int(G.P)), dtype=np.uint64)


def compose_all_rows(tc: TraceColumns, a: Alphas) -> np.ndarray:
    """compose_row(i) + compose_boundary(i) for all i, vectorized.

    Next-row values wrap (i+1) % n (air.rs:59-61)."""
    n = tc.n
    one = np.uint64(1)
    acc = np.zeros(n, dtype=np.uint64)
    one_minus_last = G.sub(np.full(n, one), tc.is_last)

    for r in range(tc.tau):
        mv = tc.mv[r]
        flg = tc.write_flag[r]
        head = tc.head[r]
        head_next = np.roll(head, -1)
        mv_next = np.roll(mv, -1)

        # C1: flag booleanity
        acc = G.add(acc, G.mul(_c(a.bool_flag, n), G.mul(flg, G.sub(flg, one))))
        # C2: mv in {-1,0,1}
        t = G.mul(mv, G.mul(G.sub(mv, one), G.add(mv, one)))
        acc = G.add(acc, G.mul(_c(a.mv_domain, n), t))
        # C3: head update, masked by !is_last
        hu = G.sub(G.sub(head_next, head), mv_next)
        acc = G.add(acc, G.mul(_c(a.head_update, n), G.mul(one_minus_last, hu)))

        # Range checks via bit reconstruction (guarded by flg).
        # head_bits_bool / slack_bits_bool / sym_bits_bool terms are 0 by
        # construction (bits derived from the same values).
        head_low = head & _HEAD_MASK
        acc = G.add(
            acc, G.mul(_c(a.head_reconstruct, n), G.mul(flg, G.sub(head, head_low)))
        )
        slack = G.sub(G.sub(tc.win_len[r], np.full(n, one)), head)
        slack_low = slack & _HEAD_MASK
        acc = G.add(
            acc, G.mul(_c(a.slack_reconstruct, n), G.mul(flg, G.sub(slack, slack_low)))
        )
        sym = tc.write_sym[r]
        sym_low = sym & _SYM_MASK
        acc = G.add(
            acc, G.mul(_c(a.sym_reconstruct, n), G.mul(flg, G.sub(sym, sym_low)))
        )

        # Boundary terms (air.rs:119-136)
        bf = G.sub(G.sub(head, mv), tc.in_off[r])
        acc = G.add(acc, G.mul(_c(a.boundary_first, n), G.mul(tc.is_first, bf)))
        bl = G.sub(head, tc.out_off[r])
        acc = G.add(acc, G.mul(_c(a.boundary_last, n), G.mul(tc.is_last, bl)))

    return acc


# ---------------- openings-only evaluation (verifier side) ------------------


def compose_row_from_openings(view: "RowView", a: Alphas) -> int:
    p = int(G.P)
    acc = 0
    one_minus_last = (1 - view.is_last) % p
    for t in view.tapes:
        acc += a.bool_flag * (t.write_flag * (t.write_flag - 1) % p)
        acc += a.mv_domain * (t.mv * ((t.mv - 1) % p) % p * ((t.mv + 1) % p) % p)
        hu = (t.next_head - t.head - t.next_mv) % p
        acc += a.head_update * (one_minus_last * hu % p)
        acc %= p
    return acc % p


def compose_boundary_from_openings(view: "RowView", a: Alphas) -> int:
    p = int(G.P)
    acc = 0
    for t in view.tapes:
        acc += a.boundary_first * (view.is_first * ((t.head - t.mv - t.in_off) % p) % p)
        acc += a.boundary_last * (view.is_last * ((t.head - t.out_off) % p) % p)
        acc %= p
    return acc % p


@dataclass
class TapeOpenView:
    mv: int
    next_mv: int
    write_flag: int
    write_sym: int
    head: int
    next_head: int
    win_len: int
    in_off: int
    out_off: int


@dataclass
class RowView:
    row: int
    is_first: int
    is_last: int
    input_mv: int
    tapes: List[TapeOpenView]

    @staticmethod
    def from_openings(q) -> "RowView":
        def f(op) -> int:
            return struct.unpack("<Q", op.value_le)[0] % int(G.P)

        tapes = [
            TapeOpenView(
                mv=f(t.mv),
                next_mv=f(t.next_mv),
                write_flag=f(t.write_flag),
                write_sym=f(t.write_sym),
                head=f(t.head),
                next_head=f(t.next_head),
                win_len=f(t.win_len),
                in_off=f(t.in_off),
                out_off=f(t.out_off),
            )
            for t in q.per_tape
        ]
        return RowView(
            row=q.row,
            is_first=f(q.is_first),
            is_last=f(q.is_last),
            input_mv=f(q.input_mv),
            tapes=tapes,
        )


# ---------------------------- micro proofs ----------------------------------

DS_LEAF_PI_V1 = b"stark/leaf_pi/v1"
DS_ARE_V2 = b"stark/are_iface/v2"
DS_WRAP_V2 = b"stark/wrap/v2"


@dataclass
class PiPublic:
    ctrl_in: int
    ctrl_out: int
    flags: int
    acc_limbs: List[int]  # 4 x u64
    left_tail_digest: bytes
    right_head_digest: bytes


def pack_boundary_limbs(left: bytes, right: bytes) -> List[int]:
    """[L[0..8], L[8..16], R[0..8], R[8..16]] as LE u64 (air.rs:288-301)."""
    return [
        struct.unpack("<Q", left[0:8])[0],
        struct.unpack("<Q", left[8:16])[0],
        struct.unpack("<Q", right[0:8])[0],
        struct.unpack("<Q", right[8:16])[0],
    ]


def _leaf_pi_mac(p: PiPublic) -> bytes:
    h = blake3.Hasher()
    h.update(DS_LEAF_PI_V1)
    h.update(struct.pack("<I", p.ctrl_in))
    h.update(struct.pack("<I", p.ctrl_out))
    h.update(struct.pack("<I", p.flags))
    for limb in p.acc_limbs:
        h.update(struct.pack("<Q", limb))
    h.update(p.left_tail_digest)
    h.update(p.right_head_digest)
    return h.digest(32)


def prove_leaf_pi(block: BlockSummary):
    l_tail = boundary_left_tail_digest(block, IFACE_WINDOW_STEPS)
    r_head = boundary_right_head_digest(block, IFACE_WINDOW_STEPS)
    public = PiPublic(
        ctrl_in=0,
        ctrl_out=0,
        flags=1,
        acc_limbs=pack_boundary_limbs(l_tail, r_head),
        left_tail_digest=l_tail,
        right_head_digest=r_head,
    )
    return public, _leaf_pi_mac(public)


def verify_leaf_pi(public: PiPublic, mac: bytes) -> bool:
    return _leaf_pi_mac(public) == mac


@dataclass
class LeafIfacePublic:
    l_tail_prefix: List[int]  # 2 x u64
    r_head_prefix: List[int]
    ctrl_out: int
    ctrl_in: int


def _iface_mac(li: LeafIfacePublic, ri: LeafIfacePublic) -> bytes:
    h = blake3.Hasher()
    h.update(DS_ARE_V2)
    for x in li.r_head_prefix:
        h.update(struct.pack("<Q", x))
    h.update(struct.pack("<I", li.ctrl_out))
    for x in ri.l_tail_prefix:
        h.update(struct.pack("<Q", x))
    h.update(struct.pack("<I", ri.ctrl_in))
    return h.digest(32)


def prove_iface_replay(li: LeafIfacePublic, ri: LeafIfacePublic) -> bytes:
    return _iface_mac(li, ri)


def verify_iface_replay(li: LeafIfacePublic, ri: LeafIfacePublic, mac: bytes) -> bool:
    if li.ctrl_out != ri.ctrl_in:
        return False
    return _iface_mac(li, ri) == mac


@dataclass
class WrapPublic:
    c_root: bytes
    c_len: int
    ctrl_in: int
    ctrl_out: int
    flags: int
    acc_limbs: List[int]


def _wrap_mac(p: WrapPublic) -> bytes:
    h = blake3.Hasher()
    h.update(DS_WRAP_V2)
    h.update(p.c_root)
    h.update(struct.pack("<I", p.c_len))
    h.update(struct.pack("<I", p.ctrl_in))
    h.update(struct.pack("<I", p.ctrl_out))
    h.update(struct.pack("<I", p.flags))
    for limb in p.acc_limbs:
        h.update(struct.pack("<Q", limb))
    return h.digest(32)


def prove_wrap_public(p: WrapPublic) -> bytes:
    return _wrap_mac(p)


def verify_wrap_public(p: WrapPublic, mac: bytes) -> bool:
    return _wrap_mac(p) == mac


def compose_lde_periodic(tc: TraceColumns, a: Alphas, blow_log2: int) -> np.ndarray:
    """Prototype periodic LDE of the composition (reference: air.rs:139-148).

    Kept for API completeness; the real pipeline uses the DEEP coset LDE."""
    base = compose_all_rows(tc, a)
    return np.tile(base, 1 << blow_log2)
