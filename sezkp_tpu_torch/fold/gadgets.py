"""Concrete Leaf / Fold / Wrap gadgets (reference: leaf.rs, fold.rs).

Leaf commitments reuse the canonical manifest leaf hash; the fold parent
commitment mirrors the Merkle parent rule so the final fold root equals the
manifest root.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ..commit.merkle import leaf_hash
from ..core.types import BlockSummary
from ..crypto import blake3
from ..utils.cbor import U8Array
from ..crypto.transcript import Blake3Transcript
from ..stark.v1.air import PiPublic, prove_leaf_pi, verify_leaf_pi
from .api import Commitment, DS_FOLD, DS_LEAF, DS_WRAP, PiCommitment, commit_pi
from .are import CombineAux, InterfaceWitness, Pi, combine
from .are_replay import (
    AreProof,
    are_proof_from_obj,
    bincode_are_proof,
    prove_replay_from_children,
)

_P = 0xFFFFFFFF00000001


# ------------------------------- Leaf ---------------------------------------


@dataclass
class CryptoLeafProof:
    public: PiPublic
    proof_mac: bytes  # inner LeafPi micro-proof MAC
    mac: bytes  # outer DS_LEAF transcript MAC

    def to_obj(self):
        p = self.public
        return {
            "public": {
                "ctrl_in": p.ctrl_in,
                "ctrl_out": p.ctrl_out,
                "flags": p.flags,
                "acc_limbs": list(p.acc_limbs),
                "left_tail_digest": U8Array(p.left_tail_digest),
                "right_head_digest": U8Array(p.right_head_digest),
            },
            "proof": {"mac": U8Array(self.proof_mac)},
            "mac": U8Array(self.mac),
        }

    @staticmethod
    def from_obj(o) -> "CryptoLeafProof":
        p = o["public"]
        return CryptoLeafProof(
            public=PiPublic(
                ctrl_in=p["ctrl_in"],
                ctrl_out=p["ctrl_out"],
                flags=p["flags"],
                acc_limbs=list(p["acc_limbs"]),
                left_tail_digest=bytes(p["left_tail_digest"]),
                right_head_digest=bytes(p["right_head_digest"]),
            ),
            proof_mac=bytes(o["proof"]["mac"]),
            mac=bytes(o["mac"]),
        )


def _pi_from_public(p: PiPublic) -> Pi:
    return Pi(
        ctrl_in=p.ctrl_in,
        ctrl_out=p.ctrl_out,
        flags=p.flags,
        acc=tuple(limb % _P for limb in p.acc_limbs),
    )


class CryptoLeaf:
    @staticmethod
    def prove_leaf(block: BlockSummary) -> Tuple[Pi, Commitment, CryptoLeafProof]:
        public, inner_mac = prove_leaf_pi(block)
        pi = _pi_from_public(public)
        c = Commitment(root=leaf_hash(block), len=1)

        pi_cmt = commit_pi(pi)
        tr = Blake3Transcript(DS_LEAF)
        tr.absorb("c.root", c.root)
        tr.absorb_u64("c.len", c.len)
        tr.absorb("pi.commit", pi_cmt.digest)
        tr.absorb("left_tail", public.left_tail_digest)
        tr.absorb("right_head", public.right_head_digest)
        tr.absorb("leaf_pi.mac", inner_mac)
        mac = tr.challenge_bytes("mac", 32)
        return pi, c, CryptoLeafProof(public, inner_mac, mac)

    @staticmethod
    def verify_leaf(
        commit: Commitment, pi_cmt: PiCommitment, proof: CryptoLeafProof
    ) -> bool:
        pi_rebuilt = _pi_from_public(proof.public)
        if commit_pi(pi_rebuilt) != pi_cmt:
            return False
        if not verify_leaf_pi(proof.public, proof.proof_mac):
            return False
        tr = Blake3Transcript(DS_LEAF)
        tr.absorb("c.root", commit.root)
        tr.absorb_u64("c.len", commit.len)
        tr.absorb("pi.commit", pi_cmt.digest)
        tr.absorb("left_tail", proof.public.left_tail_digest)
        tr.absorb("right_head", proof.public.right_head_digest)
        tr.absorb("leaf_pi.mac", proof.proof_mac)
        return tr.challenge_bytes("mac", 32) == proof.mac


# ------------------------------- Fold ---------------------------------------


def combine_commitments(left: Commitment, right: Commitment) -> Commitment:
    """Must mirror the Merkle parent: BLAKE3(left || right) (fold.rs:745-755)."""
    return Commitment(
        root=blake3.hash_bytes(left.root + right.root), len=left.len + right.len
    )


@dataclass
class CryptoFoldProof:
    iface: InterfaceWitness
    are: AreProof
    mac: bytes

    def to_obj(self):
        return {
            "iface": self.iface.to_obj(),
            "are": self.are.to_obj(),
            "mac": U8Array(self.mac),
        }

    @staticmethod
    def from_obj(o) -> "CryptoFoldProof":
        return CryptoFoldProof(
            iface=InterfaceWitness.from_obj(o["iface"]),
            are=are_proof_from_obj(o["are"]),
            mac=bytes(o["mac"]),
        )


def _fold_mac(
    left_c: Commitment,
    left_pc: PiCommitment,
    right_c: Commitment,
    right_pc: PiCommitment,
    parent_c: Commitment,
    parent_pc: PiCommitment,
    iface: InterfaceWitness,
    are: AreProof,
) -> bytes:
    tr = Blake3Transcript(DS_FOLD)
    tr.absorb("L.c.root", left_c.root)
    tr.absorb_u64("L.c.len", left_c.len)
    tr.absorb("L.pi.commit", left_pc.digest)
    tr.absorb("R.c.root", right_c.root)
    tr.absorb_u64("R.c.len", right_c.len)
    tr.absorb("R.pi.commit", right_pc.digest)
    tr.absorb("P.c.root", parent_c.root)
    tr.absorb_u64("P.c.len", parent_c.len)
    tr.absorb("P.pi.commit", parent_pc.digest)
    tr.absorb_u64("iface.left_ctrl_out", iface.left_ctrl_out)
    tr.absorb_u64("iface.right_ctrl_in", iface.right_ctrl_in)
    tr.absorb("iface.boundary_digest", iface.boundary_writes_digest)
    tr.absorb("ARE.proof", bincode_are_proof(are))
    return tr.challenge_bytes("mac", 32)


class CryptoFold:
    @staticmethod
    def fold(
        left: Tuple[Commitment, Pi],
        right: Tuple[Commitment, Pi],
        iface: InterfaceWitness,
    ) -> Tuple[Commitment, Pi, CryptoFoldProof]:
        lc, lp = left
        rc, rp = right
        are_proof = prove_replay_from_children(lp, rp, iface)
        pi_par = combine(lp, rp, CombineAux())
        c_par = combine_commitments(lc, rc)
        mac = _fold_mac(
            lc, commit_pi(lp), rc, commit_pi(rp), c_par, commit_pi(pi_par), iface, are_proof
        )
        return c_par, pi_par, CryptoFoldProof(iface, are_proof, mac)

    @staticmethod
    def verify_fold(
        parent: Tuple[Commitment, PiCommitment],
        left: Tuple[Commitment, PiCommitment],
        right: Tuple[Commitment, PiCommitment],
        proof: CryptoFoldProof,
    ) -> bool:
        expect = combine_commitments(left[0], right[0])
        if expect.root != parent[0].root or expect.len != parent[0].len:
            return False
        mac = _fold_mac(
            left[0], left[1], right[0], right[1], parent[0], parent[1],
            proof.iface, proof.are,
        )
        return mac == proof.mac


# ------------------------------- Wrap ---------------------------------------


@dataclass
class CryptoWrapProof:
    mac: bytes  # V1Mac variant

    def to_obj(self):
        return {"V1Mac": U8Array(self.mac)}

    @staticmethod
    def from_obj(o) -> "CryptoWrapProof":
        if "V1Mac" in o:
            return CryptoWrapProof(bytes(o["V1Mac"]))
        raise ValueError("unsupported wrap proof variant")


class CryptoWrap:
    @staticmethod
    def wrap(root: Tuple[Commitment, Pi]) -> CryptoWrapProof:
        c, pi = root
        pi_cmt = commit_pi(pi)
        tr = Blake3Transcript(DS_WRAP)
        tr.absorb("c.root", c.root)
        tr.absorb_u64("c.len", c.len)
        tr.absorb("pi.commit", pi_cmt.digest)
        return CryptoWrapProof(tr.challenge_bytes("mac", 32))

    @staticmethod
    def verify_wrap(
        root: Tuple[Commitment, PiCommitment], proof: CryptoWrapProof
    ) -> bool:
        c, pi_cmt = root
        tr = Blake3Transcript(DS_WRAP)
        tr.absorb("c.root", c.root)
        tr.absorb_u64("c.len", c.len)
        tr.absorb("pi.commit", pi_cmt.digest)
        return tr.challenge_bytes("mac", 32) == proof.mac
