"""ARE interface-replay proofs (reference: crates/sezkp-fold/src/are_replay.rs).

Two wire-compatible variants: legacy V1 MAC and preferred V2 (micro-proof
over child pi prefixes). The bincode encoding of `AreProof` (u32 variant tag
+ payload) is needed byte-exactly because the fold MAC absorbs it.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Union

from ..crypto import blake3
from ..stark.v1.air import LeafIfacePublic, prove_iface_replay, verify_iface_replay
from ..utils.cbor import U8Array
from .are import InterfaceWitness, Pi

DS_ARE_V1 = b"fold/are/v1"


@dataclass
class AreProofV1:
    mac: bytes  # 32

    def to_obj(self):
        return {"V1Mac": U8Array(self.mac)}


@dataclass
class AreProofV2:
    mac: bytes  # AreProofStark { mac: [u8;32] }

    def to_obj(self):
        return {"V2Stark": {"mac": U8Array(self.mac)}}


AreProof = Union[AreProofV1, AreProofV2]


def are_proof_from_obj(o) -> AreProof:
    if "V1Mac" in o:
        return AreProofV1(bytes(o["V1Mac"]))
    if "V2Stark" in o:
        return AreProofV2(bytes(o["V2Stark"]["mac"]))
    raise ValueError("unknown AreProof variant")


def bincode_are_proof(p: AreProof) -> bytes:
    """bincode 1.3 encoding: u32 LE variant index + payload bytes."""
    if isinstance(p, AreProofV1):
        return struct.pack("<I", 0) + p.mac
    return struct.pack("<I", 1) + p.mac


def prove_replay(iface: InterfaceWitness) -> AreProofV1:
    h = blake3.Hasher()
    h.update(DS_ARE_V1)
    h.update(struct.pack("<I", iface.left_ctrl_out))
    h.update(struct.pack("<I", iface.right_ctrl_in))
    h.update(iface.boundary_writes_digest)
    return AreProofV1(h.digest(32))


def verify_replay(iface: InterfaceWitness, proof: AreProof) -> bool:
    if isinstance(proof, AreProofV1):
        return prove_replay(iface).mac == proof.mac
    return False


def _limbs(pi: Pi):
    lt = [pi.acc[0] & 0xFFFFFFFFFFFFFFFF, pi.acc[1] & 0xFFFFFFFFFFFFFFFF]
    rh = [pi.acc[2] & 0xFFFFFFFFFFFFFFFF, pi.acc[3] & 0xFFFFFFFFFFFFFFFF]
    return lt, rh


def _iface_publics(left: Pi, right: Pi):
    _, rh_l = _limbs(left)
    lt_r, _ = _limbs(right)
    li = LeafIfacePublic(
        l_tail_prefix=[0, 0], r_head_prefix=rh_l, ctrl_out=left.ctrl_out, ctrl_in=0
    )
    ri = LeafIfacePublic(
        l_tail_prefix=lt_r, r_head_prefix=[0, 0], ctrl_out=0, ctrl_in=right.ctrl_in
    )
    return li, ri


def prove_replay_from_children(
    left: Pi, right: Pi, _iface: InterfaceWitness
) -> AreProofV2:
    """V2: micro-proof binding rh(left)/ctrl_out + lt(right)/ctrl_in."""
    li, ri = _iface_publics(left, right)
    return AreProofV2(prove_iface_replay(li, ri))


def verify_replay_from_children(left: Pi, right: Pi, proof: AreProof) -> bool:
    li, ri = _iface_publics(left, right)
    if isinstance(proof, AreProofV2):
        return verify_iface_replay(li, ri, proof.mac)
    return False
