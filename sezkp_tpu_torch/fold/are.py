"""ARE primitives for the fold line: Pi capsule + constant-degree combiner.

Reference: crates/sezkp-fold/src/are.rs. acc[0..2] carry the left-tail digest
prefix limbs, acc[2..4] the right-head prefix (are_replay.rs:542-548).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Tuple

from ..ops import goldilocks as G
from ..utils.cbor import U8Array

Q = 4
_P = 0xFFFFFFFF00000001


@dataclass(frozen=True)
class Pi:
    ctrl_in: int = 0
    ctrl_out: int = 0
    flags: int = 0
    acc: Tuple[int, int, int, int] = (0, 0, 0, 0)  # canonical field elements

    def to_obj(self):
        """Wire shape PiWire {ctrl_in, ctrl_out, flags, acc: [[u8;8];4]}."""
        a0, a1, a2, a3 = self.acc
        return {
            "ctrl_in": self.ctrl_in,
            "ctrl_out": self.ctrl_out,
            "flags": self.flags,
            "acc": [
                U8Array(a0.to_bytes(8, "little")),
                U8Array(a1.to_bytes(8, "little")),
                U8Array(a2.to_bytes(8, "little")),
                U8Array(a3.to_bytes(8, "little")),
            ],
        }

    @staticmethod
    def from_obj(o) -> "Pi":
        return Pi(
            ctrl_in=o["ctrl_in"],
            ctrl_out=o["ctrl_out"],
            flags=o["flags"],
            acc=tuple(
                struct.unpack("<Q", bytes(a))[0] % _P for a in o["acc"]
            ),
        )


@dataclass(frozen=True)
class CombineAux:
    gamma: Tuple[int, int, int, int] = (0, 0, 0, 0)
    flag_mask: int = 0


def combine(pi_l: Pi, pi_r: Pi, aux: CombineAux = CombineAux()) -> Pi:
    """pi_out = G(pi_L, pi_R; aux): acc add + gamma, flags OR ^ mask, ctrl from
    l.in/r.out (are.rs:258-272)."""
    acc = tuple(
        (pi_l.acc[i] + pi_r.acc[i] + aux.gamma[i]) % _P for i in range(Q)
    )
    return Pi(
        ctrl_in=pi_l.ctrl_in,
        ctrl_out=pi_r.ctrl_out,
        flags=(pi_l.flags | pi_r.flags) ^ aux.flag_mask,
        acc=acc,
    )


@dataclass
class InterfaceWitness:
    left_ctrl_out: int
    right_ctrl_in: int
    boundary_writes_digest: bytes  # 32

    def to_obj(self):
        return {
            "left_ctrl_out": self.left_ctrl_out,
            "right_ctrl_in": self.right_ctrl_in,
            "boundary_writes_digest": U8Array(self.boundary_writes_digest),
        }

    @staticmethod
    def from_obj(o):
        return InterfaceWitness(
            left_ctrl_out=o["left_ctrl_out"],
            right_ctrl_in=o["right_ctrl_in"],
            boundary_writes_digest=bytes(o["boundary_writes_digest"]),
        )
