"""Fold line public API types (reference: crates/sezkp-fold/src/api.rs)."""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..crypto import blake3
from ..utils.cbor import U8Array
from .devhash import DEVICE_HASH_MIN

DS_LEAF = "fold/leaf"
DS_FOLD = "fold/merge"
DS_WRAP = "fold/wrap"


@dataclass(frozen=True)
class Commitment:
    root: bytes  # 32
    len: int  # u32 leaf span

    def to_obj(self):
        return {"root": U8Array(self.root), "len": self.len}

    @staticmethod
    def from_obj(o):
        return Commitment(root=bytes(o["root"]), len=o["len"])


@dataclass(frozen=True)
class PiCommitment:
    """Opaque commitment to pi (newtype over [u8;32] on the wire)."""

    digest: bytes

    def to_obj(self):
        return U8Array(self.digest)

    @staticmethod
    def from_obj(o):
        return PiCommitment(bytes(o))


def commit_pi(pi) -> PiCommitment:
    """BLAKE3('sezkp-fold/pi-commitment/v1' || ctrl_in || ctrl_out || flags ||
    acc LE limbs) — reference api.rs:60-72."""
    h = blake3.Hasher()
    h.update(b"sezkp-fold/pi-commitment/v1")
    h.update(struct.pack("<I", pi.ctrl_in))
    h.update(struct.pack("<I", pi.ctrl_out))
    h.update(struct.pack("<I", pi.flags))
    for a in pi.acc:
        h.update(struct.pack("<Q", a))
    return PiCommitment(h.digest(32))


class FoldMode:
    BALANCED = "Balanced"
    MINRAM = "MinRam"


@dataclass
class DriverOptions:
    fold_mode: str = FoldMode.BALANCED
    wrap_cadence: int = 0
    endpoint_cache: int = 64
    # balanced mode only (fold/devhash.py): batches of at least this many
    # single-chunk messages are hashed on `device`; 0 asks for the host hasher.
    device_hash_min: int = DEVICE_HASH_MIN
    device: object = None  # None: the CUDA card; "cpu": the kernel's plain version
